"""Host utilities of the port: meshing dumps and the tracer (spans, counters
and torch.profiler traces)."""
