"""peak_mem_gib.train: torch.cuda.max_memory_allocated over the window, in
GiB.  Layer: device memory.  Moves train_samples_per_s."""


def read(ctx):
    peak = ctx.memory.get("window_peak_bytes")
    return peak / 2**30 if peak else None
