"""k2_roofline.mesh: K2 bf16's share of its roofline in %: the least time
of one request's dense sweep (benchmark/frozen/bounds.py: the separable
minimum, touched slices from the lattice's geometry) over the device time
of the kernels named lattice_sweep_bf16* a request, from the trace.
Layer: kernels (K2, csrc/sweep.cu).  Moves mesh_s."""

from benchmark.frozen.bounds import sweep_bound_ms


def read(ctx):
    if not ctx.trace or "k2_work" not in ctx.work or not ctx.counts.get("requests"):
        return None
    k2_s = sum(s for name, s in ctx.trace["kernels"].items() if "lattice_sweep_bf16" in name)
    if k2_s <= 0:
        return None
    bound_ms, _ = sweep_bound_ms(ctx.work["k2_work"])
    return 100.0 * bound_ms * 1e-3 / (k2_s / ctx.counts["requests"])
