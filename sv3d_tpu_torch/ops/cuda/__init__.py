"""Hand-written Hopper kernels of the port and their wrappers.

Each wrapper runs its plain torch version for a CPU tensor and launches its
CUDA kernel for a CUDA tensor (or raises); it counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.  The kernels are built from
sv3d_tpu_torch/csrc/*.cu at first use (sv3d_tpu_torch.ops.cuda.build).
"""


def launch_counters() -> dict:
    """Every kernel's wrapper by the kernel's name in the port's records
    (PERF.md): read a count as ``launch_counters()[name].launches``.  K3's
    wrapper counts both of its dtypes; "wgrad", "dgrad" and "fprop" are the
    f32 3x3x3 convs' weight and input gradients and forward, which replace
    no TPU kernel."""
    from sv3d_tpu_torch.ops.cuda import (
        conv3d_dgrad,
        conv3d_fprop,
        conv3d_wgrad,
        mlp,
        point_query,
        sweep,
        voxelize,
    )

    return {
        "K1": voxelize.scatter_voxels_cuda, "K1b": voxelize.scatter_voxels_bwd_cuda,
        "K2": sweep.lattice_sweep_bf16_cuda, "K2f32": sweep.lattice_sweep_f32_cuda,
        "K3": mlp.fused_point_mlp, "K4": point_query.level_features_cuda,
        "K5": point_query.level_features_banded_cuda, "K6": point_query.level_fc0_cuda,
        "K6bf16": point_query.level_fc0_bf16_cuda, "K7": point_query.level_grad_points_cuda,
        "K8": point_query.level_grad_vol_cuda, "wgrad": conv3d_wgrad.conv3d_wgrad_cuda,
        "dgrad": conv3d_dgrad.conv3d_dgrad_cuda, "fprop": conv3d_fprop.conv3d_fprop_cuda,
    }


def launch_counts() -> dict:
    """A snapshot of every kernel's launch count, by launch_counters' names."""
    return {name: fn.launches for name, fn in launch_counters().items()}


def launched(fn) -> dict:
    """The kernels that a call of fn launched: {launch_counters' name:
    launches}, kernels with none left out."""
    before = launch_counts()
    fn()
    return {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}


def require(ran: dict, must=(), must_not=(), what: str = "") -> None:
    """Raise unless every kernel of `must` launched in `ran` (launched's
    result) and none of `must_not` did."""
    missing = [k for k in must if not ran.get(k)]
    extra = [k for k in must_not if ran.get(k)]
    if missing or extra:
        raise RuntimeError(f"{what}: kernels {missing} did not launch, {extra} did: {ran}")


def rel_mean_err(got, ref) -> float:
    """mean |got - ref| / max(1e-30, mean |ref|): the mean-error limits of
    the bf16 kernels (K2, K3, K6 bf16) read this."""
    return float((got - ref).abs().mean()) / max(float(ref.abs().mean()), 1e-30)
