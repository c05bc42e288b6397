"""The frozen K2 bound counts what chip_smoke.py's sweep_bound counts, with
the touched axis-0 slices worked out from the lattice's geometry alone."""

import pytest
import torch

from benchmark.frozen import bounds
from conftest import ROOT


def _chip_smoke():
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("net_res,dims,res", [(128, (17, 13, 14), 1), (128, (17, 13, 14), 2),
                                              (32, (17, 13, 14), 1), (32, (9, 7, 8), 3)])
def test_sweep_bound_agrees(net_res, dims, res):
    from sv3d_tpu_torch.config import IFNetConfig
    from sv3d_tpu_torch.models.ifnet import IFNet

    cs = _chip_smoke()
    cfg = IFNetConfig.for_net_res(net_res)
    net = IFNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        levels = net.encode(torch.rand(1, *dims, 1))
    lv = list(levels)
    r = tuple(d * res for d in dims)
    chans = [f.shape[1] for f, _ in lv]
    ldims = [d for _, d in lv]
    assert ldims == bounds.level_dims(dims, len(net.stages))
    theirs = cs.touched_slices(lv, r, r[0], 0, cfg.align_corners, cfg.displacement)
    ours = [bounds.touched_slices(r[0], g[0], cfg.align_corners, cfg.displacement)
            for g in ldims]
    assert ours == theirs
    decoder = [net.fc0.weight.shape[1]] + [w.shape[0] for w, _ in net.mlp]
    work = bounds.sweep_work(chans, ldims, r, decoder, cfg.align_corners, cfg.displacement)
    ms_theirs, what_theirs = cs.sweep_bound(net, levels, r, r[0], 0, torch.bfloat16)
    ms_ours, what_ours = bounds.sweep_bound_ms(work)
    assert what_ours == what_theirs
    assert ms_ours == pytest.approx(ms_theirs, rel=1e-12)


def test_full_lattice_bound_is_the_records():
    """At the served size, r=2, the bound is the recorded 20.753 ms."""
    stages = [[16], [32, 32], [64, 64], [128, 128], [128, 128]]
    dims = (139, 104, 112)
    r = tuple(2 * d for d in dims)
    work = bounds.sweep_work([1, 16, 32, 64, 128, 128], bounds.level_dims(dims, len(stages)),
                             r, [2583, 256, 256, 256, 1], False, 0.0722)
    ms, what = bounds.sweep_bound_ms(work)
    assert what == "operations"
    assert ms == pytest.approx(20.753, abs=5e-4)
