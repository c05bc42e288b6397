"""Port parity: UNetMini / UNet and the depth helpers of sv3d_tpu_torch
against sv3d_tpu, eval mode, from converted weights.

Weights come from a flax init; biases, BatchNorm affine parameters and
running statistics are redrawn with numpy so eval-mode BatchNorm is not the
identity.  Conv sums run in another order in torch than in XLA: rtol/atol
1e-4 on the depth logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.models.unet import UNet as JUNet
from sv3d_tpu.models.unet import UNetMini as JUNetMini
from sv3d_tpu.models.unet import _upsample2x as j_upsample2x
from sv3d_tpu.models.unet import renormalize_depth as j_renorm
from sv3d_tpu.models.unet import resize_crop_depth as j_resize_crop
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.models.unet import (
    UNet,
    UNetMini,
    _upsample2x,
    renormalize_depth,
    resize_crop_depth,
)

torch.set_num_threads(1)


def randomized(variables, seed):
    """numpy copy of a flax tree with biases, BN scales and BN statistics
    redrawn."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k in ("bias", "mean") or k.endswith("_bias"):
                v = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif k in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            out[k] = v
        return out

    return walk(jax.tree_util.tree_map(np.asarray, dict(variables)))


def test_bilinear_upsample_matches_jax_resize_with_edges():
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(j_upsample2x(jnp.asarray(x)))
    got = _upsample2x(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)

    d = np.random.default_rng(1).uniform(0, 1, (1, 256, 256, 1)).astype(np.float32)
    np.testing.assert_allclose(
        resize_crop_depth(torch.tensor(d)).numpy(),
        np.asarray(j_resize_crop(jnp.asarray(d))), atol=1e-6,
    )
    np.testing.assert_allclose(
        renormalize_depth(torch.tensor(d), 0.2, 7.0).numpy(),
        np.asarray(j_renorm(jnp.asarray(d), 0.2, 7.0)), atol=1e-6,
    )


@pytest.mark.parametrize("cls,tcls,hw", [(JUNetMini, UNetMini, (240, 320)), (JUNet, UNet, (256, 256))])
def test_unet_eval_parity(cls, tcls, hw):
    x = np.random.default_rng(2).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)
    jm = cls(channels_out=1)
    variables = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 3)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))

    tm = tcls(channels_out=1)
    tm.load_state_dict(from_flax(variables))
    with torch.inference_mode():
        got = tm.eval()(torch.tensor(x)).numpy()
    assert got.shape == (1, *hw, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cls,tcls", [(JUNetMini, UNetMini)])
def test_train_mode_batch_stats_follow_flax(cls, tcls):
    """One train-mode forward: the outputs agree, and the running statistics
    the port's BatchNorm leaves equal flax's mutated batch_stats (momentum 0.9
    on the BIASED batch variance) to 1e-6; torch's own BatchNorm folds the
    unbiased variance in."""
    x = np.random.default_rng(4).uniform(-1, 1, (2, 48, 64, 3)).astype(np.float32)
    jm = cls(channels_out=1)
    variables = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 5)
    ref, mutated = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))

    tm = tcls(channels_out=1)
    tm.load_state_dict(from_flax(variables))
    tm.train()
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)
    want = from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])})
    state = tm.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 10
    for k in stats:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
