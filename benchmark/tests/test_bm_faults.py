"""A run with the timed path broken underneath comes out not correct, once
for each fault that a cell can have (on one chip there is no exchange
between chips to leave out).  Each fault is planted in the port's timed
path at the CPU size; the number that it moves is held against the cell's
own limit, beside the same seed's sound run.  In training each fault also
starts only in the window, after the warm-up's compared steps, and two
more are planted: a wrong batch from the loader's decode cache, and sigma
at the base learning rate."""

import numpy as np
import pytest
import torch

from benchmark import run as bench

SEED = 2**31 + 77


def _run(spec):
    result, numbers, limits, _ = bench.run_cell(spec, SEED, 0.1, False, torch.device("cpu"))
    return result, numbers, limits


def _mesh_spec(tiny):
    return tiny("sv3d128.mesh_r1", pool=2, sample=2, warmup=1)


def test_mesh_sound_run_is_correct(tiny):
    result, numbers, limits = _run(_mesh_spec(tiny))
    assert result["correct"], (numbers, limits)


def test_mesh_answer_altered(tiny, monkeypatch):
    """The served field altered where it is produced: the uint8 pull of the
    sweep returns every value three steps up."""
    import sv3d_tpu_torch.inference.dense_grid as dg

    inner = dg._evaluate_u8

    def altered(*a, **kw):
        u8 = inner(*a, **kw)
        return np.minimum(u8.astype(np.int32) + 3, 255).astype(np.uint8)

    monkeypatch.setattr(dg, "_evaluate_u8", altered)
    result, numbers, limits = _run(_mesh_spec(tiny))
    assert not result["correct"]
    assert numbers["field_off"] > limits["field_off"]["limit"]


WARMUP = 4


def _after_warmup(fn, broken):
    """fn as it is for the warm-up's calls, broken from the window's first."""
    calls = [0]

    def call(*a, **kw):
        calls[0] += 1
        return (fn if calls[0] <= WARMUP else broken)(*a, **kw)

    return call


def _train_spec(tiny):
    return tiny("sv3d128.train_b4", scenes=8, samples=300, batch_size=2, num_points=32,
                warmup=WARMUP)


def _freeze(after: int):
    """build_optimizer whose step applies nothing after `after` steps."""
    import sv3d_tpu_torch.training.trainer_scene_net as tsn

    inner = tsn.build_optimizer

    def frozen(*a, **kw):
        opt = inner(*a, **kw)
        step = opt.step
        calls = [0]

        def maybe(closure=None):
            calls[0] += 1
            return step() if calls[0] <= after else None

        opt.step = maybe
        return opt

    return frozen


@pytest.mark.parametrize("after", [0, WARMUP], ids=["from_the_start", "in_the_window"])
def test_train_state_unchanged(tiny, monkeypatch, after):
    """A step that returns its state unchanged: the trainer's optimizer
    applies nothing, from the first step or from the window's first."""
    import sv3d_tpu_torch.training.trainer_scene_net as tsn

    monkeypatch.setattr(tsn, "build_optimizer", _freeze(after))
    result, numbers, limits = _run(_train_spec(tiny))
    assert not result["correct"]
    name = "change_gap" if after == 0 else "window_change_gap"
    assert numbers[name] > 0.9  # reads 1 but for leaves under the median's norm
    assert numbers[name] > limits[name]["limit"]


@pytest.mark.parametrize("after", [0, WARMUP], ids=["from_the_start", "in_the_window"])
def test_train_half_batch(tiny, monkeypatch, after):
    """Half of each batch left out, the mean taken over the rest, from the
    first step or from the window's first."""
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    inner = SceneNetTrainer.train_step

    def half(self, state, batch, generator):
        n = len(batch["points"]) // 2
        return inner(self, state, {k: v[:n] for k, v in batch.items()}, generator)

    sound, sound_numbers, limits = _run(_train_spec(tiny))
    monkeypatch.setattr(SceneNetTrainer, "train_step",
                        half if after == 0 else _after_warmup(inner, half))
    result, numbers, _ = _run(_train_spec(tiny))
    assert not result["correct"]
    name = "loss_gap" if after == 0 else "window_loss_gap"
    assert numbers[name] > limits[name]["limit"] >= sound_numbers[name]


def test_train_wrong_batch_from_the_cache(tiny, monkeypatch):
    """The loader serves another room's item once it reads from its decode
    cache (every epoch after the first): the window's batches are wrong."""
    from sv3d_tpu_torch.data.datasets import SceneNetDataset

    inner = SceneNetDataset.get

    def wrong(self, idx, epoch):
        return inner(self, (idx + 1) % len(self) if epoch > 0 else idx, epoch)

    monkeypatch.setattr(SceneNetDataset, "get", wrong)
    result, numbers, limits = _run(_train_spec(tiny))
    assert not result["correct"]
    assert numbers["loss_gap"] <= limits["loss_gap"]["limit"]  # the warm-up's are right
    assert numbers["window_loss_gap"] > limits["window_loss_gap"]["limit"]


def test_train_sigma_at_the_base_learning_rate(tiny, monkeypatch):
    """The projection's sigma trained at the base learning rate, not at
    project_lr_scale times it."""
    import functools

    import sv3d_tpu_torch.training.trainer_scene_net as tsn

    monkeypatch.setattr(tsn, "build_optimizer",
                        functools.partial(tsn.build_optimizer, project_lr_scale=1.0))
    result, numbers, limits = _run(_train_spec(tiny))
    assert not result["correct"]
    assert numbers["sigma_change_gap"] > limits["sigma_change_gap"]["limit"]
