"""End-to-end training traffic: the port's SceneNetTrainer stepping through
its own loader over a tree of rooms rendered from the seed, as its fit()
loop does, with no validation in the window.

Set-up writes the tree, builds the trainer and its state with the seeded
weights, and runs the first epoch's steps through the window's own call and
feed (the loader's decode cache filled, cuDNN's first steps taken); the
first three are compared with the reference from the seeded weights.  In
the window, where every batch comes from the decode cache, two steps are
compared: one drawn from the seed among the window's first SAMPLE_SPAN,
and the last.  The program's state (parameters, buffers, Adam's moments)
is copied on the device before each and after the first, and after the
window the reference takes one step from that copy, on the batch that it
works out itself, as the program took it.  Traffic parameters:
scenes, samples (supervision points per sigma a room), batch_size,
num_points, subsample_points, precision, fused_query, flip_aug,
num_workers, warmup (steps, at least 4)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen import scenes
from benchmark.frozen.weights import seeded_state_dict
from benchmark.reference import compare, scene
from benchmark.reference import train as ref_train
from benchmark.reference.lowp import EXACT, TRAIN_CONTROL

SPANS = ("loader_wait", "step")
COMPARED_STEPS = 3
#: the window's compared step besides its last is drawn among its first SAMPLE_SPAN
SAMPLE_SPAN = 4
#: the state is copied before every step that starts within TAIL times the
#: longest step so far of the window's close, so that its last step is among them
TAIL = 3.0


class Driver:
    spans = SPANS

    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.steps = 0
        self.longest = 0.0
        self.replays = []  # the window's compared steps: {"step", "pre", "loss", "post"}
        self.tail = None   # the latest step copied near the window's close

    def setup(self):
        from sv3d_tpu_torch.data.loader import DataLoader
        from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

        run, cfg, t = self.run, self.run.cfg, self.t
        if t["warmup"] < COMPARED_STEPS + 1:
            raise ValueError(f"warmup must run the {COMPARED_STEPS} compared steps and one more")
        self.prog_seed = run.seed & 0x7FFFFFFF  # the port's Config takes a 31-bit seed
        scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
        self.cam = (scenes.FOCAL, scenes.CX, scenes.CY, scale, shift)
        root = run.tmp / "data"
        self.rooms = scenes.write_train_tree(run.seed, t["scenes"], root, "bench", scale, shift,
                                             cfg["dims"], t["samples"])
        config = run.arch.port_config(
            cfg, datasetdir=str(root), splitsdir="bench", num_points=t["num_points"],
            batch_size=t["batch_size"], subsample_points=t["subsample_points"],
            fused_query=t["fused_query"], flip_aug=t["flip_aug"], num_workers=t["num_workers"],
            seed=self.prog_seed, sanity_steps=0, precision=t["precision"])
        self.trainer = SceneNetTrainer(config, device=run.device, experiment_dir=run.tmp / "exp")
        self.state = self.trainer.build_state()
        model = self.state.model
        run.arch.check_widths(model, cfg)
        self.sd0 = seeded_state_dict(model.state_dict(), cfg.get("sigma"), run.seed,
                                     run.device)
        model.load_state_dict(self.sd0)
        loader = DataLoader(self.trainer.train_dataset(), batch_size=config.batch_size,
                            shuffle=True, drop_last=True, num_workers=config.num_workers,
                            seed=config.seed)
        self.feed = self._epochs(loader)
        self.names = {p: k for k, p in model.named_parameters()}
        self.prog = self._first_steps(model)
        if run.trace:
            run.extra.update(self._work(model))
        self.warmup = t["warmup"]
        rng = np.random.default_rng(np.random.SeedSequence([run.seed % 2**63, 2]))
        self.sample_at = int(rng.integers(0, SAMPLE_SPAN))
        self.steps = 0

    @staticmethod
    def _epochs(loader):
        while True:
            yield from loader

    def _first_steps(self, model) -> dict:
        """The warm-up steps through the window's call and feed, with the
        program's readings of the compared ones: losses, step 1's gradient
        norms as Adam holds them (exp_avg / (1 - beta1)), and the parameters'
        change after the last compared step."""
        names = self.names
        opt = self.state.optimizer
        losses, grads, change = [], {}, {}
        for i in range(self.t["warmup"] - (1 if self.run.trace else 0)):
            metrics = self.trainer.train_step(self.state, next(self.feed), self.trainer.generator)
            if i < COMPARED_STEPS:
                losses.append(float(metrics["train_loss"]))
            if i == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                grads = {k: float(opt.state[p]["exp_avg"].norm()) / (1.0 - beta1)
                         if "exp_avg" in opt.state.get(p, {}) else 0.0
                         for p, k in names.items()}
            if i == COMPARED_STEPS - 1:
                change = {k: float((p.detach() - self.sd0[k]).norm()) for p, k in names.items()}
        return {"losses": losses, "grad_norms": grads, "change_norms": change}

    def _work(self, model) -> dict:
        """The last warm-up step under FlopCounterMode (a traced run only):
        the step's operations beside the architecture's that it cannot see."""
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            self.trainer.train_step(self.state, next(self.feed), self.trainer.generator)
        return {"step_flops": float(fc.get_total_flops())
                + self.run.arch.uncounted_flops(self.run.cfg, self.t)}

    def _copy(self) -> dict:
        """The program's training state, copied on the device: parameters and
        buffers by name, Adam's moments and step count by parameter name."""
        opt = self.state.optimizer
        return {"sd": {k: v.detach().clone() for k, v in self.state.model.state_dict().items()},
                "adam": {k: {n: v.detach().clone() for n, v in opt.state[p].items()}
                         for p, k in self.names.items() if p in opt.state}}

    def _train(self, batch, i: int, end: float):
        """One step of the program; its state copied before it if it is a
        compared step or near the window's close, and after it if it is the
        drawn one."""
        run = self.run
        t0 = run.clock()
        near_end = end - t0 < TAIL * self.longest
        rec = {"step": self.warmup + i, "pre": self._copy()} \
            if i == self.sample_at or near_end else None
        metrics = self.trainer.train_step(self.state, batch, self.trainer.generator)
        if rec is not None:
            rec["loss"] = metrics["train_loss"]
            if i == self.sample_at:
                rec["post"] = self._copy()
                self.replays.append(rec)
            else:
                self.tail = rec

    def step(self, i: int):
        span = self.run.span
        t0 = self.run.clock()
        with span("loader_wait"):
            batch = next(self.feed)
        with span("step"):
            self._train(batch, i, self.run.window_end)
            if self.run.trace and self.run.device.type == "cuda":
                torch.cuda.synchronize()
        self.steps += 1
        self.longest = max(self.longest, self.run.clock() - t0)

    def finish(self):
        torch.cuda.synchronize() if self.run.device.type == "cuda" else None

    def counts(self) -> dict:
        return {"steps": self.steps,
                "samples": self.steps * self.t["batch_size"]}

    def end_to_end(self, window_s: float) -> dict:
        return {"train_samples_per_s": (self.steps * self.t["batch_size"] / window_s,
                                        "samples/s")}

    @staticmethod
    def compared(arch) -> tuple:
        """The names of the numbers that numbers() gives for an architecture."""
        return compare.train_names(arch.SCALED_LEAF)

    def free(self):
        """After the window: the copy of the state after its last step.  Where
        the copies near the close missed the last step (a stall of more than
        TAIL steps), one more step through the same call and feed, copied,
        stands in for it."""
        last = self.warmup + self.steps - 1
        if last not in {r["step"] for r in self.replays}:
            if self.tail is None or self.tail["step"] != last:
                self.tail = None
                self._train(next(self.feed), self.steps, float("-inf"))
            if self.tail is not None:
                self.tail["post"] = self._copy()
                self.replays.append(self.tail)
        self.replays = [{**r, "loss": float(r["loss"])} for r in self.replays]
        self.sd0 = {k: v.detach().cpu() for k, v in self.sd0.items()}
        del self.trainer, self.state, self.feed

    def numbers(self, control: str | None) -> dict:
        """Gaps of the compared steps, the warm-up's from the seeded weights
        and the window's each from the program's copy before it: the
        program's (control None), the training control's (TF32), or a
        fault's planted in the reference put in the program's place
        ("half_batch": the mean over half of each batch's rows; "sigma_lr",
        for an architecture with a scaled leaf: that leaf at the base
        learning rate)."""
        t, dev, cfg = self.t, self.run.device, self.run.cfg
        scaled = self.run.arch.SCALED_LEAF
        faults = {"train": {"prec": TRAIN_CONTROL},
                  "half_batch": {"rows": slice(0, t["batch_size"] // 2)}}
        if scaled is not None:
            faults["sigma_lr"] = {"project_lr_scale": 1.0}
        if control is not None and control not in faults:
            raise ValueError(f"no control {control!r} for training the architecture "
                             f"{cfg['arch']!r}")

        def batch(step):
            return ref_train.batch_at(self.rooms, self.prog_seed, t["batch_size"],
                                      t["num_points"], scenes.FOCAL, step)

        hb = [batch(g) for g in range(COMPARED_STEPS)]
        ref = ref_train.run(self.sd0, cfg, hb, self.cam, dev, EXACT)
        prog = self.prog if control is None else \
            ref_train.run(self.sd0, cfg, hb, self.cam, dev, **faults[control])
        window = []
        for r in self.replays:
            b, pre = batch(r["step"]), r["pre"]
            ref_w = ref_train.step_from(pre["sd"], pre["adam"], cfg, b, self.cam, dev, EXACT)
            if control is None:
                post = r["post"]["sd"]
                prog_w = {"loss": r["loss"],
                          "change_norms": {k: float((post[k] - pre["sd"][k]).norm())
                                           for k in ref_w["change_norms"]}}
            else:
                prog_w = ref_train.step_from(pre["sd"], pre["adam"], cfg, b, self.cam, dev,
                                             **faults[control])
            window.append((prog_w, ref_w))
        keep = compare.kept_leaves(ref["grad_norms"])
        self.detail = {"losses": [prog["losses"], ref["losses"]],
                       "leaf_gaps": {w: compare.leaf_gaps(prog[w], ref[w], keep)
                                     for w in ("grad_norms", "change_norms")},
                       "window": [{"step": r["step"], "losses": [p["loss"], q["loss"]],
                                   "worst_change_leaf": compare.leaf_gap(
                                       p["change_norms"], q["change_norms"],
                                       compare.kept_leaves(q["grad_norms"])),
                                   **({"sigma_change": [p["change_norms"][scaled],
                                                        q["change_norms"][scaled]]}
                                      if scaled is not None else {})}
                                  for r, (p, q) in zip(self.replays, window)]}
        return compare.train_numbers(prog, ref, window, scaled)
