"""Image -> mesh traffic: a closed loop of one client, as the serving CLI
(sv3d_tpu_torch/inference/predict.py::main) serves one image at a time.

A request loads one PNG of the pool, runs predict (depth, back-projection,
voxelization), then implicit_to_mesh (encode, dense sweep, the uint8 pull,
marching cubes, the OBJ write).  The pool holds the traffic's rooms rendered
from the seed, visited in an order drawn from the seed.

Traffic parameters: pool (rooms), inf_res, threshold, mesh_vertices (the
surface's size that the seeded weights are calibrated to), sample
(requests compared with the reference besides the slowest), warmup
(requests)."""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark.frozen import bounds, scenes
from benchmark.frozen.weights import seeded_state_dict
from benchmark.reference import compare, scene
from benchmark.reference.lowp import EXACT, SERVE_CONTROL

SPANS = ("load_png", "predict", "to_mesh", "meshing")


class Driver:
    spans = SPANS

    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.latencies = []
        self.kept = []       # reservoir of captured requests
        self.slowest = None  # the slowest request's capture
        self._last = None
        self.first_cycle = []  # vertices of the window's first pass over the pool

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from sv3d_tpu_torch.geometry.camera import parse_intrinsics
        from sv3d_tpu_torch.geometry.frustum import FrustumGrid
        from sv3d_tpu_torch.models.scene_net import SceneNet

        run, cfg = self.run, self.run.cfg
        self.pool = scenes.render_pool(run.seed, self.t["pool"], run.tmp / "pool")
        rng = np.random.default_rng(np.random.SeedSequence([run.seed % 2**63, 1]))
        self.order = rng.permutation(len(self.pool))
        self.pick = random.Random(run.seed)
        self.config = run.arch.port_config(cfg, inf_res=self.t["inf_res"])
        intr = parse_intrinsics(scenes.INTRINSICS_TEXT)
        frustum = FrustumGrid.create(intr, voxel_size=cfg["voxel_size"])
        self.model = SceneNet(self.config, intr, frustum, device=run.device)
        run.arch.check_widths(self.model, cfg)
        self.sd = seeded_state_dict(self.model.state_dict(), cfg["sigma"], run.seed, run.device)
        t0 = run.clock()
        self._calibrate()
        run.reference_setup_s += run.clock() - t0
        self.model.load_state_dict(self.sd)
        self.model.eval()
        self._hook()
        for i in range(self.t["warmup"]):
            self._request(self.pool[self.order[i % len(self.pool)]][0], keep=False)
        if run.trace:
            run.extra.update(self._work())
        self.latencies = []

    def _calibrate(self):
        """Give every seed served surfaces of the same size, lying as a
        trained model's do: empty space outside, a surface near the
        projected depth.  With seeded weights and zero biases, every lattice
        point that no feature reaches has logit 0, occupancy 0.5, on the
        level itself, and the surfaces' size depends on the seed.  So, on
        the reference's logits of every room of the pool on the served
        lattice, fc_out is turned if need be so that the band's upper tail
        is positive, and given the negative bias that puts the level where
        the rooms' edge crossings (the meshes' vertices) come near, on
        average, the traffic's mesh_vertices, and move least with the level.
        Runs before the program's first call; the peak memory it takes is
        forgotten, and its seconds are not set-up's (it runs the reference)."""
        cfg, dev = self.run.cfg, self.run.device
        scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
        r = tuple(x * self.t["inf_res"] for x in cfg["dims"])
        rooms = []
        with torch.no_grad():
            for _, image in self.pool:
                rgb = torch.as_tensor(image, device=dev).float()[None]
                d = scene.depth(self.sd, cfg, (rgb / 255.0 - 0.5) / 0.5, False)
                pts = scene.back_project(d, cfg, scenes.FOCAL, scenes.CX, scenes.CY, scale,
                                         shift)
                levels = scene.encode(self.sd, cfg, scene.voxelize(pts, self.sd, cfg), False)
                rooms.append(scene.lattice_logits(self.sd, cfg, levels, r))
                del d, pts, levels
            band = torch.cat([x[x != 0] for x in rooms])
            if band.numel() == 0:
                raise RuntimeError("calibration: no lattice point is reached by a feature")
            band = band[::max(1, band.numel() // 2**22)]  # quantile() takes under 2**24
            sign = 1.0 if float(band.quantile(0.99)) > 0 else -1.0
            upper = (sign * band)[sign * band > 0]
            mean_count = lambda t: sum(compare.edge_count(sign * x > t) for x in rooms) / len(rooms)
            want = self.t["mesh_vertices"]
            # levels from the band's lower quartile up: empty space (logit 0) and
            # the faint tails of the features stay clearly outside
            cands = upper.quantile(torch.linspace(0.25, 0.999, 100, device=dev)).tolist()
            counts = [mean_count(t) for t in cands]
            # a level on a plateau of logits makes the surface flip with rounding:
            # among the levels near the target, take the one whose count moves
            # least when the level moves by 2% of the band's spread
            step = 0.02 * (cands[75] - cands[25])  # 2% of the band's middle half
            near = [i for i, c in enumerate(counts) if abs(c - want) <= 0.15 * want] or \
                [min(range(len(cands)), key=lambda i: abs(counts[i] - want))]

            def cost(i):
                wobble = abs(mean_count(cands[i] + step) - mean_count(cands[i] - step))
                return abs(counts[i] - want) / want + wobble / max(counts[i], 1.0)

            level = cands[min(near, key=cost)]
            self.sd["ifnet.fc_out.weight"] *= sign
            self.sd["ifnet.fc_out.bias"].fill_(-level)
            self.run.extra["calibration"] = {"sign": sign, "level": level,
                                             "vertices": mean_count(level)}
        del rooms, band, upper
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def _hook(self):
        """Capture the uint8 field that implicit_to_mesh hands marching
        cubes, and time the meshing, by wrapping the port's function that
        implicit_to_mesh looks up at each call."""
        import sv3d_tpu_torch.utils.visualize as vis

        inner = vis.visualize_sdf_u8

        def visualize_sdf_u8(field_u8, path, level=0.5):
            with self.run.span("meshing"):
                out = inner(field_u8, path, level)
            self._last = field_u8
            return out

        vis.visualize_sdf_u8 = visualize_sdf_u8
        self.run.cleanups.append(lambda: setattr(vis, "visualize_sdf_u8", inner))

    def _work(self) -> dict:
        """Operations of one request, for mfu and the K2 roofline: the convs
        that FlopCounterMode sees in predict and encode, K1's points, K2's
        work from the lattice's geometry."""
        from torch.utils.flop_counter import FlopCounterMode

        from sv3d_tpu_torch.data.datasets import _load_normalized_rgb
        from sv3d_tpu_torch.inference.predict import predict

        cfg = self.run.cfg
        rgb = _load_normalized_rgb(self.pool[0][0], False, False, 256)
        with FlopCounterMode(display=False) as fc:
            vox, _ = predict(self.config, self.model, rgb=rgb)
            with torch.inference_mode():
                self.model.ifnet.encode(vox)
        r = tuple(d * self.t["inf_res"] for d in cfg["dims"])
        chans = [1] + [s[-1] for s in cfg["stages"]]
        work = bounds.sweep_work(chans, bounds.level_dims(cfg["dims"], len(cfg["stages"])), r,
                                 cfg["decoder"], cfg["align_corners"], cfg["displacement"])
        points = scenes.W * scenes.H
        return {"conv_flops": float(fc.get_total_flops()),
                "k1_flops": bounds.K1_FLOPS_PER_POINT * points, "k2_work": work}

    # -- the window -------------------------------------------------------------
    def _request(self, path, keep=True):
        from sv3d_tpu_torch.data.datasets import _load_normalized_rgb
        from sv3d_tpu_torch.inference.dense_grid import implicit_to_mesh
        from sv3d_tpu_torch.inference.predict import predict

        span, c = self.run.span, self.config
        self._last = None
        with span("load_png"):
            rgb = _load_normalized_rgb(path, False, c.resize_input, c.W)
        with span("predict"):
            vox, depth = predict(c, self.model, rgb=rgb)
        with span("to_mesh"):
            verts, _ = implicit_to_mesh(self.model.ifnet, vox, c.dims, self.t["threshold"],
                                        self.run.tmp / f"{path.stem}.obj",
                                        res_increase=c.inf_res)
        if self._last is None:
            raise RuntimeError("implicit_to_mesh did not mesh through "
                               "sv3d_tpu_torch.utils.visualize.visualize_sdf_u8: the "
                               "meshing span and the compared field are not captured")
        return vox, depth, verts

    def step(self, i: int):
        k = int(self.order[i % len(self.pool)])
        t0 = self.run.clock()
        vox, depth, verts = self._request(self.pool[k][0])
        lat = self.run.clock() - t0
        self.latencies.append(lat)
        capture = (k, depth, vox, self._last, verts, lat)
        if len(self.first_cycle) < len(self.pool):
            self.first_cycle.append(len(verts))
        # a reservoir sample of the requests, drawn from the seed, and the slowest
        n, size = len(self.latencies), self.t["sample"]
        if n <= size:
            self.kept.append(capture)
        else:
            j = self.pick.randrange(n)
            if j < size:
                self.kept[j] = capture
        if self.slowest is None or lat > self.slowest[-1]:
            self.slowest = capture

    def finish(self):
        torch.cuda.synchronize() if self.run.device.type == "cuda" else None

    def counts(self) -> dict:
        objs = list(self.run.tmp.glob("*.obj"))
        return {"requests": len(self.latencies),
                "mesh_vertices": [len(c[4]) for c in self.kept],
                "first_cycle_vertices": self.first_cycle,
                "calibration": self.run.extra.get("calibration"),
                "obj_bytes_mean": sum(p.stat().st_size for p in objs) / max(len(objs), 1)}

    def end_to_end(self, window_s: float) -> dict:
        lat = sorted(self.latencies)
        p90 = lat[max(0, -(-9 * len(lat) // 10) - 1)]  # nearest rank
        return {"mesh_s": (window_s / len(lat), "s"), "mesh_p90_s": (p90, "s")}

    @staticmethod
    def compared(arch) -> tuple:
        """The names of the numbers that numbers() gives."""
        return compare.MESH_NUMBERS

    def free(self):
        del self.model
        self.sample = [c for c in self.kept if c is not self.slowest] + [self.slowest]
        self.kept = self.slowest = None

    # -- correctness ---------------------------------------------------------------
    def numbers(self, control: str | None) -> dict:
        """The worst of each gap over the compared requests: the program's
        (control None), or the serving control's put in its place."""
        cfg, dev = self.run.cfg, self.run.device
        r = tuple(d * self.t["inf_res"] for d in cfg["dims"])
        scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
        cam = (scenes.FOCAL, scenes.CX, scenes.CY, scale, shift)
        worst = {}
        with torch.no_grad():
            for k, depth, vox, field_u8, verts, _ in self.sample:
                ref = self._reference(k, cam, r, EXACT)
                if control == "serve":
                    depth, vox, occ = self._reference(k, cam, r, SERVE_CONTROL)
                    field = (occ * 255.0 + 0.5).floor()
                    n_verts = compare.crossings(field)
                elif control is None:
                    field = torch.as_tensor(field_u8, device=dev)
                    depth = torch.as_tensor(depth, device=dev)[None]
                    vox = vox.to(dev)[..., 0]
                    n_verts = len(verts)
                else:
                    raise ValueError(f"no control {control!r} for serving")
                got = compare.mesh_numbers(depth, vox, field, n_verts, *ref)
                for name, v in got.items():
                    worst[name] = max(worst.get(name, 0.0), v)
        return worst

    def _reference(self, k, cam, r, prec):
        cfg = self.run.cfg
        f, cx, cy, scale, shift = cam
        rgb = torch.as_tensor(self.pool[k][1], device=self.run.device).float()[None]
        rgb = (rgb / 255.0 - 0.5) / 0.5
        d = scene.depth(self.sd, cfg, rgb, False, prec)
        vox = scene.voxelize(scene.back_project(d, cfg, f, cx, cy, scale, shift), self.sd, cfg,
                             prec)
        levels = scene.encode(self.sd, cfg, vox, False, prec)
        return d, vox, scene.lattice_occupancy(self.sd, cfg, levels, r, prec)
