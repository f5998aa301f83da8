"""Driver of gslam_tpu_torch.tracking.track.track_frame, the frontend's
per-frame entry point, in a closed loop: each frame is tracked from the
previous frame's tracked pose and exposure, as a live frontend takes the
next frame.

Set-up makes the configuration's map and the traffic's camera path from
the seed, renders every frame of the path with the plain reference, builds
the program's map from the same tensors and warms the tracker's shapes up
on one frame with a cut budget. A unit is one frame; frames are walked
forth and back along the path, so the window never runs out of them.

The check, after the window, judges what each frame's track_frame call
returned:
  * loss_gap: on a sample of frames drawn from the seed (with the traced
    frames and the frame with the most evaluations), |loss - reference| /
    reference, where the reference evaluates the tracking objective at the
    returned pose and exposure with the tile lists binned where the
    program binned them (the full-resolution level's base pose);
  * grad_gap, grad_vec_gap: on the same frames, the first gradient the
    full-resolution level's optimizer got, at the level's base pose and
    incoming exposure, against the reference's autograd gradient of the
    objective there (Gauss-Newton: J^T r of its first linearization,
    against half the gradient with beta held, as its weights hold it);
    by leaf (rotation, translation, exposure), the gap of their norms and
    the norm of their difference, each over the larger of the leaf's and
    the median leaf's reference norm, the worst leaf and frame;
  * trans_err_m, rot_err_rad: over every frame of the window, the
    distance of the returned camera from the frame's true pose and the
    angle between them.
A frame counts as failed where the tracker's guard rejected it or its
output is not finite.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

from benchmark.metrics import roofline
from benchmark.reference import splats
from benchmark.traffic import generate

TRACK_MODULE = "gslam_tpu_torch.tracking.track"
LEVEL_IMPLS = ("track_frame_impl", "track_frame_gn_impl")  # what a pyramid level calls
OPTIMIZER = "warmup_lbfgs_impl"  # the igs level's optimizer, as the track module calls it
GRAD_LEAVES = {"rot6": slice(0, 6), "t": slice(6, 9), "exposure": slice(9, 11)}


def grad_gaps(prog: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(gap of norms, gap of vectors) between two gradients of the
    tracker's variables, each the worst leaf's, over the larger of the
    leaf's and the median leaf's reference norm: |norm(prog) - norm(ref)|
    and norm(prog - ref), which holds the direction too. A leaf far below
    the median (the exposure's, where the incoming exposure already fits)
    is measured on the median's scale, where its rounding is no error."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    leaves = [sl for sl in GRAD_LEAVES.values() if sl.start < ref.numel()]
    norms = [float(torch.linalg.norm(ref[sl])) for sl in leaves]
    median = sorted(norms)[len(norms) // 2]
    scale = [max(r, median, 1e-30) for r in norms]
    gap = max(abs(float(torch.linalg.norm(prog[sl])) - r) / d
              for sl, r, d in zip(leaves, norms, scale))
    vec = max(float(torch.linalg.norm(prog[sl] - ref[sl])) / d for sl, d in zip(leaves, scale))
    return gap, vec


class Driver:
    sync_each_unit = True

    def __init__(self, run):
        self.run, self.cfg, self.tr, self.dev = run, run.config, run.traffic, run.device
        self.control = False  # True: the TF32 reference takes the program's place
        self.ranges = False
        self.saved = []  # (owner, attribute, original) of every wrapped call
        self.first_grad = None

    # ------------------------------------------------------------ set-up

    def setup(self):
        from gslam_tpu_torch.mapping.gaussians import GaussianMap
        from gslam_tpu_torch.ops.rasterize import RenderConfig
        from gslam_tpu_torch.tracking.track import TrackingConfig

        cfg, tr, dev, seed = self.cfg, self.tr, self.dev, self.run.seed
        self.w, self.h = cfg["camera"]["width"], cfg["camera"]["height"]
        self.spec = splats.RenderSpec(**cfg["render"])
        self.K = generate.intrinsics(cfg["camera"], dev)
        self.fields = generate.make_map(cfg, seed, dev)
        self.gt = generate.pose_chain(seed, int(tr["frames"]), float(tr["motion_sigma"]))
        self.images = generate.render_views(self.fields, self.gt, self.K, cfg, self.spec)

        self.run.program_start()
        tracking = dict(cfg["tracking"], **tr.get("tracking", {}))
        tracking["pyramid_evals"] = tuple(tracking["pyramid_evals"])
        self.tcfg = TrackingConfig(**tracking, render=RenderConfig(**cfg["render"]))
        n = self.fields["means"].shape[0]
        self.gmap = GaussianMap(ages=torch.zeros(n, dtype=torch.int32, device=dev),
                                **self.fields)
        self._wrap_levels()
        self.prior = torch.eye(4, device=dev)
        self.exposure = torch.zeros(2, device=dev)
        warm = dataclasses.replace(self.tcfg, **tr["warmup_tracking"])
        self._track(0, warm)
        self.prior = torch.eye(4, device=dev)
        self.exposure = torch.zeros(2, device=dev)
        self.records = []

    def _wrap_levels(self):
        """Record each pyramid level's call (the pose its tile lists are
        binned at, its incoming exposure, size and intrinsics, its
        evaluations, the first gradient its optimizer got, the pose and
        loss it returns); with ranges on, inside a profiler range."""
        mod = importlib.import_module(TRACK_MODULE)
        for name in LEVEL_IMPLS:
            orig = getattr(mod, name)

            def level(*args, _orig=orig, _name=name):
                rec = {"impl": _name, "base": args[1], "exposure0": args[2], "K": args[4],
                       "width": args[5], "height": args[6], "cfg": args[7]}
                self.first_grad = None
                if self.ranges:
                    from torch.profiler import record_function

                    with record_function("track_level"):
                        r = _orig(*args)
                else:
                    r = _orig(*args)
                rec.update(n_evals=int(r.n_evals), pose=r.pose, loss=r.loss,
                           grad=self.first_grad)
                self.levels.append(rec)
                return r

            self._wrap(mod, name, level)

        def keep(g):
            if self.first_grad is None:
                self.first_grad = g.detach().clone()

        def optimizer(loss_fn, *args, _orig=getattr(mod, OPTIMIZER), **kw):
            def loss(p):
                if self.first_grad is not None or not p.requires_grad:
                    return loss_fn(p)
                q = p.clone()  # the gradient reaching the optimizer's variables
                q.register_hook(keep)
                return loss_fn(q)

            return _orig(loss, *args, **kw)

        self._wrap(mod, OPTIMIZER, optimizer)
        problem = mod.GaussNewtonProblem

        def normal_equations(prob, x, _orig=problem.normal_equations):
            JtJ, Jtr = _orig(prob, x)
            keep(Jtr)
            return JtJ, Jtr

        self._wrap(problem, "normal_equations", normal_equations)

    def _wrap(self, owner, name, fn):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def _track(self, i, tcfg):
        from gslam_tpu_torch.tracking.track import track_frame

        self.levels = []
        r = track_frame(self.gmap, self.prior, self.exposure, self.images[i], self.K, self.w,
                        self.h, tcfg, device=self.dev)
        self.prior, self.exposure = r.pose, r.exposure
        return r

    # ------------------------------------------------------------ window

    def unit(self, k):
        i = generate.walk(k, len(self.images))
        prior = self.prior
        r = self._track(i, self.tcfg)
        self.records.append({"frame": i, "prior": prior, "pose": r.pose, "exposure": r.exposure,
                             "loss": r.loss, "n_evals": int(r.n_evals),
                             "rejected": bool(r.rejected), "levels": self.levels})

    def install_ranges(self):
        self.ranges = True

    def remove_ranges(self):
        self.ranges = False

    def close_window(self):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)
        self.saved = []
        del self.gmap

    # ------------------------------------------------------------- check

    def _loss(self, rec, tf32):
        """The reference's tracking objective at the frame's returned pose,
        on the full-resolution level's tile lists; and its Render."""
        lvl = rec["levels"][-1]
        rule = "core" if (self.tcfg.method != "gn" and self.tcfg.fused) else "visible"
        with torch.no_grad(), splats.precision(tf32):
            loss, out = splats.tracking_loss(
                self.fields, self.images[rec["frame"]], lvl["base"], rec["pose"],
                rec["exposure"], self.K, self.w, self.h, self.spec,
                self.tcfg.bin_radius_margin, rule)
        return float(loss), out

    def _gradient(self, rec, tf32):
        """The reference's gradient where the full-resolution level's
        optimizer took its first one (Gauss-Newton: half of it, beta
        held, which is its J^T r)."""
        lvl = rec["levels"][-1]
        gn = lvl["impl"] == "track_frame_gn_impl"
        rule = "core" if (not gn and self.tcfg.fused) else "visible"
        with splats.precision(tf32):
            g = splats.tracking_gradient(
                self.fields, self.images[rec["frame"]], lvl["base"], lvl["exposure0"], self.K,
                self.w, self.h, self.spec, self.tcfg.bin_radius_margin, rule,
                self.tcfg.learn_exposure, fixed_beta=gn)
        return 0.5 * g if gn else g

    def check(self, n_traced):
        recs = self.records
        rng = np.random.default_rng([int(self.run.seed), 4])
        n = min(int(self.tr["check_frames"]), len(recs))
        chosen = set(range(min(n_traced, len(recs))))
        chosen.add(int(np.argmax([r["n_evals"] for r in recs])))
        chosen |= {int(j) for j in rng.choice(len(recs), size=n, replace=False)}
        gaps, grad, grad_vec = [], [], []
        for j in sorted(chosen):
            ref, _ = self._loss(recs[j], False)
            prog = self._loss(recs[j], True)[0] if self.control else float(recs[j]["loss"])
            gaps.append(abs(prog - ref) / max(ref, 1e-30))
            ref_g = self._gradient(recs[j], False)
            prog_g = (self._gradient(recs[j], True) if self.control
                      else recs[j]["levels"][-1]["grad"])
            g_gap, v_gap = grad_gaps(prog_g, ref_g)
            self.run.log(f"frame {recs[j]['frame']}: first gradient {prog_g.tolist()!r} "
                         f"against {ref_g.tolist()!r}")
            grad.append(g_gap)
            grad_vec.append(v_gap)
        trans, rot = [], []
        failed = 0
        for r in recs:
            t_err, r_err = splats.pose_errors(r["pose"], torch.as_tensor(self.gt[r["frame"]]))
            trans.append(t_err)
            rot.append(r_err)
            if r["rejected"] or not (math.isfinite(float(r["loss"]))
                                     and bool(torch.isfinite(r["pose"]).all())):
                failed += 1
        self._work(recs[:n_traced])
        return {"loss_gap": max(gaps), "grad_gap": max(grad), "grad_vec_gap": max(grad_vec),
                "trans_err_m": max(trans),
                "rot_err_rad": max(rot)}, failed

    def _work(self, traced):
        """Operations and bytes of the traced frames' render passes, counted
        by the reference on each level's inputs: lists binned at the
        level's base pose, the alpha test at the pose it returned."""
        fwd, bwd, ops, evals = [], [], 0.0, 0
        p = 11 if self.tcfg.learn_exposure else 9
        for rec in traced:
            evals += rec["n_evals"]
            for lvl in rec["levels"]:
                spec = splats.RenderSpec(**dataclasses.asdict(lvl["cfg"].render))
                fields = self.fields
                w, h = lvl["width"], lvl["height"]
                with torch.no_grad(), splats.precision(False):
                    p0 = splats.project(fields, lvl["base"], lvl["K"], w, h, spec)
                    bins = splats.bin_tiles(p0.means2d, p0.radii * self.tcfg.bin_radius_margin,
                                            p0.depths, p0.valid, w, h, spec)
                    out = splats.render(fields, lvl["pose"], lvl["K"], w, h, spec, bins=bins)
                T, M = bins.ids.shape
                P = spec.tile_size**2
                f_ops, f_bytes = roofline.blend_fwd_work(T, M, P, out.pairs, out.ok_pairs)
                b_ops, b_bytes = roofline.blend_bwd_work(T, M, P, out.pairs, out.ok_pairs)
                n_proj = int(torch.unique(bins.ids[bins.mask]).numel())
                if lvl["impl"] == "track_frame_gn_impl":
                    # 1 + 2 per LM iteration render passes; an iteration's
                    # linearization is a primal pass and p tangent passes,
                    # each counted as one forward pass
                    iters = (lvl["n_evals"] - 1) // 2
                    passes = 1 + iters * (p + 2)
                    ops += passes * (f_ops + n_proj * roofline.PROJ_OPS_FWD)
                else:
                    k = lvl["n_evals"]
                    fwd += [(f_ops, f_bytes)] * k
                    bwd += [(b_ops, b_bytes)] * k
                    ops += k * (f_ops + b_ops
                                + n_proj * (roofline.PROJ_OPS_FWD + roofline.PROJ_OPS_BWD))
        self.work_counts = {"units": len(traced), "evals": evals, "blend_fwd": fwd,
                            "blend_bwd": bwd, "ops": ops}

    def work(self):
        return self.work_counts

    def counters(self):
        return {"evals": [r["n_evals"] for r in self.records]}
