"""Driver of gslam_tpu_torch.mapping.backend_ops.mapping_step, the
backend's map-optimization step, run back to back on one keyframe window.

Set-up makes the configuration's map from the seed, renders the traffic's
keyframes from it with the plain reference, perturbs the map's colour
logits (the state mapping starts from), builds the program's map, Adam
state, keyframe store and pose Adam from those tensors, and runs the
check's first steps through mapping_step itself, which also warms up every
shape; the window then continues from that same state. A unit is one
step; the host never waits for the card between steps beyond what the step
itself waits for.

The check follows the rule for training: the reference runs the same
first steps from the same start, and the numbers compared are
  * loss_gap: each step's total loss, |program - reference| / reference,
    the worst step;
  * grad_gap: each leaf's first gradient as Adam got it (its first moment
    after step 1 over 1 - beta1), the gap between the program's norm and
    the reference's over the larger of the reference's norm of that leaf
    and of the median leaf, the worst leaf;
  * change_gap: each leaf's change from the start after the last check
    step, the same gap, over the leaves whose reference gradient is above
    a thousandth of the median leaf's.
Leaves: the six splat fields and the window's pose deltas (rotation,
translation). A window step whose loss is not finite counts as failed.
"""

from __future__ import annotations

import gc
import math

import torch

from benchmark.metrics import roofline
from benchmark.reference import splats
from benchmark.traffic import generate

LEAVES = splats.TRAINABLE + ("pose_rot6", "pose_t")
MAP_SPEC_KEYS = ("ssim_weight", "isotropic_weight", "depth_tv_weight", "pose_lr",
                 "opacity_decay")


def _gap(prog: dict, ref: dict, leaves) -> float:
    median = sorted(ref.values())[len(ref) // 2]
    return max(abs(prog[f] - ref[f]) / max(ref[f], median, 1e-30) for f in leaves)


class Driver:
    sync_each_unit = False

    def __init__(self, run):
        self.run, self.cfg, self.tr, self.dev = run, run.config, run.traffic, run.device
        self.control = False

    def setup(self):
        from gslam_tpu_torch.mapping.backend_ops import MapConfig, init_pose_adam
        from gslam_tpu_torch.mapping.gaussians import GaussianMap
        from gslam_tpu_torch.mapping.keyframes import add_keyframe, empty_keyframes
        from gslam_tpu_torch.mapping.optimizer import init_adam
        from gslam_tpu_torch.ops.rasterize import RenderConfig

        cfg, tr, dev, seed = self.cfg, self.tr, self.dev, self.run.seed
        self.w, self.h = cfg["camera"]["width"], cfg["camera"]["height"]
        self.spec = splats.RenderSpec(**cfg["render"])
        self.K = generate.intrinsics(cfg["camera"], dev)
        fields = generate.make_map(cfg, seed, dev)
        n_kf = int(tr["keyframes"])
        poses = torch.as_tensor(generate.keyframe_poses(n_kf, float(tr["spacing_m"])),
                                dtype=torch.float32, device=dev)
        self.images = generate.render_views(fields, poses.cpu().numpy(), self.K, cfg, self.spec)
        self.fields0 = generate.perturb_colors(fields, seed, float(tr["color_noise"]))
        del fields
        window = int(cfg["mapping"]["window_size"])
        first = int(tr["window_first_slot"])
        self.slots = torch.arange(first, first + window, device=dev)
        self.poses = poses

        self.run.program_start()
        n = self.fields0["means"].shape[0]
        gmap = GaussianMap(ages=torch.zeros(n, dtype=torch.int32, device=dev), **self.fields0)
        kf = empty_keyframes(int(tr["store"]), self.h, self.w, device=dev)
        for s in range(n_kf):
            kf = add_keyframe(kf, s, self.images[s], poses[s], torch.zeros(2), s)
        mapping = dict(cfg["mapping"], background=tuple(cfg["mapping"]["background"]))
        self.mcfg = MapConfig(**mapping, render=RenderConfig(**cfg["render"]))
        self.wmask = torch.ones(window, dtype=torch.bool, device=dev)
        self.state = [gmap, init_adam(gmap), kf, init_pose_adam(int(tr["store"]), device=dev)]
        self.check_losses = []
        for s in range(int(tr["check_steps"])):
            aux = self._step()
            self.check_losses.append(aux.total_loss)
            if s == 0:
                opt, pose_opt = self.state[1], self.state[3]
                self.first_mu = dict(opt.mu, pose=pose_opt.mu[self.slots])
        g, _, kf, _ = self.state
        self.after = dict({f: getattr(g, f) for f in splats.TRAINABLE},
                          pose_rot6=kf.d_rot6[self.slots], pose_t=kf.d_t[self.slots])
        self.window_losses = []

    def _step(self):
        from gslam_tpu_torch.mapping.backend_ops import mapping_step

        g, o, kf, p, aux = mapping_step(*self.state, self.slots, self.wmask, self.K, self.w,
                                        self.h, self.mcfg)
        self.state = [g, o, kf, p]
        return aux

    def unit(self, k):
        self.window_losses.append(self._step().total_loss)

    def install_ranges(self):
        from gslam_tpu_torch.ops import rasterize
        from torch.profiler import record_function

        self.saved_bin = rasterize._bin_cameras

        def binning(*args, **kw):
            with record_function("binning"):
                return self.saved_bin(*args, **kw)

        rasterize._bin_cameras = binning

    def remove_ranges(self):
        from gslam_tpu_torch.ops import rasterize

        rasterize._bin_cameras = self.saved_bin

    def close_window(self):
        self.window_losses = [float(x) for x in self.window_losses]
        self.check_losses = [float(x) for x in self.check_losses]
        del self.state
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def _reference(self, tf32: bool):
        """The reference's first steps from the same start: losses, first
        gradient norms by leaf, change norms by leaf, per-camera work."""
        mspec = splats.MapSpec(**{k: self.cfg["mapping"][k] for k in MAP_SPEC_KEYS})
        state = splats.init_map_state(self.fields0, len(self.slots))
        exposures = torch.zeros((len(self.slots), 2), device=self.dev)
        losses, g1, work = [], None, None
        with splats.precision(tf32):
            for s in range(int(self.tr["check_steps"])):
                state, loss, grads, work = splats.mapping_step(
                    state, self.images[self.slots], self.poses[self.slots], exposures, self.K,
                    self.w, self.h, self.spec, mspec, self.cfg["adam_lrs"])
                losses.append(loss)
                if s == 0:
                    g1 = {f: float(torch.linalg.norm(grads[f])) for f in LEAVES}
        change = {f: float(torch.linalg.norm(state.fields[f] - self.fields0[f]))
                  for f in splats.TRAINABLE}
        change["pose_rot6"] = float(torch.linalg.norm(state.pose_vec[:, :6]))
        change["pose_t"] = float(torch.linalg.norm(state.pose_vec[:, 6:]))
        return losses, g1, change, work

    def check(self, n_traced):
        ref_loss, ref_g1, ref_change, work = self._reference(False)
        if self.control:
            prog_loss, prog_g1, prog_change, _ = self._reference(True)
        else:
            prog_loss = self.check_losses
            mu = self.first_mu
            prog_g1 = {f: float(torch.linalg.norm(mu[f])) / 0.1 for f in splats.TRAINABLE}
            prog_g1["pose_rot6"] = float(torch.linalg.norm(mu["pose"][:, :6])) / 0.1
            prog_g1["pose_t"] = float(torch.linalg.norm(mu["pose"][:, 6:])) / 0.1
            after = self.after
            prog_change = {f: float(torch.linalg.norm(after[f] - self.fields0[f]))
                           for f in splats.TRAINABLE}
            prog_change["pose_rot6"] = float(torch.linalg.norm(after["pose_rot6"]))
            prog_change["pose_t"] = float(torch.linalg.norm(after["pose_t"]))
        for f in LEAVES:
            self.run.log(f"leaf {f}: first gradient {prog_g1[f]!r} against {ref_g1[f]!r}, "
                         f"change {prog_change[f]!r} against {ref_change[f]!r}")
        median_g = sorted(ref_g1.values())[len(ref_g1) // 2]
        moved = [f for f in LEAVES if ref_g1[f] >= 1e-3 * median_g]
        numbers = {
            "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog_loss, ref_loss)),
            "grad_gap": _gap(prog_g1, ref_g1, LEAVES),
            "change_gap": _gap(prog_change, {f: ref_change[f] for f in moved}, moved),
        }
        failed = sum(not math.isfinite(x) for x in self.window_losses + self.check_losses)
        self._work(work, n_traced)
        return numbers, failed

    def _work(self, per_camera, n_traced):
        """Operations and bytes of the traced steps, counted from the
        reference's last check step: per camera one forward and one
        backward blend, and the projection of its visible splats."""
        tiles_x = -(-self.w // self.spec.tile_size)
        tiles_y = -(-self.h // self.spec.tile_size)
        T, M, P = tiles_x * tiles_y, self.spec.tile_capacity, self.spec.tile_size**2
        fwd, bwd, ops = [], [], 0.0
        for pairs, ok, n_proj in per_camera:
            f = roofline.blend_fwd_work(T, M, P, pairs, ok)
            b = roofline.blend_bwd_work(T, M, P, pairs, ok)
            fwd.append(f)
            bwd.append(b)
            ops += f[0] + b[0] + n_proj * (roofline.PROJ_OPS_FWD + roofline.PROJ_OPS_BWD)
        self.work_counts = {"units": n_traced, "blend_fwd": fwd * n_traced,
                            "blend_bwd": bwd * n_traced, "ops": ops * n_traced}

    def work(self):
        return self.work_counts

    def counters(self):
        return {}
