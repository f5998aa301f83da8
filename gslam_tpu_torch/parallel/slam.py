"""Multi-device SLAM: the full track -> keyframe -> insert -> map -> prune
loop with the splat buffer in depth bands.

Counterpart of gslam_tpu/parallel/slam.py, a host-driven loop over a mesh
with a 'gauss' axis (parallel/sharding.py): the buffer and its Adam moments
are split into D contiguous bands, band b on the b-th device along
'gauss', so map capacity grows with the devices.

  * Hot per-frame work, every tracking evaluation of the L-BFGS line search
    and every windowed mapping iteration, runs band by band: each band bins,
    projects and blends only its splats on its own device (the blend kernel
    pair once per band and camera on the card), its (rgb, alpha, depth,
    beta) layers are copied under autograd to the mesh's first device and
    composed there (`_compose_bands`). Splat gradients stay on their band;
    the pose and exposure gradients come back summed through the copies.
    The 11-vector of the tracker lives on the host, as in the single-device
    tracker.
  * Rare ops, keyframe insertion, gradient densification and the depth
    repartition, run on the JOINED buffer on the first device and are split
    back: the slots they pick are the single-device ones, as GSPMD's global
    scatters give in the JAX package. For the length of such an op the
    first device holds a full copy of the map and its moments.
  * The keyframe ring, the pose-graph visibility snapshots and the
    composites live on the first device; the adjacency on the host.

Band-order exactness: the buffer is kept permuted into ascending camera
depth at the latest tracked pose (`partition_by_depth`), so the band order
is the global depth order at that pose. The per-band tile lists hold D x
`tile_capacity` entries per tile in all: a tile that saturates on one
device renders more splats in bands. A test that holds a banded render to a
single-device one needs unsaturated lists.

One difference from the JAX loop (ROADMAP C-ref6): its per-frame
repartition at the motion prior permutes the buffer but not the pose
graph's visibility snapshots, whose columns then no longer name the splats
they were taken of. Here every repartition permutes them with the buffer.

Random draws follow runtime/fused.py: `key` is an int64 [2] CPU tensor and
every draw comes through `draws` (KeyDraws by default: a CPU generator per
key, its numbers copied to the device), split where the JAX loop splits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gslam_tpu_torch import to_device
from gslam_tpu_torch.core.transforms import PoseDelta, invert_se3, pose_matrix
from gslam_tpu_torch.eval.trajectory import ate_mean, ate_rmse, trajectory_positions
from gslam_tpu_torch.mapping import pruning
from gslam_tpu_torch.mapping.backend_ops import MapConfig, _set_rows
from gslam_tpu_torch.mapping.gaussians import (
    empty_map, gaussian_map_from_numpy, gaussian_map_to_numpy, masked_median,
)
from gslam_tpu_torch.mapping.insertion import (
    InsertionConfig, densify_by_gradients, insert_from_depthmap, insertion_masks,
)
from gslam_tpu_torch.mapping.optimizer import (
    adam_state_from_numpy, adam_state_to_numpy, init_adam,
)
from gslam_tpu_torch.ops.losses import (
    apply_exposure, mapping_photometric, masked_depth_l1, tracking_photometric,
)
from gslam_tpu_torch.ops.rasterize import compute_bins
from gslam_tpu_torch.ops.ssim import ssim_per_image
from gslam_tpu_torch.ops.track_fused import gather_tracking_tiles, render_tracking_fused
from gslam_tpu_torch.opt.lbfgs_compact import warmup_lbfgs_impl
from gslam_tpu_torch.parallel.sharding import (
    Mesh, _band_outputs, _band_render, _banded_step, _compose_bands, compose_outputs,
    join_bands, partition_by_depth, split_bands,
)
from gslam_tpu_torch.runtime.fused import KeyDraws
from gslam_tpu_torch.tracking.track import TrackingConfig, constant_motion_prior

__all__ = ["ShardedSlamConfig", "ShardedSlam", "_compose_bands"]


@dataclasses.dataclass(frozen=True)
class ShardedSlamConfig:
    tracking: TrackingConfig = TrackingConfig()
    mapping: MapConfig = MapConfig()
    init_n_new: int = 5000  # bootstrap insertion
    kf_n_new: int = 100  # per-keyframe insertion
    idle_iters: int = 2  # mapping iterations on non-keyframe frames
    use_gt_depths: bool = False
    prune_every: int = 10  # frames between low-opacity prunes (0 = off)
    # abort threshold on the tracking-guard rejection counter (0 = off)
    abort_unhealthy: int = 0


# the host loop's scalars and lists, carried by state_to_numpy / load_state
_HOST_STATE = ("kf_count", "loop_closures", "total_map_iters", "health",
               "step_ema", "innov_ema", "consec_rej")


class ShardedSlam:
    """Host-driven SLAM over a mesh with a 'gauss' axis (splat bands)."""

    def __init__(self, cfg: ShardedSlamConfig, mesh: Mesh, width: int, height: int,
                 capacity: int, kf_capacity: int = 32, seed: int = 0, draws=KeyDraws):
        if "gauss" not in mesh.axis_names:
            raise ValueError(f"ShardedSlam needs a 'gauss' axis, got {mesh.axis_names}")
        self.band_devices = mesh.axis_devices("gauss")
        if capacity % len(self.band_devices):
            raise ValueError(f"capacity {capacity} does not split into "
                             f"{len(self.band_devices)} bands")
        self.cfg, self.mesh, self.draws = cfg, mesh, draws
        self.width, self.height = width, height
        self.capacity, self.kf_capacity = capacity, kf_capacity
        dev = self.device = mesh.first

        gmap = empty_map(capacity, device=dev)
        self.bands = split_bands(gmap, self.band_devices)
        self.opt_bands = split_bands(init_adam(gmap), self.band_devices)

        kc = kf_capacity
        f32 = dict(dtype=torch.float32, device=dev)
        self.kf_imgs = torch.zeros((kc, height, width, 3), **f32)
        self.kf_poses = torch.eye(4, **f32).repeat(kc, 1, 1)
        self.kf_exps = torch.zeros((kc, 2), **f32)
        self.kf_gt_depths = torch.zeros((kc, height, width), **f32)
        self.kf_est_depths = torch.zeros((kc, height, width), **f32)
        self.kf_mask = np.zeros((kc,), bool)
        self.kf_count = 0
        self.kf_frames: list[int] = []

        # pose graph (enable_pgo): per-keyframe splat-visibility snapshots in
        # buffer order, and a host-side covisibility adjacency
        self.kf_vis = (torch.zeros((kc, capacity), dtype=torch.bool, device=dev)
                       if cfg.mapping.enable_pgo else None)
        self.adj = np.zeros((kc, kc), bool)
        self.loop_closures = 0  # IoU edges beyond the consecutive chain
        self.total_map_iters = 0
        self._last_probe_grad = None  # per band [win, cap / D, 2] dL/dmeans2d

        self.key = torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                                dtype=torch.int64)
        self.health = 0
        self.step_ema = 0.0  # EMA per-frame translation (kf_adapt trigger)
        self.innov_ema = 0.0  # accepted-innovation EMA (guard gauge)
        self.consec_rej = 0  # consecutive rejections (guard bound growth)
        self._kf_anchor = np.eye(4, dtype=np.float32)  # tracked pose at the
        # last keyframe event (kf_adapt gauge anchor)
        self.trajectory: list[np.ndarray] = []
        self.exposure_traj: list[np.ndarray] = []
        self._exposure = torch.zeros((2,), **f32)
        self.insertion = InsertionConfig(initial_opacity=cfg.mapping.initial_opacity)

    # ----------------------------- state -----------------------------

    def joined(self) -> tuple:
        """(map, Adam state) joined on the first device."""
        return join_bands(self.bands, self.device), join_bands(self.opt_bands, self.device)

    def _set_joined(self, gmap, opt):
        self.bands = split_bands(gmap, self.band_devices)
        self.opt_bands = split_bands(opt, self.band_devices)

    def state_to_numpy(self) -> dict:
        """Everything a step reads, as numpy arrays and host values: the map
        (`map/<field>`), the Adam state (`opt/mu/<field>`, ...), the ring,
        the pose graph, the key and the host loop's counters."""
        gmap, opt = self.joined()
        out = {f"map/{k}": v for k, v in gaussian_map_to_numpy(gmap).items()}
        out.update({f"opt/{k}": v for k, v in adam_state_to_numpy(opt).items()})
        for name in ("kf_imgs", "kf_poses", "kf_exps", "kf_gt_depths", "kf_est_depths",
                     "_exposure", "key"):
            out[name] = getattr(self, name).cpu().numpy()
        if self.kf_vis is not None:
            out["kf_vis"] = self.kf_vis.cpu().numpy()
        if self._last_probe_grad is not None:
            out["last_probe_grad"] = torch.cat(
                [g.to(self.device) for g in self._last_probe_grad], dim=1).cpu().numpy()
        out.update(kf_mask=self.kf_mask.copy(), adj=self.adj.copy(),
                   kf_anchor=self._kf_anchor.copy(),
                   trajectory=[np.array(t) for t in self.trajectory],
                   exposure_traj=[np.array(e) for e in self.exposure_traj],
                   kf_frames=list(self.kf_frames),
                   **{k: getattr(self, k) for k in _HOST_STATE})
        return out

    def load_state(self, d: dict):
        """Take over a state from state_to_numpy, or one carried across from
        the JAX loop as numpy arrays under the same names."""
        dev = self.device
        gmap = gaussian_map_from_numpy({k[4:]: v for k, v in d.items()
                                        if k.startswith("map/")}, device=dev)
        opt = adam_state_from_numpy({k[4:]: v for k, v in d.items() if k.startswith("opt/")},
                                    device=dev)
        self._set_joined(gmap, opt)
        for name in ("kf_imgs", "kf_poses", "kf_exps", "kf_gt_depths", "kf_est_depths",
                     "_exposure"):
            setattr(self, name, torch.tensor(np.asarray(d[name], np.float32), device=dev))
        self.key = torch.tensor(np.asarray(d["key"]).astype(np.int64))
        if self.kf_vis is not None:
            self.kf_vis = torch.tensor(np.asarray(d["kf_vis"], bool), device=dev)
        probe = d.get("last_probe_grad")
        self._last_probe_grad = None if probe is None else [
            g.to(b) for g, b in zip(torch.tensor(np.asarray(probe, np.float32)).chunk(
                len(self.band_devices), dim=1), self.band_devices)]
        self.kf_mask = np.array(d["kf_mask"], bool)
        self.adj = np.array(d["adj"], bool)
        self._kf_anchor = np.array(d["kf_anchor"], np.float32)
        self.trajectory = [np.array(t, np.float32) for t in d["trajectory"]]
        self.exposure_traj = [np.array(e, np.float32) for e in d["exposure_traj"]]
        for k in _HOST_STATE:
            setattr(self, k, d[k])
        self.kf_frames = [int(k) for k in d["kf_frames"]]

    # ------------------------- banded programs -------------------------

    @torch.no_grad()
    def _render(self, viewmats, Ks):
        return _band_render(self.bands, viewmats, Ks, self.width, self.height,
                            self.cfg.mapping, self.device)

    def _track(self, prior, exposure, img, K, gt_depth):
        """Banded tracking: per band, tile lists binned once at the prior
        (footprints inflated by bin_radius_margin) and their rows gathered;
        then warm-up + L-BFGS over a loss that renders every band with the
        fused tracking render and composes them. Returns (pose, exposure,
        loss, n_evals, rejected)."""
        tcfg = self.cfg.tracking
        W_, H_ = self.width, self.height
        dev = self.device
        tiles, Kb = [], []
        for g in self.bands:
            bdev = g.means.device
            bins = compute_bins(g.means, g.quats, g.log_scales, g.alive,
                                prior[None].to(bdev), K[None].to(bdev), W_, H_,
                                tcfg.render, radius_scale=tcfg.bin_radius_margin)
            tiles.append(gather_tracking_tiles(g, bins))
            Kb.append(K.to(bdev))

        def unpack(x):
            pose = pose_matrix(PoseDelta(prior, x[:6], x[6:9]))
            return pose, (x[9:11] if tcfg.learn_exposure else exposure)

        def loss_fn(x_host):
            pose, exp = unpack(x_host.to(dev))
            layers = []
            for tg, k in zip(tiles, Kb):
                rgb, depth, beta, alpha = render_tracking_fused(
                    tg, pose.to(k.device), k, W_, H_, tcfg.render)
                layers.append((rgb, alpha, depth, beta))
            rgb, alpha, depth, beta = compose_outputs(layers, dev,
                                                      tcfg.render.beta_background)
            loss = tracking_photometric(apply_exposure(rgb, exp), img, beta,
                                        tcfg.photometric_loss)
            if self.cfg.use_gt_depths:
                # the single-device tracker's alpha-normalized expected depth
                # on confidently covered pixels only
                d_hat = depth / torch.clamp(alpha, min=1e-3)
                loss = loss + tcfg.depth_loss_weight * masked_depth_l1(
                    d_hat[None], gt_depth[None], alpha=alpha[None],
                    alpha_min=tcfg.depth_alpha_min)
            return loss

        x0 = torch.cat([torch.zeros(9), exposure.detach().cpu().to(torch.float32)])
        x, f, n_evals = warmup_lbfgs_impl(
            loss_fn, x0, warmup_steps=tcfg.warmup_steps, max_iter=tcfg.lbfgs_max_iter,
            max_eval=tcfg.lbfgs_max_eval, history=tcfg.lbfgs_history, lr=tcfg.pose_lr,
            warmup_lr=tcfg.pose_lr)
        ok = (bool(torch.all(torch.isfinite(x))) and bool(torch.isfinite(f))
              and bool(torch.linalg.norm(x[6:9]) < tcfg.max_step))
        if not ok:
            x, f = x0, torch.tensor(1e3)
        with torch.no_grad():
            pose, exp = unpack(x.to(dev))
        return pose, exp, f, n_evals, not ok

    @torch.no_grad()
    def _kd_stats(self, new_pose, prev_pose, K):
        """Keyframe-decision statistics from the composite at new_pose:
        (translation, median depth, view-axis cosine) read to the host, and
        the rendered depth and alpha."""
        _rgb, alpha, depth, _beta = self._render(new_pose[None], K[None])
        rel = invert_se3(new_pose) @ prev_pose
        translation = torch.linalg.norm(rel[:3, 3])
        valid = (alpha[0] > 0.1).reshape(-1)
        med = masked_median(depth[0].reshape(-1), valid)
        z_new, z_prev = new_pose[:3, 2], prev_pose[:3, 2]
        cos_z = torch.dot(z_new, z_prev) / torch.clamp(
            torch.linalg.norm(z_new) * torch.linalg.norm(z_prev), min=1e-12)
        tr, med_h, cos_h = torch.stack([translation, med, cos_z]).tolist()
        return tr, med_h, cos_h, depth[0], alpha[0]

    def _map_step(self, win_imgs, win_poses, win_exps, win_mask, win_depths, K,
                  n_iters: int):
        """n_iters banded mapping iterations: the masked 3-term loss on the
        composite, one adam_step per band, the window poses by SGD. Keeps
        the first valid window pose fixed (the gauge anchor) and returns the
        refined poses; the last iteration's band-local dL/dmeans2d (from a
        zero probe added to each band's projected means) is kept for
        densification. Every window slot renders, padded ones included."""
        mcfg = self.cfg.mapping
        dev = self.device
        win = win_poses.shape[0]
        Ks = K[None].expand(win, 3, 3)
        mask_t = torch.as_tensor(win_mask, device=dev)
        wm = mask_t.to(torch.float32)
        pv = torch.zeros((win, 9), device=dev)
        zeros = [torch.zeros((win, b.capacity, 2), device=b.means.device) for b in self.bands]
        g_probe = zeros

        def loss_of(params, pv, *probes):
            viewmats = pose_matrix(PoseDelta(win_poses, pv[:, :6], pv[:, 6:9]))
            gs = [b.with_trainable(p) for b, p in zip(self.bands, params)]
            rgb, _alpha, depth, beta = _band_render(gs, viewmats, Ks, self.width,
                                                    self.height, mcfg, dev, probes)
            photo = mapping_photometric(apply_exposure(rgb, win_exps), win_imgs, beta,
                                        active_gs=mcfg.active_gs, cam_mask=mask_t)
            ssim = 1.0 - torch.sum(ssim_per_image(rgb, win_imgs) * wm) / torch.clamp(
                torch.sum(wm), min=1.0)
            loss = (1.0 - mcfg.ssim_weight) * photo + mcfg.ssim_weight * ssim
            if self.cfg.use_gt_depths:
                loss = loss + mcfg.depth_loss_weight * masked_depth_l1(depth, win_depths,
                                                                       mask_t)
            return loss

        for _ in range(n_iters):
            self.bands, self.opt_bands, pv, g_probe = _banded_step(
                self.bands, self.opt_bands, pv, loss_of, mcfg.pose_lr, zeros)
        # gauge anchor: never move the oldest VALID window pose (early
        # positions may be masked padding duplicates of it)
        first_valid = int(np.argmax(win_mask))
        with torch.no_grad():
            pv = pv.detach().clone()
            pv[first_valid] = 0.0
            refined = pose_matrix(PoseDelta(win_poses, pv[:, :6], pv[:, 6:9]))
        self._last_probe_grad = g_probe
        return refined

    @torch.no_grad()
    def _view_vis(self, pose, K) -> torch.Tensor:
        """[cap] per-splat visibility (radii > 0) at one pose, band by band,
        on the first device."""
        outs = _band_outputs(self.bands, pose[None], K[None], self.width, self.height,
                             self.cfg.mapping.render)
        return torch.cat([(o.radii[0] > 0).to(self.device) for o in outs])

    @torch.no_grad()
    def _vis_iou(self, vis: torch.Tensor) -> np.ndarray:
        """Loop-closure IoU of one visibility row against the ring."""
        inter = torch.sum(self.kf_vis & vis[None], dim=1).to(torch.float32)
        union = torch.sum(self.kf_vis | vis[None], dim=1).to(torch.float32)
        iou = (inter / torch.clamp(union, min=1.0)).cpu().numpy()
        return np.where(self.kf_mask, iou, 0.0)

    def _insert(self, key, depth, alpha, img, K, pose, n_new: int, frame_index: int,
                gt_depth, **occlusion):
        """insert_from_depthmap on the joined buffer, split back."""
        gmap, opt = self.joined()
        need = insertion_masks(depth, alpha, self.insertion, gt_depth)[1]
        r = insert_from_depthmap(self.draws.insertion(key, need, n_new), gmap, opt, depth,
                                 alpha, img, K, pose, n_new, frame_index, self.insertion,
                                 gt_depthmap=gt_depth, **occlusion)
        self._set_joined(r.gmap, r.opt_state)

    def _densify(self, key, frame_index: int):
        """densify_by_gradients on the joined buffer and the joined probe
        gradient, split back."""
        mcfg = self.cfg.mapping
        gmap, opt = self.joined()
        grad = torch.cat([g.to(self.device) for g in self._last_probe_grad], dim=1)
        r = densify_by_gradients(
            self.draws.normal(key, (mcfg.densify_max_new, 3), self.device), gmap, opt,
            grad, self.width, self.height, mcfg.densify_max_new, frame_index,
            grow_grad2d=mcfg.grow_grad2d, grow_scale3d=mcfg.grow_scale3d)
        self._set_joined(r.gmap, r.opt_state)

    @torch.no_grad()
    def _prune(self):
        thr = self.cfg.mapping.opacity_prune_threshold
        self.bands = [pruning.apply_prune(b, pruning.low_opacity_mask(b, thr))
                      for b in self.bands]

    @torch.no_grad()
    def _repartition_all(self, ref_pose):
        """Depth-repartition the joined buffer, its Adam moments and the
        pose-graph visibility columns at a reference pose, and split it back
        into bands."""
        gmap, opt = self.joined()
        if self.kf_vis is not None:
            gmap, opt, self.kf_vis = partition_by_depth(gmap, ref_pose, opt, self.kf_vis)
        else:
            gmap, opt = partition_by_depth(gmap, ref_pose, opt)
        self._set_joined(gmap, opt)

    # ----------------------------- frame loop -----------------------------

    def _window(self):
        """Ring slots of the most recent `window_size` keyframes, padded by
        repeating the oldest resident one, and the validity mask (padded
        duplicates are masked out of the loss). With enable_pgo the window
        is `recent_window` recents plus the newest keyframe's pose-graph
        neighbours, the first ones, as the JAX loop picks them."""
        mcfg = self.cfg.mapping
        win = mcfg.window_size
        n_recent = mcfg.recent_window if mcfg.enable_pgo else win
        lo = max(self.kf_count - self.kf_capacity, 0)  # oldest resident kf
        ks = np.clip(np.arange(self.kf_count - n_recent, self.kf_count), lo,
                     max(self.kf_count - 1, 0))
        slots = (ks % self.kf_capacity).astype(np.int64)
        mask = np.zeros((n_recent,), bool)
        mask[max(n_recent - (self.kf_count - lo), 0):] = True
        if mcfg.enable_pgo:
            newest = self.kf_frames_slot(max(self.kf_count - 1, 0))
            cand = self.adj[newest] & self.kf_mask
            cand[slots[mask]] = False  # already in the recent set
            extra = np.flatnonzero(cand)[: win - n_recent]
            pad = win - n_recent - len(extra)
            slots = np.concatenate([slots, extra, np.zeros((pad,), np.int64)])
            mask = np.concatenate([mask, np.ones((len(extra),), bool), np.zeros((pad,), bool)])
        return slots, mask

    def kf_frames_slot(self, k: int) -> int:
        return int(k % self.kf_capacity)

    def _run_mapping(self, slots, mask, n_iters: int, K):
        idx = torch.as_tensor(slots, device=self.device)
        refined = self._map_step(self.kf_imgs[idx], self.kf_poses[idx], self.kf_exps[idx],
                                 mask, self.kf_gt_depths[idx], K, n_iters)
        self.total_map_iters += int(n_iters)
        # fold the refined window poses back into the ring; padded duplicate
        # positions are dropped (a duplicate index could otherwise let an
        # unrefined duplicate overwrite the refined pose)
        self.kf_poses = _set_rows(self.kf_poses, idx, torch.as_tensor(mask, device=self.device),
                                  refined)

    def step(self, i: int, image, gt_depth, K):
        cfg = self.cfg
        mcfg, tcfg = cfg.mapping, cfg.tracking
        dev = self.device
        img, K = to_device(image, dev), to_device(K, dev)
        dep = (to_device(gt_depth, dev) if gt_depth is not None
               else torch.zeros((self.height, self.width), device=dev))
        gt_arg = dep if cfg.use_gt_depths else None

        if i == 0:
            pose = torch.eye(4, device=dev)
            self.key, k_a, k_b = self.draws.split(self.key, 3)
            mock_depth = (1.0 + (self.draws.normal(k_a, (self.height, self.width), dev)
                                 - 0.5) * 0.3) * mcfg.initial_scale
            mock_alpha = torch.full((self.height, self.width), 0.01, device=dev)
            self._insert(k_b, mock_depth, mock_alpha, img, K, pose, cfg.init_n_new, 0, gt_arg)
            self._add_keyframe(0, img, pose, dep, mock_depth, K)
            self._repartition_all(pose)
            slots, mask = self._window()
            self._run_mapping(slots, mask, mcfg.num_iters_init, K)
            self.trajectory.append(np.eye(4, dtype=np.float32))
            self.exposure_traj.append(self._exposure.cpu().numpy())
            return

        # constant-motion prior + banded tracking
        t = self.trajectory
        prior = (constant_motion_prior(torch.from_numpy(t[-2]).to(dev),
                                       torch.from_numpy(t[-1]).to(dev))
                 if i >= 2 else torch.from_numpy(t[-1]).to(dev))
        self._repartition_all(prior)
        pose, exp, _loss, _n_evals, rejected = self._track(prior, self._exposure, img, K, dep)
        # innovation-scaled plausibility gate, the fused and actor runtimes'
        # rule (TrackingConfig.guard_*): a refinement many times the typical
        # accepted innovation, or a large rotation off the prior, is a basin
        # jump: dead-reckon on the motion model. The bound grows with
        # consecutive rejections, so a genuine re-lock is accepted.
        pose_np, prior_np = pose.cpu().numpy(), prior.cpu().numpy()
        delta = pose_np @ np.linalg.inv(prior_np)
        innov = float(np.linalg.norm(delta[:3, 3]))
        if tcfg.guard_innov_mult > 0.0 and not rejected and i >= 3:
            cos_rot = (float(np.trace(delta[:3, :3])) - 1.0) * 0.5
            bound = (max(tcfg.guard_innov_mult * self.innov_ema, tcfg.guard_step_floor)
                     + self.consec_rej * max(2.0 * self.innov_ema,
                                             0.5 * tcfg.guard_step_floor))
            if innov > bound or cos_rot < np.cos(tcfg.guard_max_rot):
                pose, exp, pose_np = prior, self._exposure, prior_np
                rejected = True
        if rejected:
            self.consec_rej += 1
        else:
            self.consec_rej = 0
            self.innov_ema = (innov if self.innov_ema == 0.0
                              else 0.8 * self.innov_ema + 0.2 * innov)
        self._exposure = exp
        self.health += int(rejected)
        if cfg.abort_unhealthy and self.health >= cfg.abort_unhealthy:
            raise RuntimeError(f"health counter {self.health} >= {cfg.abort_unhealthy}: "
                               f"tracking guard rejected too many frames")
        prev_pose_np = t[-1]  # before append: last frame's pose
        self.trajectory.append(pose_np)
        self.exposure_traj.append(exp.cpu().numpy())
        rel = pose_np @ np.linalg.inv(prev_pose_np)
        step = float(np.linalg.norm(rel[:3, 3]))
        self.step_ema = step if self.step_ema == 0.0 else 0.9 * self.step_ema + 0.1 * step

        prev_kf_pose = self.kf_poses[self.kf_frames_slot(self.kf_count - 1)]
        tr, med, cos_z, est_depth, est_alpha = self._kd_stats(pose, prev_kf_pose, K)
        # motion-adaptive trigger (MapConfig.kf_adapt), measured in the
        # tracked-trajectory gauge: the pose at the last keyframe event
        rel_a = pose_np @ np.linalg.inv(self._kf_anchor)
        anchor_tr = float(np.linalg.norm(rel_a[:3, 3]))
        adaptive = (mcfg.kf_adapt > 0.0 and self.step_ema > 1e-3 * med
                    and anchor_tr > mcfg.kf_adapt * self.step_ema)
        take = ((tr > mcfg.kf_m * med) or (cos_z < mcfg.kf_cos) or adaptive) \
            and not rejected

        if take:
            self._kf_anchor = pose_np
            self.key, k_b = self.draws.split(self.key, 2)
            filt_mask = torch.as_tensor(self.kf_mask & (self.kf_count > 1), device=dev)
            self._insert(k_b, est_depth * mcfg.initial_scale, est_alpha, img, K, pose,
                         cfg.kf_n_new, i, gt_arg, kf_viewmats=self.kf_poses,
                         kf_est_depths=self.kf_est_depths, kf_mask=filt_mask)
            self._add_keyframe(i, img, pose, dep, est_depth, K)
            self._repartition_all(pose)

        slots, mask = self._window()
        n_iters = mcfg.num_iters_mapping if take else cfg.idle_iters
        before_iters = self.total_map_iters
        if n_iters > 0:
            self._run_mapping(slots, mask, n_iters, K)

        # gradient densification at the reference cadence (every
        # densify_every total optimization steps), selecting on the final
        # iteration's banded dL/dmeans2d
        if (mcfg.densify_every > 0 and self._last_probe_grad is not None
                and (before_iters // mcfg.densify_every)
                != (self.total_map_iters // mcfg.densify_every)):
            self.key, k_d = self.draws.split(self.key, 2)
            self._densify(k_d, i)
            self._last_probe_grad = None
            self._repartition_all(torch.from_numpy(self.trajectory[-1]).to(dev))
        elif cfg.prune_every and (i + 1) % cfg.prune_every == 0:
            self._prune()  # never on a pass that just densified

    def _add_keyframe(self, i, img, pose, gt_depth, est_depth, K):
        slot = self.kf_frames_slot(self.kf_count)
        self.kf_imgs[slot] = img
        self.kf_poses[slot] = pose
        self.kf_exps[slot] = self._exposure
        self.kf_gt_depths[slot] = gt_depth
        self.kf_est_depths[slot] = est_depth
        if self.kf_vis is not None:
            # pose-graph bookkeeping: a visibility snapshot for the new
            # keyframe, the consecutive-chain edge, and loop-closure edges
            # by visible-splat IoU > kf_cov against every resident keyframe;
            # the overwritten ring slot loses its old edges first
            prev_slot = self.kf_frames_slot(self.kf_count - 1)
            vis = self._view_vis(pose, K)
            iou = self._vis_iou(vis)
            self.kf_vis[slot] = vis
            self.adj[slot, :] = False
            self.adj[:, slot] = False
            if self.kf_count > 0:
                self.adj[slot, prev_slot] = self.adj[prev_slot, slot] = True
            closures = (iou > self.cfg.mapping.kf_cov) & self.kf_mask
            closures[slot] = closures[prev_slot] = False
            if closures.any():
                self.loop_closures += int(closures.sum())
                self.adj[slot, closures] = True
                self.adj[closures, slot] = True
        self.kf_mask[slot] = True
        self.kf_count += 1
        self.kf_frames.append(i)

    def run(self, dataset, max_frames: int | None = None, eval_stride: int = 0) -> dict:
        frames = list(dataset)
        if max_frames is not None:
            frames = frames[:max_frames]
        K = to_device(frames[0].camera.K, self.device)
        for i, f in enumerate(frames):
            self.step(i, f.image, getattr(f, "gt_depth", None), K)

        gt = np.stack([np.asarray(f.gt_pose) for f in frames])
        est = np.stack(self.trajectory)
        nonfinite = int(np.sum((~np.isfinite(est)).any(axis=(1, 2))))
        live = sum(int(b.n_live()) for b in self.bands)
        metrics = {
            "L": len(frames),
            "C": self.kf_count,
            "kf_frames": self.kf_frames,
            "health": self.health,
            "nonfinite_poses": nonfinite,
            # transient guard rejections are recoveries; diverged means the
            # abort threshold was reached or a pose went non-finite
            "diverged": bool(nonfinite > 0 or (
                self.health >= self.cfg.abort_unhealthy if self.cfg.abort_unhealthy
                else self.health > 0)),
            "n_devices": self.mesh.size,
            "live": live,
            "total_map_iters": self.total_map_iters,
            "loop_closures": self.loop_closures,
        }
        if nonfinite == 0:
            gt_c, est_c = trajectory_positions(gt), trajectory_positions(est)
            # 'ate' is the mean, 'ate_rmse' the RMSE, as in every runtime
            metrics["ate"] = float(ate_mean(gt_c, est_c))
            metrics["ate_rmse"] = float(ate_rmse(gt_c, est_c))
        else:
            metrics["ate"] = float("inf")
        if eval_stride:
            psnrs = []
            for i in range(0, len(frames), eval_stride):
                w2c = torch.from_numpy(est[i]).to(self.device)
                rgb, _alpha, _d, _b = self._render(w2c[None], K[None])
                # each frame scored with its own exposure
                rgb = apply_exposure(rgb[0], torch.from_numpy(self.exposure_traj[i]).to(
                    self.device))
                gt_img = to_device(frames[i].image, self.device)
                mse = float(torch.mean((rgb - gt_img) ** 2))
                psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
            metrics["psnr"] = float(np.mean(psnrs))
        return metrics
