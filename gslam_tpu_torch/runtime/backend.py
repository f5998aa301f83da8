"""Mapping backend actor.

Counterpart of gslam_tpu/runtime/backend.py, the host-side orchestration
of the mapping programs (mapping/backend_ops.py):
  * REQUEST_INIT: bootstrap the map from a mock unit-depth map (5000
    splats) and run the long initialization optimization;
  * ADD_FRAME: the keyframe policy (translation and view angle against the
    rendered median depth, and the motion-adaptive trigger), insertion
    from the rendered depth with the occlusion filter, one optimization
    step, optional pose-graph loop closures;
  * idle: windowed map optimization with the plateau pause, then pruning
    and the L-BFGS pose refinement;
  * `sync_payload`: the map snapshot for the frontend.

The actor owns fixed-capacity tensors on its device (the splat map, its
Adam moments, the keyframe store, the pose optimizer); every program takes
them and returns new ones. Python decides which program runs next.

Random draws. `key` is an int64 [2] tensor on the CPU (the JAX key's
shape), split where the JAX actor splits it; its numbers come from
`draws` (runtime/fused.py's `KeyDraws` by default: a CPU generator seeded
by the key), so tests can replay the JAX package's draws. The PGO window
samples from `random.Random(rng_seed)`, as the JAX actor does.
"""

from __future__ import annotations

import dataclasses
import logging
import random as py_random

import numpy as np
import torch

from gslam_tpu_torch import resolve_device, to_device
from gslam_tpu_torch.io.frames import Frame
from gslam_tpu_torch.mapping import pruning
from gslam_tpu_torch.mapping.backend_ops import (
    MapConfig, init_pose_adam, keyframe_decision_stats, mapping_step, pose_refinement_lbfgs,
    render_view_stats, visibility_pass,
)
from gslam_tpu_torch.mapping.gaussians import GaussianMap, empty_map, grow_map
from gslam_tpu_torch.mapping.insertion import (
    InsertionConfig, densify_by_gradients, insert_from_depthmap, insertion_masks,
)
from gslam_tpu_torch.mapping.keyframes import add_keyframe, empty_keyframes
from gslam_tpu_torch.mapping.optimizer import init_adam
from gslam_tpu_torch.runtime.fused import KeyDraws
from gslam_tpu_torch.runtime import trace
from gslam_tpu_torch.runtime.messages import SyncPayload

logger = logging.getLogger("gslam_tpu_torch.backend")


class PlateauStopper:
    """Stop when the loss is low and keeps decreasing for `patience` steps."""

    def __init__(self, patience: int, min_loss: float):
        self.patience = patience
        self.min_loss = min_loss
        self.counter = 0
        self.last = None

    def stop(self, loss: float) -> bool:
        if self.last is None:
            self.last = loss
            return False
        if loss > self.min_loss:
            self.last = loss
            self.counter = 0
            return False
        if self.last > loss:
            self.counter += 1
            if self.counter >= self.patience:
                return True
        else:
            self.counter = 0
        self.last = loss
        return False


class BackendActor:
    def __init__(
        self,
        cfg: MapConfig,
        width: int,
        height: int,
        capacity: int = 2**17,
        kf_capacity: int = 64,
        seed: int = 0,
        rng_seed: int = 0,
        device: str | torch.device | None = None,
        draws=KeyDraws,
    ):
        self.cfg = cfg
        self.width, self.height = width, height
        self.capacity = capacity
        self.kf_capacity = kf_capacity
        self.device = dev = resolve_device(device)
        self.draws = draws

        self.gmap = empty_map(capacity, device=dev)
        self.opt_state = init_adam(self.gmap)
        self.kf = empty_keyframes(kf_capacity, height, width, device=dev)
        self.pose_opt = init_pose_adam(kf_capacity, device=dev)
        # the JAX PRNGKey(seed): high and low 32 bits
        self.key = torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                                dtype=torch.int64)
        self.py_rng = py_random.Random(rng_seed)

        self.kf_order: list[int] = []  # slots in insertion order
        self.kf_frame_idx: dict[int, int] = {}  # slot -> frame index
        self.frame_slot: dict[int, int] = {}  # frame index -> slot
        self.pose_graph: dict[int, set] = {}
        self.frames: list[Frame] = []
        self.total_step = 0
        self.pause_map_optim = False
        # EMA of the per-frame camera translation (MapConfig.kf_adapt)
        self.step_ema = 0.0
        self._last_pose: np.ndarray | None = None
        # tracked pose at the last keyframe event: the adaptive trigger
        # measures against it, not against the keyframe's map-optimized
        # pose, whose gauge drifts from the tracking gauge
        self._kf_anchor: np.ndarray | None = None
        self.K = None  # shared intrinsics [3, 3] on the device, set on the first frame
        self.insertion_cfg = InsertionConfig(
            depth_variance=0.1 * cfg.initial_scale,
            no_depth_variance=0.2 * cfg.initial_scale,
            min_alpha_for_depth=0.1,
            initial_opacity=cfg.initial_opacity,
        )
        # the variant without the depth TV term (regularize=False passes)
        self._cfg_noreg = dataclasses.replace(cfg, depth_tv_weight=0.0)
        self.last_sync_depth = None
        self.last_sync_rgb = None
        self.last_sync_alpha = None
        self.last_sync_pose = None
        # overflow telemetry: the largest pair-buffer fill and the count of
        # saturated mapping iterations
        self.max_pairs_seen = 0
        self.n_pair_overflows = 0
        # the pose refinement's evaluations; each phase's host time is the
        # recorder's span backend.<phase> (map/insert/prune/pose_refine/sync)
        self.refine_evals: list[int] = []

    def _split(self, n: int) -> list[torch.Tensor]:
        """Advance the key; returns n - 1 fresh keys (JAX: key, *ks = split(key, n))."""
        keys = self.draws.split(self.key, n)
        self.key = keys[0]
        return list(keys[1:])

    def _gt_depth(self, frame: Frame):
        if self.cfg.use_gt_depths and frame.gt_depth is not None:
            return to_device(frame.gt_depth, self.device)
        return None

    # ---------------- window policy ----------------

    def _window(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The optimization window (slots + mask), padded to cfg.window_size:
        the last recent_window keyframes, or with PGO the newest keyframe,
        a sample of its graph neighbours and of their neighbours."""
        size = self.cfg.window_size
        if self.cfg.enable_pgo and len(self.kf_order) > 1:
            latest = self.kf_frame_idx[self.kf_order[-1]]
            chosen = {latest}
            neighbors = sorted(self.pose_graph.get(latest, set()))
            if 0 < len(neighbors) < size:
                chosen.update(self.py_rng.sample(neighbors, min(len(neighbors), size)))
            elif neighbors:
                chosen.update(neighbors)
            for _ in range(size - len(chosen)):
                if not neighbors:
                    break
                hop = sorted(self.pose_graph.get(self.py_rng.choice(neighbors), set()))
                if hop:
                    chosen.add(self.py_rng.choice(hop))
            frame_ids = sorted(chosen)[:size]
            slots = [self.frame_slot[f] for f in frame_ids if f in self.frame_slot]
        else:
            slots = self.kf_order[-self.cfg.recent_window:]
        idx = np.zeros(size, np.int64)
        mask = np.zeros(size, bool)
        idx[: len(slots)] = slots
        mask[: len(slots)] = True
        return (torch.from_numpy(idx).to(self.device), torch.from_numpy(mask).to(self.device))

    # ---------------- optimization ----------------

    def optimize_map(self, n_iters=None, prune=True, regularize=True):
        if not self.kf_order:
            return
        with trace.span("backend.map"):
            self._optimize_map(n_iters, prune, regularize)

    def _optimize_map(self, n_iters, prune, regularize):
        cfg = self.cfg if regularize else self._cfg_noreg
        if n_iters is None:
            n_iters = cfg.num_iters_mapping
        stopper = PlateauStopper(cfg.plateau_patience, cfg.plateau_min_loss)
        aux = None
        for _ in range(n_iters):
            self.total_step += 1
            widx, wmask = self._window()
            self.gmap, self.opt_state, self.kf, self.pose_opt, aux = mapping_step(
                self.gmap, self.opt_state, self.kf, self.pose_opt,
                widx, wmask, self.K, self.width, self.height, cfg,
            )
            if self.total_step % cfg.densify_every == 0:
                (k,) = self._split(2)
                res = densify_by_gradients(
                    self.draws.normal(k, (cfg.densify_max_new, 3), self.device),
                    self.gmap, self.opt_state, aux.means2d_grad,
                    self.width, self.height, cfg.densify_max_new,
                    self.frames[-1].index if self.frames else 0,
                    grow_grad2d=cfg.grow_grad2d, grow_scale3d=cfg.grow_scale3d,
                )
                self.gmap, self.opt_state = res.gmap, res.opt_state
                prune = False
            # the plateau and overflow checks read two scalars per iteration,
            # in one copy
            n_pairs, loss = torch.stack([torch.max(aux.n_pairs).to(torch.float64),
                                         aux.photometric_loss.to(torch.float64)]).tolist()
            n_pairs = int(n_pairs)
            self.max_pairs_seen = max(self.max_pairs_seen, n_pairs)
            if n_pairs >= int(cfg.render.pairs_per_gaussian * self.capacity):
                self.n_pair_overflows += 1
                if self.n_pair_overflows in (1, 10, 100, 1000):
                    logger.warning(
                        "pair buffer saturated (%d pairs, %d times so far): tile lists are "
                        "truncating; raise render.pairs_per_gaussian or capacity",
                        n_pairs, self.n_pair_overflows)
            if stopper.stop(loss):
                self.pause_map_optim = True
                break

        if aux is not None and prune:
            self._apply_pruning(aux.radii, aux.n_touched)
        self._refresh_sync_payload()

    def _apply_pruning(self, radii, n_touched):
        cfg = self.cfg
        remove = pruning.low_opacity_mask(self.gmap, cfg.opacity_prune_threshold)
        remove = remove | pruning.large_radius_mask(torch.amax(radii, dim=0),
                                                    cfg.size_prune_threshold)
        if cfg.enable_visibility_pruning and len(self.kf_order) >= 2:
            remove = remove | pruning.ill_conditioned_mask(
                radii[: cfg.recent_window], n_touched[: cfg.recent_window],
                cfg.min_visibility_views)
        self.gmap = pruning.apply_prune(self.gmap, remove)

    def run_pruning(self):
        """Prune on a fresh render of the last keyframe."""
        if not self.kf_order:
            return
        with trace.span("backend.prune"):
            self._run_pruning()

    def _run_pruning(self):
        pose = self.kf.poses()[self.kf_order[-1]]
        vs = render_view_stats(self.gmap, pose, self.K, self.width, self.height, self.cfg)
        remove = pruning.low_opacity_mask(self.gmap, self.cfg.opacity_prune_threshold)
        remove = remove | pruning.large_radius_mask(vs.radii, self.cfg.size_prune_threshold)
        if self.cfg.enable_visibility_pruning and len(self.kf_order) >= 2:
            remove = remove | pruning.ill_conditioned_mask(
                vs.radii[None], vs.n_touched[None], self.cfg.min_visibility_views)
        self.gmap = pruning.apply_prune(self.gmap, remove)
        self._set_sync_render(vs, pose)

    def refine_poses(self):
        if len(self.kf_order) < 2:
            return
        with trace.span("backend.pose_refine"):
            widx, wmask = self._window()
            self.kf, _, n_evals = pose_refinement_lbfgs(
                self.gmap, self.kf, widx, wmask, self.K, self.width, self.height, self.cfg)
            self.refine_evals.append(n_evals)

    # ---------------- keyframe management ----------------

    def _next_slot(self) -> int:
        for s in range(self.kf_capacity):
            if s not in self.kf_order:
                return s
        # evict the oldest keyframe but the first (the gauge anchor)
        victim = self.kf_order[1] if len(self.kf_order) > 1 else self.kf_order[0]
        self._remove_keyframe_slot(victim)
        return victim

    def _remove_keyframe_slot(self, slot: int):
        fidx = self.kf_frame_idx.pop(slot)
        self.kf_order.remove(slot)
        self.frame_slot.pop(fidx, None)
        self.pose_graph.pop(fidx, None)
        for n in self.pose_graph.values():
            n.discard(fidx)
        mask = self.kf.mask.clone()
        mask[slot] = False
        self.kf = self.kf._replace(mask=mask)

    def _add_keyframe(self, frame: Frame, image, pose, exposure, est_depth=None) -> int:
        slot = self._next_slot()
        self.kf = add_keyframe(
            self.kf, slot, image, pose, exposure, frame.index,
            gt_depth=None if frame.gt_depth is None else to_device(frame.gt_depth, self.device),
            est_depth=est_depth)
        self.kf_order.append(slot)
        self.kf_frame_idx[slot] = frame.index
        self.frame_slot[frame.index] = slot
        return slot

    def _insert(self, key, depth, alpha, image, pose, n_new, frame, **occlusion):
        gt_depth = self._gt_depth(frame)
        need = insertion_masks(depth, alpha, self.insertion_cfg, gt_depth)[1]
        with trace.span("backend.insert"):
            res = insert_from_depthmap(
                self.draws.insertion(key, need, n_new), self.gmap, self.opt_state, depth,
                alpha, image, self.K, pose, n_new, frame.index, self.insertion_cfg,
                gt_depthmap=gt_depth, **occlusion)
        self.gmap, self.opt_state = res.gmap, res.opt_state
        return res

    def initialize(self, frame: Frame, pose, exposure):
        """Bootstrap from the first frame with a mock noisy unit-depth map."""
        dev = self.device
        self.K = to_device(frame.camera.K, dev)
        self.frames.append(frame.strip())
        H, W = self.height, self.width
        pose, exposure = to_device(pose, dev), to_device(exposure, dev)
        image = to_device(frame.image, dev)

        k_depth, k_ins = self._split(3)
        mock_depth = (1.0 + (self.draws.normal(k_depth, (H, W), dev) - 0.5) * 0.3) \
            * self.cfg.initial_scale
        mock_alpha = torch.full((H, W), 0.01, device=dev)
        res = self._insert(k_ins, mock_depth, mock_alpha, image, pose, 5000, frame)
        self._add_keyframe(frame, image, pose, exposure)
        self.pose_graph.setdefault(frame.index, set())
        logger.info("initialized map with %d splats", int(res.n_inserted))

    def maybe_add_keyframe(self, frame: Frame, pose, exposure) -> bool:
        """The keyframe decision, and insertion when it takes one."""
        dev = self.device
        pose, exposure = to_device(pose, dev), to_device(exposure, dev)
        prev_pose = self.kf.poses()[self.kf_order[-1]]
        stats = keyframe_decision_stats(self.gmap, pose, prev_pose, self.K, self.width,
                                        self.height, self.cfg)
        translation, med, cos_z = torch.stack(
            [stats.translation, stats.median_depth, stats.cos_z]).tolist()
        pose_np = pose.cpu().numpy()
        # motion-adaptive trigger (MapConfig.kf_adapt), measured against the
        # tracked pose at the last keyframe event
        moving = self.step_ema > 1e-3 * med
        if self._kf_anchor is not None:
            anchor_tr = float(np.linalg.norm((pose_np @ np.linalg.inv(self._kf_anchor))[:3, 3]))
        else:
            anchor_tr = translation
        adaptive = (self.cfg.kf_adapt > 0.0 and moving
                    and anchor_tr > self.cfg.kf_adapt * self.step_ema)
        take = translation > self.cfg.kf_m * med or cos_z < self.cfg.kf_cos or adaptive
        # never keyframe a guard-rejected (dead-reckoned) frame
        if not take or frame.rejected:
            return False
        self._kf_anchor = pose_np

        (k_ins,) = self._split(2)
        occlusion = {}
        if len(self.kf_order) > 1:
            occlusion = dict(kf_viewmats=self.kf.poses(), kf_est_depths=self.kf.est_depths,
                             kf_mask=self.kf.mask)
        image = to_device(frame.image, dev)
        self._insert(k_ins, stats.new_depth * self.cfg.initial_scale, stats.new_alpha, image,
                     pose, 100, frame, **occlusion)
        self._add_keyframe(frame, image, pose, exposure, est_depth=stats.new_depth)
        # consecutive-keyframe covisibility edge
        if len(self.kf_order) >= 2:
            a = self.kf_frame_idx[self.kf_order[-2]]
            self.pose_graph.setdefault(a, set()).add(frame.index)
            self.pose_graph.setdefault(frame.index, set()).add(a)
        else:
            self.pose_graph.setdefault(frame.index, set())
        return True

    def add_pgo_constraints(self):
        """Loop-closure edges between keyframes whose visible splats overlap
        by IoU > kf_cov."""
        if len(self.kf_order) < 2:
            return
        slots = list(self.kf_order)
        poses = self.kf.poses()[torch.tensor(slots, device=self.device)]
        vis = visibility_pass(self.gmap, poses, self.K, self.width, self.height,
                              self.cfg).cpu().numpy()
        for i in range(len(slots)):
            for j in range(i + 1, len(slots)):
                fi = self.kf_frame_idx[slots[i]]
                fj = self.kf_frame_idx[slots[j]]
                if fj in self.pose_graph.get(fi, set()):
                    continue
                inter = np.sum(vis[i] & vis[j])
                union = max(np.sum(vis[i] | vis[j]), 1)
                if inter / union > self.cfg.kf_cov:
                    logger.info("loop closure %d <-> %d", fi, fj)
                    self.pose_graph.setdefault(fi, set()).add(fj)
                    self.pose_graph.setdefault(fj, set()).add(fi)

    # ---------------- sync ----------------

    def _set_sync_render(self, vs, pose):
        self.last_sync_depth = vs.depth
        self.last_sync_rgb = vs.rgb
        self.last_sync_alpha = vs.alpha
        self.last_sync_pose = pose.cpu().numpy()

    def _refresh_sync_payload(self):
        if not self.kf_order:
            return
        pose = self.kf.poses()[self.kf_order[-1]]
        self._set_sync_render(
            render_view_stats(self.gmap, pose, self.K, self.width, self.height, self.cfg), pose)

    def sync_payload(self) -> SyncPayload:
        # the snapshot owns its memory: nothing the backend does later may
        # show through it
        with trace.span("backend.sync"):
            snapshot = GaussianMap(*(x.clone() for x in self.gmap))
        poses = self.kf.poses().cpu().numpy()
        return SyncPayload(
            gmap=snapshot,
            keyframe_poses={self.kf_frame_idx[s]: poses[s] for s in self.kf_order},
            reference_depth=self.last_sync_depth,
            reference_rgb=self.last_sync_rgb,
            pose_graph={k: set(v) for k, v in self.pose_graph.items()},
            reference_alpha=self.last_sync_alpha,
            reference_pose=self.last_sync_pose,
        )

    # ---------------- top-level message handling ----------------

    def handle_request_init(self, frame: Frame, pose, exposure):
        self.pause_map_optim = False
        self._last_pose = np.asarray(pose, np.float32)
        self._kf_anchor = self._last_pose
        self.initialize(frame, pose, exposure)
        self.optimize_map(self.cfg.num_iters_init, prune=False, regularize=True)

    def handle_add_frame(self, frame: Frame, pose, exposure) -> bool:
        """Returns True if a keyframe was added."""
        self.frames.append(frame.strip())
        pose_np = np.asarray(pose, np.float32)
        if self._last_pose is not None:
            step = float(np.linalg.norm((pose_np @ np.linalg.inv(self._last_pose))[:3, 3]))
            self.step_ema = step if self.step_ema == 0.0 else 0.9 * self.step_ema + 0.1 * step
        self._last_pose = pose_np
        if not self.kf_order:
            logger.warning("ADD_FRAME before initialization")
            self.initialize(frame, pose, exposure)
            return True
        added = self.maybe_add_keyframe(frame, pose, exposure)
        self._maybe_grow()
        if added:
            self.pause_map_optim = False
            self.optimize_map(1, prune=True, regularize=False)
            if self.cfg.enable_pgo:
                self.add_pgo_constraints()
        return added

    def _maybe_grow(self):
        """Double the splat buffer at 80% occupancy."""
        n = int(self.gmap.n_live())
        if n <= 0.8 * self.capacity:
            return
        new_cap = self.capacity * 2
        logger.info("growing splat buffer %d -> %d (live=%d)", self.capacity, new_cap, n)
        self.gmap, self.opt_state = grow_map(self.gmap, self.opt_state, new_cap)
        self.capacity = new_cap

    def idle_step(self):
        """One slice of idle-time optimization."""
        if self.pause_map_optim or not self.kf_order:
            return False
        self.optimize_map()
        if len(self.kf_order) > 1:
            self.run_pruning()
            self.refine_poses()
        return True

    def n_live_splats(self) -> int:
        return int(self.gmap.n_live())
