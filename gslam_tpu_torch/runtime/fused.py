"""The fused per-frame SLAM loop.

Counterpart of gslam_tpu/runtime/fused.py. Each frame is one Python call,
`slam_step_impl`, over a `FusedState` of tensors:
  * tracking from a constant-motion prior (skipped on frame 0), then an
    innovation-scaled plausibility gate that falls back to the prior;
  * the keyframe decision: translation against the median depth, the view
    angle, and a motion-adaptive trigger, never on a rejected frame;
  * insertion: a mock-depth bootstrap of `init_n_new` splats on frame 0,
    `kf_n_new` splats from the rendered depth on each later keyframe, with
    the multi-keyframe occlusion filter;
  * a mapping pass of `mapping_step`s over the keyframe window (400
    iterations at bootstrap, `idle_iters` after), with the plateau rule;
  * gradient densification when the pass crosses a multiple of
    `densify_every` steps, pruning, covisibility loop closure (enable_pgo)
    and periodic compaction, the per-keyframe visibility riding the
    compaction's permutation.

Where the JAX package branches on the device (`lax.cond`, `while_loop`),
the port branches in Python. The counters the host branches on
(`frame_count`, `kf_count`, `total_map_iters`, `paused`, `plateau_count`)
and the PRNG `key` are CPU tensors even when the state lies on the card, so
reading them costs no wait for the device; every other leaf lies on the
state's device. A frame reads the card for the keyframe decision (one
value), for whether the map has a live splat when it inserts, and for the
plateau test only when `plateau_min_loss` > 0 (at the default 0 no loss
can fall below it, so the pass needs no read). Tracking, binning and the
fixed-size scatters make their own reads.

Random draws. `key` is an int64 [2] tensor (the JAX key's shape). Each
key seeds a CPU `torch.Generator`, whose numbers are copied to the device,
so the card and the CPU draw the same numbers; the step splits keys where
the JAX step does. The stream is not JAX's: a JAX key carried across seeds
a different sequence. `draws` replaces the source of every draw (tests
replay the JAX package's).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from gslam_tpu_torch import resolve_device, to_device
from gslam_tpu_torch.core.transforms import invert_se3
from gslam_tpu_torch.mapping import pruning
from gslam_tpu_torch.mapping.backend_ops import (
    MapConfig, PoseAdamState, _set_rows, eval_views, init_pose_adam,
    keyframe_decision_stats, mapping_step,
)
from gslam_tpu_torch.mapping.gaussians import (
    GaussianMap, compact_map, empty_map, grow_map, nonzero_fixed,
)
from gslam_tpu_torch.mapping.insertion import (
    InsertionConfig, densify_by_gradients, insert_draws, insert_from_depthmap,
    insertion_masks,
)
from gslam_tpu_torch.mapping.keyframes import KeyframeStore, add_keyframe, empty_keyframes
from gslam_tpu_torch.mapping.optimizer import MaskedAdamState, init_adam
from gslam_tpu_torch.tracking.track import (
    TrackingConfig, constant_motion_prior, track_frame_pyramid_impl,
)

__all__ = [
    "FusedConfig", "FusedState", "FusedSlam", "KeyDraws", "constant_motion_prior",
    "grow_fused_state", "init_fused_state", "ring_slot", "slam_chunk_unrolled",
    "slam_refine", "slam_refine_impl", "slam_scan", "slam_step", "slam_step_impl",
]


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    tracking: TrackingConfig = TrackingConfig()
    mapping: MapConfig = MapConfig()
    max_frames: int = 2048
    init_n_new: int = 5000  # bootstrap insertion
    kf_n_new: int = 100  # per-keyframe insertion
    idle_iters: int = 15  # mapping iterations per frame
    # cap on the bootstrap mapping iterations run inside frame 0's step; the
    # rest run as slam_refine passes of this length (0 = all in the step)
    init_iters_per_dispatch: int = 0
    compact_every: int = 32  # frames between live-slot compactions
    # host-triggered capacity doubling at sync points once live_count >=
    # grow_watermark * capacity, up to max_capacity (0 disables growth)
    max_capacity: int = 0
    grow_watermark: float = 0.85
    use_gt_depths: bool = False
    # "while" and "fori" are one loop here: the JAX package's two forms give
    # the same result by its own definition
    mapping_loop: str = "while"
    # abort at a sync point once this many guard rejections and non-finite
    # mapping losses have accumulated (0 disables)
    abort_unhealthy: int = 4

    @property
    def insertion(self) -> InsertionConfig:
        m = self.mapping
        return InsertionConfig(
            depth_variance=0.1 * m.initial_scale,
            no_depth_variance=0.2 * m.initial_scale,
            min_alpha_for_depth=0.1,
            initial_opacity=m.initial_opacity,
        )


class FusedState(NamedTuple):
    """Everything the SLAM iteration touches (see the module docstring for
    which leaves lie on the CPU)."""

    gmap: GaussianMap
    opt_state: MaskedAdamState
    kf: KeyframeStore
    pose_opt: PoseAdamState
    kf_count: torch.Tensor  # [] int32 keyframes added so far (CPU)
    frame_count: torch.Tensor  # [] int32 frames processed (CPU)
    traj: torch.Tensor  # [F, 4, 4] estimated world-to-camera per frame
    exposure_traj: torch.Tensor  # [F, 2]
    track_losses: torch.Tensor  # [F]
    kf_flags: torch.Tensor  # [F] bool: frame became a keyframe
    exposure: torch.Tensor  # [2] latest exposure (seeds the next frame)
    paused: torch.Tensor  # [] bool plateau pause, reset on keyframe (CPU)
    plateau_last: torch.Tensor  # [] f32 last mapping loss
    plateau_count: torch.Tensor  # [] int32 consecutive decreasing-low steps (CPU)
    total_map_iters: torch.Tensor  # [] int32 (CPU)
    max_pairs: torch.Tensor  # [] int32 overflow telemetry
    inserted_total: torch.Tensor  # [] int32 splats actually scattered
    dropped_total: torch.Tensor  # [] int32 candidates lost to a full buffer
    live_count: torch.Tensor  # [] int32 live splats (drives host-side growth)
    health: torch.Tensor  # [] int32 rejected tracks + non-finite mapping losses
    step_ema: torch.Tensor  # [] f32 EMA of per-frame camera translation
    innov_ema: torch.Tensor  # [] f32 EMA of accepted tracking innovations
    consec_rej: torch.Tensor  # [] int32 consecutive guard rejections
    kf_anchor: torch.Tensor  # [4, 4] tracked pose at the last keyframe event
    n_evals_traj: torch.Tensor  # [F] int32 tracking evals per frame
    kd_translation: torch.Tensor  # [F] keyframe-decision translation
    kd_median_depth: torch.Tensor  # [F] keyframe-decision median depth
    kd_cos_z: torch.Tensor  # [F] keyframe-decision view-axis cosine
    kf_vis: torch.Tensor  # [kf_cap, cap] bool per-keyframe splat visibility
    # ([kf_cap, 1] without PGO)
    adj: torch.Tensor  # [kf_cap, kf_cap] bool pose-graph adjacency over slots
    key: torch.Tensor  # [2] int64 PRNG key (CPU)


# leaves kept on the CPU whatever the state's device
HOST_FIELDS = ("kf_count", "frame_count", "paused", "plateau_count", "total_map_iters",
               "key")


def init_fused_state(
    cfg: FusedConfig, capacity: int, kf_capacity: int, height: int, width: int,
    seed: int = 0, device: str | torch.device | None = None,
) -> FusedState:
    """An empty state on `device` (CUDA unless the caller names one)."""
    dev = resolve_device(device)
    gmap = empty_map(capacity, device=dev)
    F = cfg.max_frames
    vis_cols = capacity if cfg.mapping.enable_pgo else 1
    f32 = dict(dtype=torch.float32, device=dev)

    def host(v, dtype):
        return torch.tensor(v, dtype=dtype)

    return FusedState(
        gmap=gmap,
        opt_state=init_adam(gmap),
        kf=empty_keyframes(kf_capacity, height, width, device=dev),
        pose_opt=init_pose_adam(kf_capacity, device=dev),
        kf_count=host(0, torch.int32),
        frame_count=host(0, torch.int32),
        traj=torch.eye(4, **f32).repeat(F, 1, 1),
        exposure_traj=torch.zeros((F, 2), **f32),
        track_losses=torch.zeros((F,), **f32),
        kf_flags=torch.zeros((F,), dtype=torch.bool, device=dev),
        exposure=torch.zeros((2,), **f32),
        paused=host(False, torch.bool),
        plateau_last=torch.tensor(float("inf"), **f32),
        plateau_count=host(0, torch.int32),
        total_map_iters=host(0, torch.int32),
        max_pairs=torch.zeros((), dtype=torch.int32, device=dev),
        inserted_total=torch.zeros((), dtype=torch.int32, device=dev),
        dropped_total=torch.zeros((), dtype=torch.int32, device=dev),
        live_count=torch.zeros((), dtype=torch.int32, device=dev),
        health=torch.zeros((), dtype=torch.int32, device=dev),
        step_ema=torch.zeros((), **f32),
        innov_ema=torch.zeros((), **f32),
        consec_rej=torch.zeros((), dtype=torch.int32, device=dev),
        kf_anchor=torch.eye(4, **f32),
        n_evals_traj=torch.zeros((F,), dtype=torch.int32, device=dev),
        kd_translation=torch.zeros((F,), **f32),
        kd_median_depth=torch.zeros((F,), **f32),
        kd_cos_z=torch.zeros((F,), **f32),
        kf_vis=torch.zeros((kf_capacity, vis_cols), dtype=torch.bool, device=dev),
        adj=torch.zeros((kf_capacity, kf_capacity), dtype=torch.bool, device=dev),
        # the JAX PRNGKey(seed): high and low 32 bits
        key=torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=torch.int64),
    )


def ring_slot(k: int, kf_cap: int) -> int:
    """Keyframe-store slot of the k-th keyframe (0-based). Slot 0 holds the
    bootstrap keyframe, the gauge anchor whose pose stays frozen, and is
    never evicted; later keyframes rotate through slots 1..kf_cap-1."""
    return 0 if k == 0 else 1 + (k - 1) % (kf_cap - 1)


def _generator(key: torch.Tensor) -> torch.Generator:
    k0, k1 = (int(x) for x in key)  # a CPU tensor: no wait for the device
    return torch.Generator().manual_seed(((k0 & 0xFFFFFFFF) << 32) | (k1 & 0xFFFFFFFF))


class KeyDraws:
    """The step's random draws from a key, through a CPU generator."""

    @staticmethod
    def split(key: torch.Tensor, n: int) -> torch.Tensor:
        """[n, 2] new keys."""
        return torch.randint(0, 2**32, (n, 2), generator=_generator(key), dtype=torch.int64)

    @staticmethod
    def normal(key: torch.Tensor, shape: tuple, device) -> torch.Tensor:
        return torch.randn(shape, generator=_generator(key)).to(device)

    @staticmethod
    def insertion(key: torch.Tensor, need: torch.Tensor, n_new: int):
        return insert_draws(_generator(key), need, n_new)


def _set_row(x: torch.Tensor, i: int, value) -> torch.Tensor:
    """A copy of x with row i set to value."""
    x = x.clone()
    x[i] = value
    return x


def _zeros_i32(dev):
    return torch.zeros((), dtype=torch.int32, device=dev)


def slam_step_impl(
    state: FusedState,
    image: torch.Tensor,  # [H, W, 3] on the state's device
    gt_depth: torch.Tensor,  # [H, W] (zeros when not RGB-D)
    K: torch.Tensor,  # [3, 3]
    width: int,
    height: int,
    cfg: FusedConfig,
    draws=KeyDraws,
) -> FusedState:
    """One frame. Returns a new state; the given one is left as it was."""
    mcfg = cfg.mapping
    tcfg = cfg.tracking
    kf_cap = state.kf.capacity
    i = int(state.frame_count)
    kf_count = int(state.kf_count)
    dev = state.traj.device

    # ---- tracking (constant-motion prior; skipped on the first frame) ----
    pa = state.traj[max(i - 2, 0)]
    pb = state.traj[max(i - 1, 0)]
    prior = constant_motion_prior(pa, pb) if i >= 2 else pb
    if i > 0:
        res = track_frame_pyramid_impl(
            state.gmap, prior, state.exposure, image, K, width, height, tcfg,
            gt_depth=gt_depth if cfg.use_gt_depths else None)
        pose, exposure, tloss, n_evals = res.pose, res.exposure, res.loss, res.n_evals
        rejected = torch.tensor(int(res.rejected), dtype=torch.int32, device=dev)
    else:
        pose, exposure, n_evals = prior, state.exposure, 0
        tloss = torch.zeros((), dtype=torch.float32, device=dev)
        rejected = _zeros_i32(dev)

    # ---- innovation-scaled plausibility gate (TrackingConfig.guard_*) ----
    # innov_ema tracks the typical accepted innovation (translation of the
    # refined pose off the motion prior); many times that, or a large
    # rotation off the prior, is a basin jump: fall back to the prior and
    # count a rejection. The bound grows with consecutive rejections, so a
    # genuine re-lock correction after dead reckoning is accepted.
    innov_ema, consec_rej = state.innov_ema, state.consec_rej
    if tcfg.guard_innov_mult > 0.0:
        delta = pose @ invert_se3(prior)
        innov = torch.linalg.norm(delta[:3, 3])
        cos_rot = (torch.trace(delta[:3, :3]) - 1.0) * 0.5
        bound = (torch.clamp(tcfg.guard_innov_mult * innov_ema, min=tcfg.guard_step_floor)
                 + consec_rej.to(torch.float32)
                 * torch.clamp(2.0 * innov_ema, min=0.5 * tcfg.guard_step_floor))
        implaus = ((innov > bound) | (cos_rot < math.cos(tcfg.guard_max_rot))) & (i >= 3)
        pose = torch.where(implaus, prior, pose)
        exposure = torch.where(implaus, state.exposure, exposure)
        rejected = rejected + implaus.to(torch.int32)
        if i >= 1:
            accepted = rejected == 0
            innov_ema = torch.where(
                accepted, torch.where(innov_ema == 0.0, innov, 0.8 * innov_ema + 0.2 * innov),
                innov_ema)
        consec_rej = torch.where(rejected > 0, consec_rej + 1,
                                 _zeros_i32(dev) if i >= 1 else consec_rej)

    # ---- keyframe decision ----
    last_slot = ring_slot(max(kf_count - 1, 0), kf_cap)
    prev_kf_pose = state.kf.poses()[last_slot]
    stats = keyframe_decision_stats(state.gmap, pose, prev_kf_pose, K, width, height, mcfg)
    # motion-adaptive trigger: a keyframe once the camera has moved kf_adapt
    # frames' worth of its own recent motion since the last keyframe event
    # (measured on the tracked poses); an EMA floor keeps a parked camera
    # from taking noise-triggered keyframes
    frame_step = torch.linalg.norm((pose @ invert_se3(state.traj[max(i - 1, 0)]))[:3, 3])
    if i <= 0:
        step_ema = state.step_ema
    elif i == 1:
        step_ema = frame_step
    else:
        step_ema = 0.9 * state.step_ema + 0.1 * frame_step
    moving = step_ema > 1e-3 * stats.median_depth
    anchor_tr = torch.linalg.norm((pose @ invert_se3(state.kf_anchor))[:3, 3])
    adaptive = moving & (anchor_tr > mcfg.kf_adapt * step_ema) & (mcfg.kf_adapt > 0.0)
    # never on a guard-rejected frame: splats inserted at a dead-reckoned
    # pose would poison the map when tracking most needs it clean
    take = i == 0 or bool(
        ((stats.translation > mcfg.kf_m * stats.median_depth)
         | (stats.cos_z < mcfg.kf_cos) | adaptive) & (rejected == 0))
    kf_anchor = pose if take else state.kf_anchor

    # ---- conditional insertion ----
    slot = ring_slot(kf_count, kf_cap)
    k_a, k_b, k_next = draws.split(state.key, 3)
    icfg = cfg.insertion
    gt_arg = gt_depth if cfg.use_gt_depths else None
    gmap, opt_state = state.gmap, state.opt_state
    n_ins = n_req = _zeros_i32(dev)
    if i == 0 or take:
        if i == 0:
            # mock noisy unit-depth bootstrap
            depth = (1.0 + (draws.normal(k_a, (height, width), dev) - 0.5) * 0.3) \
                * mcfg.initial_scale
            alpha = torch.full((height, width), 0.01, device=dev)
            n_new, occlusion = cfg.init_n_new, {}
        else:
            depth, alpha, n_new = stats.new_depth * mcfg.initial_scale, stats.new_alpha, \
                cfg.kf_n_new
            # the occlusion filter engages once a second keyframe exists:
            # the bootstrap keyframe's depth was rendered from an empty map
            occlusion = dict(kf_viewmats=state.kf.poses(), kf_est_depths=state.kf.est_depths,
                             kf_mask=state.kf.mask & (kf_count > 1))
        need = insertion_masks(depth, alpha, icfg, gt_arg)[1]
        r = insert_from_depthmap(
            draws.insertion(k_b, need, n_new), gmap, opt_state, depth, alpha, image, K,
            pose, n_new, i, icfg, gt_depthmap=gt_arg, **occlusion)
        gmap, opt_state, n_ins, n_req = r

    # ---- keyframe store write (ring eviction beyond capacity) ----
    kf, pose_opt, kf_vis, adj = state.kf, state.pose_opt, state.kf_vis, state.adj
    if take:
        kf = add_keyframe(kf, slot, image, pose, exposure, i, gt_depth=gt_depth,
                          est_depth=stats.new_depth)
        pose_opt = PoseAdamState(*(_set_row(x, slot, 0) for x in pose_opt))
        if mcfg.enable_pgo:
            # visibility snapshot and the consecutive-keyframe edge; the
            # overwritten slot loses its old edges first
            kf_vis = _set_row(kf_vis, slot, stats.new_visible)
            adj = adj.clone()
            adj[slot, :] = False
            adj[:, slot] = False
            adj[slot, last_slot] = adj[last_slot, slot] = kf_count > 0
        kf_count += 1

    ipd = cfg.init_iters_per_dispatch
    init_budget = min(mcfg.num_iters_init, ipd) if ipd else mcfg.num_iters_init
    n_iters = init_budget if i == 0 else cfg.idle_iters

    (gmap, opt_state, kf, pose_opt, paused, plast, pcnt, total_iters, max_pairs, kf_vis,
     adj, d_ins, d_req, k_next) = _mapping_phase(
        state, gmap, opt_state, kf, pose_opt, kf_count, kf_vis, adj, take, i, n_iters,
        k_next, K, width, height, cfg, draws, allow_compact=True)
    n_ins, n_req = n_ins + d_ins, n_req + d_req

    # health: guard rejections plus a non-finite mapping loss
    map_bad = (total_iters > int(state.total_map_iters)) & ~torch.isfinite(plast)
    health = state.health + rejected + map_bad.to(torch.int32)

    return state._replace(
        gmap=gmap, opt_state=opt_state, kf=kf, pose_opt=pose_opt,
        kf_count=torch.tensor(kf_count, dtype=torch.int32),
        frame_count=torch.tensor(i + 1, dtype=torch.int32),
        traj=_set_row(state.traj, i, pose),
        exposure_traj=_set_row(state.exposure_traj, i, exposure),
        track_losses=_set_row(state.track_losses, i, tloss),
        kf_flags=_set_row(state.kf_flags, i, take),
        exposure=exposure,
        paused=paused, plateau_last=plast, plateau_count=pcnt,
        total_map_iters=torch.tensor(total_iters, dtype=torch.int32),
        max_pairs=max_pairs,
        inserted_total=state.inserted_total + n_ins,
        dropped_total=state.dropped_total + (n_req - n_ins),
        live_count=torch.sum(gmap.alive.to(torch.int32)),
        health=health,
        step_ema=step_ema, innov_ema=innov_ema, consec_rej=consec_rej,
        kf_anchor=kf_anchor,
        n_evals_traj=_set_row(state.n_evals_traj, i, n_evals),
        kd_translation=_set_row(state.kd_translation, i, stats.translation),
        kd_median_depth=_set_row(state.kd_median_depth, i, stats.median_depth),
        kd_cos_z=_set_row(state.kd_cos_z, i, stats.cos_z),
        kf_vis=kf_vis, adj=adj,
        key=k_next,
    )


def _window(kf_count: int, kf_cap: int, n_recent: int):
    """Slots and mask of the last `n_recent` keyframes still resident: the
    anchor (ordinal 0) or among the last kf_cap-1 (host lists)."""
    ki = [kf_count - 1 - o for o in range(n_recent)]
    mask = [k >= 0 and (k == 0 or k >= kf_count - (kf_cap - 1)) for k in ki]
    slots = [ring_slot(max(k, 0), kf_cap) if m else 0 for k, m in zip(ki, mask)]
    return slots, mask


def _mapping_phase(
    state: FusedState,
    gmap, opt_state, kf, pose_opt, kf_count: int, kf_vis, adj,
    take: bool, i: int, n_iters: int, key,
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: FusedConfig,
    draws=KeyDraws,
    allow_compact: bool = True,
):
    """Windowed map optimization, densify, prune, loop closure and
    compaction, shared by the per-frame step and the idle refine step.
    Returns the updated buffers, the densify insert/request counts and the
    advanced key."""
    mcfg = cfg.mapping
    kf_cap = kf.capacity
    dev = gmap.means.device

    # ---- optimization window: the last window_size keyframes; with PGO
    # the last recent_window plus the newest keyframe's graph neighbours
    # (the first ones, as the JAX package picks them) ----
    n_recent = mcfg.recent_window if mcfg.enable_pgo else mcfg.window_size
    rslots, rmask = _window(kf_count, kf_cap, n_recent)
    widx = torch.tensor(rslots, dtype=torch.int64, device=dev)
    wmask = torch.tensor(rmask, dtype=torch.bool, device=dev)
    if mcfg.enable_pgo:
        newest = ring_slot(max(kf_count - 1, 0), kf_cap)
        in_recent = torch.zeros(kf_cap, dtype=torch.bool, device=dev)
        in_recent = _set_rows(in_recent, widx, wmask, torch.ones_like(wmask))
        cand = adj[newest] & ~in_recent & kf.mask
        extra = nonzero_fixed(cand, mcfg.window_size - n_recent, kf_cap)
        emask = extra < kf_cap
        widx = torch.cat([widx, torch.where(emask, extra, 0)])
        wmask = torch.cat([wmask, emask])

    # ---- mapping pass with the plateau rule ----
    paused = bool(state.paused) and not take  # keyframes resume optimization
    plast, pcnt, mp = state.plateau_last, int(state.plateau_count), state.max_pairs
    aux, it = None, 0
    while it < n_iters and not paused:
        gmap, opt_state, kf, pose_opt, aux = mapping_step(
            gmap, opt_state, kf, pose_opt, widx, wmask, K, width, height, mcfg)
        loss = aux.photometric_loss
        # StopOnPlateau: low loss and still decreasing for `patience` steps.
        # No loss is below a threshold <= 0, so then nothing is read.
        low = dec = False
        if mcfg.plateau_min_loss > 0.0:
            low, dec = torch.stack([loss < mcfg.plateau_min_loss, plast > loss]).tolist()
        pcnt = pcnt + 1 if (low and dec) else 0
        paused = paused or (low and pcnt >= mcfg.plateau_patience)
        plast = loss
        mp = torch.maximum(mp, torch.max(aux.n_pairs).to(torch.int32))
        it += 1
    # the last iteration's radii (zeros when no iteration ran, as JAX's carry)
    radii = (torch.zeros((widx.shape[0], gmap.capacity), device=dev) if aux is None
             else aux.radii)
    total_iters = int(state.total_map_iters) + it

    # ---- gradient densification: fires when this pass crossed a multiple
    # of densify_every steps, on the final iteration's dL/dmeans2d ----
    densified = False
    d_ins = d_req = _zeros_i32(dev)
    k_next = key
    if mcfg.densify_every > 0:
        k_dens, k_next = draws.split(k_next, 2)
        densified = it > 0 and (int(state.total_map_iters) // mcfg.densify_every
                                != total_iters // mcfg.densify_every)
        if densified:
            gmap, opt_state, d_ins, d_req = densify_by_gradients(
                draws.normal(k_dens, (mcfg.densify_max_new, 3), dev), gmap, opt_state,
                aux.means2d_grad, width, height, mcfg.densify_max_new, i,
                grow_grad2d=mcfg.grow_grad2d, grow_scale3d=mcfg.grow_scale3d)

    # ---- pruning: only after a real pass, never right after densifying ----
    if it > 0 and not densified:
        remove = pruning.low_opacity_mask(gmap, mcfg.opacity_prune_threshold)
        remove = remove | pruning.large_radius_mask(torch.amax(radii, dim=0),
                                                    mcfg.size_prune_threshold)
        if mcfg.enable_visibility_pruning:
            remove = remove | pruning.ill_conditioned_mask(
                radii[: mcfg.recent_window], aux.n_touched[: mcfg.recent_window],
                mcfg.min_visibility_views)
        gmap = pruning.apply_prune(gmap, remove)

    if mcfg.enable_pgo:
        # the window keyframes' visibility from the final iteration, then
        # covisibility loop-closure edges by IoU > kf_cov over resident pairs
        kf_vis = _set_rows(kf_vis, widx, wmask, radii > 0)
        if take:
            vf = kf_vis.to(torch.float32)
            inter = vf @ vf.T
            counts = torch.sum(vf, dim=1)
            iou = inter / torch.clamp(counts[:, None] + counts[None, :] - inter, min=1.0)
            valid = kf.mask[:, None] & kf.mask[None, :]
            eye = torch.eye(kf_cap, dtype=torch.bool, device=dev)
            adj = adj | ((iou > mcfg.kf_cov) & valid & ~eye)

    # periodic live-slot compaction; kf_vis columns are per slot, so they
    # ride the same permutation
    if cfg.compact_every > 0 and allow_compact and (i + 1) % cfg.compact_every == 0:
        gmap, opt_state, order = compact_map(gmap, opt_state, return_order=True)
        if mcfg.enable_pgo:
            kf_vis = kf_vis[:, order]

    return (gmap, opt_state, kf, pose_opt, torch.tensor(paused),
            plast, torch.tensor(pcnt, dtype=torch.int32), total_iters, mp, kf_vis, adj,
            d_ins, d_req, k_next)


def slam_refine_impl(
    state: FusedState,
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: FusedConfig,
    n_iters: int,
    draws=KeyDraws,
) -> FusedState:
    """Idle-time map refinement: one mapping pass of at most `n_iters` over
    the current keyframe window; no frame is consumed. FusedSlam.run also
    spreads the bootstrap optimization over such passes when
    `init_iters_per_dispatch` is set."""
    (gmap, opt_state, kf, pose_opt, paused, plast, pcnt, total_iters, max_pairs, kf_vis,
     adj, d_ins, d_req, k_next) = _mapping_phase(
        state, state.gmap, state.opt_state, state.kf, state.pose_opt,
        int(state.kf_count), state.kf_vis, state.adj, False, int(state.frame_count),
        n_iters, state.key, K, width, height, cfg, draws, allow_compact=False)
    return state._replace(
        gmap=gmap, opt_state=opt_state, kf=kf, pose_opt=pose_opt,
        paused=paused, plateau_last=plast, plateau_count=pcnt,
        total_map_iters=torch.tensor(total_iters, dtype=torch.int32), max_pairs=max_pairs,
        inserted_total=state.inserted_total + d_ins,
        dropped_total=state.dropped_total + (d_req - d_ins),
        live_count=torch.sum(gmap.alive.to(torch.int32)),
        kf_vis=kf_vis, adj=adj, key=k_next,
    )


def grow_fused_state(state: FusedState, new_capacity: int) -> FusedState:
    """Host-triggered splat-capacity growth: live slots compacted to the
    front, the buffer, its Adam moments and (with PGO) the per-keyframe
    visibility columns permuted alike, then padded with dead slots."""
    gmap, opt, order = compact_map(state.gmap, state.opt_state, return_order=True)
    kf_vis = state.kf_vis
    if kf_vis.shape[1] > 1:  # PGO: per-slot visibility columns
        pad = torch.zeros((kf_vis.shape[0], new_capacity - kf_vis.shape[1]),
                          dtype=torch.bool, device=kf_vis.device)
        kf_vis = torch.cat([kf_vis[:, order], pad], dim=1)
    gmap, opt = grow_map(gmap, opt, new_capacity)
    return state._replace(gmap=gmap, opt_state=opt, kf_vis=kf_vis)


def _device(state: FusedState) -> torch.device:
    return state.traj.device


def slam_step(state: FusedState, image, gt_depth, K, width: int, height: int,
              cfg: FusedConfig, draws=KeyDraws) -> FusedState:
    """slam_step_impl with the frame (tensors or numpy) moved to the
    state's device."""
    dev = _device(state)
    return slam_step_impl(state, to_device(image, dev), to_device(gt_depth, dev),
                          to_device(K, dev), width, height, cfg, draws)


def slam_refine(state: FusedState, K, width: int, height: int, cfg: FusedConfig,
                n_iters: int, draws=KeyDraws) -> FusedState:
    return slam_refine_impl(state, to_device(K, _device(state)), width, height, cfg,
                            n_iters, draws)


def slam_scan(state: FusedState, images, gt_depths, K, width: int, height: int,
              cfg: FusedConfig, draws=KeyDraws) -> FusedState:
    """A chunk of frames ([C, H, W, 3], [C, H, W]), one step after another."""
    dev = _device(state)
    images, gt_depths, K = (to_device(x, dev) for x in (images, gt_depths, K))
    for j in range(images.shape[0]):
        state = slam_step_impl(state, images[j], gt_depths[j], K, width, height, cfg, draws)
    return state


# the JAX package's two chunk programs (lax.scan and unrolled) are one loop here
slam_chunk_unrolled = slam_scan


class FusedSlam:
    """Host loop around the fused step: streams frames in, reads the
    health counter (and live_count when growth is on) every `sync_every`
    frames, and reads the results back at the end."""

    def __init__(self, cfg: FusedConfig, width: int, height: int,
                 capacity: int = 2**17, kf_capacity: int = 32, seed: int = 0,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.width, self.height = width, height
        self.capacity, self.kf_capacity = capacity, kf_capacity
        self.seed = seed
        self.device = device

    def run(self, dataset, chunk: int = 16, eval_stride: int = 0,
            sync_every: int = 8, resume_from=None,
            checkpoint_every: int = 0, checkpoint_path=None,
            chunk_backend: str = "scan") -> dict:
        """chunk > 1 buffers frames and folds them with `slam_scan`
        (`chunk_backend` "scan" or "unroll": one loop here); chunk == 1 steps
        each frame as it arrives, and with `init_iters_per_dispatch` spreads
        the bootstrap over slam_refine passes. Every `sync_every` frames the
        host checks the health counter (abort at cfg.abort_unhealthy), grows
        the buffer when cfg.max_capacity allows, and writes a checkpoint
        when `checkpoint_every` frames have passed since the last. Runs on
        the FusedSlam's device (CUDA unless one was named)."""
        from gslam_tpu_torch.runtime.checkpoint import (
            load_fused_checkpoint, save_fused_checkpoint,
        )

        if chunk_backend not in ("scan", "unroll"):
            raise ValueError(f"chunk_backend must be 'scan' or 'unroll', "
                             f"got {chunk_backend!r}")
        dev = resolve_device(self.device)
        H, W = self.height, self.width
        try:
            n_ds = len(dataset)
        except TypeError:
            n_ds = None
        if n_ds is not None and n_ds > self.cfg.max_frames:
            raise ValueError(
                f"dataset has {n_ds} frames but cfg.max_frames={self.cfg.max_frames}; "
                "trajectory buffers would silently truncate: raise FusedConfig.max_frames")
        if resume_from:
            state, resumed_meta = load_fused_checkpoint(resume_from, self.cfg, dev)
            self.capacity = state.gmap.capacity
            skip_below = len(resumed_meta)
            print(f"[fused] resumed at frame {skip_below} (capacity {self.capacity}) "
                  f"from {resume_from}", flush=True)
        else:
            state = init_fused_state(self.cfg, self.capacity, self.kf_capacity, H, W,
                                     self.seed, dev)
            resumed_meta, skip_below = [], 0
        K = to_device(dataset.camera.K, dev)

        frames_meta = list(resumed_meta)  # (index, timestamp, gt_pose)
        since_ckpt = 0
        t_start = time.time()
        buf_imgs, buf_depths = [], []
        unsynced = 0

        def maybe_grow():
            nonlocal state
            if not self.cfg.max_capacity:
                return
            cap = state.gmap.capacity
            if cap >= self.cfg.max_capacity:
                return
            live = int(state.live_count)
            if live >= self.cfg.grow_watermark * cap:
                new_cap = min(cap * 2, self.cfg.max_capacity)
                state = grow_fused_state(state, new_cap)
                print(f"[fused] grew capacity {cap} -> {new_cap} (live {live})", flush=True)

        def maybe_checkpoint():
            nonlocal since_ckpt
            if checkpoint_every and checkpoint_path and since_ckpt >= checkpoint_every:
                save_fused_checkpoint(checkpoint_path, state, frames_meta)
                since_ckpt = 0
                print(f"[fused] checkpoint @ frame {len(frames_meta)} -> {checkpoint_path}",
                      flush=True)

        def check_health(fc):
            # a growing counter means the plausibility gate keeps firing (or
            # the map went non-finite): stop instead of running blind
            if not self.cfg.abort_unhealthy:
                return
            h = int(state.health)
            if h > 0:
                print(f"[fused] health counter {h} at frame {fc}", flush=True)
            if h >= self.cfg.abort_unhealthy:
                raise RuntimeError(
                    f"aborting: health counter reached {h} (>= {self.cfg.abort_unhealthy}) "
                    f"at frame {fc}: tracking guard rejections / non-finite mapping losses")

        def sync():
            fc = int(state.frame_count)
            print(f"[fused] frame {fc} synced at {time.time() - t_start:.1f}s", flush=True)
            check_health(fc)
            maybe_grow()
            maybe_checkpoint()

        def flush():
            nonlocal state, buf_imgs, buf_depths, unsynced
            if not buf_imgs:
                return
            state = slam_scan(state, np.stack(buf_imgs), np.stack(buf_depths), K, W, H,
                              self.cfg)
            unsynced += len(buf_imgs)
            buf_imgs, buf_depths = [], []
            if sync_every and unsynced >= sync_every:
                unsynced = 0
                sync()

        zeros_depth = np.zeros((H, W), np.float32)
        for frame in iter(dataset):
            if frame.index < skip_below:
                continue  # already folded into the resumed state
            frames_meta.append((frame.index, frame.timestamp, frame.gt_pose))
            since_ckpt += 1
            if len(frames_meta) > self.cfg.max_frames:
                raise ValueError(f"stream exceeded cfg.max_frames={self.cfg.max_frames}; "
                                 "trajectory buffers would silently truncate")
            depth = (np.asarray(frame.gt_depth, np.float32)
                     if frame.gt_depth is not None else zeros_depth)
            if chunk <= 1:
                state = slam_step(state, np.asarray(frame.image, np.float32), depth, K,
                                  W, H, self.cfg)
                ipd = self.cfg.init_iters_per_dispatch
                if frame.index == 0 and ipd:
                    done = min(ipd, self.cfg.mapping.num_iters_init)
                    while done < self.cfg.mapping.num_iters_init:
                        state = slam_refine(state, K, W, H, self.cfg, ipd)
                        done += ipd
                    print(f"[fused] bootstrap refined to {done} iters at "
                          f"{time.time() - t_start:.1f}s", flush=True)
                if sync_every and (frame.index == 0
                                   or frame.index % sync_every == sync_every - 1):
                    sync()
            else:
                buf_imgs.append(np.asarray(frame.image, np.float32))
                buf_depths.append(depth)
                if len(buf_imgs) >= chunk:
                    flush()
        flush()
        t_enqueue = time.time() - t_start

        n = len(frames_meta)
        traj = state.traj[:n].cpu().numpy()
        wall = time.time() - t_start
        finite_mask = np.isfinite(traj.reshape(n, -1)).all(axis=1)
        health = int(state.health)
        metrics = {
            "L": n,
            "C": int(state.kf_count),
            "N": int(state.gmap.n_live()),
            "capacity": int(state.gmap.capacity),
            "wall_s": wall,
            "enqueue_s": t_enqueue,
            "fps_wall": n / wall if wall > 0 else 0.0,
            "total_map_iters": int(state.total_map_iters),
            "max_pairs_seen": int(state.max_pairs),
            "inserted_total": int(state.inserted_total),
            "dropped_inserts": int(state.dropped_total),
            "health": health,
            "nonfinite_poses": int(np.sum(~finite_mask)),
            # a transient guard rejection is the recovery working; only the
            # abort threshold (or a non-finite pose) marks a diverged run
            "diverged": bool((~finite_mask).any()
                             or (health >= self.cfg.abort_unhealthy
                                 if self.cfg.abort_unhealthy else health > 0)),
            **({"n_pgo_edges": int(torch.sum(state.adj)) // 2}
               if self.cfg.mapping.enable_pgo else {}),
            "track_losses_mean": float(state.track_losses[1:n].mean()) if n > 1 else 0.0,
            "mean_track_evals": float(state.n_evals_traj[1:n].float().mean())
            if n > 1 else 0.0,
            "kf_frames": np.nonzero(state.kf_flags[:n].cpu().numpy())[0].tolist(),
        }
        # per-frame decision telemetry
        self.telemetry = {
            name: getattr(state, field)[:n].cpu().numpy()
            for name, field in (("track_losses", "track_losses"), ("n_evals", "n_evals_traj"),
                                ("kd_translation", "kd_translation"),
                                ("kd_median_depth", "kd_median_depth"),
                                ("kd_cos_z", "kd_cos_z"), ("kf_flags", "kf_flags"),
                                ("exposure_traj", "exposure_traj"))
        }

        gt = [m[2] for m in frames_meta]
        if all(g is not None for g in gt) and n >= 2 and finite_mask.sum() >= 2:
            from gslam_tpu_torch.eval.trajectory import (
                ate_mean, ate_rmse, trajectory_positions,
            )

            gt_t = trajectory_positions(np.stack([np.asarray(g) for g in gt]))
            est_t = trajectory_positions(traj)
            # score the finite frames only (nonfinite_poses counts the rest)
            gt_f, est_f = gt_t[finite_mask], est_t[finite_mask]
            metrics["ate"] = float(ate_mean(gt_f, est_f))
            metrics["ate_rmse"] = float(ate_rmse(gt_f, est_f))
        self.final_state = state
        self.trajectory = traj

        if eval_stride:
            self._evaluate_renders(dataset, traj, eval_stride, metrics)
        return metrics

    def _evaluate_renders(self, dataset, traj, stride, metrics, batch: int = 16):
        """PSNR/SSIM of every stride-th frame re-rendered from the final map,
        `batch` views per render."""
        dev = _device(self.final_state)
        K = to_device(dataset.camera.K, dev)
        poses, imgs = [], []
        for frame in iter(dataset):
            if frame.index % stride != 0 or frame.index >= len(traj):
                continue
            poses.append(traj[frame.index])
            imgs.append(np.asarray(frame.image, np.float32))
        psnrs, ssims = [], []
        for c0 in range(0, len(poses), batch):
            ps, ss = eval_views(
                self.final_state.gmap, to_device(np.stack(poses[c0:c0 + batch]), dev),
                to_device(np.stack(imgs[c0:c0 + batch]), dev), K, self.width, self.height,
                self.cfg.mapping)
            psnrs.extend(ps.tolist())
            ssims.extend(ss.tolist())
        if psnrs:
            metrics["psnr"] = float(np.mean(psnrs))
            metrics["ssim"] = float(np.mean(ssims))
