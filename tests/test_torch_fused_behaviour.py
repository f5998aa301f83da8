"""Behaviours of the port's fused SLAM loop on the CPU, one test for each of
tests/test_fused.py's: the anchor keyframe is never evicted, the overflow
counters, PGO and densification, capacity growth and the kf_vis
permutation, the NaN-frame fallback, the unhealthy abort, and the kf_adapt
and kf_cos keyframe triggers."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu_torch.mapping.backend_ops import MapConfig  # noqa: E402
from gslam_tpu_torch.runtime.fused import FusedSlam, grow_fused_state  # noqa: E402

from test_torch_fused import CPU, RCFG, small_fused_cfg, walk  # noqa: E402


def mapping(**kw):
    return MapConfig(render=RCFG, **kw)


def test_fused_ring_never_evicts_anchor():
    """More keyframes than the 4 slots: the bootstrap keyframe (the gauge
    anchor) stays in slot 0 with an untouched pose delta; later keyframes
    rotate through slots 1-3."""
    cfg = small_fused_cfg(mapping=mapping(window_size=3, recent_window=3, num_iters_init=20,
                                          num_iters_mapping=3, kf_m=0.01))
    slam = FusedSlam(cfg, 64, 48, capacity=2048, kf_capacity=4, seed=0, device=CPU)
    m = slam.run(walk(10, 64, 48, 400, seed=5, motion_scale=0.06), chunk=1, sync_every=0)
    assert m["C"] > 4, f"needs the ring to wrap: {m}"
    kf = slam.final_state.kf
    assert int(kf.frame_idx[0]) == 0
    assert not kf.d_rot6[0].any() and not kf.d_t[0].any()
    assert all(int(f) != 0 for f in kf.frame_idx[1:])


def test_fused_overflow_counters():
    """A buffer too small for the bootstrap reports dropped candidates."""
    slam = FusedSlam(small_fused_cfg(max_frames=8), 64, 48, capacity=128, kf_capacity=8,
                     seed=0, device=CPU)
    m = slam.run(walk(3, 64, 48, 400, seed=4, motion_scale=0.01), chunk=1, sync_every=0)
    assert m["inserted_total"] <= 128
    assert m["dropped_inserts"] > 0, m
    assert m["inserted_total"] + m["dropped_inserts"] >= 400


def test_fused_pgo_and_densify():
    """With PGO, covisibility loop-closure edges join non-consecutive
    keyframes, the window fans out over graph neighbours, compactions every
    2 frames permute kf_vis, and gradient densification adds splats that a
    run without it does not."""
    ds = walk(6, 64, 48, 400, seed=5, motion_scale=0.04)
    common = dict(window_size=4, recent_window=2, num_iters_init=20, num_iters_mapping=4,
                  kf_m=0.01, enable_pgo=True)
    cfg = small_fused_cfg(compact_every=2, mapping=mapping(
        densify_every=20, densify_max_new=64, grow_grad2d=1e-8, **common))
    m = FusedSlam(cfg, 64, 48, capacity=2048, kf_capacity=8, seed=0,
                  device=CPU).run(ds, chunk=1, sync_every=0)
    assert m["C"] >= 4, m
    assert m["n_pgo_edges"] > m["C"] - 1, m  # more than the consecutive chain
    cfg_nd = small_fused_cfg(mapping=mapping(densify_every=0, **common))
    m2 = FusedSlam(cfg_nd, 64, 48, capacity=2048, kf_capacity=8, seed=0,
                   device=CPU).run(ds, chunk=1, sync_every=0)
    assert m["inserted_total"] > m2["inserted_total"], (m, m2)


def test_fused_capacity_growth():
    """A run that overfills its buffer grows it at a sync point and finishes
    at the larger capacity."""
    cfg = small_fused_cfg(
        init_n_new=700, kf_n_new=200, max_capacity=4096,
        mapping=mapping(window_size=4, recent_window=2, num_iters_init=20,
                        num_iters_mapping=4, kf_m=0.02, enable_pgo=True))
    m = FusedSlam(cfg, 64, 48, capacity=512, kf_capacity=8, seed=0,
                  device=CPU).run(walk(6, 64, 48, 400), chunk=1, sync_every=2)
    assert m["capacity"] > 512, m
    assert m["C"] >= 2, m
    assert np.isfinite(m["ate"]), m


def test_grow_fused_state_permutes_kf_vis():
    """grow_fused_state carries each surviving splat's visibility column
    (matched by its unique mean) through the compaction; padded slots are
    invisible."""
    cfg = small_fused_cfg(init_n_new=200, kf_n_new=50, mapping=mapping(
        window_size=3, recent_window=3, num_iters_init=15, num_iters_mapping=3, kf_m=0.01,
        enable_pgo=True))
    slam = FusedSlam(cfg, 64, 48, capacity=512, kf_capacity=4, seed=0, device=CPU)
    slam.run(walk(6, 64, 48, 400, seed=5, motion_scale=0.03), chunk=1, sync_every=0)
    st = slam.final_state
    assert st.kf_vis.any(), "needs nonzero visibility"
    grown = grow_fused_state(st, 1024)
    assert grown.gmap.capacity == 1024 and grown.kf_vis.shape == (4, 1024)
    pre_alive, post_alive = st.gmap.alive.numpy(), grown.gmap.alive.numpy()
    assert pre_alive.sum() == post_alive.sum()
    post_means = grown.gmap.means.numpy()
    post_idx = {tuple(post_means[j]): j for j in np.nonzero(post_alive)[0]}
    pre_vis, post_vis = st.kf_vis.numpy(), grown.kf_vis.numpy()
    pre_means = st.gmap.means.numpy()
    for i in np.nonzero(pre_alive)[0]:
        np.testing.assert_array_equal(pre_vis[:, i], post_vis[:, post_idx[tuple(pre_means[i])]])
    assert not post_vis[:, 512:].any()


def test_fused_nan_frame_survives_with_fallback():
    """A frame of NaNs: the tracking guard falls back to the motion prior,
    the health counter counts it, and every pose stays finite."""
    ds = walk(6, 64, 48, 400, seed=4, motion_scale=0.01)
    ds.images = ds.images.copy()
    ds.images[3] = np.nan
    slam = FusedSlam(small_fused_cfg(max_frames=8), 64, 48, capacity=1024, kf_capacity=8,
                     seed=0, device=CPU)
    m = slam.run(ds, chunk=1, sync_every=0)
    assert np.isfinite(slam.trajectory).all()
    assert m["health"] >= 1
    assert m["diverged"] is False  # one recovered rejection is not divergence
    assert m["nonfinite_poses"] == 0
    assert 3 not in m["kf_frames"]  # never a keyframe on a rejected frame


def test_fused_host_abort_on_unhealthy():
    """The sync-point read aborts a doomed run once the health counter
    reaches the threshold."""
    ds = walk(8, 64, 48, 400, seed=4, motion_scale=0.01)
    ds.images = ds.images.copy()
    ds.images[2:6] = np.nan
    slam = FusedSlam(small_fused_cfg(max_frames=8, abort_unhealthy=2), 64, 48,
                     capacity=1024, kf_capacity=8, seed=0, device=CPU)
    with pytest.raises(RuntimeError, match="health counter"):
        slam.run(ds, chunk=1, sync_every=2)


def test_keyframes_trigger_via_kf_adapt():
    """The motion-adaptive trigger (MapConfig.kf_adapt, at its default) alone
    takes keyframes on a ~1.2 cm/frame walk: with the translation and angle
    rules switched off (kf_m = 10, kf_cos = -1) the run still takes a
    keyframe every 2-3 frames of motion. (Without kf_adapt it takes only the
    bootstrap's.) The JAX test runs the default config and asserts that the
    fixed kf_m rule never fires; on the port's random stream the mapping
    moves the keyframe poses so that it fires at some frames, so here the
    other rules are switched off instead."""
    cfg = small_fused_cfg(max_frames=10, mapping=mapping(
        window_size=4, recent_window=4, num_iters_init=40, num_iters_mapping=5, kf_m=10.0,
        kf_cos=-1.0))
    assert cfg.mapping.kf_adapt == MapConfig().kf_adapt == 2.5
    slam = FusedSlam(cfg, 64, 48, capacity=2048, kf_capacity=8, seed=0, device=CPU)
    m = slam.run(walk(10, 64, 48, 400, seed=5, motion_scale=0.012), chunk=1, sync_every=0)
    assert m["C"] >= 3, m
    gaps = np.diff(m["kf_frames"])
    assert 0 in m["kf_frames"] and gaps.min() >= 2 and gaps.max() <= 4, m["kf_frames"]


def test_kf_cos_angle_rule_fires_on_pure_rotation():
    """keyframe_decision_stats on a 7 degree pan in place reports cos_z below
    cos(pi/30) (the angle rule fires) while the translation rule does not;
    a 3 degree pan fires neither."""
    from gslam_tpu_torch.core.transforms import so3_exp
    from gslam_tpu_torch.mapping.backend_ops import keyframe_decision_stats
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy

    rng = np.random.default_rng(3)
    cap, W, H = 256, 64, 48
    z = rng.uniform(0.8, 2.0, cap).astype(np.float32)
    gmap = gaussian_map_from_numpy(dict(
        means=np.stack([rng.normal(0, 0.5, cap), rng.normal(0, 0.4, cap), z], -1),
        quats=np.tile([1.0, 0, 0, 0], (cap, 1)), log_scales=np.full((cap, 3), np.log(0.06)),
        logit_opacities=rng.normal(1.0, 0.3, cap), logit_colors=rng.normal(0, 1, (cap, 3)),
        log_uncertainties=np.zeros(cap), alive=np.ones(cap, bool)), device=CPU)
    K = torch.tensor([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]])
    cfg = MapConfig(window_size=4, recent_window=4, render=RCFG)

    def pan(deg):
        p = torch.eye(4)
        p[:3, :3] = so3_exp(torch.tensor([0.0, math.radians(deg), 0.0]))
        return p

    stats = keyframe_decision_stats(gmap, pan(7.0), torch.eye(4), K, W, H, cfg)
    assert float(stats.translation) < 1e-5
    assert float(stats.cos_z) < cfg.kf_cos, stats.cos_z
    assert float(stats.translation) < cfg.kf_m * float(stats.median_depth)
    s2 = keyframe_decision_stats(gmap, pan(3.0), torch.eye(4), K, W, H, cfg)
    assert float(s2.cos_z) > cfg.kf_cos, s2.cos_z
