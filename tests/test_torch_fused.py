"""The port's fused SLAM loop (gslam_tpu_torch/runtime/fused.py) on the CPU:
tests/test_fused.py's end-to-end run and its "two runs give the same state"
cases, on the port. The behaviours of its other tests are in
tests/test_torch_fused_behaviour.py.

The port runs every variant through the same per-frame loop (the JAX
package's scan, unrolled, fori and while programs are one Python loop), so
where JAX's tests hold two programs to float tolerance, these hold the
port's runs to equal bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu_torch.io.synthetic import SyntheticDataset  # noqa: E402
from gslam_tpu_torch.mapping.backend_ops import MapConfig  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig  # noqa: E402
from gslam_tpu_torch.runtime.fused import FusedConfig, FusedSlam  # noqa: E402
from gslam_tpu_torch.tracking.track import TrackingConfig  # noqa: E402

CPU = "cpu"
RCFG = RenderConfig(tile_capacity=64, pairs_per_gaussian=8)


def small_fused_cfg(**kw):
    """tests/test_fused.py's small configuration."""
    base = dict(
        tracking=TrackingConfig(warmup_steps=5, lbfgs_max_iter=10, lbfgs_max_eval=12,
                                render=RCFG),
        mapping=MapConfig(window_size=4, recent_window=4, num_iters_init=40,
                          num_iters_mapping=5, render=RCFG),
        max_frames=16, init_n_new=400, kf_n_new=50, idle_iters=5,
    )
    base.update(kw)
    return FusedConfig(**base)


def walk(seq_len=8, width=80, height=60, n_splats=600, seed=3, motion_scale=0.015):
    return SyntheticDataset(seq_len=seq_len, width=width, height=height, n_splats=n_splats,
                            seed=seed, motion_scale=motion_scale, device=CPU)


def test_fused_slam_end_to_end():
    """tests/test_fused.py's end-to-end run at its size: chunked, keyframes
    trigger, the map grows, and ATE stays under the JAX test's 0.06."""
    cfg = small_fused_cfg(
        init_n_new=1500,
        mapping=MapConfig(window_size=4, recent_window=4, num_iters_init=40,
                          num_iters_mapping=5, kf_m=0.04, render=RCFG))
    m = FusedSlam(cfg, 80, 60, capacity=4096, kf_capacity=8, seed=0,
                  device=CPU).run(walk(), chunk=4, eval_stride=4)
    assert m["L"] == 8
    assert m["C"] >= 2, m
    assert m["N"] > 100, m
    assert np.isfinite(m["ate"]) and m["ate"] < 0.06, m
    assert m["total_map_iters"] == 40 + 7 * 5
    assert 0 in m["kf_frames"]
    assert m["dropped_inserts"] == 0 and m["inserted_total"] >= 1500
    assert np.isfinite(m["psnr"]) and 0.0 < m["ssim"] <= 1.0


# ---------------------------------------------------------------- equal runs

EQ_KW = dict(init_n_new=800, max_frames=8,
             mapping=MapConfig(window_size=4, recent_window=4, num_iters_init=30,
                               num_iters_mapping=5, kf_m=0.04, render=RCFG))


@pytest.fixture(scope="module")
def eq_scene():
    ds = walk(seq_len=6, width=64, height=48, n_splats=400)
    slam = FusedSlam(small_fused_cfg(**EQ_KW), 64, 48, capacity=2048, kf_capacity=8,
                     seed=0, device=CPU)
    return ds, slam, slam.run(ds, chunk=1, sync_every=0)


def _same_run(a, ma, b, mb):
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    for k in ("C", "N", "total_map_iters", "kf_frames", "inserted_total", "ate"):
        assert ma[k] == mb[k], k
    np.testing.assert_array_equal(a.final_state.gmap.means.numpy(),
                                  b.final_state.gmap.means.numpy())


@pytest.mark.parametrize("case", ["fori", "chunk", "unroll", "init_split", "resume"])
def test_fused_runs_agree(eq_scene, case, tmp_path):
    """Each variant against the per-frame run (chunk=1, mapping_loop
    "while", the whole bootstrap in frame 0, no checkpoint):
      fori: mapping_loop "fori";  chunk: frames folded 4 at a time;
      unroll: chunk_backend "unroll", 3 at a time;  resume: a run that
      checkpoints at its sync points, and a fresh FusedSlam resumed from
      that checkpoint;  init_split: the bootstrap's 30 iterations in passes
      of 15. All but init_split give equal bits. init_split splits the PRNG
      key once more per pass (as the JAX package does), so later draws
      differ: it holds tests/test_fused.py's bands (same keyframe count, at
      least as many mapping iterations, ATE < 0.06 and within 0.03)."""
    ds, ref, m_ref = eq_scene

    def slam(**kw):
        return FusedSlam(small_fused_cfg(**{**EQ_KW, **kw}), 64, 48, capacity=2048,
                         kf_capacity=8, seed=0, device=CPU)

    if case == "fori":
        s = slam(mapping_loop="fori")
        _same_run(s, s.run(ds, chunk=1, sync_every=0), ref, m_ref)
    elif case == "chunk":
        s = slam()
        _same_run(s, s.run(ds, chunk=4), ref, m_ref)
    elif case == "unroll":
        s = slam()
        _same_run(s, s.run(ds, chunk=3, chunk_backend="unroll"), ref, m_ref)
    elif case == "init_split":
        m = slam(init_iters_per_dispatch=15).run(ds, chunk=1, sync_every=2)
        assert m["C"] == m_ref["C"]
        assert m["total_map_iters"] >= m_ref["total_map_iters"]
        assert np.isfinite(m["ate"]) and m["ate"] < 0.06, m
        assert abs(m["ate"] - m_ref["ate"]) < 0.03, (m["ate"], m_ref["ate"])
    else:
        from gslam_tpu_torch.runtime.checkpoint import load_fused_checkpoint

        ckpt = tmp_path / "fused_ckpt.npz"
        first = slam()
        # syncs after frames 0, 1, 3 and 5; checkpoint_every=4 writes one at
        # frame 3's sync only, so the resumed run has frames 4-5 to do
        _same_run(first, first.run(ds, chunk=1, sync_every=2, checkpoint_every=4,
                                   checkpoint_path=ckpt), ref, m_ref)
        st, meta = load_fused_checkpoint(ckpt, first.cfg, device=CPU)
        assert int(st.frame_count) == len(meta) == 4
        second = slam()
        _same_run(second, second.run(ds, chunk=1, sync_every=2, resume_from=str(ckpt)),
                  ref, m_ref)
