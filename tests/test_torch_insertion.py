"""Parity of the port's insertion slice with the JAX package on the CPU: the
configs' fields and defaults, the camera model, kNN, `insert_from_depthmap`
(empty and live map, with and without the occlusion filter, RGB-D and
monocular), both densify cases, ATE, the map and fused checkpoints in both
directions, the synthetic dataset, and two `slam_step_impl` frames from a
state carried across.

Inputs are made with numpy from a seed. The JAX functions run un-jitted
(`.__wrapped__` under `jax.disable_jit()`), op by op as torch's eager ones
do, and their random draws are passed to the port: the port's own draws
come from a torch generator and follow another stream.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu.core import camera as jc  # noqa: E402
from gslam_tpu.eval import trajectory as jtr  # noqa: E402
from gslam_tpu.mapping import gaussians as jg  # noqa: E402
from gslam_tpu.mapping import insertion as ji  # noqa: E402
from gslam_tpu.mapping import optimizer as jo  # noqa: E402
from gslam_tpu.ops import knn as jknn  # noqa: E402
from gslam_tpu_torch.core import camera as tc  # noqa: E402
from gslam_tpu_torch.eval import trajectory as ttr  # noqa: E402
from gslam_tpu_torch.mapping import gaussians as tg  # noqa: E402
from gslam_tpu_torch.mapping import insertion as ti  # noqa: E402
from gslam_tpu_torch.mapping import optimizer as to  # noqa: E402
from gslam_tpu_torch.ops import knn as tknn  # noqa: E402

CPU = "cpu"
H, W = 24, 32
K_NP = np.array([[28.8, 0, 16], [0, 28.8, 12], [0, 0, 1]], np.float32)
# float32 geometry through a 4x4 inverse and a matmul of scale ~3 m
POS_TOL = dict(atol=2e-5, rtol=1e-5)


def T(x):
    return torch.from_numpy(np.array(x))


def pose(t, rotvec=(0.0, 0.0, 0.0)):
    import scipy.spatial.transform as sst

    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = sst.Rotation.from_rotvec(rotvec).as_matrix()
    m[:3, 3] = t
    return m


def map_fields(rng, cap, n_dead, scale_lo=0.02, scale_hi=0.08):
    alive = np.ones(cap, bool)
    alive[rng.choice(cap, n_dead, replace=False)] = False
    return dict(
        means=(rng.normal(0, 0.5, (cap, 3)) + [0, 0, 2.0]).astype(np.float32),
        quats=rng.normal(size=(cap, 4)).astype(np.float32),
        log_scales=np.log(rng.uniform(scale_lo, scale_hi, (cap, 3))).astype(np.float32),
        logit_opacities=rng.normal(1.0, 0.5, cap).astype(np.float32),
        logit_colors=rng.normal(size=(cap, 3)).astype(np.float32),
        log_uncertainties=rng.uniform(-0.3, 0.3, cap).astype(np.float32),
        ages=rng.integers(0, 5, cap).astype(np.int32),
        alive=alive,
    )


def both_maps(d):
    jm = jg.empty_map(d["means"].shape[0])._replace(**{k: jnp.asarray(v) for k, v in d.items()})
    return jm, tg.gaussian_map_from_numpy(d, device=CPU)


def adam_with_history(jm, tm, rng):
    """Both packages' Adam states after one step on the same gradients, so
    zeroed slots are visible (dead slots are updated too)."""
    g = {f: rng.normal(size=getattr(tm, f).shape).astype(np.float32)
         for f in tg.TRAINABLE_FIELDS}
    every = np.ones(tm.capacity, bool)
    _, js = jo.adam_step(jm, {k: jnp.asarray(v) for k, v in g.items()}, jo.init_adam(jm),
                         update_mask=jnp.asarray(every))
    _, ts = to.adam_step(tm, {k: T(v) for k, v in g.items()}, to.init_adam(tm),
                         update_mask=T(every))
    return js, ts


def assert_results_match(tr, jr):
    """InsertResult of the port against JAX's: counts exact, the map's
    positions within POS_TOL, other fields within float32 rounding."""
    assert int(tr.n_inserted) == int(jr.n_inserted)
    assert int(tr.n_requested) == int(jr.n_requested)
    for f in tg.FIELDS:
        a, b = getattr(tr.gmap, f).numpy(), np.asarray(getattr(jr.gmap, f))
        if a.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f == "means":
            np.testing.assert_allclose(a, b, err_msg=f, **POS_TOL)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=f)
    for k in ("mu", "nu"):
        for f in tg.TRAINABLE_FIELDS:
            np.testing.assert_array_equal(getattr(tr.opt_state, k)[f].numpy(),
                                          np.asarray(getattr(jr.opt_state, k)[f]))


# ---------------------------------------------------------------- configs


def test_configs_match_jax():
    """MapConfig, FusedConfig and InsertionConfig have every field of the JAX
    package's under its name and default (RenderConfig, which lacks the
    XLA-only tile_chunk, aside); TrackingConfig has the guard_* fields and
    JAX's defaults for every field it has (the gn_* fields come with the
    Gauss-Newton tracker)."""
    from gslam_tpu.mapping.backend_ops import MapConfig as JMap
    from gslam_tpu.runtime.fused import FusedConfig as JFused
    from gslam_tpu.tracking.track import TrackingConfig as JTrack
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.runtime.fused import FusedConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    def defaults(cls):
        return {f.name: getattr(cls(), f.name) for f in dataclasses.fields(cls)
                if f.name not in ("render", "tracking", "mapping")}

    assert len(dataclasses.fields(MapConfig)) == len(dataclasses.fields(JMap)) == 32
    for port, ref in ((MapConfig, JMap), (FusedConfig, JFused),
                      (ti.InsertionConfig, ji.InsertionConfig)):
        assert defaults(port) == defaults(ref), port.__name__
    assert FusedConfig().insertion == ti.InsertionConfig(**dataclasses.asdict(JFused().insertion))
    track, jtrack = defaults(TrackingConfig), defaults(JTrack)
    assert {"guard_innov_mult", "guard_step_floor", "guard_max_rot"} <= set(track)
    assert track == {k: jtrack[k] for k in track}


# ---------------------------------------------------------------- camera, kNN


def test_camera_backproject_matches_jax():
    rng = np.random.default_rng(30)
    depth = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    np.testing.assert_array_equal(tc.pixel_grid(H, W).numpy(), np.asarray(jc.pixel_grid(H, W)))
    np.testing.assert_allclose(tc.backproject(T(K_NP), T(depth)).numpy(),
                               np.asarray(jc.backproject(jnp.asarray(K_NP), jnp.asarray(depth))),
                               atol=1e-6, rtol=1e-6)
    m = pose([0.1, -0.2, 0.3], [0.05, 0.1, -0.02])
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(tc.transform_points(T(m), T(pts)).numpy(),
                               np.asarray(jc.transform_points(jnp.asarray(m), jnp.asarray(pts))),
                               atol=1e-6)
    jcam = jc.Camera(K=jnp.asarray(K_NP), height=H, width=W).scaled(0.5)
    tcam = tc.Camera(K=T(K_NP), height=H, width=W).scaled(0.5)
    assert (tcam.height, tcam.width) == (jcam.height, jcam.width) == (12, 16)
    np.testing.assert_allclose(tcam.K.numpy(), np.asarray(jcam.K), atol=1e-6)


@pytest.mark.parametrize("n,k", [(300, 4), (64, 8)])
def test_knn_matches_jax(n, k):
    """Distances within 2e-5 m: the expanded form rounds |a|^2 + |b|^2 - 2ab
    in float32 in both packages, and the two matmuls sum in other orders."""
    pts = np.random.default_rng(31).normal(size=(n, 3)).astype(np.float32)
    d = tknn.knn_distances(T(pts), k).numpy()
    np.testing.assert_allclose(d, np.asarray(jknn.knn_distances(jnp.asarray(pts), k)), atol=2e-5)
    # the self-distance is the square root of a float32 cancellation of
    # |p|^2 ~ 10: up to sqrt(10 * 2^-23 * a few) ~ 3e-3
    assert (np.diff(d, axis=1) >= 0).all() and np.abs(d[:, 0]).max() < 4e-3
    np.testing.assert_allclose(tknn.mean_knn_scale(T(pts), k).numpy(),
                               np.asarray(jknn.mean_knn_scale(jnp.asarray(pts), k)), atol=2e-5)


# ---------------------------------------------------------------- insertion


def jax_insert_draws(key, need, n_new):
    """The draws JAX's insert_from_depthmap makes from `key`, for the port."""
    k_noise, k_pick, k_quat = jax.random.split(key, 3)
    need = jnp.asarray(need)
    logits = jnp.where(need, 0.0, -jnp.inf)
    logits = jnp.where(jnp.sum(need) > 0, logits, jnp.zeros_like(logits))
    return ti.InsertDraws(
        noise=T(jax.random.normal(k_noise, need.shape)),
        picks=T(jax.random.categorical(k_pick, logits, shape=(n_new,))).to(torch.int64),
        quats=T(jax.random.uniform(k_quat, (n_new, 4))),
    )


@pytest.mark.parametrize("live", [False, True], ids=["empty_map", "live_map"])
@pytest.mark.parametrize("occlusion", [False, True], ids=["no_filter", "filter"])
@pytest.mark.parametrize("rgbd", [False, True], ids=["mono", "rgbd"])
def test_insert_from_depthmap_matches_jax(live, occlusion, rgbd):
    """An empty map takes kNN scales, a live one the median; the live map
    has 20 free slots for 50 candidates, so the unfiltered ones overflow."""
    rng = np.random.default_rng(32 + 4 * live + 2 * occlusion + rgbd)
    cap, n_new = 256, 50
    d = map_fields(rng, cap, 20) if live else {
        k: np.asarray(v) for k, v in jg.empty_map(cap)._asdict().items()}
    jm, tm = both_maps(d)
    js, ts = adam_with_history(jm, tm, rng)
    depth = rng.uniform(1.0, 3.0, (H, W)).astype(np.float32)
    alpha = np.where(rng.random((H, W)) < 0.5, 0.05, 0.9).astype(np.float32)
    image = rng.random((H, W, 3)).astype(np.float32)
    gt = (np.where(rng.random((H, W)) < 0.8, rng.uniform(1.0, 3.0, (H, W)), 0.0)
          .astype(np.float32) if rgbd else None)
    viewmat = pose([0.05, -0.02, 0.1], [0.02, -0.03, 0.01])
    kw = {}
    if occlusion:
        kf_views = np.stack([pose([0, 0, 0]), pose([0.1, 0, 0.05], [0, 0.05, 0]),
                             pose([-0.1, 0.05, 0])])
        # est depths well inside the candidates' range, so the filter drops some
        kw = dict(kf_viewmats=kf_views,
                  kf_est_depths=rng.uniform(1.5, 3.5, (3, H, W)).astype(np.float32),
                  kf_mask=np.array([True, True, False]))
    cfg = ti.InsertionConfig(depth_variance=0.1, no_depth_variance=0.2)
    key = jax.random.PRNGKey(5)
    _, need = ti.insertion_masks(T(depth), T(alpha), cfg, None if gt is None else T(gt))
    with jax.disable_jit():
        jr = ji.insert_from_depthmap.__wrapped__(
            key, jm, js, jnp.asarray(depth), jnp.asarray(alpha), jnp.asarray(image),
            jnp.asarray(K_NP), jnp.asarray(viewmat), n_new, 3, cfg,
            **{k: jnp.asarray(v) for k, v in kw.items()},
            gt_depthmap=None if gt is None else jnp.asarray(gt))
        draws = jax_insert_draws(key, need.numpy(), n_new)
    tr = ti.insert_from_depthmap(
        draws, tm, ts, T(depth), T(alpha), T(image), T(K_NP), T(viewmat), n_new, 3, cfg,
        **{k: T(v) for k, v in kw.items()}, gt_depthmap=None if gt is None else T(gt))
    assert_results_match(tr, jr)
    free = 20 if live else cap
    assert int(tr.n_inserted) == min(free, int(tr.n_requested)) > 0
    if occlusion:
        assert int(tr.n_requested) < n_new  # the filter dropped candidates
    new = tr.gmap.alive & ~tm.alive
    assert (tr.gmap.ages[new] == 3).all() and not ts.mu["means"][new].eq(0).all()
    assert tr.opt_state.mu["means"][new].eq(0).all()


def test_insert_draws_pick_pixels_in_need():
    """The port's picks: uniform over the pixels in need (searchsorted over
    their cumulative count), over all pixels when none is in need."""
    gen = torch.Generator().manual_seed(0)
    need = torch.zeros(H * W, dtype=torch.bool)
    need[torch.randperm(H * W, generator=gen)[:40]] = True
    d = ti.insert_draws(gen, need, 20_000)
    assert d.noise.shape == (H * W,) and d.quats.shape == (20_000, 4)
    assert need[d.picks].all()
    counts = torch.bincount(d.picks, minlength=H * W)[need].double()
    assert counts.min() > 0.6 * 500 and counts.max() < 1.4 * 500  # 500 expected each
    d = ti.insert_draws(gen, torch.zeros(H * W, dtype=torch.bool), 20_000)
    assert torch.unique(d.picks).numel() > 0.9 * H * W and int(d.picks.max()) < H * W


@pytest.mark.parametrize("split", [False, True], ids=["duplicate", "split"])
def test_densify_matches_jax(split):
    rng = np.random.default_rng(40 + split)
    cap, max_new = 256, 64
    # small splats are duplicated, large ones split along their covariance
    d = map_fields(rng, cap, 100, *((0.03, 0.08) if split else (0.002, 0.008)))
    jm, tm = both_maps(d)
    js, ts = adam_with_history(jm, tm, rng)
    grad = (rng.normal(size=(3, cap, 2)) * 10.0 ** rng.uniform(-7, -3, (3, cap, 1))
            ).astype(np.float32)
    key = jax.random.PRNGKey(9)
    with jax.disable_jit():
        jr = ji.densify_by_gradients.__wrapped__(key, jm, js, jnp.asarray(grad), W, H,
                                                 max_new, 7)
        noise = T(jax.random.normal(key, (max_new, 3)))
    tr = ti.densify_by_gradients(noise, tm, ts, T(grad), W, H, max_new, 7)
    assert_results_match(tr, jr)
    # enough high-gradient splats to fill the free slots or the cap
    assert int(tr.n_inserted) > 20
    moved = tr.gmap.alive & ~tm.alive
    log_sc = tr.gmap.log_scales[moved]
    if split:
        assert (log_sc < np.log(0.08) - np.log(1.6) + 1e-6).all()
    else:
        assert (log_sc < np.log(0.0081)).all()


# ---------------------------------------------------------------- ATE


def test_ate_matches_jax(tmp_path):
    rng = np.random.default_rng(50)
    gt = np.stack([pose(rng.normal(size=3) * 0.3, rng.normal(size=3) * 0.1)
                   for _ in range(12)])
    est = gt.copy()
    est[:, :3, 3] = gt[:, :3, 3] * 1.3 + rng.normal(scale=0.02, size=(12, 3))
    g, e = jtr.trajectory_positions(gt), jtr.trajectory_positions(est)
    np.testing.assert_array_equal(ttr.trajectory_positions(gt), g)
    for name in ("ate_mean", "ate_rmse"):
        a, b = getattr(ttr, name)(g, e), getattr(jtr, name)(g, e)
        assert a == b and 0.0 < a < 0.1, name
    r, c, t = ttr.kabsch_umeyama(g, e)
    jr_, jc_, jt_ = jtr.kabsch_umeyama(g, e)
    np.testing.assert_array_equal(r, jr_)
    assert c == jc_ and np.isclose(c, 1 / 1.3, rtol=0.1)
    np.testing.assert_array_equal(ttr.align_trajectory(g, e), jtr.align_trajectory(g, e))
    ttr.plot_trajectories(g, e, tmp_path / "traj.png", keyframe_indices=[0, 5, 40])
    assert (tmp_path / "traj.png").read_bytes()[:4] == b"\x89PNG"


# ---------------------------------------------------------------- checkpoint


def _small_cfgs(pgo=True, **kw):
    """The same FusedConfig in both packages (JAX's, port's) at a size the
    CPU runs quickly; max_span=4 covers the 4x3 tiles of a 64x48 image."""
    from gslam_tpu.mapping.backend_ops import MapConfig as JMapConfig
    from gslam_tpu.ops.rasterize import RenderConfig as JRenderConfig
    from gslam_tpu.runtime.fused import FusedConfig as JFusedConfig
    from gslam_tpu.tracking.track import TrackingConfig as JTrackingConfig
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.runtime.fused import FusedConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    r = dict(tile_capacity=64, pairs_per_gaussian=8, max_span=4)
    t = dict(warmup_steps=3, lbfgs_max_iter=8, lbfgs_max_eval=8)
    m = dict(window_size=3, recent_window=2 if pgo else 3, num_iters_init=8,
             num_iters_mapping=3, kf_m=0.0, enable_pgo=pgo, densify_every=10,
             densify_max_new=32, grow_grad2d=1e-8)
    f = dict(max_frames=4, init_n_new=300, kf_n_new=40, idle_iters=3, **kw)
    jr, tr = JRenderConfig(tile_chunk=8, **r), RenderConfig(**r)
    return (JFusedConfig(tracking=JTrackingConfig(render=jr, **t),
                         mapping=JMapConfig(render=jr, **m), **f),
            FusedConfig(tracking=TrackingConfig(render=tr, **t),
                        mapping=MapConfig(render=tr, **m), **f))


def test_map_checkpoint_crosses_packages(tmp_path):
    """save_map of either package loads into the other, field for field,
    with its extra arrays."""
    from gslam_tpu.runtime import checkpoint as jck
    from gslam_tpu_torch.runtime import checkpoint as tck

    d = map_fields(np.random.default_rng(62), 64, 10)
    jm, tm = both_maps(d)
    extra = {"frame": np.arange(3)}
    jck.save_map(tmp_path / "jax.npz", jm, extra)
    tck.save_map(tmp_path / "port.npz", tm, extra)
    loaded = [tck.load_map(tmp_path / "jax.npz", device=CPU),
              jck.load_map(tmp_path / "port.npz")]
    for gmap, ex in loaded:
        np.testing.assert_array_equal(ex["frame"], extra["frame"])
        for f, v in d.items():
            got = np.asarray(getattr(gmap, f))
            assert got.dtype == v.dtype, f
            np.testing.assert_array_equal(got, v, err_msg=f)


def test_synthetic_dataset_matches_jax():
    """Both packages build the same scene and trajectory from a seed, and
    render it within float32 rounding (images 1e-5, depth 2e-5 m)."""
    from gslam_tpu.io.synthetic import SyntheticDataset as JSynthetic
    from gslam_tpu_torch.io.synthetic import SyntheticDataset

    kw = dict(seq_len=3, width=32, height=24, n_splats=150, seed=2, motion_scale=0.03)
    j, t = JSynthetic(**kw), SyntheticDataset(**kw, device=CPU)
    for f, v in t.gt_map_fields.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(j.gt_map, f)), err_msg=f)
    np.testing.assert_array_equal(t.poses, j.poses)
    np.testing.assert_array_equal(t.camera.K.numpy(), np.asarray(j.camera.K))
    np.testing.assert_allclose(t.images, j.images, atol=1e-5)
    np.testing.assert_allclose(t.depths, j.depths, atol=2e-5)
    assert len(t) == 3 and t.images.std() > 0.05
    fj, ft = j[2], t[2]
    assert (ft.index, ft.timestamp) == (fj.index, fj.timestamp)
    np.testing.assert_array_equal(ft.gt_pose, fj.gt_pose)


def _jax_leaves(state):
    """A JAX FusedState flattened as its save_fused_checkpoint does."""
    return {"leaf/" + jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def test_fused_checkpoint_crosses_packages(tmp_path):
    """A checkpoint written by the JAX runtime loads into the port leaf for
    leaf (CPU counters and the key on the CPU), and the port's loads into
    the JAX runtime; a config that gives other shapes is refused."""
    from gslam_tpu.runtime import checkpoint as jck
    from gslam_tpu.runtime.fused import init_fused_state as j_init
    from gslam_tpu_torch.runtime import checkpoint as tck
    from gslam_tpu_torch.runtime.fused import HOST_FIELDS

    jcfg, tcfg = _small_cfgs()
    rng = np.random.default_rng(60)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return jnp.asarray(rng.random(x.shape) < 0.5)
        if x.dtype == np.float32:
            return jnp.asarray(rng.normal(size=x.shape).astype(np.float32))
        return jnp.asarray(rng.integers(0, 1000, x.shape).astype(x.dtype))

    jstate = jax.tree_util.tree_map(fill, j_init(jcfg, 64, 3, 8, 12))
    meta = [(0, 0.0, np.eye(4, dtype=np.float32)), (1, 1 / 30, None)]
    jck.save_fused_checkpoint(tmp_path / "jax.npz", jstate, meta)
    state, meta2 = tck.load_fused_checkpoint(tmp_path / "jax.npz", tcfg, device=CPU)
    want = _jax_leaves(jstate)
    got = tck.state_leaves(state)
    assert set("leaf/" + p for p in got) == set(want) and len(want) == 60
    for p, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want["leaf/" + p], err_msg=p)
        assert v.dtype == {np.dtype(np.uint32): torch.int64}.get(
            want["leaf/" + p].dtype, v.dtype), p
    assert all(getattr(state, f).device.type == "cpu" for f in HOST_FIELDS)
    assert state.key.shape == (2,) and state.key.dtype == torch.int64
    assert [m[:2] for m in meta2] == [(0, 0.0), (1, 1 / 30)] and meta2[1][2] is None

    tck.save_fused_checkpoint(tmp_path / "port.npz", state, meta2)
    back, _ = jck.load_fused_checkpoint(str(tmp_path / "port.npz"), jcfg)
    for p, v in _jax_leaves(back).items():
        np.testing.assert_array_equal(v, want[p], err_msg=p)

    with pytest.raises(ValueError, match="kf_vis"):  # PGO off: one visibility column
        tck.load_fused_checkpoint(tmp_path / "jax.npz", _small_cfgs(pgo=False)[1], CPU)
    with pytest.raises(ValueError, match="max_frames"):
        tck.load_fused_checkpoint(tmp_path / "jax.npz",
                                  dataclasses.replace(tcfg, max_frames=5), CPU)


# ---------------------------------------------------------------- slam_step_impl


class JaxDraws:
    """The port's draw interface (runtime/fused.KeyDraws) answered with the
    JAX package's draws from the same (carried-across) key."""

    @staticmethod
    def _key(key):
        return jnp.asarray(np.asarray(key).astype(np.uint32))

    def split(self, key, n):
        return torch.from_numpy(np.asarray(jax.random.split(self._key(key), n)).astype(np.int64))

    def normal(self, key, shape, device):
        return T(jax.random.normal(self._key(key), shape))

    def insertion(self, key, need, n_new):
        return jax_insert_draws(self._key(key), need.numpy(), n_new)


def test_slam_step_impl_matches_jax():
    """Frames 1 and 2 after a JAX bootstrap (frame 0), in both packages from
    the same state: tracking (44 evaluations), the gate, the keyframe
    decision (kf_m = 0: every accepted frame), insertion, the PGO window,
    densify (its cadence of 10 falls in frame 1) and pruning. The JAX side
    is its jitted slam_step (op by op it takes minutes per frame here).
    Counts and keys exact. Poses within 3x, plus 1e-4, of how far the JAX
    step itself moves its pose when the frame gets N(0, 1e-6) noise: on this
    freshly bootstrapped map the photometric basin is flat, and the JAX
    tracker moves 3-14 mm under that noise (the port sits 4-7 mm away)."""
    from gslam_tpu.runtime import fused as jf
    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.runtime import fused as tf
    from gslam_tpu_torch.runtime.checkpoint import fused_state_from_numpy

    track = dict(lbfgs_max_eval=40, lbfgs_max_iter=40)
    jcfg, tcfg = (dataclasses.replace(
        c, init_n_new=150, tracking=dataclasses.replace(c.tracking, **track),
        mapping=dataclasses.replace(c.mapping, num_iters_init=30)) for c in _small_cfgs())
    W2, H2 = 64, 48
    ds = SyntheticDataset(seq_len=3, width=W2, height=H2, n_splats=600, seed=6,
                          motion_scale=0.02, device=CPU)
    K = ds.camera.K.numpy()
    depth0 = np.zeros((H2, W2), np.float32)

    def j_step(state, img):
        return jf.slam_step(state, jnp.asarray(img), jnp.asarray(depth0), jnp.asarray(K),
                            W2, H2, jcfg)

    js = j_step(jf.init_fused_state(jcfg, 1024, 4, H2, W2, seed=0), ds.images[0])
    ts = fused_state_from_numpy(_jax_leaves(js), tcfg, device=CPU)
    assert int(ts.frame_count) == 1 and int(ts.live_count) == int(js.live_count) > 100
    rng = np.random.default_rng(61)
    for i in (1, 2):
        noisy = j_step(js, ds.images[i] + rng.normal(scale=1e-6, size=ds.images[i].shape)
                       .astype(np.float32))
        js = j_step(js, ds.images[i])
        ts = tf.slam_step_impl(ts, T(ds.images[i]), T(depth0), T(K), W2, H2, tcfg,
                               draws=JaxDraws())
        jax_self = np.abs(np.asarray(noisy.traj[i]) - np.asarray(js.traj[i])).max()
        np.testing.assert_allclose(ts.traj[i].numpy(), np.asarray(js.traj[i]),
                                   atol=3 * jax_self + 1e-4, err_msg=f"frame {i}")
        for f in ("kf_flags", "kf_count", "n_evals_traj", "inserted_total", "dropped_total",
                  "live_count", "total_map_iters", "health", "adj"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f"{f}, frame {i}")
        np.testing.assert_array_equal(ts.key.numpy(), np.asarray(js.key).astype(np.int64))
    assert ts.kf_flags[:3].all() and int(ts.total_map_iters) == 36
    # bootstrap plus densify's 32 (this bootstrap covers every pixel, so the
    # keyframes find none in need of geometry)
    assert int(ts.inserted_total) == 150 + 32
