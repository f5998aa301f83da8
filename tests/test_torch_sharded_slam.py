"""The port's sharded SLAM loop (gslam_tpu_torch/parallel/slam.py) on the
CPU: copies of tests/test_sharded_slam.py (a banded tracking render against
the single-device fused one, insertion on bands against one device, mono
and RGB-D runs, mesh-size invariance, the pose graph with densification),
the visibility snapshots following the repartitions, and ShardedSlam frames
against the JAX package's from a carried-across state.

The port's meshes repeat the "cpu" device; the JAX side runs on the
conftest's virtual CPU mesh. Inputs are made with numpy from a seed; the
frame parity replays the JAX package's random draws
(test_torch_insertion.JaxDraws).
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu_torch.io.synthetic import SyntheticDataset  # noqa: E402
from gslam_tpu_torch.mapping.backend_ops import MapConfig  # noqa: E402
from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig  # noqa: E402
from gslam_tpu_torch.parallel.sharding import (  # noqa: E402
    compose_outputs, join_bands, make_mesh, partition_by_depth, split_bands,
)
from gslam_tpu_torch.parallel.slam import ShardedSlam, ShardedSlamConfig  # noqa: E402
from gslam_tpu_torch.tracking.track import TrackingConfig  # noqa: E402

CPU = "cpu"
RCFG = RenderConfig(tile_capacity=64, pairs_per_gaussian=8)


def mesh(n):
    return make_mesh(n, axis="gauss", devices=[CPU] * n)


def _slam_cfg(rcfg=RCFG, **kw):
    """tests/test_sharded_slam.py's configuration."""
    kw.setdefault("init_n_new", 600)
    kw.setdefault("kf_n_new", 100)
    kw.setdefault("mapping", MapConfig(window_size=3, num_iters_init=20,
                                       num_iters_mapping=4, render=rcfg))
    return ShardedSlamConfig(
        tracking=TrackingConfig(warmup_steps=4, lbfgs_max_iter=20, lbfgs_max_eval=25,
                                render=rcfg),
        idle_iters=1, **kw)


def scene_fields(rng, n, width=64, height=48):
    """tests/scene_utils.make_scene's splats as numpy fields, and K."""
    fx = 0.9 * width
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]], np.float32)
    z = rng.uniform(2.0, 4.0, n).astype(np.float32)
    u = rng.uniform(4, width - 4, n).astype(np.float32)
    v = rng.uniform(4, height - 4, n).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    return dict(
        means=np.stack([(u - width / 2) * z / fx, (v - height / 2) * z / fx, z], -1),
        quats=quats / np.linalg.norm(quats, axis=-1, keepdims=True),
        log_scales=np.log(rng.uniform(0.04, 0.12, (n, 3))).astype(np.float32),
        logit_opacities=rng.uniform(-1.0, 3.0, n).astype(np.float32),
        logit_colors=rng.normal(size=(n, 3)).astype(np.float32),
        log_uncertainties=rng.uniform(-0.5, 0.5, n).astype(np.float32),
        alive=np.ones(n, bool)), K


def test_banded_track_render_matches_full():
    """Per-band tile lists, the fused tracking render of each band and the
    composite reproduce the single-device fused render of the same
    depth-ordered map, and its pose gradient (tile lists unsaturated: a
    band's lists hold D x tile_capacity entries per tile in all)."""
    from gslam_tpu_torch.ops.rasterize import compute_bins
    from gslam_tpu_torch.ops.track_fused import gather_tracking_tiles, render_tracking_fused

    rng = np.random.default_rng(7)
    fields, K = scene_fields(rng, 256)
    rcfg = RenderConfig(tile_capacity=160, pairs_per_gaussian=8)
    tcfg = TrackingConfig(render=rcfg)
    pose, K = torch.eye(4), torch.from_numpy(K)
    gmap = partition_by_depth(gaussian_map_from_numpy(fields, device=CPU), pose)

    def tiles_of(g):
        bins = compute_bins(g.means, g.quats, g.log_scales, g.alive, pose[None], K[None],
                            64, 48, rcfg, radius_scale=tcfg.bin_radius_margin)
        return gather_tracking_tiles(g, bins), bins

    full, bins = tiles_of(gmap)
    assert int(bins.tile_mask[0].sum(-1).max()) < rcfg.tile_capacity, "lists saturate"
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in ((48, 64, 3), (48, 64), (48, 64), (48, 64))]

    def render_and_grad(render):
        vm = pose.clone().requires_grad_(True)
        out = render(vm)
        (g,) = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), vm)
        return [o.detach() for o in out], g

    def single(vm):
        rgb, depth, beta, alpha = render_tracking_fused(full, vm, K, 64, 48, rcfg)
        return rgb, alpha, depth, beta

    band_tiles = [tiles_of(b)[0] for b in split_bands(gmap, [CPU] * 8)]

    def banded(vm):
        layers = []
        for tg in band_tiles:
            rgb, depth, beta, alpha = render_tracking_fused(tg, vm, K, 64, 48, rcfg)
            layers.append((rgb, alpha, depth, beta))
        return compose_outputs(layers, CPU, rcfg.beta_background)

    (ref, g_ref), (out, g_out) = render_and_grad(single), render_and_grad(banded)
    for k, (a, b) in enumerate(zip(out, ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5 if k < 2 else 1e-4)
    np.testing.assert_allclose(g_out.numpy(), g_ref.numpy(), rtol=1e-4,
                               atol=1e-4 * float(g_ref.abs().max()))


def test_sharded_insert_matches_single_device():
    """Insertion into an 8-band buffer (on the joined buffer, split back)
    gives the single-device insert bit for bit: the same draws, the same
    free slots."""
    from gslam_tpu_torch.mapping.gaussians import empty_map
    from gslam_tpu_torch.mapping.insertion import (
        InsertionConfig, insert_from_depthmap, insertion_masks,
    )
    from gslam_tpu_torch.mapping.optimizer import init_adam

    rng = np.random.default_rng(7)
    h, w = 24, 32
    gmap = empty_map(512, device=CPU)
    alive = gmap.alive.clone()
    alive[:37] = True
    gmap = gmap._replace(alive=alive, means=torch.from_numpy(
        rng.normal(size=(512, 3)).astype(np.float32)))
    depth, alpha = (torch.from_numpy((1.0 + rng.random((h, w))).astype(np.float32)),
                    torch.from_numpy(rng.random((h, w)).astype(np.float32)))
    img = torch.from_numpy(rng.random((h, w, 3)).astype(np.float32))
    K = torch.tensor([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])
    key = torch.tensor([0, 5])

    slam = ShardedSlam(_slam_cfg(), mesh(8), w, h, capacity=512)
    slam._set_joined(gmap, init_adam(gmap))
    slam._insert(key, depth, alpha, img, K, torch.eye(4), 64, 3, None)
    icfg = InsertionConfig(initial_opacity=slam.cfg.mapping.initial_opacity)
    ref = insert_from_depthmap(
        slam.draws.insertion(key, insertion_masks(depth, alpha, icfg)[1], 64), gmap,
        init_adam(gmap), depth, alpha, img, K, torch.eye(4), 64, 3, icfg)
    out, opt = slam.joined()
    assert int(ref.n_inserted) == int(out.alive.sum()) - 37 > 0
    for a, b in zip(out, ref.gmap):
        assert torch.equal(a, b)
    for f in opt.mu:
        assert torch.equal(opt.mu[f], ref.opt_state.mu[f])


@pytest.mark.parametrize("rgbd", [False, True], ids=["mono", "rgbd"])
def test_sharded_slam_e2e(rgbd):
    """The loop on a 2-band mesh, monocular and RGB-D (the alpha-normalized,
    alpha-masked depth lock): finite, healthy, ATE < 0.05 and PSNR > 15 on
    an easy walk, the bounds of tests/test_sharded_slam.py (whose mesh has
    8 bands; the invariance test below runs 8)."""
    ds = SyntheticDataset(seq_len=6, width=64, height=48, n_splats=400, seed=3,
                          motion_scale=0.01, device=CPU)
    slam = ShardedSlam(_slam_cfg(use_gt_depths=rgbd), mesh(2), 64, 48, capacity=1024,
                       kf_capacity=8, seed=0)
    m = slam.run(ds, eval_stride=2)
    assert m["L"] == 6 and m["C"] >= 1 and m["n_devices"] == 2
    assert m["health"] == 0 and m["nonfinite_poses"] == 0
    assert np.isfinite(m["ate"]) and m["ate"] < 0.05, m
    assert m["psnr"] > 15.0, m
    assert m["live"] > 0


def test_sharded_slam_mesh_size_invariance():
    """The same loop, with the pose graph and densification, on a 1-band
    and an 8-band mesh solves the same problem. The band composite
    reassociates float sums (~1e-7), which flips line-search branches, so
    the bounds are statistical: both healthy, ATE < 0.02 and within 0.01 of
    each other, trajectories within 5 cm (tests/test_sharded_slam.py's
    envelope). Neither run's tile lists can saturate: 256 slots at D=1, and
    at D=8 as many as a band holds (64), which blends the same splats as
    256 would."""
    ds = SyntheticDataset(seq_len=4, width=48, height=32, n_splats=300, seed=5,
                          motion_scale=0.008, device=CPU)
    runs = {}
    for n in (1, 8):
        rcfg = RenderConfig(tile_capacity=min(256, 512 // n), pairs_per_gaussian=8)
        cfg = _slam_cfg(rcfg=rcfg, init_n_new=300, kf_n_new=50, mapping=MapConfig(
            window_size=3, recent_window=2, num_iters_init=20, num_iters_mapping=4,
            enable_pgo=True, densify_every=8, densify_max_new=32, render=rcfg))
        slam = ShardedSlam(cfg, mesh(n), 48, 32, capacity=512, kf_capacity=8, seed=0)
        runs[n] = (slam.run(ds), slam)
    (m1, s1), (m8, s8) = runs[1], runs[8]
    assert m1["health"] == m8["health"] == 0
    assert m1["nonfinite_poses"] == m8["nonfinite_poses"] == 0
    assert m1["ate"] < 0.02 and m8["ate"] < 0.02, (m1["ate"], m8["ate"])
    assert abs(m1["ate"] - m8["ate"]) < 0.01
    np.testing.assert_allclose(np.stack(s8.trajectory), np.stack(s1.trajectory), atol=0.05)


def test_sharded_pgo_and_densify():
    """The pose graph and gradient densification on a 2-band mesh: IoU
    loop closures on a slow walk over a shared view, a symmetric adjacency
    without self-edges, densification at the densify_every cadence from the
    banded dL/dmeans2d; healthy and ATE < 0.05. kf_m = 1e-4 takes every
    accepted frame as a keyframe (as the dry run does): a non-consecutive
    IoU edge needs at least 3, which the default rule gives this walk on
    some band counts only."""
    ds = SyntheticDataset(seq_len=6, width=64, height=48, n_splats=400, seed=3,
                          motion_scale=0.012, device=CPU)
    cfg = _slam_cfg(
        init_n_new=800,
        mapping=MapConfig(window_size=4, recent_window=2, num_iters_init=20,
                          num_iters_mapping=4, render=RCFG, enable_pgo=True,
                          densify_every=8, densify_max_new=64, kf_m=1e-4))
    slam = ShardedSlam(cfg, mesh(2), 64, 48, capacity=1024, kf_capacity=8, seed=0)
    m = slam.run(ds, eval_stride=3)
    assert m["health"] == 0 and m["nonfinite_poses"] == 0
    assert np.isfinite(m["ate"]) and m["ate"] < 0.05, m
    assert m["loop_closures"] >= 1, m
    assert (slam.adj == slam.adj.T).all() and not slam.adj.diagonal().any()
    assert m["total_map_iters"] >= 8
    assert m["live"] > cfg.init_n_new, m  # densified splats present


def test_visibility_snapshots_follow_the_repartition():
    """The pose graph's visibility columns name the same splats after every
    repartition, the per-frame one at the motion prior included (the JAX
    loop leaves them behind there, ROADMAP C-ref6). After the bootstrap the
    snapshot is replaced by a random half of the slots and the prior of
    frame 1 is turned 90 degrees, which reorders the buffer; with no
    keyframe and no mapping in that frame, the live splats the snapshot
    marks are the ones it marked before."""
    import scipy.spatial.transform as sst

    ds = SyntheticDataset(seq_len=2, width=48, height=32, n_splats=300, seed=5,
                          motion_scale=0.02, device=CPU)
    cfg = dataclasses.replace(_slam_cfg(
        init_n_new=300, prune_every=0,
        mapping=MapConfig(window_size=2, recent_window=1, num_iters_init=5,
                          enable_pgo=True, kf_m=1e9, kf_cos=-1.0, kf_adapt=0.0,
                          densify_every=0, render=RCFG)), idle_iters=0)
    slam = ShardedSlam(cfg, mesh(4), 48, 32, capacity=512, kf_capacity=4, seed=0)
    K = ds.camera.K

    def marked():
        gmap = join_bands(slam.bands, CPU)
        return {tuple(m) for m in gmap.means[slam.kf_vis[0] & gmap.alive].tolist()}

    slam.step(0, ds.images[0], None, K)
    slam.kf_vis[0] = torch.from_numpy(np.random.default_rng(9).random(512) < 0.5)
    before, order_before = marked(), join_bands(slam.bands, CPU).means.clone()
    turned = np.eye(4, dtype=np.float32)
    turned[:3, :3] = sst.Rotation.from_rotvec([0.0, np.pi / 2, 0.0]).as_matrix()
    slam.trajectory[-1] = turned
    slam.step(1, ds.images[1], None, K)
    assert slam.kf_count == 1 and len(before) > 100
    # the buffer was reordered, and the snapshot's columns moved with it
    assert not torch.equal(join_bands(slam.bands, CPU).means, order_before)
    assert marked() == before


# ------------------------------------------------------ against the JAX loop


def _jax_state(js):
    """A JAX ShardedSlam's state under the port's load_state names."""
    from gslam_tpu.mapping.gaussians import GaussianMap as JMap

    out = {f"map/{f}": np.asarray(getattr(js.gmap, f)) for f in JMap._fields}
    out.update({f"opt/{k}/{f}": np.asarray(v) for k in ("mu", "nu")
                for f, v in getattr(js.opt, k).items()})
    out["opt/count"] = np.asarray(js.opt.count)
    for name in ("kf_imgs", "kf_poses", "kf_exps", "kf_gt_depths", "kf_est_depths",
                 "_exposure", "key"):
        out[name] = np.asarray(getattr(js, name))
    out["key"] = out["key"].astype(np.int64)
    if js.kf_vis is not None:
        out["kf_vis"] = np.asarray(js.kf_vis)
    if js._last_probe_grad is not None:
        out["last_probe_grad"] = np.asarray(js._last_probe_grad)
    out.update(kf_mask=js.kf_mask, adj=js.adj, kf_anchor=np.asarray(js._kf_anchor),
               trajectory=js.trajectory, exposure_traj=js.exposure_traj,
               kf_frames=js.kf_frames)
    for k in ("kf_count", "loop_closures", "total_map_iters", "health", "step_ema",
              "innov_ema", "consec_rej"):
        out[k] = getattr(js, k)
    return out


def _jax_copy(js):
    """A JAX ShardedSlam that steps on from js's state without touching it
    (its jax arrays are immutable; its host arrays and lists are copied)."""
    c = copy.copy(js)
    c.kf_mask, c.adj = js.kf_mask.copy(), js.adj.copy()
    c.kf_frames, c.trajectory = list(js.kf_frames), list(js.trajectory)
    c.exposure_traj = list(js.exposure_traj)
    return c


def test_sharded_slam_frames_match_jax():
    """Frames 1 and 2 after a JAX bootstrap (frame 0), in both packages from
    the same state over 2 bands, the pose graph and densification on
    (kf_m = 0: every accepted frame is a keyframe; densify fires in frame
    2). The JAX loop's per-frame repartition is given the visibility
    columns too (C-ref6, repaired in the port). Counts, keyframes,
    adjacency and keys exact; live splats exact. Poses within 3x, plus
    1e-4, of how far the JAX step itself moves its pose when the frame gets
    N(0, 1e-6) noise (the slam_step_impl parity test's rule)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from gslam_tpu.mapping.backend_ops import MapConfig as JMapConfig
    from gslam_tpu.ops.rasterize import RenderConfig as JRenderConfig
    from gslam_tpu.parallel.slam import ShardedSlam as JSlam
    from gslam_tpu.parallel.slam import ShardedSlamConfig as JSlamConfig
    from gslam_tpu.tracking.track import TrackingConfig as JTrackingConfig
    from test_torch_insertion import JaxDraws

    r = dict(tile_capacity=64, pairs_per_gaussian=8, max_span=4)
    t = dict(warmup_steps=3, lbfgs_max_iter=10, lbfgs_max_eval=12)
    m = dict(window_size=3, recent_window=2, num_iters_init=20, num_iters_mapping=3,
             kf_m=0.0, enable_pgo=True, densify_every=24, densify_max_new=32,
             grow_grad2d=1e-8)
    s = dict(init_n_new=200, kf_n_new=40, idle_iters=1)
    jr, tr = JRenderConfig(tile_chunk=8, **r), RenderConfig(**r)
    jcfg = JSlamConfig(tracking=JTrackingConfig(render=jr, **t),
                       mapping=JMapConfig(render=jr, **m), **s)
    tcfg = ShardedSlamConfig(tracking=TrackingConfig(render=tr, **t),
                             mapping=MapConfig(render=tr, **m), **s)
    W2, H2, cap = 64, 48, 1024
    ds = SyntheticDataset(seq_len=3, width=W2, height=H2, n_splats=600, seed=6,
                          motion_scale=0.02, device=CPU)
    K = ds.camera.K.numpy()

    js = JSlam(jcfg, JMesh(np.asarray(jax.devices("cpu")[:2]), ("gauss",)), W2, H2,
               capacity=cap, kf_capacity=4, seed=0)

    def repaired(slam):
        # C-ref6: the per-frame repartition permutes the visibility columns
        def repartition(gmap, prior, opt):
            slam._repartition_all(prior)
            return slam.gmap, slam.opt
        slam._repartition = repartition
        return slam

    repaired(js)
    js.step(0, jnp.asarray(ds.images[0]), None, jnp.asarray(K))
    port = ShardedSlam(tcfg, mesh(2), W2, H2, capacity=cap, kf_capacity=4, draws=JaxDraws())
    port.load_state(_jax_state(js))
    rng = np.random.default_rng(61)
    for i in (1, 2):
        noisy = repaired(_jax_copy(js))
        noisy.step(i, jnp.asarray(ds.images[i] + rng.normal(
            scale=1e-6, size=ds.images[i].shape).astype(np.float32)), None, jnp.asarray(K))
        js.step(i, jnp.asarray(ds.images[i]), None, jnp.asarray(K))
        port.step(i, ds.images[i], None, K)
        jax_self = np.abs(noisy.trajectory[i] - js.trajectory[i]).max()
        np.testing.assert_allclose(port.trajectory[i], js.trajectory[i],
                                   atol=3 * jax_self + 1e-4, err_msg=f"frame {i}")
        want = _jax_state(js)
        got = port.state_to_numpy()
        for k in ("kf_count", "kf_frames", "loop_closures", "total_map_iters", "health"):
            assert got[k] == want[k], (k, i, got[k], want[k])
        for k in ("kf_mask", "adj", "key", "map/alive"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k}, frame {i}")
    assert port.kf_count == 3 and port.total_map_iters == 26
    assert port._last_probe_grad is None  # densify fired in frame 2
