"""Parity of the port's tracking slice with the JAX package on the CPU: the
fused tracking render and its gradient, the losses, the Adam + L-BFGS loop
and `track_frame` itself (flat and a 2-level pyramid). Also the tracking
projection's plain VJP (`tracking_rows_vjp_plain`, the chain its CUDA
kernel computes) against autograd, on a scene and on edge cases.

Inputs are made with numpy from a seed and fed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu.mapping.gaussians import empty_map as j_empty_map  # noqa: E402
from gslam_tpu.ops import losses as jl  # noqa: E402
from gslam_tpu.ops import track_fused as jf  # noqa: E402
from gslam_tpu.ops.rasterize import RenderConfig as JRenderConfig  # noqa: E402
from gslam_tpu.ops.rasterize import compute_bins as j_compute_bins  # noqa: E402
from gslam_tpu.core.transforms import PoseDelta as JPoseDelta  # noqa: E402
from gslam_tpu.core.transforms import pose_matrix as j_pose_matrix  # noqa: E402
from gslam_tpu.opt.lbfgs_compact import warmup_lbfgs_impl as j_warmup_lbfgs  # noqa: E402
from gslam_tpu.tracking import track as jt  # noqa: E402
from gslam_tpu_torch.core.transforms import PoseDelta, pose_matrix  # noqa: E402
from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy  # noqa: E402
from gslam_tpu_torch.ops import losses as tl  # noqa: E402
from gslam_tpu_torch.ops import track_fused as tf  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig, compute_bins  # noqa: E402
from gslam_tpu_torch.opt.lbfgs_compact import warmup_lbfgs_impl  # noqa: E402
from gslam_tpu_torch.runtime import trace  # noqa: E402
from gslam_tpu_torch.tracking import track as tt  # noqa: E402

import test_torch_track_rows_cuda as rc  # noqa: E402

from scene_utils import make_scene  # noqa: E402

CPU = "cpu"
CAP = 64  # tile_capacity of the small scenes


def T(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def scene(seed, n, width, height):
    """numpy map fields, K, and both packages' maps."""
    params, _vm, Ks, w, h = make_scene(np.random.default_rng(seed), n=n,
                                       width=width, height=height)
    d = {k: np.asarray(v) for k, v in params.items()}
    jmap = j_empty_map(n)._replace(**{k: jnp.asarray(v) for k, v in d.items()})
    return d, np.asarray(Ks[0]), jmap, gaussian_map_from_numpy(d, device=CPU)


def pose_np(rotvec, t):
    import scipy.spatial.transform as sst

    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = sst.Rotation.from_rotvec(rotvec).as_matrix()
    M[:3, 3] = t
    return M


# ---------------------------------------------------------------- fused render


def test_render_tracking_fused_and_x_gradient_match_jax():
    # 88x56 is a ragged 6x4 tile grid: the last tile column and row are
    # computed and then cropped
    W, H = 88, 56
    d, K, jmap, tmap = scene(21, 250, W, H)
    base = pose_np([0.01, -0.02, 0.015], [0.02, -0.01, 0.03])
    rng = np.random.default_rng(22)
    x = np.concatenate([rng.normal(size=9) * 0.01, [0.05, -0.02]]).astype(np.float32)
    gt = rng.random((H, W, 3)).astype(np.float32)
    jcfg, tcfg = JRenderConfig(tile_capacity=CAP), RenderConfig(tile_capacity=CAP)

    def j_loss(xv, tiles):
        pose = j_pose_matrix(JPoseDelta(jnp.asarray(base), xv[:6], xv[6:9]))
        rgb, depth, beta, alpha = jf.render_tracking_fused(
            tiles, pose, jnp.asarray(K), W, H, jcfg)
        loss = jl.tracking_photometric(jl.apply_exposure(rgb, xv[9:11]),
                                       jnp.asarray(gt), beta)
        return loss + 0.1 * jnp.mean(depth * alpha), (rgb, depth, beta, alpha)

    @jax.jit
    def j_run(xv):
        bins = j_compute_bins(jmap.means, jmap.quats, jmap.log_scales, jmap.alive,
                              jnp.asarray(base)[None], jnp.asarray(K)[None], W, H,
                              jcfg, radius_scale=1.5)
        tiles = jf.gather_tracking_tiles(jmap, bins)
        return jax.value_and_grad(lambda v: j_loss(v, tiles), has_aux=True)(xv)

    (jloss, jimgs), jgrad = j_run(jnp.asarray(x))

    bins = compute_bins(tmap.means, tmap.quats, tmap.log_scales, tmap.alive,
                        T(base)[None], T(K)[None], W, H, tcfg, radius_scale=1.5)
    tiles = tf.gather_tracking_tiles(tmap, bins)
    xt = T(x).requires_grad_(True)
    pose = pose_matrix(PoseDelta(T(base), xt[:6], xt[6:9]))
    timgs = tf.render_tracking_fused(tiles, pose, T(K), W, H, tcfg)
    rgb, depth, beta, alpha = timgs
    tloss = tl.tracking_photometric(tl.apply_exposure(rgb, xt[9:11]), T(gt), beta)
    tloss = tloss + 0.1 * torch.mean(depth * alpha)
    (tgrad,) = torch.autograd.grad(tloss, xt)

    assert alpha.shape == (H, W) and float(alpha.detach().max()) > 0.5
    for name, a, b, tol in zip(("rgb", "depth", "beta", "alpha"), jimgs, timgs,
                               (1e-5, 1e-4, 1e-4, 1e-5)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    # float32 reductions over every (tile, slot) in another order
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=1e-3)


def _scene_tiles():
    """The parity test's small scene gathered at its base pose, a viewmat
    near it, K and cotangents drawn from N(0, 1)."""
    W, H = 88, 56
    _d, K, _jmap, tmap = scene(21, 250, W, H)
    base = T(pose_np([0.01, -0.02, 0.015], [0.02, -0.01, 0.03]))
    cfg = RenderConfig(tile_capacity=CAP)
    bins = compute_bins(tmap.means, tmap.quats, tmap.log_scales, tmap.alive, base[None],
                        T(K)[None], W, H, cfg, radius_scale=1.5)
    tg = tf.gather_tracking_tiles(tmap, bins)
    gen = torch.Generator().manual_seed(23)
    Tn, _, M = tg.m3d.shape
    g = [torch.randn(Tn, c, M, generator=gen) for c in (2, 3, 5)]
    vm = base @ T(pose_np([0.004, 0.002, -0.003], [0.003, 0.001, -0.002]))
    return tg, g, vm, T(K), W, H, cfg


@pytest.mark.parametrize("case", ("scene",) + rc.EDGE_CASES)
def test_tracking_rows_vjp_plain_matches_autograd(case):
    """tracking_rows_vjp_plain against autograd through tracking_rows_plain:
    in float64 to rounding, in float32 by the card tests' rule against
    float64 autograd; on the CPU the node gives the plain rows and autograd's
    gradient through them bit for bit, and counts no kernel forward."""
    if case == "scene":
        tg, g, vm, K, W, H, cfg = _scene_tiles()
    else:
        (tg, g), vm, K = rc.edge_tiles(case), rc.edge_pose(), rc.edge_K()
        W, H, cfg = rc.EDGE_W, rc.EDGE_H, rc.EDGE_CFG
    in_depth, in_x, in_y, det_ok = tf._forward_masks(tg, vm, K, W, H, cfg)
    edge = {"scene": in_depth, "ordinary": in_depth & in_x & in_y & det_ok,
            "behind_near": ~in_depth, "beyond_far": ~in_depth, "outside_clamp": ~(in_x & in_y),
            "det_nonpositive": ~det_ok, "invalid_slots": tg.opac[:, 0] == 0,
            "all_edges": ~(in_depth & in_x & in_y & det_ok)}[case]
    assert bool(edge.any())

    p32, r64 = rc.viewmat_grads(tg, vm, K, W, H, cfg, g)
    g64 = tf.tracking_rows_vjp_plain(rc.moved(tg, CPU, torch.float64), vm.double(),
                                     K.double(), W, H, cfg, *(x.double() for x in g))
    np.testing.assert_allclose(g64.numpy(), r64.numpy(), rtol=1e-9,
                               atol=1e-12 * float(r64.abs().max()))
    g32 = tf.tracking_rows_vjp_plain(tg, vm, K, W, H, cfg, *g)
    assert g32.dtype == torch.float32
    rc.assert_gradient_rule(g32, p32, r64, case)

    before = trace.snapshot()["counters"].get("track.rows_kernel", 0)
    v = vm.clone().requires_grad_(True)
    rows = tf.tracking_rows(tg, v, K, W, H, cfg)
    for a, b in zip(rows, tf.tracking_rows_plain(tg, vm, K, W, H, cfg)):
        assert torch.equal(a, b)
    assert not rows[2].requires_grad
    loss = sum((r * c).sum() for r, c in zip((rows[0], rows[1], rows[3]), g))
    (auto,) = torch.autograd.grad(loss, v)
    assert torch.equal(auto, p32)
    assert trace.snapshot()["counters"].get("track.rows_kernel", 0) == before
    with pytest.raises(ValueError):
        tf.tracking_rows(tg, v, K.clone().requires_grad_(True), W, H, cfg)


# ---------------------------------------------------------------- losses


def test_losses_match_jax():
    rng = np.random.default_rng(31)
    rend = rng.random((2, 12, 10, 3)).astype(np.float32)
    gt = rng.random((2, 12, 10, 3)).astype(np.float32)
    betas = rng.uniform(0.1, 2.0, (2, 12, 10)).astype(np.float32)
    for kind in ("l1", "mse", "active-nerf"):
        np.testing.assert_allclose(
            float(tl.tracking_photometric(T(rend), T(gt), T(betas), kind)),
            float(jl.tracking_photometric(jnp.asarray(rend), jnp.asarray(gt),
                                          jnp.asarray(betas), kind)),
            rtol=1e-6, err_msg=kind)
    with pytest.raises(ValueError):
        tl.tracking_photometric(T(rend), T(gt), T(betas), "huber")

    dr = rng.uniform(0, 4, (2, 12, 10)).astype(np.float32)
    dg = np.where(rng.random((2, 12, 10)) > 0.3, rng.uniform(0, 4, (2, 12, 10)),
                  0.0).astype(np.float32)
    alpha = rng.random((2, 12, 10)).astype(np.float32)
    cam = np.array([True, False])
    for kw in ({}, {"alpha_min": 0.5}, {"cam_mask": cam, "alpha_min": 0.3}):
        j = jl.masked_depth_l1(jnp.asarray(dr), jnp.asarray(dg), alpha=jnp.asarray(alpha),
                               **{k: (jnp.asarray(v) if k == "cam_mask" else v)
                                  for k, v in kw.items()})
        t = tl.masked_depth_l1(T(dr), T(dg), alpha=T(alpha),
                               **{k: (torch.as_tensor(v) if k == "cam_mask" else v)
                                  for k, v in kw.items()})
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6, err_msg=str(kw))

    expo = rng.normal(size=(2, 2)).astype(np.float32) * 0.2
    np.testing.assert_allclose(
        tl.apply_exposure(T(rend), T(expo)).numpy(),
        np.asarray(jl.apply_exposure(jnp.asarray(rend), jnp.asarray(expo))),
        atol=1e-6)


# ---------------------------------------------------------------- optimizer

_W = np.random.default_rng(0).normal(size=(32, 9)).astype(np.float32)
_Y = np.random.default_rng(1).normal(size=32).astype(np.float32)
_A = np.diag(np.array([1.0, 10.0, 100.0], np.float32))
_B = np.array([1.0, -2.0, 3.0], np.float32)

# name: (loss(x, xp), x0, options); xp is jnp or torch
PROBLEMS = {
    "quadratic": (
        lambda x, xp: 0.5 * x @ xp.asarray(_A) @ x - xp.asarray(_B) @ x,
        np.zeros(3, np.float32), dict(warmup_steps=0, max_iter=50, max_eval=100)),
    "rosenbrock": (
        lambda x, xp: (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2,
        np.array([-1.2, 1.0], np.float32),
        dict(warmup_steps=0, max_iter=100, max_eval=400)),
    "tanh": (
        lambda x, xp: xp.sum((xp.tanh(xp.asarray(_W) @ x) - xp.asarray(_Y)) ** 2),
        np.zeros(9, np.float32),
        dict(warmup_steps=0, max_iter=20, max_eval=25, history=5, lr=1.0)),
    "tanh_warmup": (
        lambda x, xp: xp.sum((xp.tanh(xp.asarray(_W) @ x) - xp.asarray(_Y)) ** 2),
        np.zeros(9, np.float32),
        # stops short of the minimum's flat floor, where the two packages'
        # one-ulp differences in tanh and matmul steer the line search
        dict(warmup_steps=4, max_iter=20, max_eval=12, history=3, lr=0.5,
             warmup_lr=0.05)),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_warmup_lbfgs_matches_jax(name):
    """Held against the JAX loop run op by op (jax.disable_jit), where every
    float32 operation rounds as torch's eager ones do. Jitted, XLA fuses and
    reorders the float32 arithmetic, and near convergence that changes which
    termination test fires first (the quadratic stops after 17 evaluations
    op by op and after 101 jitted)."""
    loss, x0, kw = PROBLEMS[name]
    with jax.disable_jit():
        jx, jfv, jn = j_warmup_lbfgs(lambda x: loss(x, jnp), jnp.asarray(x0),
                                     fixed_trip=False, **kw)
    tx, tfv, tn = warmup_lbfgs_impl(lambda x: loss(x, torch), T(x0), **kw)
    assert tn == int(jn), (tn, int(jn))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(float(tfv), float(jfv), atol=1e-5)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def track_setup():
    """A 96x64, 300-splat scene, its ground truth rendered by the port at a
    known pose (rgb and expected depth), and a prior 1.3 cm / 0.45 degree
    off it."""
    W, H = 96, 64
    d, K, jmap, tmap = scene(41, 300, W, H)
    gt_pose = pose_np([0.004, -0.006, 0.003], [0.01, -0.008, 0.004])
    cfg = RenderConfig(tile_capacity=CAP)
    bins = compute_bins(tmap.means, tmap.quats, tmap.log_scales, tmap.alive,
                        T(gt_pose)[None], T(K)[None], W, H, cfg)
    with torch.no_grad():
        rgb, depth, _, alpha = tf.render_tracking_fused(
            tf.gather_tracking_tiles(tmap, bins), T(gt_pose), T(K), W, H, cfg)
    gt = np.clip(rgb.numpy(), 0.0, 1.0)
    gt_depth = np.where(alpha.numpy() > 0.5,
                        depth.numpy() / np.maximum(alpha.numpy(), 1e-3), 0.0)
    prior = pose_np([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    return dict(W=W, H=H, K=K, jmap=jmap, tmap=tmap, gt=gt, gt_pose=gt_pose,
                prior=prior, gt_depth=gt_depth.astype(np.float32))


@pytest.mark.parametrize("levels,rgbd,fused",
                         [(1, False, True), (2, False, True), (1, True, True),
                          (1, False, False)],
                         ids=["flat", "pyramid2", "flat_rgbd", "flat_unfused"])
def test_track_frame_matches_jax(track_setup, levels, rgbd, fused):
    """fused=False renders each evaluation through the generic render_impl
    with the frame's reused bins, in both packages."""
    s = track_setup
    common = dict(warmup_steps=3, lbfgs_max_iter=12, lbfgs_max_eval=12,
                  pyramid_levels=levels, pyramid_evals=(8, 6), use_gt_depths=rgbd,
                  fused=fused)
    depth = s["gt_depth"] if rgbd else None
    jcfg = jt.TrackingConfig(render=JRenderConfig(tile_capacity=CAP), **common)
    tcfg = tt.TrackingConfig(render=RenderConfig(tile_capacity=CAP), **common)
    jr = jt.track_frame(s["jmap"], jnp.asarray(s["prior"]), jnp.zeros(2),
                        jnp.asarray(s["gt"]), jnp.asarray(s["K"]), s["W"], s["H"], jcfg,
                        gt_depth=None if depth is None else jnp.asarray(depth))
    tr = tt.track_frame(s["tmap"], s["prior"], np.zeros(2, np.float32), s["gt"],
                        s["K"], s["W"], s["H"], tcfg, gt_depth=depth, device=CPU)
    assert tr.n_evals == int(jr.n_evals) and tr.rejected == bool(jr.rejected)
    # The line search's cubic fits amplify float32 rounding: the JAX tracker
    # itself moves its pose by 1.1e-4 (flat), 7.3e-4 (2 levels) and 4.4e-4
    # (RGB-D) when the image gets 1e-6 noise; the port sits 1.5e-4, 1.5e-4
    # and 6.4e-4 from it (1.2e-4 unfused).
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-3)
    np.testing.assert_allclose(tr.exposure.numpy(), np.asarray(jr.exposure), atol=1e-3)
    # the loss at poses that far apart: 0.4% (RGB), 2% with the alpha-masked
    # depth term, whose pixel set moves with the pose
    np.testing.assert_allclose(float(tr.loss), float(jr.loss), rtol=5e-2 if rgbd else 1e-2)
    # the refinement moved toward the ground truth
    err = np.linalg.norm(tr.pose.numpy()[:3, 3] - s["gt_pose"][:3, 3])
    assert err < np.linalg.norm(s["prior"][:3, 3] - s["gt_pose"][:3, 3])


def test_track_frame_guard_and_unported_configs(track_setup):
    s = track_setup
    args = (s["tmap"], s["prior"], np.zeros(2, np.float32), s["gt"], s["K"],
            s["W"], s["H"])
    # a zero step bound rejects every refinement: the prior comes back
    cfg = tt.TrackingConfig(render=RenderConfig(tile_capacity=CAP), warmup_steps=2,
                            lbfgs_max_eval=3, max_step=0.0)
    r = tt.track_frame(*args, cfg, device=CPU)
    assert r.rejected and float(r.loss) == 1e3
    np.testing.assert_allclose(r.pose.numpy(), s["prior"], atol=1e-6)
    # Gauss-Newton is ported (tests/test_torch_gn.py) and takes the same guard
    r = tt.track_frame(*args, dataclasses.replace(cfg, method="gn", gn_iters=2), device=CPU)
    assert r.rejected and float(r.loss) == 1e3
    np.testing.assert_allclose(r.pose.numpy(), s["prior"], atol=1e-6)
    r = tt.track_frame(*args, dataclasses.replace(cfg, fused=False), device=CPU)
    assert r.rejected and float(r.loss) == 1e3
