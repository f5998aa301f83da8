"""The port's Gauss-Newton tracker (TrackingConfig.method="gn") against the
JAX package on the CPU, and tests/test_gauss_newton.py's bounds on the port.

Parity: the same map fields, frames and depths (numpy, from the JAX
package's synthetic scene) go through JAX's `track_frame` and the port's:
the start loss f0 and the first normal system JtJ, Jtr within rtol 1e-4
(norm-relative), the accept sequence and render-pass count of JAX's loop
(up to decisions at the float32 floor) with each iteration's loss within
1e-4 of f0 while they agree, final poses within 1e-4. The
forward-mode render route is held against JAX's jnp blend, the route JAX's
tracker pins, within 1e-5.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset  # noqa: E402
from gslam_tpu.ops import rasterize as jr  # noqa: E402
from gslam_tpu.ops.losses import apply_exposure as j_apply_exposure  # noqa: E402
from gslam_tpu.core.transforms import HIGH, PoseDelta as JPoseDelta  # noqa: E402
from gslam_tpu.core.transforms import pose_matrix as j_pose_matrix  # noqa: E402
from gslam_tpu.tracking import track as jt  # noqa: E402
from gslam_tpu_torch.io.synthetic import SyntheticDataset  # noqa: E402
from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig, compute_bins, render, render_impl  # noqa: E402
from gslam_tpu_torch.tracking.track import (  # noqa: E402
    GaussNewtonProblem, TrackingConfig, levenberg_marquardt, track_frame,
)

CPU = "cpu"
W, H = 96, 72
_RCFG = RenderConfig(tile_capacity=128, tile_chunk=16)
_JRCFG = jr.RenderConfig(tile_capacity=128, tile_chunk=16)
MAP_FIELDS = ("means", "quats", "log_scales", "logit_opacities", "logit_colors",
              "log_uncertainties", "alive")


def _center(m):
    m = np.asarray(m)
    return -m[:3, :3].T @ m[:3, 3]


# ------------------------------------------------- tests/test_gauss_newton.py


@pytest.fixture(scope="module")
def scene():
    ds = SyntheticDataset(seq_len=4, width=W, height=H, n_splats=1500, seed=0,
                          motion_scale=0.03, device=CPU)
    return ds, gaussian_map_from_numpy(ds.gt_map_fields, device=CPU)


def test_gn_converges_from_prev_frame_prior(scene):
    """~7 cm prior error -> sub-mm in <= 2 gn_iters + 1 render passes."""
    ds, gmap = scene
    cfg = TrackingConfig(method="gn", gn_iters=10, render=_RCFG)
    prior = ds.poses[0]
    r = track_frame(gmap, prior, np.zeros(2), ds.images[1], ds.camera.K, W, H, cfg,
                    device=CPU)
    err_prior = np.linalg.norm(_center(prior) - _center(ds.poses[1]))
    err = np.linalg.norm(_center(r.pose) - _center(ds.poses[1]))
    assert not r.rejected
    assert err_prior > 0.02  # the prior really is far off
    assert err < 1e-3, (err_prior, err)
    assert r.n_evals <= 2 * cfg.gn_iters + 1


def test_gn_rgbd_depth_residual(scene):
    """RGB-D mode: the alpha-normalized depth rows are part of the normal
    system and the tracker still converges."""
    ds, gmap = scene
    cfg = TrackingConfig(method="gn", gn_iters=10, use_gt_depths=True, render=_RCFG)
    out = render(**gmap.render_kwargs(), viewmats=ds.poses[1][None],
                 Ks=ds.camera.K[None], width=W, height=H, cfg=_RCFG, device=CPU)
    gt_depth = out.depth[0] / torch.clamp(out.alpha[0], min=1e-3)
    r = track_frame(gmap, ds.poses[0], np.zeros(2), ds.images[1], ds.camera.K, W, H, cfg,
                    gt_depth=gt_depth, device=CPU)
    err = np.linalg.norm(_center(r.pose) - _center(ds.poses[1]))
    assert not r.rejected
    assert err < 2e-3, err


def test_gn_guard_rejects_nonfinite_image(scene):
    """A NaN frame must trip the divergence guard, not poison the pose."""
    ds, gmap = scene
    cfg = TrackingConfig(method="gn", gn_iters=4, render=_RCFG)
    bad = np.full_like(ds.images[1], np.nan)
    r = track_frame(gmap, ds.poses[0], np.zeros(2), bad, ds.camera.K, W, H, cfg,
                    device=CPU)
    assert r.rejected
    # fallback pose is the untouched prior
    np.testing.assert_allclose(r.pose.numpy(), ds.poses[0], atol=1e-6)


def test_gn_pyramid_dispatch(scene):
    """method='gn' + pyramid_levels>1 runs GN at every level."""
    ds, gmap = scene
    cfg = TrackingConfig(method="gn", gn_iters=6, pyramid_levels=2, render=_RCFG)
    r = track_frame(gmap, ds.poses[0], np.zeros(2), ds.images[1], ds.camera.K, W, H, cfg,
                    device=CPU)
    err = np.linalg.norm(_center(r.pose) - _center(ds.poses[1]))
    assert not r.rejected
    assert err < 1e-3, err
    assert r.n_evals <= 2 * (2 * cfg.gn_iters + 1)


def test_gn_without_exposure_converges(scene):
    """learn_exposure=False: a 9-vector and a 9x9 system (the JAX tracker
    sizes its start vector 11 here and cannot linearize it: C-ref1)."""
    ds, gmap = scene
    cfg = TrackingConfig(method="gn", gn_iters=10, learn_exposure=False, render=_RCFG)
    prob = GaussNewtonProblem(gmap, torch.from_numpy(ds.poses[0]), torch.zeros(2),
                              torch.from_numpy(ds.images[1]), ds.camera.K, W, H, cfg)
    assert prob.x0().shape == (9,)
    JtJ, Jtr = prob.normal_equations(prob.x0())
    assert JtJ.shape == (9, 9) and Jtr.shape == (9,)
    r = track_frame(gmap, ds.poses[0], np.zeros(2), ds.images[1], ds.camera.K, W, H, cfg,
                    device=CPU)
    err = np.linalg.norm(_center(r.pose) - _center(ds.poses[1]))
    assert not r.rejected
    assert err < 1e-3, err
    np.testing.assert_array_equal(r.exposure.numpy(), np.zeros(2))


# ------------------------------------------------------------ parity with JAX


@pytest.fixture(scope="module")
def jax_scene():
    """The JAX package's scene as numpy: map fields, frames, K, and frame 1's
    alpha-normalized depth rendered by JAX's jnp route."""
    ds = JSyntheticDataset(seq_len=4, width=W, height=H, n_splats=1500, seed=0,
                           motion_scale=0.03)
    fields = {f: np.array(getattr(ds.gt_map, f)) for f in MAP_FIELDS}
    K = np.array(ds.camera.K, np.float32)
    out = jr.render(**ds.gt_map.render_kwargs(), viewmats=jnp.asarray(ds.poses[1])[None],
                    Ks=jnp.asarray(K)[None], width=W, height=H, cfg=_JRCFG)
    depth = np.array(out.depth[0] / jnp.maximum(out.alpha[0], 1e-3))
    return dict(jmap=ds.gt_map, fields=fields, K=K, poses=np.array(ds.poses),
                pose0=np.array(ds.poses[0]), img1=np.array(ds.images[1]), depth1=depth)


@partial(jax.jit, static_argnames=("cfg", "use_depth"))
def _jax_lm_iter(jmap, base, img, K, gt_depth, x, lam, f, cfg, use_depth):
    """One iteration of JAX's track_frame_gn_impl loop through its own path
    (compute_bins at the prior, render_impl pinned to backend="xla",
    jax.linearize; tracking/track.py:285-374), with learn_exposure=True.
    Returns the new (x, lam, f), this iteration's JtJ, Jtr, f_new and
    (better, done), and the loss at x (f0 when x = x0)."""
    bins = jr.compute_bins(jmap.means, jmap.quats, jmap.log_scales, jmap.alive,
                           base[None], K[None], W, H, cfg.render,
                           radius_scale=cfg.bin_radius_margin)
    rcfg = dataclasses.replace(cfg.render, backend="xla")
    gt_d = gt_depth.reshape(-1)

    def resid_parts(x):
        pose = j_pose_matrix(JPoseDelta(base, x[:6], x[6:9]))
        out = jr.render_impl(**jmap.render_kwargs(), viewmats=pose[None], Ks=K[None],
                             width=W, height=H, cfg=rcfg, bins=bins)
        err = (j_apply_exposure(out.rgb[0], x[9:11]) - img).reshape(-1)
        if use_depth:
            d_hat = out.depth[0] / jnp.maximum(out.alpha[0], 1e-3)
            derr = (d_hat - gt_depth).reshape(-1)
        else:
            derr = jnp.zeros((1,), jnp.float32)
        return err, derr, out.beta[0].reshape(-1), out.alpha[0].reshape(-1)

    def valid_count(alpha):
        valid = (gt_d > 0.0) & (alpha > cfg.depth_alpha_min)
        return valid, jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)

    def true_loss(err, derr, beta, alpha):
        loss = jnp.mean(jnp.sum(err.reshape(-1, 3) ** 2, axis=-1) * beta ** -2.0)
        if use_depth:
            valid, nv = valid_count(alpha)
            loss = loss + cfg.depth_loss_weight * (
                jnp.sum(jnp.where(valid, jnp.abs(derr), 0.0)) / nv)
        return loss

    (err, derr, beta, alpha), jvp = jax.linearize(resid_parts, x)
    w_rgb = 1.0 / (beta * jnp.sqrt(float(H * W)))
    if use_depth:
        valid, nv = valid_count(alpha)
        w2 = cfg.depth_loss_weight / (jnp.maximum(jnp.abs(derr), cfg.gn_huber_depth) * nv)
        w_d = jnp.where(valid, jnp.sqrt(w2), 0.0)
    else:
        w_d = jnp.zeros_like(derr)
    w3 = jnp.repeat(w_rgb, 3)
    r = jnp.concatenate([err * w3, derr * w_d])
    eye = jnp.eye(11, dtype=jnp.float32)
    Je, Jd, _, _ = jax.vmap(jvp)(eye)
    J = jnp.concatenate([Je * w3[None, :], Jd * w_d[None, :]], axis=1)
    JtJ = jnp.matmul(J, J.T, precision=HIGH)
    Jtr = jnp.matmul(J, r, precision=HIGH)
    delta = -jnp.linalg.solve(JtJ + lam * jnp.diag(jnp.diagonal(JtJ)) + 1e-8 * eye, Jtr)
    f_new = true_loss(*resid_parts(x + delta))
    better = jnp.isfinite(f_new) & (f_new < f)
    done = (better & (jnp.linalg.norm(delta) < cfg.gn_tol)) | (
        jnp.where(better, lam * 0.33, lam * 10.0) > 1e7)
    return (jnp.where(better, x + delta, x), jnp.where(better, lam * 0.33, lam * 10.0),
            jnp.where(better, f_new, f), JtJ, Jtr, f_new, better, done,
            true_loss(err, derr, beta, alpha))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


@pytest.mark.parametrize("rgbd", [False, True], ids=["mono", "rgbd"])
def test_gn_matches_jax(jax_scene, rgbd):
    """f0 and the first normal system within rtol 1e-4; the accept sequence
    equal to JAX's loop, hence equal render-pass counts, unless the two part
    only once both losses are below 1e-4 of f0 (the float32 floor of the
    objective: there x drifts apart along the 6D rotation's null directions
    and the depth L1 rounds at ~1e-7 m, so accept decisions are rounding);
    the final pose and exposure within 1e-4 of JAX's track_frame either way."""
    s = jax_scene
    cfg = TrackingConfig(method="gn", gn_iters=10, use_gt_depths=rgbd, render=_RCFG)
    jcfg = jt.TrackingConfig(method="gn", gn_iters=10, use_gt_depths=rgbd, render=_JRCFG)
    depth = s["depth1"] if rgbd else None
    base, img, K = (jnp.asarray(s[k]) for k in ("pose0", "img1", "K"))
    exp0 = np.zeros(2, np.float32)
    jres = jt.track_frame(s["jmap"], base, jnp.asarray(exp0), img, K, W, H, jcfg,
                          gt_depth=None if depth is None else jnp.asarray(depth))

    # JAX's loop, iteration by iteration, from f0 (the loss at x0)
    args = (s["jmap"], base, img, K, jnp.asarray(s["depth1"]))
    x = jnp.concatenate([jnp.zeros(9), jnp.asarray(exp0)])
    lam = jnp.float32(jcfg.gn_lambda0)
    f = _jax_lm_iter(*args, x, lam, jnp.float32(np.inf), jcfg, rgbd)[-1]
    jf0, jsteps = float(f), []
    for k in range(jcfg.gn_iters):
        x, lam, f, JtJ_k, Jtr_k, _f_new, better, done, _ = _jax_lm_iter(
            *args, x, lam, f, jcfg, rgbd)
        if k == 0:
            jJtJ, jJtr = JtJ_k, Jtr_k
        jsteps.append((bool(better), float(f)))
        if bool(done):
            break
    assert 1 + 2 * len(jsteps) == int(jres.n_evals)

    gmap = gaussian_map_from_numpy(s["fields"], device=CPU)
    T = torch.from_numpy
    prob = GaussNewtonProblem(gmap, T(s["pose0"]), T(exp0), T(s["img1"]), T(s["K"]), W, H,
                              cfg, None if depth is None else T(depth))
    x0 = prob.x0()
    f0 = prob.loss(*prob.residuals(x0))
    JtJ, Jtr = prob.normal_equations(x0)
    assert _rel(f0, jf0) <= 1e-4, (float(f0), jf0)
    assert _rel(JtJ, jJtJ) <= 1e-4
    assert _rel(Jtr, jJtr) <= 1e-4

    x, _f, n_evals, steps = levenberg_marquardt(prob, cfg)
    seq, jseq = [a for a, _ in steps], [a for a, _ in jsteps]
    part = next((k for k, (a, b) in enumerate(zip(seq, jseq)) if a != b), None)
    if part is None and len(seq) != len(jseq):
        part = min(len(seq), len(jseq))
    # each loss while the sequences agree, within 1e-4 of f0: the loss falls
    # by ~5 orders, so its float32 rounding is a share of f0, not of itself
    for k in range(len(seq) if part is None else part):
        assert abs(steps[k][1] - jsteps[k][1]) <= 1e-4 * jf0, (k, steps, jsteps, jf0)
    if part is None:
        assert n_evals == int(jres.n_evals), (steps, jsteps)
    else:  # the losses before the parting iteration, on both sides
        assert part > 0 and max(steps[part - 1][1], jsteps[part - 1][1]) < 1e-4 * jf0, (
            part, steps, jsteps, jf0)
    assert not bool(jres.rejected)
    pose, exposure = prob.unpack(x)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    np.testing.assert_allclose(exposure.numpy(), np.asarray(jres.exposure), atol=1e-4)


def test_forward_route_render_matches_jax_jnp_route(jax_scene):
    """render_impl(forward_mode=True) against JAX's jnp blend (backend
    "xla") with the same precomputed bins, at a pose off the binning pose,
    on a ragged tile grid (88x56) and a chunk that does not divide it."""
    s = jax_scene
    w, h = 88, 56
    pose = s["poses"][1]
    K = s["K"].copy()
    K[0, 2], K[1, 2] = w / 2, h / 2
    jcfg = jr.RenderConfig(tile_capacity=128, tile_chunk=5, backend="xla")
    tcfg = RenderConfig(tile_capacity=128, tile_chunk=5)
    jbins = jr.compute_bins_jit(s["jmap"].means, s["jmap"].quats, s["jmap"].log_scales,
                                s["jmap"].alive, jnp.asarray(s["poses"][0])[None],
                                jnp.asarray(K)[None], w, h, jcfg, radius_scale=1.5)
    jout = jr.render(**s["jmap"].render_kwargs(), viewmats=jnp.asarray(pose)[None],
                     Ks=jnp.asarray(K)[None], width=w, height=h, cfg=jcfg, bins=jbins)
    gmap = gaussian_map_from_numpy(s["fields"], device=CPU)
    bins = compute_bins(gmap.means, gmap.quats, gmap.log_scales, gmap.alive,
                        torch.from_numpy(s["poses"][0])[None], torch.from_numpy(K)[None],
                        w, h, tcfg, radius_scale=1.5)
    np.testing.assert_array_equal(bins.tile_gauss.numpy()[bins.tile_mask.numpy()],
                                  np.asarray(jbins.tile_gauss)[np.asarray(jbins.tile_mask)])
    out = render_impl(**gmap.render_kwargs(), viewmats=torch.from_numpy(pose)[None],
                      Ks=torch.from_numpy(K)[None], width=w, height=h, cfg=tcfg,
                      bins=bins, forward_mode=True)
    for name in ("rgb", "depth", "beta", "alpha"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out.n_touched.numpy(), np.asarray(jout.n_touched))
