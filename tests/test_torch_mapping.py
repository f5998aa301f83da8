"""Parity of the port's mapping slice with the JAX package on the CPU: the
masked Adam, the Gaussian buffer's median/compaction/growth, the keyframe
store, SSIM, the mapping losses, the pruning masks, the render-only
programs and `mapping_step` itself.

Inputs are made with numpy from a seed and fed to both packages. JAX's
programs are jitted, so XLA may reorder float32 sums: values are held to
stated tolerances, integer outputs exactly. At Adam's first step the update
is about lr * sign(g), so two correct implementations can move a splat with
a near-zero gradient by up to 2 lr: the map after a step is compared tightly
only where |g| > 1e-4, and within 2 lr elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu.mapping import backend_ops as jb  # noqa: E402
from gslam_tpu.mapping import gaussians as jg  # noqa: E402
from gslam_tpu.mapping import keyframes as jk  # noqa: E402
from gslam_tpu.mapping import optimizer as jo  # noqa: E402
from gslam_tpu.mapping import pruning as jp  # noqa: E402
from gslam_tpu.ops import losses as jl  # noqa: E402
from gslam_tpu.ops.rasterize import RenderConfig as JRenderConfig  # noqa: E402
from gslam_tpu.ops.ssim import ssim_per_image as j_ssim  # noqa: E402
from gslam_tpu_torch.mapping import backend_ops as tb  # noqa: E402
from gslam_tpu_torch.mapping import gaussians as tg  # noqa: E402
from gslam_tpu_torch.mapping import keyframes as tk  # noqa: E402
from gslam_tpu_torch.mapping import optimizer as to  # noqa: E402
from gslam_tpu_torch.mapping import pruning as tp  # noqa: E402
from gslam_tpu_torch.ops import losses as tl  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig  # noqa: E402
from gslam_tpu_torch.ops.ssim import ssim_per_image as t_ssim  # noqa: E402

CPU = "cpu"
H = W = 32
CAP = 256
N_KF = 4
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


def T(x):
    return torch.from_numpy(np.array(x))


def map_fields(rng, cap=CAP, n_dead=20):
    """test_slam_modes.py's mapping scene (splats around z=2 in front of a
    32x32 camera), with random rotations, colors and uncertainties and
    `n_dead` dead slots."""
    alive = np.ones(cap, bool)
    alive[rng.choice(cap, n_dead, replace=False)] = False
    return dict(
        means=(rng.normal(0, 0.5, (cap, 3)) + [0, 0, 2.0]).astype(np.float32),
        quats=rng.normal(size=(cap, 4)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.06, 0.14, (cap, 3))).astype(np.float32),
        logit_opacities=rng.normal(1.0, 0.5, cap).astype(np.float32),
        logit_colors=rng.normal(size=(cap, 3)).astype(np.float32),
        log_uncertainties=rng.uniform(-0.3, 0.3, cap).astype(np.float32),
        ages=rng.integers(0, 5, cap).astype(np.int32),
        alive=alive,
    )


def j_map(d):
    return jg.empty_map(d["means"].shape[0])._replace(
        **{k: jnp.asarray(v) for k, v in d.items()})


def pose(t, rotvec=(0.0, 0.0, 0.0)):
    import scipy.spatial.transform as sst

    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = sst.Rotation.from_rotvec(rotvec).as_matrix()
    m[:3, 3] = t
    return m


K_NP = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)


# ---------------------------------------------------------------- mapping_step


@pytest.fixture(scope="module", params=[False, True], ids=["rgb", "gt_depths"])
def step_case(request):
    """One mapping step in both packages: keyframes 0-2 (frame 0 frozen)
    and one padded slot in a window of 4; JAX's window-loss gradients too."""
    use_gt = request.param
    rng = np.random.default_rng(5)
    d = map_fields(rng)
    kf = jk.empty_keyframes(N_KF, H, W)
    for slot in range(3):
        kf = jk.add_keyframe(
            kf, slot, jnp.asarray(rng.random((H, W, 3)).astype(np.float32)),
            jnp.asarray(pose([0.03 * slot, -0.01 * slot, 0.0], [0.0, 0.01 * slot, 0.0])),
            jnp.asarray([0.05 * slot, -0.01]), slot,
            gt_depth=jnp.asarray(rng.uniform(1.5, 2.5, (H, W)).astype(np.float32)))
    # a pose delta and an Adam history on keyframe 1, so the step is not the first
    kf = kf._replace(d_t=kf.d_t.at[1].set(jnp.asarray([0.002, -0.001, 0.003])))
    pose_opt = jb.init_pose_adam(N_KF)
    pose_opt = pose_opt._replace(
        mu=pose_opt.mu.at[1].set(0.01), nu=pose_opt.nu.at[1].set(1e-4),
        count=pose_opt.count.at[1].set(3))
    widx = np.array([0, 1, 2, 0], np.int32)
    wmask = np.array([True, True, True, False])
    common = dict(window_size=4, use_gt_depths=use_gt)
    jcfg = jb.MapConfig(render=JRenderConfig(tile_capacity=64, tile_chunk=8),
                        recent_window=4, **common)
    tcfg = tb.MapConfig(render=RenderConfig(tile_capacity=64), **common)

    jmap = j_map(d)
    jout = jb.mapping_step(jmap, jo.init_adam(jmap), kf, pose_opt, jnp.asarray(widx),
                           jnp.asarray(wmask), jnp.asarray(K_NP), W, H, jcfg)

    # JAX's gradients of the same window loss
    safe = np.where(wmask, widx, 0)
    pose_vec = jnp.concatenate([kf.d_rot6[safe], kf.d_t[safe]], -1)
    grad_fn = jax.jit(jax.value_and_grad(jb._window_loss, argnums=(0, 2, 3), has_aux=True),
                      static_argnames=("width", "height", "cfg"))
    (jtotal, (jphoto, _)), jgrads = grad_fn(
        jmap.trainable(), jmap, pose_vec, jnp.zeros((4, CAP, 2)), kf.pose_base[safe],
        kf.images[safe], kf.gt_depths[safe], kf.exposures[safe], jnp.asarray(wmask),
        jnp.tile(jnp.asarray(K_NP)[None], (4, 1, 1)), width=W, height=H, cfg=jcfg)

    tmap = tg.gaussian_map_from_numpy(d, device=CPU)
    tkf = tk.keyframes_from_numpy({f: np.asarray(x) for f, x in zip(kf._fields, kf)},
                                  device=CPU)
    tpose = tb.PoseAdamState(*(T(np.asarray(x)) for x in pose_opt))
    targs = (tkf, T(widx), T(wmask), T(K_NP), W, H, tcfg)
    twg = tb.window_grads(tmap, *targs)
    tout = tb.mapping_step(tmap, to.init_adam(tmap), tkf, tpose, *targs[1:])
    return dict(jout=jout, jgrads=jgrads, jloss=(jtotal, jphoto), tout=tout, twg=twg,
                kf=kf, widx=widx, wmask=wmask, d=d, tkf=tkf)


def test_window_grads_match_jax(step_case):
    c = step_case
    jtotal, jphoto = c["jloss"]
    g_map, g_pose, g_probe = c["jgrads"]
    wg = c["twg"]
    np.testing.assert_allclose(float(wg.total_loss), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(wg.photometric_loss), float(jphoto), rtol=1e-5)
    for f in tg.TRAINABLE_FIELDS:
        a = wg.g_map[f].numpy()
        assert np.abs(a).max() > 0, f
        np.testing.assert_allclose(a, np.asarray(g_map[f]), err_msg=f, **GRAD_TOL)
    np.testing.assert_allclose(wg.g_pose.numpy(), np.asarray(g_pose), **GRAD_TOL)
    np.testing.assert_allclose(wg.g_probe.numpy(), np.asarray(g_probe), **GRAD_TOL)
    # the padded camera carries no gradient to its pose
    assert not wg.g_pose[3].any()


def test_mapping_step_matches_jax(step_case):
    c = step_case
    jmap, _jopt, jkf, jpose, jaux = c["jout"]
    tmap, topt, tkf, tpose, taux = c["tout"]
    np.testing.assert_allclose(float(taux.total_loss), float(jaux.total_loss), rtol=1e-5)
    np.testing.assert_allclose(float(taux.photometric_loss),
                               float(jaux.photometric_loss), rtol=1e-5)
    for f in ("radii", "n_touched", "n_pairs"):
        np.testing.assert_array_equal(getattr(taux, f).numpy(),
                                      np.asarray(getattr(jaux, f)), err_msg=f)
    assert not taux.radii[3].any() and taux.n_touched[:3].sum() > 0
    np.testing.assert_allclose(taux.means2d_grad.numpy(), np.asarray(jaux.means2d_grad),
                               **GRAD_TOL)
    np.testing.assert_allclose(taux.depthmaps.numpy(), np.asarray(jaux.depthmaps),
                               atol=1e-4)

    # keyframes: est_depths written in the window's slots only; frame 0's
    # pose frozen; poses and the pose Adam as JAX's
    est = tkf.est_depths.numpy()
    np.testing.assert_allclose(est, np.asarray(jkf.est_depths), atol=1e-4)
    assert not est[3].any()
    for f in ("d_rot6", "d_t"):
        np.testing.assert_allclose(getattr(tkf, f).numpy(), np.asarray(getattr(jkf, f)),
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(tkf.d_t[0].numpy(), c["tkf"].d_t[0].numpy())
    assert np.abs(tkf.d_t[2].numpy()).max() > 1e-4  # keyframe 2 moved
    for name, a, b in zip(jpose._fields, tpose, jpose):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(tpose.count.numpy(), [0, 4, 1, 0])

    # the map, under the Adam rule of the module docstring
    g_map = c["jgrads"][0]
    for f in tg.TRAINABLE_FIELDS:
        a, b = getattr(tmap, f).numpy(), np.asarray(getattr(jmap, f))
        g = np.abs(np.asarray(g_map[f]))
        sure = g > 1e-4
        assert sure.sum() > 20, f
        np.testing.assert_allclose(a[sure], b[sure], atol=1e-6, rtol=1e-6, err_msg=f)
        assert np.abs(a - b).max() <= 2 * to.DEFAULT_LRS[f] + 1e-6, f
    for f in ("ages", "alive"):
        np.testing.assert_array_equal(getattr(tmap, f).numpy(), np.asarray(getattr(jmap, f)))


# ---------------------------------------------------------------- optimizer


def _grads(rng, cap=CAP):
    d = map_fields(rng, cap)
    return {f: (rng.normal(size=d[f].shape) * 10.0 ** rng.uniform(-6, -1, d[f].shape))
            .astype(np.float32) for f in tg.TRAINABLE_FIELDS}


def test_masked_adam_matches_jax():
    """Three steps with identical gradients, the second with an update mask
    that also freezes some live slots; dead slots keep their moments."""
    rng = np.random.default_rng(11)
    d = map_fields(rng)
    jm, tm = j_map(d), tg.gaussian_map_from_numpy(d, device=CPU)
    js, ts = jo.init_adam(jm), to.init_adam(tm)
    for i in range(3):
        g = _grads(rng)
        mask = (d["alive"] & (rng.random(CAP) > 0.3)) if i == 1 else None
        jm, js = jo.adam_step(jm, {k: jnp.asarray(v) for k, v in g.items()}, js,
                              update_mask=None if mask is None else jnp.asarray(mask))
        tm, ts = to.adam_step(tm, {k: T(v) for k, v in g.items()}, ts,
                              update_mask=None if mask is None else T(mask))
    assert int(ts.count) == int(js.count) == 3
    for f in tg.TRAINABLE_FIELDS:
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   atol=1e-6, rtol=1e-6, err_msg=f)
        for k in ("mu", "nu"):
            np.testing.assert_allclose(getattr(ts, k)[f].numpy(),
                                       np.asarray(getattr(js, k)[f]), rtol=1e-5,
                                       atol=1e-12, err_msg=f"{k}/{f}")
    assert not ts.mu["means"][~T(d["alive"])].any()
    # the state goes across as numpy arrays
    back = to.adam_state_from_numpy(to.adam_state_to_numpy(ts), device=CPU)
    for f in tg.TRAINABLE_FIELDS:
        assert torch.equal(back.nu[f], ts.nu[f])


def test_zero_state_at_matches_jax():
    rng = np.random.default_rng(12)
    d = map_fields(rng)
    g = _grads(rng)
    jm = j_map(d)
    _, js = jo.adam_step(jm, {k: jnp.asarray(v) for k, v in g.items()}, jo.init_adam(jm))
    ts = to.adam_state_from_numpy(
        {**{f"{k}/{f}": np.asarray(getattr(js, k)[f]) for k in ("mu", "nu")
            for f in tg.TRAINABLE_FIELDS}, "count": np.asarray(js.count)}, device=CPU)
    slots = np.array([3, 17, CAP, 200, CAP + 5], np.int32)  # out of range: dropped
    js2 = jo.zero_state_at(js, jnp.asarray(slots))
    ts2 = to.zero_state_at(ts, T(slots))
    for f in tg.TRAINABLE_FIELDS:
        for k in ("mu", "nu"):
            np.testing.assert_array_equal(getattr(ts2, k)[f].numpy(),
                                          np.asarray(getattr(js2, k)[f]))
    assert not ts2.mu["means"][[3, 17, 200]].any() and ts2.mu["means"].any()


def test_vector_adam_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.normal(size=11).astype(np.float32)
    jx, js = jnp.asarray(x), jo.init_vector_adam(jnp.asarray(x))
    tx, ts = T(x), to.init_vector_adam(T(x))
    for _ in range(4):
        g = rng.normal(size=11).astype(np.float32) * 1e-2
        jx, js = jo.vector_adam_step(jx, jnp.asarray(g), js, lr=0.01)
        tx, ts = to.vector_adam_step(tx, T(g), ts, lr=0.01)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js.nu), rtol=1e-5)
    assert int(ts.count) == 4


# ---------------------------------------------------------------- gaussians


@pytest.mark.parametrize("shape,share", [((101,), 0.4), ((60, 3), 0.5), ((40,), 0.0)],
                         ids=["1d", "2d", "empty_mask"])
def test_masked_median_matches_jax(shape, share):
    rng = np.random.default_rng(14)
    v = rng.normal(size=shape).astype(np.float32)
    mask = rng.random(shape[0]) < share
    got = tg.masked_median(T(v), T(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.masked_median(jnp.asarray(v),
                                                                   jnp.asarray(mask))))
    if not mask.any():
        assert np.isinf(got).all()


def test_compact_and_grow_match_jax():
    """test_components.py::test_compact_and_grow_preserve_render in both
    packages: the same permutation, the optimizer moments with it, and an
    unchanged render."""
    from gslam_tpu_torch.ops.rasterize import render_impl

    rng = np.random.default_rng(15)
    cap = 128
    d = map_fields(rng, cap, n_dead=58)
    jm, tm = j_map(d), tg.gaussian_map_from_numpy(d, device=CPU)
    g = _grads(rng, cap)
    jm1, js = jo.adam_step(jm, {k: jnp.asarray(v) for k, v in g.items()}, jo.init_adam(jm))
    tm1, ts = to.adam_step(tm, {k: T(v) for k, v in g.items()}, to.init_adam(tm))

    def same(tmap, jmap, tstate, jstate):
        for f in tg.FIELDS:
            np.testing.assert_allclose(getattr(tmap, f).numpy(),
                                       np.asarray(getattr(jmap, f)), atol=1e-6, err_msg=f)
        for f in tg.TRAINABLE_FIELDS:
            np.testing.assert_allclose(tstate.nu[f].numpy(), np.asarray(jstate.nu[f]),
                                       rtol=1e-5, atol=1e-12, err_msg=f)

    jc, jcs, jorder = jg.compact_map(jm1, js, return_order=True)
    tc, tcs, torder = tg.compact_map(tm1, ts, return_order=True)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    same(tc, jc, tcs, jcs)
    assert int(tc.n_live()) == 70 and tc.alive[:70].all() and not tc.alive[70:].any()

    jgw, jgs = jg.grow_map(jm1, js, 2 * cap)
    tgw, tgs = tg.grow_map(tm1, ts, 2 * cap)
    assert tgw.capacity == 2 * cap
    same(tgw, jgw, tgs, jgs)
    with pytest.raises(ValueError):
        tg.grow_map(tm1, ts, cap - 1)

    np.testing.assert_array_equal(
        tg.compact_free_slots(tm.alive, 70).numpy(),
        np.asarray(jg.compact_free_slots(jnp.asarray(d["alive"]), 70)))

    def img(m):
        return render_impl(**m.render_kwargs(), viewmats=torch.eye(4)[None],
                           Ks=T(K_NP)[None], width=W, height=H,
                           cfg=RenderConfig(tile_capacity=96)).rgb
    np.testing.assert_allclose(img(tc).numpy(), img(tm1).numpy(), atol=1e-5)
    np.testing.assert_allclose(img(tgw).numpy(), img(tm1).numpy(), atol=1e-5)


# ---------------------------------------------------------------- keyframes


def test_keyframe_store_matches_jax():
    rng = np.random.default_rng(16)
    jkf, tkf = jk.empty_keyframes(3, 8, 6), tk.empty_keyframes(3, 8, 6, device=CPU)
    for slot, fi in ((2, 7), (0, 9)):
        img = rng.random((8, 6, 3)).astype(np.float32)
        p = pose(rng.normal(size=3) * 0.1, rng.normal(size=3) * 0.1)
        dep = rng.random((8, 6)).astype(np.float32)
        jkf = jk.add_keyframe(jkf, slot, jnp.asarray(img), jnp.asarray(p),
                              jnp.asarray([0.1, 0.2]), fi, gt_depth=jnp.asarray(dep),
                              est_depth=jnp.asarray(dep * 2))
        tkf = tk.add_keyframe(tkf, slot, img, p, [0.1, 0.2], fi, gt_depth=dep,
                              est_depth=T(dep * 2))
    jkf = jkf._replace(d_t=jkf.d_t.at[2].set(jnp.asarray([0.01, 0.0, -0.02])),
                       d_rot6=jkf.d_rot6.at[2].set(0.01))
    tkf = tkf._replace(d_t=T(np.asarray(jkf.d_t)), d_rot6=T(np.asarray(jkf.d_rot6)))
    for f, a in tk.keyframes_to_numpy(tkf).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jkf, f)), err_msg=f)
    np.testing.assert_allclose(tkf.poses().numpy(), np.asarray(jkf.poses()), atol=1e-6)
    assert tkf.capacity == 3 and tkf.frame_idx.tolist() == [9, -1, 7]


# ---------------------------------------------------------------- losses


def test_ssim_matches_jax():
    """As test_opt_losses.py::test_ssim_reference, in both packages, with
    the gradient of the mean SSIM."""
    rng = np.random.default_rng(17)
    a = rng.random((2, 24, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    jv, jgrad = jax.value_and_grad(lambda x: jnp.sum(j_ssim(x, jnp.asarray(b))))(
        jnp.asarray(a))
    ta = T(a).requires_grad_(True)
    tv = t_ssim(ta, T(b))
    (tgrad,) = torch.autograd.grad(tv.sum(), ta)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(j_ssim(jnp.asarray(a),
                                                                      jnp.asarray(b))),
                               atol=1e-6)
    np.testing.assert_allclose(float(tv.detach().sum()), float(jv), atol=1e-6)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **GRAD_TOL)
    assert float(t_ssim(T(a), T(a)).min()) > 0.9999


def _loss_inputs(rng):
    return dict(
        rend=rng.random((3, 10, 12, 3)).astype(np.float32),
        gt=rng.random((3, 10, 12, 3)).astype(np.float32),
        betas=rng.uniform(0.2, 2.0, (3, 10, 12)).astype(np.float32),
        cam=np.array([True, True, False]),
        log_scales=rng.normal(-2.5, 0.4, (50, 3)).astype(np.float32),
        visible=rng.random(50) > 0.3,
        depth=rng.uniform(1, 3, (3, 10, 12)).astype(np.float32),
        mask=rng.random((3, 10, 12)) > 0.3,
    )


LOSSES = {
    "photometric_active": (lambda m, x: m.mapping_photometric(
        x["rend"], x["gt"], x["betas"], cam_mask=x["cam"]), ("rend", "betas")),
    "photometric_mse": (lambda m, x: m.mapping_photometric(
        x["rend"], x["gt"], x["betas"], active_gs=False), ("rend",)),
    "isotropic": (lambda m, x: m.isotropic_scale_loss(x["log_scales"], x["visible"]),
                  ("log_scales",)),
    "depth_tv": (lambda m, x: m.edge_aware_depth_tv(x["depth"], x["rend"], x["mask"]),
                 ("depth", "rend")),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_mapping_losses_match_jax(name):
    fn, wrt = LOSSES[name]
    x = _loss_inputs(np.random.default_rng(18))
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    jv, jgrads = jax.value_and_grad(
        lambda ws: fn(jl, {**jx, **ws}))({k: jx[k] for k in wrt})
    tx = {k: T(v) for k, v in x.items()}
    ws = {k: tx[k].requires_grad_(True) for k in wrt}
    tv = fn(tl, tx)
    tgrads = torch.autograd.grad(tv, list(ws.values()))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    for k, g in zip(wrt, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), atol=1e-7, rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------- pruning


def test_pruning_masks_match_jax():
    rng = np.random.default_rng(19)
    d = map_fields(rng, 200)
    d["logit_opacities"] = rng.normal(-0.5, 1.5, 200).astype(np.float32)
    jm, tm = j_map(d), tg.gaussian_map_from_numpy(d, device=CPU)
    radii = np.where(rng.random((5, 200)) > 0.4, rng.integers(0, 300, (5, 200)), 0
                     ).astype(np.float32)
    touched = np.where(rng.random((5, 200)) > 0.7, rng.integers(1, 50, (5, 200)), 0
                       ).astype(np.int32)
    vis = rng.integers(0, 6, 200).astype(np.int32)
    pairs = [
        (jp.low_opacity_mask(jm), tp.low_opacity_mask(tm)),
        (jp.large_radius_mask(jnp.asarray(radii.max(0))), tp.large_radius_mask(T(radii.max(0)))),
        (jp.ill_conditioned_mask(jnp.asarray(radii), jnp.asarray(touched)),
         tp.ill_conditioned_mask(T(radii), T(touched))),
        (jp.young_invisible_mask(jm, jnp.asarray(vis), 4),
         tp.young_invisible_mask(tm, T(vis), 4)),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(i))
        assert b.any() and not b.all(), i
    remove = pairs[0][1] | pairs[2][1]
    np.testing.assert_array_equal(
        tp.apply_prune(tm, remove).alive.numpy(),
        np.asarray(jp.apply_prune(jm, jnp.asarray(remove.numpy())).alive))
    np.testing.assert_allclose(
        tp.opacity_decay(tm, T(radii), 0.9).logit_opacities.numpy(),
        np.asarray(jp.opacity_decay(jm, jnp.asarray(radii), 0.9).logit_opacities),
        atol=0, rtol=0)


# ---------------------------------------------------------------- render programs


@pytest.fixture(scope="module")
def view_scene():
    rng = np.random.default_rng(20)
    d = map_fields(rng)
    poses = np.stack([pose([0.0, 0.0, 0.0]), pose([0.08, -0.02, 0.05], [0.0, 0.05, 0.02]),
                      pose([-0.05, 0.03, 0.0], [0.03, 0.0, -0.02])])
    gt = rng.random((3, H, W, 3)).astype(np.float32)
    jcfg = jb.MapConfig(render=JRenderConfig(tile_capacity=64, tile_chunk=8),
                        background=(0.1, 0.2, 0.3))
    tcfg = tb.MapConfig(render=RenderConfig(tile_capacity=64), background=(0.1, 0.2, 0.3))
    return dict(jm=j_map(d), tm=tg.gaussian_map_from_numpy(d, device=CPU), poses=poses,
                gt=gt, jcfg=jcfg, tcfg=tcfg)


PROGRAMS = {
    "keyframe_decision_stats": lambda m, s, p, cfg: m.keyframe_decision_stats(
        s["map"], p(s["poses"][1]), p(s["poses"][0]), p(K_NP), W, H, cfg),
    "render_view_stats": lambda m, s, p, cfg: m.render_view_stats(
        s["map"], p(s["poses"][2]), p(K_NP), W, H, cfg),
    "eval_views": lambda m, s, p, cfg: m.eval_views(
        s["map"], p(s["poses"]), p(s["gt"]), p(K_NP), W, H, cfg),
    "visibility_pass": lambda m, s, p, cfg: (m.visibility_pass(
        s["map"], p(s["poses"]), p(K_NP), W, H, cfg),),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_render_programs_match_jax(view_scene, name):
    """Floats atol 1e-4 (depth-valued) and 1e-5 otherwise, rtol 1e-5;
    visibility, radii and n_touched exact."""
    s = view_scene
    j = PROGRAMS[name](jb, {**s, "map": s["jm"]}, jnp.asarray, s["jcfg"])
    t = PROGRAMS[name](tb, {**s, "map": s["tm"]}, T, s["tcfg"])
    for i, (a, b) in enumerate(zip(t, j)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, i
        if a.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5, err_msg=str(i))
    if name == "keyframe_decision_stats":
        assert 0.0 < float(t.iou) < 1.0 and np.isfinite(float(t.median_depth))
        np.testing.assert_array_equal(t.new_visible.numpy(), np.asarray(j.new_visible))
    if name == "render_view_stats":
        np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
        assert int(t.n_touched.sum()) > 0
