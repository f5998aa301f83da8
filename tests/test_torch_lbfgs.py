"""Parity of the port's actor slice with the JAX package on the CPU, call by
call: `lbfgs_impl` (with its strong-Wolfe search), `pose_refinement_lbfgs`,
the warp tracker's bilinear gather, warp and `warp_track`, `method="warp"`
in `track_frame`, the backend actor's first three messages with JAX's
draws replayed, and the actor checkpoint carried JAX -> port -> JAX. Whole
SlamSystems run in the port alone (tests/test_torch_actor*.py).

Inputs are made with numpy from a seed. `lbfgs_impl` is held to the JAX
loop run op by op under `jax.disable_jit()`; the renders of pose
refinement and the warp tracker run in JAX's jitted programs (op by op they
take minutes on a CPU). The loss and gradient at x0 and the evaluation counts
come from wrapping each package's `lbfgs_impl` where the function under
test calls it.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu.mapping import backend_ops as jb  # noqa: E402
from gslam_tpu.mapping import gaussians as jg  # noqa: E402
from gslam_tpu.mapping import keyframes as jk  # noqa: E402
from gslam_tpu.ops.rasterize import RenderConfig as JRenderConfig  # noqa: E402
from gslam_tpu.tracking import track as jt  # noqa: E402
from gslam_tpu.tracking import warp as jw  # noqa: E402
from gslam_tpu_torch.io.synthetic import SyntheticDataset  # noqa: E402
from gslam_tpu_torch.mapping import backend_ops as tb  # noqa: E402
from gslam_tpu_torch.mapping import gaussians as tg  # noqa: E402
from gslam_tpu_torch.mapping import keyframes as tk  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig  # noqa: E402
from gslam_tpu_torch.runtime.system import SlamConfig, SlamSystem  # noqa: E402
from gslam_tpu_torch.tracking import track as tt  # noqa: E402
from gslam_tpu_torch.tracking import warp as tw  # noqa: E402

from test_torch_insertion import JaxDraws  # noqa: E402

CPU = "cpu"
# the modules (each package's opt/__init__ binds `lbfgs` to its entry point)
jl = importlib.import_module("gslam_tpu.opt.lbfgs")
tl = importlib.import_module("gslam_tpu_torch.opt.lbfgs")


def T(x):
    return torch.from_numpy(np.array(x))


def pose(t, rotvec=(0.0, 0.0, 0.0)):
    import scipy.spatial.transform as sst

    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = sst.Rotation.from_rotvec(rotvec).as_matrix()
    m[:3, 3] = t
    return m


# ---------------------------------------------------------------- lbfgs_impl

# tests/test_opt_losses.py's three problems, as (f, gradient) in float64
_A = np.diag([1.0, 10.0, 100.0])
_B = np.array([1.0, -2.0, 3.0])
_RNG = np.random.default_rng(0)
_WM = _RNG.normal(size=(32, 9))
_Y = _RNG.normal(size=32)


def _quadratic(x):
    return 0.5 * x @ _A @ x - _B @ x, _A @ x - _B


def _rosenbrock(x):
    r = x[1] - x[0] ** 2
    return ((1 - x[0]) ** 2 + 100.0 * r**2,
            np.array([-2 * (1 - x[0]) - 400.0 * x[0] * r, 200.0 * r]))


def _pose_like(x):
    h = np.tanh(_WM @ x)
    r = h - _Y
    return np.sum(r**2), _WM.T @ (2 * r * (1 - h**2))


PROBLEMS = {
    "quadratic": (_quadratic, np.zeros(3), dict(max_iter=50, max_eval=100)),
    "rosenbrock": (_rosenbrock, np.array([-1.2, 1.0]), dict(max_iter=100, max_eval=500)),
    "pose_like": (_pose_like, np.zeros(9), dict(max_iter=20, max_eval=25, history=5, lr=1.0)),
}


def _jax_loss(fn):
    """fn's value and gradient, rounded to float32, as a JAX function."""

    @jax.custom_vjp
    def f(x):
        return jnp.float32(fn(np.asarray(x, np.float64))[0])

    def fwd(x):
        v, g = fn(np.asarray(x, np.float64))
        return jnp.float32(v), jnp.asarray(g, jnp.float32)

    f.defvjp(fwd, lambda g, ct: (ct * g,))
    return f


class _TorchLoss(torch.autograd.Function):
    """fn's value and gradient, rounded to float32, as a torch function."""

    @staticmethod
    def forward(ctx, x, fn):
        v, g = fn(x.detach().numpy().astype(np.float64))
        ctx.save_for_backward(torch.tensor(g, dtype=torch.float32))
        return torch.tensor(v, dtype=torch.float32)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.saved_tensors[0], None


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_lbfgs_impl_matches_jax(name):
    """Both loops see the same float32 values and gradients (computed once
    in float64): tanh and matmul round differently in XLA and torch, and on
    these flat minima one ulp flips which termination test fires. So the
    optimizer's own arithmetic is what is compared: the same evaluation
    count, and x and f within 1e-5."""
    fn, x0, kw = PROBLEMS[name]
    with jax.disable_jit():
        jr = jl.lbfgs_impl(_jax_loss(fn), jnp.asarray(x0, jnp.float32), **kw)
    tr = tl.lbfgs_impl(lambda x: _TorchLoss.apply(x, fn), T(x0.astype(np.float32)), **kw)
    assert tr.n_evals == int(jr.n_evals) and tr.n_iters == int(jr.n_iters)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-5)
    np.testing.assert_allclose(float(tr.f), float(jr.f), atol=1e-5, rtol=1e-5)
    if name == "quadratic":
        np.testing.assert_allclose(tr.x.numpy(), np.linalg.solve(_A, _B), atol=1e-4)


def test_lbfgs_impl_counts_one_readback_per_evaluation(monkeypatch):
    """Each evaluation reads [f, g] back once; n_evals counts the reads."""
    reads = []
    real = tl.value_and_grad

    def counting(loss_fn, device):
        fg = real(loss_fn, device)

        def wrapped(x):
            reads.append(1)
            return fg(x)

        return wrapped

    monkeypatch.setattr(tl, "value_and_grad", counting)
    fn, x0, kw = PROBLEMS["rosenbrock"]
    r = tl.lbfgs_impl(lambda x: _TorchLoss.apply(x, fn), T(x0.astype(np.float32)), **kw)
    assert r.n_evals == len(reads) > 10


# ------------------------------------------------------ pose_refinement_lbfgs

H, W = 32, 48
K_NP = np.array([[30.0, 0, 24], [0, 30.0, 16], [0, 0, 1]], np.float32)


def _map_fields(rng, cap=256):
    alive = np.ones(cap, bool)
    alive[rng.choice(cap, 20, replace=False)] = False
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


class _TorchRecorder:
    """Wraps the port's lbfgs_impl where a function calls it: keeps the loss
    and gradient at x0 and the evaluation count."""

    def __init__(self, real):
        self.real = real

    def __call__(self, loss_fn, x0, **kw):
        f, g = tl.value_and_grad(loss_fn, x0.device)(x0)
        self.f0, self.g0 = float(f), g.numpy()
        res = self.real(loss_fn, x0, **kw)
        self.n_evals = res.n_evals
        return res


class _JaxRecorder:
    """The same for the JAX package's lbfgs_impl inside a jitted program: the
    values come out through host callbacks."""

    def __init__(self, real):
        self.real = real

    def _keep(self, f0, g0, n_evals):
        self.f0, self.g0, self.n_evals = float(f0), np.asarray(g0), int(n_evals)

    def __call__(self, loss_fn, x0, **kw):
        f0, g0 = jax.value_and_grad(loss_fn)(x0)
        res = self.real(loss_fn, x0, **kw)
        jax.debug.callback(self._keep, f0, g0, res.n_evals)
        return res


def test_pose_refinement_lbfgs_matches_jax(monkeypatch):
    """Keyframes 0-2 (frame 0 frozen) and a padded slot in a window of 4, on
    a 48x32 scene whose keyframe images were rendered 1-2 cm and ~0.5
    degrees away from the poses the store holds. The loss and gradient at
    x0 within rtol 1e-5; the evaluation count equal; the final loss within
    rtol 1e-4 and the refined pose deltas within 2e-4 (the searches' cubic
    fits amplify the 1e-7 gaps of the losses); the frozen keyframe and
    every slot outside the window bit for bit."""
    rng = np.random.default_rng(7)
    d = _map_fields(rng)
    jmap = jg.empty_map(256)._replace(**{k: jnp.asarray(v) for k, v in d.items()})
    jcfg = jb.MapConfig(window_size=4, recent_window=4,
                        render=JRenderConfig(tile_capacity=64, tile_chunk=8))
    tcfg = tb.MapConfig(window_size=4, recent_window=4, render=RenderConfig(tile_capacity=64))
    true_poses = [pose([0.02 * s, -0.01 * s, 0.0], [0.0, 0.01 * s, 0.0]) for s in range(3)]
    tmap = tg.gaussian_map_from_numpy(d, device=CPU)
    with torch.no_grad():
        rgb = tb._render_views(tmap, T(np.stack(true_poses)), T(K_NP), W, H, tcfg).rgb
    kf = jk.empty_keyframes(5, H, W)
    for slot in range(3):
        off = pose([0.01 * slot, 0.005, -0.01 * slot], [0.004 * slot, -0.003, 0.0])
        kf = jk.add_keyframe(kf, slot, jnp.asarray(np.clip(rgb[slot].numpy(), 0, 1)),
                             jnp.asarray(off @ true_poses[slot]),
                             jnp.asarray([0.02 * slot, -0.01]), slot)
    kf = kf._replace(d_t=kf.d_t.at[1].set(jnp.asarray([0.002, -0.001, 0.003])),
                     d_rot6=kf.d_rot6.at[4].set(0.5))  # slot 4: outside the window
    widx = np.array([0, 1, 2, 0], np.int32)
    wmask = np.array([True, True, True, False])

    jrec = _JaxRecorder(jb.lbfgs_impl)
    monkeypatch.setattr(jb, "lbfgs_impl", jrec)
    jkf, jf = jb.pose_refinement_lbfgs(jmap, kf, jnp.asarray(widx), jnp.asarray(wmask),
                                       jnp.asarray(K_NP), W, H, jcfg)
    jax.block_until_ready(jf)
    trec = _TorchRecorder(tb.lbfgs_impl)
    monkeypatch.setattr(tb, "lbfgs_impl", trec)
    tkf0 = tk.keyframes_from_numpy({f: np.asarray(x) for f, x in zip(kf._fields, kf)},
                                   device=CPU)
    tkf, tf_, n_evals = tb.pose_refinement_lbfgs(tmap, tkf0, T(widx), T(wmask), T(K_NP),
                                                 W, H, tcfg)

    np.testing.assert_allclose(trec.f0, jrec.f0, rtol=1e-5)
    np.testing.assert_allclose(trec.g0, jrec.g0, rtol=1e-5, atol=1e-5 * np.abs(jrec.g0).max())
    assert not trec.g0[:9].any()  # frame 0 frozen
    assert not trec.g0[27:].any()  # the padded slot
    assert n_evals == trec.n_evals == jrec.n_evals > 3
    np.testing.assert_allclose(float(tf_), float(jf), rtol=1e-4)
    assert float(tf_) < trec.f0
    for f in ("d_rot6", "d_t"):
        a, b = getattr(tkf, f).numpy(), np.asarray(getattr(jkf, f))
        np.testing.assert_allclose(a, b, atol=2e-4, err_msg=f)
        for slot in (0, 3, 4):  # frozen, empty, outside the window
            np.testing.assert_array_equal(a[slot], getattr(tkf0, f)[slot].numpy())
        assert np.abs(a[1:3] - getattr(tkf0, f)[1:3].numpy()).max() > 1e-4
    for f in ("pose_base", "images", "exposures", "frame_idx", "mask"):
        np.testing.assert_array_equal(getattr(tkf, f).numpy(), getattr(tkf0, f).numpy())


# ------------------------------------------------------------------- warp


def _two_views():
    """The splat scene rendered at a reference pose (rgb, depth, alpha) and at
    a new pose 1.1 cm and 0.3 degrees away (rgb)."""
    tmap = tg.gaussian_map_from_numpy(_map_fields(np.random.default_rng(3), cap=600),
                                      device=CPU)
    ref_pose = pose([0.0, 0.0, 0.0])
    new_pose = pose([0.008, -0.006, 0.004], [0.002, 0.004, -0.001])
    with torch.no_grad():
        out = tb._render_views(tmap, T(np.stack([ref_pose, new_pose])), T(K_NP), W, H,
                               tb.MapConfig(render=RenderConfig(tile_capacity=64)))
    rgb = np.clip(out.rgb.numpy(), 0.0, 1.0)
    return rgb[0], out.depth[0].numpy(), out.alpha[0].numpy(), rgb[1], ref_pose, new_pose


def test_bilinear_sample_and_warp_image_match_jax():
    """Exact where the reference is: the in-bounds and in-front masks, taps at
    integer coordinates, zeros outside the image; float32 rounding (1e-6)
    at fractional ones."""
    img, depth, alpha, _, ref_pose, new_pose = _two_views()
    depth = depth / np.maximum(alpha, 1e-3)
    rng = np.random.default_rng(4)
    uv = np.concatenate([
        rng.uniform(-3, W + 2, (200, 2)) * [1, H / W],  # fractional, some outside
        np.stack(np.meshgrid(np.arange(-1, W + 1), [0, H - 1, H]), -1).reshape(-1, 2),
    ]).astype(np.float32)
    js, jinb = jw.bilinear_sample(jnp.asarray(img), jnp.asarray(uv))
    ts, tinb = tw.bilinear_sample(T(img), T(uv))
    np.testing.assert_array_equal(tinb.numpy(), np.asarray(jinb))
    integer = (uv == np.round(uv)).all(-1)
    np.testing.assert_array_equal(ts.numpy()[integer], np.asarray(js)[integer])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    assert not ts.numpy()[~tinb.numpy() & integer].any()

    juv, jok = jw.warp_image(jnp.asarray(ref_pose), jnp.asarray(new_pose), jnp.asarray(img),
                             jnp.asarray(depth), jnp.asarray(K_NP))
    tuv, tok = tw.warp_image(T(ref_pose), T(new_pose), T(img), T(depth), T(K_NP))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-4)
    # the identity warp lands every pixel with depth on itself
    tuv, _ = tw.warp_image(T(ref_pose), T(ref_pose), T(img), T(depth), T(K_NP))
    v, u = np.mgrid[0:H, 0:W]
    has = depth.reshape(-1) > 0.1
    assert has.mean() > 0.5
    np.testing.assert_allclose(tuv.numpy()[has], np.stack([u, v], -1).reshape(-1, 2)[has],
                               atol=1e-4)


@pytest.mark.parametrize("alpha", [False, True], ids=["depth", "alpha"])
def test_warp_track_matches_jax(monkeypatch, alpha):
    """warp_track of the new view against the reference render, from the
    reference pose, with the rendered depth (alpha-premultiplied, with its
    alpha) or its alpha-normalized depth alone: the loss and gradient at x0
    within rtol 1e-5, the same evaluation count, the pose and exposure
    within 1e-4 of JAX's and the final loss within rtol 1e-4, and the loss
    fell. The budget is 15 evaluations: JAX's program is jitted, and with
    40 the two searches branch apart after ~39 (XLA sums the residual in
    another order), which the op-by-op run would not show but costs ~30 s
    on a CPU core."""
    img, depth, ref_alpha, new_img, ref_pose, _ = _two_views()
    depth_in = depth if alpha else depth / np.maximum(ref_alpha, 1e-3)
    common = dict(lbfgs_max_iter=15, lbfgs_max_eval=15)
    exposure = np.array([0.01, -0.02], np.float32)

    jrec = _JaxRecorder(jw.lbfgs_impl)
    monkeypatch.setattr(jw, "lbfgs_impl", jrec)
    jpose, jexp, jf = jw.warp_track(
        jnp.asarray(ref_pose), jnp.asarray(ref_pose), jnp.asarray(img), jnp.asarray(depth_in),
        jnp.asarray(new_img), jnp.asarray(K_NP), jnp.asarray(exposure),
        jt.TrackingConfig(**common), ref_alpha=jnp.asarray(ref_alpha) if alpha else None)
    jax.block_until_ready(jf)
    trec = _TorchRecorder(tw.lbfgs_impl)
    monkeypatch.setattr(tw, "lbfgs_impl", trec)
    tpose, texp, tf_ = tw.warp_track(
        T(ref_pose), T(ref_pose), T(img), T(depth_in), T(new_img), T(K_NP), T(exposure),
        tt.TrackingConfig(**common), ref_alpha=T(ref_alpha) if alpha else None)
    np.testing.assert_allclose(trec.f0, jrec.f0, rtol=1e-5)
    np.testing.assert_allclose(trec.g0, jrec.g0, rtol=1e-5, atol=1e-5 * np.abs(jrec.g0).max())
    assert trec.n_evals == jrec.n_evals > 5
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-4)
    np.testing.assert_allclose(texp.numpy(), np.asarray(jexp), atol=1e-4)
    np.testing.assert_allclose(float(tf_), float(jf), rtol=1e-4)
    assert float(tf_) < 0.9 * trec.f0


def test_track_frame_runs_warp_as_igs():
    """The JAX tracker runs method="warp" as igs (the frontend warps only
    against a synced reference render): the port does the same, with the
    same result as method="igs"."""
    rng = np.random.default_rng(9)
    tmap = tg.gaussian_map_from_numpy(_map_fields(rng), device=CPU)
    cfg = tt.TrackingConfig(render=RenderConfig(tile_capacity=64), warmup_steps=2,
                            lbfgs_max_iter=4, lbfgs_max_eval=4)
    with torch.no_grad():
        img = np.clip(tb._render_views(tmap, T(pose([0.01, 0, 0]))[None], T(K_NP), W, H,
                                       tb.MapConfig(render=cfg.render)).rgb[0].numpy(), 0, 1)
    args = (tmap, np.eye(4, dtype=np.float32), np.zeros(2, np.float32), img, K_NP, W, H)
    igs = tt.track_frame(*args, cfg, device=CPU)
    warp = tt.track_frame(*args, dataclasses.replace(cfg, method="warp"), device=CPU)
    assert warp.n_evals == igs.n_evals
    np.testing.assert_array_equal(warp.pose.numpy(), igs.pose.numpy())


# ------------------------------------------------------------ the actors


def frames_of(ds, jax_frames=False):
    """The dataset's frames, as the port's Frame or the JAX package's."""
    if not jax_frames:
        return list(ds)
    from gslam_tpu.core.camera import Camera as JCamera
    from gslam_tpu.io.frames import Frame as JFrame

    cam = JCamera(K=ds.camera.K.numpy(), width=ds.camera.width, height=ds.camera.height)
    return [JFrame(image=f.image, timestamp=f.timestamp, camera=cam, index=f.index,
                   gt_pose=f.gt_pose, gt_depth=f.gt_depth) for f in ds]


# ---------------------------------------------------------------- parity


def test_backend_messages_match_jax():
    """REQUEST_INIT (bootstrap insertion and 3 mapping iterations) and two
    ADD_FRAMEs at the ground-truth poses, in both packages, the port drawing
    JAX's numbers: the keyframe decisions, kf_order, frame_slot, the pose
    graph, the live count and ages equal; the map within the Adam bound of
    tests/test_torch_mapping.py (2 lr per step where a gradient's sign may
    differ), summed over the 5 steps (the keyframes' new splats: within 5 cm,
    where the two maps' depth renders place them), and the keyframes' pose
    deltas within the pose Adam's."""
    from gslam_tpu.mapping.backend_ops import MapConfig as JMapConfig
    from gslam_tpu.ops.rasterize import RenderConfig as JRenderConfig
    from gslam_tpu.runtime.backend import BackendActor as JBackend
    from gslam_tpu_torch.mapping.optimizer import DEFAULT_LRS
    from gslam_tpu_torch.runtime.backend import BackendActor

    W, H = 48, 32
    ds = SyntheticDataset(seq_len=3, width=W, height=H, n_splats=300, seed=2,
                          motion_scale=0.03, device=CPU)
    # without the depth TV term the keyframe steps' (regularize=False)
    # program is the bootstrap's, one JAX compile fewer
    common = dict(window_size=3, recent_window=3, num_iters_init=3, kf_m=0.02,
                  depth_tv_weight=0.0)
    jbe = JBackend(JMapConfig(render=JRenderConfig(tile_capacity=64, tile_chunk=8), **common),
                   W, H, capacity=1024, kf_capacity=4)
    tbe = BackendActor(tb.MapConfig(render=RenderConfig(tile_capacity=64), **common), W, H,
                       capacity=1024, kf_capacity=4, device=CPU, draws=JaxDraws())
    exposure = np.zeros(2, np.float32)
    added = []
    for jf, tf in zip(frames_of(ds, jax_frames=True), frames_of(ds)):
        if jf.index == 0:
            jbe.handle_request_init(jf, jnp.asarray(jf.gt_pose), jnp.asarray(exposure))
            tbe.handle_request_init(tf, tf.gt_pose, exposure)
        else:
            a = jbe.handle_add_frame(jf, jnp.asarray(jf.gt_pose), jnp.asarray(exposure))
            b = tbe.handle_add_frame(tf, tf.gt_pose, exposure)
            assert a == b, f"frame {jf.index}"
            added.append(a)
        assert tbe.kf_order == jbe.kf_order and tbe.frame_slot == jbe.frame_slot
        assert tbe.pose_graph == jbe.pose_graph and tbe.total_step == jbe.total_step
        assert tbe.n_live_splats() == jbe.n_live_splats()
        np.testing.assert_array_equal(tbe.key.numpy(), np.asarray(jbe.key).astype(np.int64))
    assert any(added), "no keyframe was added"
    bound = {f: 2 * tbe.total_step * lr + 1e-5 for f, lr in DEFAULT_LRS.items()}
    for f in bound:
        a, b = getattr(tbe.gmap, f).numpy(), np.asarray(getattr(jbe.gmap, f))
        if f == "log_scales":
            # the bootstrap's kNN scales come from sqrt(|a|^2 + |b|^2 - 2ab)
            # in float32, whose rounding noise (~1e-6 of |a|^2) moves a scale
            # by up to ~1e-3; so scales are held to that plus Adam's bound
            sa, sb = np.exp(a), np.exp(b)
            assert (np.abs(sa - sb) <= 2e-3 + np.expm1(bound[f]) * np.maximum(sa, sb)).all()
            continue
        if f == "means":
            # a splat inserted at a keyframe is backprojected from the map's
            # render at that frame, whose depth differs where the maps do
            later = tbe.gmap.ages.numpy() > 0
            assert later.any() and np.abs(a[later] - b[later]).max() <= 0.05
            a, b = a[~later], b[~later]
        assert np.abs(a - b).max() <= bound[f], f
    for f in ("alive", "ages"):
        np.testing.assert_array_equal(getattr(tbe.gmap, f).numpy(),
                                      np.asarray(getattr(jbe.gmap, f)), err_msg=f)
    for f in ("d_rot6", "d_t"):  # the pose Adam's bound, as the map's
        a, b = getattr(tbe.kf, f).numpy(), np.asarray(getattr(jbe.kf, f))
        assert np.abs(a - b).max() <= 2 * tbe.total_step * tbe.cfg.pose_lr, f
    np.testing.assert_array_equal(tbe.kf.pose_base.numpy(), np.asarray(jbe.kf.pose_base))
    np.testing.assert_array_equal(tbe.kf.mask.numpy(), np.asarray(jbe.kf.mask))
    np.testing.assert_array_equal(tbe.kf.frame_idx.numpy(), np.asarray(jbe.kf.frame_idx))


def test_actor_checkpoint_crosses_packages(tmp_path):
    """A checkpoint the JAX SlamSystem writes, restored by the port's
    restore_system and saved again, restores into a JAX SlamSystem whose
    own checkpoint equals the first, array for array."""
    from gslam_tpu.runtime import checkpoint as jck
    from gslam_tpu.runtime.system import SlamConfig as JSlamConfig
    from gslam_tpu.runtime.system import SlamSystem as JSlamSystem
    from gslam_tpu_torch.runtime import checkpoint as tck
    import jax

    W, H, cap, kf_cap = 32, 24, 64, 4
    rng = np.random.default_rng(11)
    ds = SyntheticDataset(seq_len=3, width=W, height=H, n_splats=50, seed=1, device=CPU)
    jsys = JSlamSystem(JSlamConfig(capacity=cap, kf_capacity=kf_cap), W, H)
    be, fe = jsys.backend, jsys.frontend
    be.gmap = be.gmap._replace(**{
        f: jnp.asarray(rng.normal(size=np.shape(v)).astype(np.float32))
        for f, v in be.gmap._asdict().items() if f not in ("ages", "alive")},
        ages=jnp.asarray(rng.integers(0, 3, cap).astype(np.int32)),
        alive=jnp.asarray(rng.random(cap) < 0.7))
    be.opt_state = be.opt_state._replace(
        mu={f: v + 0.1 for f, v in be.opt_state.mu.items()},
        count=jnp.asarray(7, jnp.int32))
    be.kf = be.kf._replace(d_t=jnp.asarray(rng.normal(0, 0.01, (kf_cap, 3)), jnp.float32),
                           frame_idx=jnp.asarray([0, 2, -1, 1], jnp.int32),
                           mask=jnp.asarray([True, True, False, True]))
    be.pose_opt = be.pose_opt._replace(count=jnp.asarray([0, 3, 0, 1], jnp.int32))
    be.key = jax.random.PRNGKey(12345)
    be.K = ds.camera.K.numpy()
    be.kf_order, be.kf_frame_idx = [0, 3, 1], {0: 0, 3: 1, 1: 2}
    be.frame_slot = {0: 0, 1: 3, 2: 1}
    be.pose_graph = {0: {1}, 1: {0, 2}, 2: {1}}
    be.total_step, be.pause_map_optim = 17, True
    jsys.n_keyframes_added = 2
    frames = frames_of(ds, jax_frames=True)
    for i, f in enumerate(frames):
        f.est_pose = f.gt_pose + 0.01 * i
        f.exposure = np.array([0.1 * i, -0.1], np.float32)
    be.frames = [f.strip() for f in frames]
    fe.frames = [f.strip() for f in frames[:2]]
    fe.track_times, fe.losses = [0.5, 0.25], [0.125, 0.0625]
    jck.save_checkpoint(tmp_path / "jax.npz", jsys)

    tsys = SlamSystem(SlamConfig(capacity=8, kf_capacity=2), W, H, device=CPU)
    assert tck.restore_system(tmp_path / "jax.npz", tsys) == 2
    assert tsys.frontend.gmap is not None and tsys.backend.capacity == cap
    tck.save_checkpoint(tmp_path / "port.npz", tsys)
    back = JSlamSystem(JSlamConfig(capacity=8, kf_capacity=2), W, H)
    assert jck.restore_system(tmp_path / "port.npz", back) == 2
    jck.save_checkpoint(tmp_path / "back.npz", back)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "back.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            if k == "meta_json":
                assert json.loads(bytes(a[k])) == json.loads(bytes(b[k]))
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
