"""Parity of the port's multi-device package (gslam_tpu_torch/parallel/
sharding.py) with gslam_tpu.parallel.sharding on the CPU.

The JAX side runs on the conftest's virtual 8-device CPU mesh; the port's
mesh repeats the "cpu" device, so every band and camera chunk is its own
render and the composite and gradient sums are those of a real mesh.
Inputs are made with numpy from a seed and fed to both packages. The
permutation of `partition_by_depth` is held exactly; float outputs to the
stated tolerances (the JAX programs are jitted, so XLA may reorder float32
sums). After one Adam step from zero moments a parameter moves by about
lr * sign(g), so the updated maps are compared where |g| > 1e-4 (the first
moment, 0.1 g, is compared everywhere).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu_torch.mapping.backend_ops import MapConfig  # noqa: E402
from gslam_tpu_torch.mapping.gaussians import (  # noqa: E402
    GaussianMap, TRAINABLE_FIELDS, gaussian_map_from_numpy,
)
from gslam_tpu_torch.mapping.optimizer import init_adam  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig, render_impl  # noqa: E402
from gslam_tpu_torch.parallel import sharding as ts  # noqa: E402

CPU = "cpu"
W, H = 64, 48
N = 96
# float32 composite of D layers against JAX's (rgb, alpha; depth, beta)
RENDER_TOL = (2e-5, 1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


def T(x):
    return torch.from_numpy(np.array(x))


def scene(rng, n=N, n_dead=0):
    """tests/scene_utils.make_scene's splats (in front of a 64x48 camera at
    z 2-4) as numpy fields, with `n_dead` dead slots."""
    fx = 0.9 * W
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
    z = rng.uniform(2.0, 4.0, n).astype(np.float32)
    u = rng.uniform(4, W - 4, n).astype(np.float32)
    v = rng.uniform(4, H - 4, n).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[rng.choice(n, n_dead, replace=False)] = False
    fields = dict(
        means=np.stack([(u - W / 2) * z / fx, (v - H / 2) * z / fx, z], -1),
        quats=quats / np.linalg.norm(quats, axis=-1, keepdims=True),
        log_scales=np.log(rng.uniform(0.04, 0.12, (n, 3))).astype(np.float32),
        logit_opacities=rng.uniform(-1.0, 3.0, n).astype(np.float32),
        logit_colors=rng.normal(size=(n, 3)).astype(np.float32),
        log_uncertainties=rng.uniform(-0.5, 0.5, n).astype(np.float32),
        ages=np.zeros(n, np.int32), alive=alive)
    return {k: np.asarray(v, np.bool_ if k == "alive" else v.dtype)
            for k, v in fields.items()}, K


def jax_map(fields):
    from gslam_tpu.mapping.gaussians import GaussianMap as JMap

    return JMap(**{k: jnp.asarray(v) for k, v in fields.items()})


def adam_fields(rng, n):
    return {f"{k}/{f}": (rng.normal(size=s).astype(np.float32) if k == "mu" else
                         rng.uniform(0, 1, s).astype(np.float32))
            for k in ("mu", "nu")
            for f, s in (("means", (n, 3)), ("quats", (n, 4)), ("log_scales", (n, 3)),
                         ("logit_opacities", (n,)), ("logit_colors", (n, 3)),
                         ("log_uncertainties", (n,)))}


def cameras(rng, C):
    """C poses 2 cm apart in x, exposures and ground-truth images."""
    base = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    base[:, 0, 3] = 0.02 * np.arange(C)
    gt = rng.random((C, H, W, 3)).astype(np.float32)
    exps = rng.normal(scale=0.05, size=(C, 2)).astype(np.float32)
    return base, gt, exps


def jcfg(tile_capacity=64):
    from gslam_tpu.mapping.backend_ops import MapConfig as JMapConfig
    from gslam_tpu.ops.rasterize import RenderConfig as JRenderConfig

    return JMapConfig(render=JRenderConfig(backend="jnp", tile_capacity=tile_capacity,
                                           tile_chunk=2))


def tcfg(tile_capacity=64):
    return MapConfig(render=RenderConfig(tile_capacity=tile_capacity))


def jax_mesh(n, axis):
    from jax.sharding import Mesh as JMesh

    return JMesh(np.asarray(jax.devices("cpu")[:n]), (axis,))


def test_mesh_devices(monkeypatch):
    """The mesh reads as JAX's (axis_names, shape[axis], devices); a hybrid
    mesh lays bands along rows; with no CUDA and no devices it raises."""
    m = ts.make_hybrid_mesh(2, 3, devices=[CPU] * 6)
    assert m.axis_names == ("gauss", "cam") and m.shape == {"gauss": 2, "cam": 3}
    assert m.devices.shape == (2, 3) and m.size == 6
    assert m.axis_devices("gauss") == [torch.device(CPU)] * 2
    replicate, split = ts.camera_dp_shardings(ts.make_mesh(2, devices=[CPU] * 4))
    assert len(replicate(torch.zeros(3))) == 2
    assert [c.shape[0] for c in split(torch.zeros(4, 2))] == [2, 2]
    with pytest.raises(ValueError):
        split(torch.zeros(3, 2))
    with pytest.raises(ValueError):
        ts.make_mesh(3, devices=[CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.make_mesh(1)


def test_bands_split_and_join():
    """split_bands cuts contiguous bands (capacity must divide), join_bands
    puts them back bit for bit, the Adam count rides along."""
    from gslam_tpu_torch.mapping.optimizer import adam_state_from_numpy

    rng = np.random.default_rng(1)
    fields, _ = scene(rng, n=12, n_dead=3)
    gmap = gaussian_map_from_numpy(fields, device=CPU)
    opt = adam_state_from_numpy({**adam_fields(rng, 12), "count": np.int32(7)}, device=CPU)
    bands = ts.split_bands(gmap, [CPU] * 3)
    assert [b.capacity for b in bands] == [4, 4, 4]
    back = ts.join_bands(bands, CPU)
    for a, b in zip(gmap, back):
        assert torch.equal(a, b)
    obands = ts.split_bands(opt, [CPU] * 3)
    oback = ts.join_bands(obands, CPU)
    assert all(int(o.count) == 7 for o in obands) and int(oback.count) == 7
    for k in opt.mu:
        assert torch.equal(opt.mu[k], oback.mu[k]) and torch.equal(opt.nu[k], oback.nu[k])
    with pytest.raises(ValueError, match="split"):
        ts.split_bands(gmap, [CPU] * 5)


def test_partition_by_depth_matches_jax():
    """The same permutation as JAX's, exactly: live splats by camera depth,
    ties (duplicated means) and the dead (+inf) in their original order;
    the map, the Adam moments and a [K, cap] side table all follow it."""
    from gslam_tpu.mapping.optimizer import MaskedAdamState as JState
    from gslam_tpu.parallel.sharding import partition_by_depth as j_part
    from gslam_tpu_torch.mapping.optimizer import adam_state_from_numpy
    import scipy.spatial.transform as sst

    rng = np.random.default_rng(2)
    fields, _ = scene(rng, n=200, n_dead=40)
    fields["means"][150:160] = fields["means"][10:20]  # depth ties
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, :3] = sst.Rotation.from_rotvec([0.1, -0.2, 0.05]).as_matrix()
    viewmat[:3, 3] = [0.1, -0.05, 0.3]
    opt = {**adam_fields(rng, 200), "count": np.int32(3)}
    vis = rng.random((5, 200)) < 0.5
    jopt = JState(mu={f: jnp.asarray(opt[f"mu/{f}"]) for f in TRAINABLE_FIELDS},
                  nu={f: jnp.asarray(opt[f"nu/{f}"]) for f in TRAINABLE_FIELDS},
                  count=jnp.int32(3))
    jg, jo, jv = j_part(jax_map(fields), jnp.asarray(viewmat), jopt, jnp.asarray(vis))
    tg, to, tv = ts.partition_by_depth(gaussian_map_from_numpy(fields, device=CPU),
                                       T(viewmat), adam_state_from_numpy(opt, device=CPU),
                                       T(vis))
    for f in GaussianMap._fields:
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                      err_msg=f)
    for f in TRAINABLE_FIELDS:
        np.testing.assert_array_equal(to.mu[f].numpy(), np.asarray(jo.mu[f]))
        np.testing.assert_array_equal(to.nu[f].numpy(), np.asarray(jo.nu[f]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tg.alive[-40:].any() and tg.alive[:160].all()
    # the map alone, as its single-argument call returns it
    alone = ts.partition_by_depth(gaussian_map_from_numpy(fields, device=CPU), T(viewmat))
    assert torch.equal(alone.means, tg.means)


def test_compose_bands_matches_jax():
    """The front-to-back composite and its vector-Jacobian product, against
    gslam_tpu.parallel.slam._compose_bands on the same D=3 layer stacks."""
    from gslam_tpu.parallel.slam import _compose_bands as j_compose
    from gslam_tpu_torch.parallel.slam import _compose_bands as t_compose

    rng = np.random.default_rng(3)
    D, h, w = 3, 5, 7
    alphas = rng.uniform(0.0, 0.99, (D, h, w)).astype(np.float32)
    rgbs = (rng.random((D, h, w, 3)) * alphas[..., None]).astype(np.float32)
    depths = (rng.uniform(1, 4, (D, h, w)) * alphas).astype(np.float32)
    betas = rng.uniform(0.5, 3.0, (D, h, w)).astype(np.float32)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((h, w, 3), (h, w), (h, w), (h, w))]
    bg = float(np.e)
    j_out, j_vjp = jax.vjp(lambda *a: j_compose(*a, bg), *(jnp.asarray(x) for x in
                                                         (rgbs, alphas, depths, betas)))
    j_grads = j_vjp(tuple(jnp.asarray(c) for c in cots))
    ins = [T(x).requires_grad_(True) for x in (rgbs, alphas, depths, betas)]
    t_out = t_compose(*ins, bg)
    t_grads = torch.autograd.grad(t_out, ins, [T(c) for c in cots])
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    for a, b in zip(t_grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)


def test_gauss_render_matches_jax():
    """A 4-band render of a depth-partitioned map composes to JAX's 4-band
    gauss_render, and to the port's single-device render of the same map
    (tile lists unsaturated: 128 slots for 96 splats)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gslam_tpu.parallel.sharding import gauss_render as j_render
    from gslam_tpu.parallel.sharding import partition_by_depth as j_part

    rng = np.random.default_rng(4)
    fields, K = scene(rng)
    vms = np.stack([np.eye(4, dtype=np.float32)] * 2)
    vms[1, 0, 3] = 0.05
    Ks = np.stack([K, K])
    jg = j_part(jax_map(fields), jnp.asarray(vms[0]))
    mesh = jax_mesh(4, "gauss")
    j_out = jax.jit(j_render, static_argnums=(0, 4, 5, 6))(
        mesh, jax.device_put(jg, NamedSharding(mesh, P("gauss"))), jnp.asarray(vms),
        jnp.asarray(Ks), W, H, jcfg(128))
    gmap = ts.partition_by_depth(gaussian_map_from_numpy(fields, device=CPU), T(vms[0]))
    tmesh = ts.make_mesh(4, axis="gauss", devices=[CPU] * 4)
    bands = ts.split_bands(gmap, tmesh.axis_devices("gauss"))
    t_out = ts.gauss_render(tmesh, bands, T(vms), T(Ks), W, H, tcfg(128))
    dense = render_impl(**gmap.render_kwargs(), viewmats=T(vms), Ks=T(Ks), width=W,
                        height=H, cfg=tcfg(128).render)
    for k, (a, b, d) in enumerate(zip(t_out, j_out, (dense.rgb, dense.alpha, dense.depth,
                                                      dense.beta))):
        tol = RENDER_TOL[k >= 2]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
        np.testing.assert_allclose(a.numpy(), d.numpy(), atol=tol)
    # the background is added once, behind the composite
    bg = ts.gauss_render(tmesh, bands, T(vms), T(Ks), W, H, tcfg(128), bg_rgb=(0.2, 0.3, 0.4))
    np.testing.assert_allclose(
        bg[0].numpy(), (t_out[0] + (1 - t_out[1])[..., None] * T([0.2, 0.3, 0.4])).numpy(),
        atol=1e-6)


def _step_inputs(seed, C, n_dead=0):
    rng = np.random.default_rng(seed)
    fields, K = scene(rng, n_dead=n_dead)
    base, gt, exps = cameras(rng, C)
    pose_vec = rng.normal(scale=1e-3, size=(C, 9)).astype(np.float32)
    return fields, K, base, gt, exps, pose_vec


def _check_step(t_maps, t_opt, t_pv, j_map, j_opt, j_pv, where):
    """Updated parameters where |g| > 1e-4 (|mu| > 1e-5), moments and the
    pose step."""
    t_map = t_maps if isinstance(t_maps, GaussianMap) else ts.join_bands(t_maps, CPU)
    t_opt = t_opt if not isinstance(t_opt, list) else ts.join_bands(t_opt, CPU)
    for f in TRAINABLE_FIELDS:
        mu = np.asarray(j_opt.mu[f])
        np.testing.assert_allclose(t_opt.mu[f].numpy(), mu, **GRAD_TOL,
                                   err_msg=f"{where}: mu/{f}")
        big = np.abs(mu) > 1e-5
        assert big.any(), f
        np.testing.assert_allclose(getattr(t_map, f).numpy()[big],
                                   np.asarray(getattr(j_map, f))[big], atol=1e-5,
                                   err_msg=f"{where}: {f}")
    assert int(t_opt.count) == int(j_opt.count) == 1
    np.testing.assert_allclose(t_pv.numpy(), np.asarray(j_pv), atol=1e-6, rtol=1e-4,
                               err_msg=f"{where}: pose_vec")


def test_dp_mapping_train_step_matches_jax():
    """Camera DP over a 2-device mesh, 2 cameras: JAX's step with the
    cameras sharded over 'cam' against the port's over ["cpu"] * 2 and over
    a one-device mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gslam_tpu.mapping.optimizer import init_adam as j_init
    from gslam_tpu.parallel.sharding import dp_mapping_train_step as j_step

    C = 2
    fields, K, base, gt, exps, pv = _step_inputs(5, C, n_dead=10)
    Ks = np.stack([K] * C)
    mesh = jax_mesh(2, "cam")
    repl, cam = NamedSharding(mesh, P()), NamedSharding(mesh, P("cam"))
    jm = jax_map(fields)
    j_out = j_step(jax.device_put(jm, repl), jax.device_put(j_init(jm), repl),
                   *(jax.device_put(jnp.asarray(x), cam) for x in (pv, base, gt, exps, Ks)),
                   W, H, jcfg())
    args = [T(x) for x in (pv, base, gt, exps, Ks)]
    for n in (2, 1):
        gmap = gaussian_map_from_numpy(fields, device=CPU)
        t_out = ts.dp_mapping_train_step(gmap, init_adam(gmap), *args, W, H, tcfg(),
                                         mesh=ts.make_mesh(n, devices=[CPU] * n))
        _check_step(*t_out, *j_out, f"{n} devices")


@pytest.fixture(scope="module")
def gauss_step_reference():
    """JAX's splat-sharded mapping step over 4 bands, 4 cameras."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gslam_tpu.mapping.optimizer import MaskedAdamState as JState
    from gslam_tpu.mapping.optimizer import init_adam as j_init
    from gslam_tpu.parallel.sharding import make_gauss_mapping_step as j_make
    from gslam_tpu.parallel.sharding import partition_by_depth as j_part

    C = 4
    fields, K, base, gt, exps, pv = _step_inputs(6, C, n_dead=8)
    Ks = np.stack([K] * C)
    jm = jax_map(fields)
    jm, jo = j_part(jm, jnp.eye(4), j_init(jm))
    mesh = jax_mesh(4, "gauss")
    shard, repl = NamedSharding(mesh, P("gauss")), NamedSharding(mesh, P())
    jo = JState(mu=jax.device_put(jo.mu, shard), nu=jax.device_put(jo.nu, shard),
                count=jax.device_put(jo.count, repl))
    out = j_make(mesh, W, H, jcfg())(jax.device_put(jm, shard), jo,
                                     *(jnp.asarray(x) for x in (pv, base, gt, exps, Ks)))
    return (fields, pv, base, gt, exps, Ks), out


def _port_bands(fields, devices):
    gmap = gaussian_map_from_numpy(fields, device=CPU)
    gmap, opt = ts.partition_by_depth(gmap, torch.eye(4), init_adam(gmap))
    return ts.split_bands(gmap, devices), ts.split_bands(opt, devices)


@pytest.mark.parametrize("layout", ["gauss_4", "hybrid_2x4"])
def test_banded_mapping_steps_match_jax(gauss_step_reference, layout):
    """make_gauss_mapping_step over 4 bands and make_hybrid_mapping_step
    over 2 bands x 4 camera chunks, each against JAX's 4-band step on the
    same inputs (JAX's own tests hold its hybrid step to its band step)."""
    (fields, *cams), j_out = gauss_step_reference
    if layout == "gauss_4":
        mesh = ts.make_mesh(4, axis="gauss", devices=[CPU] * 4)
        step = ts.make_gauss_mapping_step(mesh, W, H, tcfg())
    else:
        mesh = ts.make_hybrid_mesh(2, 4, devices=[CPU] * 8)
        step = ts.make_hybrid_mapping_step(mesh, W, H, tcfg())
    bands, opts = _port_bands(fields, mesh.axis_devices("gauss"))
    t_out = step(bands, opts, *(T(x) for x in cams))
    assert len(t_out[0]) == mesh.shape["gauss"]
    _check_step(*t_out, *j_out, layout)


def test_dryrun_multichip_8():
    """The port's dry run over 8 repeated CPU devices: camera DP, the hybrid
    2x4 step and 4 frames of ShardedSlam with the pose graph (its asserts:
    finite, healthy, at least one IoU loop closure)."""
    from gslam_tpu_torch.parallel import dryrun_multichip

    out = dryrun_multichip(8, devices=[CPU] * 8)
    assert set(out) == {"camera_dp", "hybrid", "slam"}
    m = out["slam"]
    assert m["L"] == 4 and m["C"] == 4 and m["n_devices"] == 8
    assert np.isfinite(m["ate"]) and m["total_map_iters"] == 4 + 3 * 2
