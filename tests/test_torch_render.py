"""Parity of the port's generic multi-camera render (`render_impl`) with the
JAX package on the CPU, where JAX takes its jnp blend and the port the
blend kernels' plain versions.

Tolerances are those of test_pallas_and_sharding.py's kernel-vs-jnp tests:
rgb and alpha atol 1e-5, depth and beta atol 1e-4, `n_touched`, `radii` and
`n_pairs` exact; gradients atol 1e-6, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu.ops import rasterize as jr  # noqa: E402
from gslam_tpu_torch.ops import rasterize as tr  # noqa: E402

from scene_utils import make_scene  # noqa: E402

CAP = 64  # tile_capacity of the small scenes
FIELDS = ("means", "quats", "log_scales", "logit_opacities", "logit_colors",
          "log_uncertainties")


def _pose(t, rotvec=(0.0, 0.0, 0.0)):
    import scipy.spatial.transform as sst

    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = sst.Rotation.from_rotvec(rotvec).as_matrix()
    m[:3, 3] = t
    return m


# name: (seed, n, width, height, second camera, bg_rgb, dead splats, reused bins)
CASES = {
    "one_camera": (0, 100, 64, 48, False, False, 0, False),
    "two_cameras_bg": (1, 100, 64, 48, True, True, 0, False),
    "odd_size_dead": (2, 90, 70, 45, False, False, 25, False),
    "reused_bins": (3, 80, 64, 48, True, False, 10, True),
}


def _case(name):
    seed, n, w, h, two, bg, dead, reuse = CASES[name]
    rng = np.random.default_rng(seed)
    params, _vm, Ks, w, h = make_scene(rng, n=n, width=w, height=h)
    d = {k: np.asarray(v) for k, v in params.items()}
    d["alive"] = d["alive"].copy()
    d["alive"][rng.choice(n, dead, replace=False)] = False
    vms = [np.eye(4, dtype=np.float32)]
    if two:
        vms.append(_pose([0.05, -0.03, 0.1], [0.02, -0.03, 0.01]))
    vms = np.stack(vms)
    Ks = np.repeat(np.asarray(Ks), len(vms), 0)
    C = len(vms)
    return dict(
        d=d, vms=vms, Ks=Ks, w=w, h=h, reuse=reuse,
        bg=rng.random(3).astype(np.float32) if bg else None,
        target=rng.random((C, h, w, 3)).astype(np.float32),
    )


def _loss(o, target, xp):
    """test_pallas_matches_jnp_gradients's mean loss, plus depth and beta
    terms so that every field gets a gradient."""
    return (xp.mean((o.rgb - target) ** 2) + 0.1 * xp.mean(o.alpha)
            + 0.01 * xp.mean(o.depth) + 0.01 * xp.mean(o.beta))


def _jax_run(c):
    jcfg = jr.RenderConfig(tile_capacity=CAP)
    fields = {k: jnp.asarray(c["d"][k]) for k in FIELDS}
    alive = jnp.asarray(c["d"]["alive"])
    vms, Ks = jnp.asarray(c["vms"]), jnp.asarray(c["Ks"])
    bg = None if c["bg"] is None else jnp.asarray(c["bg"])
    bins = None
    if c["reuse"]:
        bins = jr.compute_bins_jit(fields["means"], fields["quats"], fields["log_scales"],
                                   alive, vms, Ks, c["w"], c["h"], jcfg, radius_scale=1.5)

    @jax.jit
    def run(fields, vms, probe):
        def f(fields, vms, probe):
            o = jr.render_impl(**fields, alive=alive, viewmats=vms, Ks=Ks,
                               width=c["w"], height=c["h"], bg_rgb=bg, cfg=jcfg,
                               probe2d=probe, bins=bins)
            return _loss(o, jnp.asarray(c["target"]), jnp), o
        return jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(fields, vms, probe)

    probe = jnp.zeros((len(c["vms"]), c["d"]["means"].shape[0], 2))
    (loss, out), grads = run(fields, vms, probe)
    return loss, out, grads


def _torch_run(c):
    tcfg = tr.RenderConfig(tile_capacity=CAP)
    fields = {k: torch.tensor(c["d"][k]).requires_grad_(True) for k in FIELDS}
    alive = torch.tensor(c["d"]["alive"])
    vms = torch.tensor(c["vms"]).requires_grad_(True)
    Ks = torch.tensor(c["Ks"])
    probe = torch.zeros((len(c["vms"]), c["d"]["means"].shape[0], 2), requires_grad=True)
    bins = None
    if c["reuse"]:
        bins = tr.compute_bins(fields["means"], fields["quats"], fields["log_scales"],
                               alive, vms, Ks, c["w"], c["h"], tcfg, radius_scale=1.5)
    bg = None if c["bg"] is None else torch.tensor(c["bg"])
    o = tr.render_impl(**fields, alive=alive, viewmats=vms, Ks=Ks, width=c["w"],
                       height=c["h"], bg_rgb=bg, cfg=tcfg, probe2d=probe, bins=bins)
    loss = _loss(o, torch.tensor(c["target"]), torch)
    grads = torch.autograd.grad(loss, [*fields.values(), vms, probe])
    return loss, o, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_impl_matches_jax(name):
    c = _case(name)
    jloss, jo, (jg_fields, jg_vm, jg_probe) = _jax_run(c)
    tloss, to, tgrads = _torch_run(c)

    C = len(c["vms"])
    assert to.rgb.shape == (C, c["h"], c["w"], 3)
    assert float(to.alpha.detach().max()) > 0.5
    for f, tol in (("rgb", 1e-5), ("alpha", 1e-5), ("depth", 1e-4), ("beta", 1e-4),
                   ("means2d", 1e-4), ("depths", 1e-5)):
        np.testing.assert_allclose(getattr(to, f).detach().numpy(),
                                   np.asarray(getattr(jo, f)), atol=tol, err_msg=f)
    for f in ("n_touched", "radii", "n_pairs"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                      err_msg=f)
    assert int(to.n_touched.sum()) > 0
    # dead splats are culled in every camera
    assert not to.radii.numpy()[:, ~c["d"]["alive"]].any()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)

    want = [jg_fields[k] for k in FIELDS] + [jg_vm, jg_probe]
    for name_g, a, b in zip(FIELDS + ("viewmats", "probe2d"), tgrads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-4,
                                   err_msg=name_g)
    assert np.abs(tgrads[-1].numpy()).max() > 1e-5  # the probe sees dL/dmeans2d


def test_render_entry_point_and_per_camera_launch_split():
    """`render` takes numpy arrays; a two-camera render equals the two
    one-camera renders (each camera is its own slice of the blend rows)."""
    c = _case("two_cameras_bg")
    args = [c["d"][k] for k in FIELDS] + [c["d"]["alive"]]
    cfg = tr.RenderConfig(tile_capacity=CAP)
    both = tr.render(*args, c["vms"], c["Ks"], c["w"], c["h"], bg_rgb=c["bg"], cfg=cfg,
                     device="cpu")
    for cam in range(2):
        one = tr.render(*args, c["vms"][cam:cam + 1], c["Ks"][cam:cam + 1], c["w"],
                        c["h"], bg_rgb=c["bg"], cfg=cfg, device="cpu")
        for f in tr.RenderOutput._fields:
            np.testing.assert_array_equal(getattr(one, f)[0].numpy(),
                                          getattr(both, f)[cam].numpy(), err_msg=f)
