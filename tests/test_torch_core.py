"""Parity of the PyTorch port's geometry, map buffer, projection and binning
with the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial.transform as sst

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu.core import transforms as jt  # noqa: E402
from gslam_tpu.mapping.gaussians import empty_map as j_empty_map  # noqa: E402
from gslam_tpu.ops.projection import project_gaussians as j_project  # noqa: E402
from gslam_tpu.ops.rasterize import RenderConfig as JRenderConfig  # noqa: E402
from gslam_tpu.ops.rasterize import compute_bins_jit as j_compute_bins  # noqa: E402
from gslam_tpu_torch.core import transforms as tt  # noqa: E402
from gslam_tpu_torch.mapping.gaussians import (  # noqa: E402
    empty_map, gaussian_map_from_numpy, gaussian_map_to_numpy,
)
from gslam_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig, compute_bins  # noqa: E402

from scene_utils import make_scene  # noqa: E402

CPU = "cpu"


def T(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def random_rotations(rng, n):
    return sst.Rotation.random(n, random_state=rng).as_matrix().astype(np.float32)


def scene_np(seed, **kw):
    params, vm, Ks, w, h = make_scene(np.random.default_rng(seed), **kw)
    return ({k: np.asarray(v) for k, v in params.items()}, np.asarray(vm[0]),
            np.asarray(Ks[0]), w, h)


# ---------------------------------------------------------------- transforms
# The cases of tests/test_transforms.py, on the port.


def test_quat_roundtrip(rng):
    R = random_rotations(rng, 64)
    q = tt.matrix_to_quaternion(T(R))
    np.testing.assert_allclose(tt.quaternion_to_matrix(q).numpy(), R, atol=1e-5)
    assert np.all(q.numpy()[:, 0] >= 0)


def test_quat_matches_scipy(rng):
    R = random_rotations(rng, 16)
    q = tt.matrix_to_quaternion(T(R)).numpy()
    q_ref = sst.Rotation.from_matrix(R).as_quat()  # xyzw
    q_ref = np.concatenate([q_ref[:, 3:4], q_ref[:, :3]], axis=1)
    np.testing.assert_allclose(np.abs(q), np.abs(q_ref), atol=1e-5)


def test_rotation_6d_identity():
    d6 = T([1.0, 0, 0, 0, 1.0, 0])
    np.testing.assert_allclose(tt.rotation_6d_to_matrix(d6).numpy(), np.eye(3), atol=1e-6)


def test_rotation_6d_orthonormal(rng):
    R = tt.rotation_6d_to_matrix(T(rng.normal(size=(32, 6)))).numpy()
    eye = np.einsum("bij,bkj->bik", R, R)
    np.testing.assert_allclose(eye, np.tile(np.eye(3), (32, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), np.ones(32), atol=1e-5)


def test_rotation_6d_recovers_rotation(rng):
    R = random_rotations(rng, 8)
    R2 = tt.rotation_6d_to_matrix(T(R[:, :2, :].reshape(8, 6))).numpy()
    np.testing.assert_allclose(R2, R, atol=1e-5)


def test_so3_exp_log_roundtrip(rng):
    w = rng.normal(size=(32, 3)).astype(np.float32) * 0.8
    w2 = tt.so3_log(tt.so3_exp(T(w))).numpy()
    np.testing.assert_allclose(w2, w, atol=1e-4)


def test_so3_exp_matches_scipy(rng):
    w = rng.normal(size=(8, 3)).astype(np.float32)
    R_ref = sst.Rotation.from_rotvec(w).as_matrix()
    np.testing.assert_allclose(tt.so3_exp(T(w)).numpy(), R_ref, atol=1e-5)


def test_so3_exp_grad_at_zero():
    w = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad(tt.so3_exp(w)[0, 1], w)
    assert torch.all(torch.isfinite(g))


def test_se3_exp_identity_and_translation():
    np.testing.assert_allclose(tt.se3_exp(torch.zeros(6)).numpy(), np.eye(4), atol=1e-6)
    M = tt.se3_exp(T([1.0, 2.0, 3.0, 0, 0, 0])).numpy()
    np.testing.assert_allclose(M[:3, 3], [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(M[:3, :3], np.eye(3), atol=1e-6)


def test_invert_se3(rng):
    M = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    M[:, :3, :3] = random_rotations(rng, 4)
    M[:, :3, 3] = rng.normal(size=(4, 3))
    prod = np.einsum("bij,bjk->bik", M, tt.invert_se3(T(M)).numpy())
    np.testing.assert_allclose(prod, np.tile(np.eye(4), (4, 1, 1)), atol=1e-5)


def test_pose_delta_identity_and_composition(rng):
    base = np.eye(4, dtype=np.float32)
    base[:3, :3] = random_rotations(rng, 1)[0]
    base[:3, 3] = rng.normal(size=3)
    p = tt.PoseDelta(T(base), torch.zeros(6), torch.zeros(3))
    np.testing.assert_allclose(tt.pose_matrix(p).numpy(), base, atol=1e-6)
    p = tt.PoseDelta(p.base, p.d_rot6, p.d_t + T([0.1, 0.0, 0.0]))
    expected_t = base[:3, :3] @ np.array([0.1, 0, 0]) + base[:3, 3]
    np.testing.assert_allclose(tt.pose_matrix(p).numpy()[:3, 3], expected_t, atol=1e-5)


def test_pose_grad_flows():
    d_rot6 = torch.zeros(6, requires_grad=True)
    d_t = torch.zeros(3, requires_grad=True)
    m = tt.pose_matrix(tt.PoseDelta(torch.eye(4), d_rot6, d_t))
    g = torch.autograd.grad(torch.sum(m[:3, 3] ** 2) + m[0, 1] ** 2, (d_rot6, d_t))
    assert all(torch.all(torch.isfinite(x)) for x in g)


def _pose_inputs(rng):
    base = np.eye(4, dtype=np.float32)
    base[:3, :3] = random_rotations(rng, 1)[0]
    base[:3, 3] = rng.normal(size=3)
    return base, rng.normal(size=6).astype(np.float32) * 0.1, rng.normal(
        size=3).astype(np.float32) * 0.1


# (name, jax fn, torch fn, input maker); each case is a cross-package parity
PARITY = {
    "rotation_6d_to_matrix": (
        jt.rotation_6d_to_matrix, tt.rotation_6d_to_matrix,
        lambda r: (r.normal(size=(16, 6)).astype(np.float32),)),
    "quaternion_to_matrix": (
        jt.quaternion_to_matrix, tt.quaternion_to_matrix,
        lambda r: (r.normal(size=(16, 4)).astype(np.float32),)),
    "matrix_to_quaternion": (
        jt.matrix_to_quaternion, tt.matrix_to_quaternion,
        lambda r: (random_rotations(r, 16),)),
    "so3_exp": (jt.so3_exp, tt.so3_exp,
                lambda r: (r.normal(size=(16, 3)).astype(np.float32),)),
    "so3_log": (jt.so3_log, tt.so3_log, lambda r: (random_rotations(r, 16),)),
    "se3_exp": (jt.se3_exp, tt.se3_exp,
                lambda r: (r.normal(size=(16, 6)).astype(np.float32),)),
    "so3_hat": (jt.so3_hat, tt.so3_hat,
                lambda r: (r.normal(size=(4, 3)).astype(np.float32),)),
    "invert_se3": (
        jt.invert_se3, tt.invert_se3,
        lambda r: (np.stack([_pose_inputs(r)[0] for _ in range(4)]),)),
    "pose_matrix": (
        lambda b, d6, dt: jt.pose_matrix(jt.PoseDelta(b, d6, dt)),
        lambda b, d6, dt: tt.pose_matrix(tt.PoseDelta(b, d6, dt)),
        _pose_inputs),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_transform_matches_jax(name):
    jf, tf, make = PARITY[name]
    args = make(np.random.default_rng(3))
    a = np.asarray(jf(*[jnp.asarray(x) for x in args]))
    b = tf(*[T(x) for x in args]).numpy()
    np.testing.assert_allclose(b, a, atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------- map buffer


def test_map_carry_across_roundtrip():
    rng = np.random.default_rng(1)
    jm = j_empty_map(16)
    d = {k: np.asarray(v) for k, v in jm._asdict().items()}
    d["means"] = rng.normal(size=(16, 3)).astype(np.float32)
    d["ages"] = np.arange(16, dtype=np.int32)
    d["alive"] = rng.random(16) > 0.5
    gm = gaussian_map_from_numpy(d, device=CPU)
    assert gm.capacity == 16
    back = gaussian_map_to_numpy(gm)
    assert set(back) == set(d)
    for k, v in d.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the port's empty map equals the JAX one field by field
    for k, v in gaussian_map_to_numpy(empty_map(16, device=CPU)).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jm, k)), err_msg=k)


# ---------------------------------------------------------------- projection


def _projection_loss_terms(means2d, depths, conics, valid, w):
    return (0.01 * means2d[:, 0] + 0.02 * means2d[:, 1] + conics[:, 0]
            - 0.5 * conics[:, 1] + 2.0 * conics[:, 2] + 0.1 * depths) * w * valid


def test_project_gaussians_matches_jax():
    params, vm, K, w, h = scene_np(4, n=200, behind_fraction=0.1)
    vm = vm.copy()
    vm[:3, :3] = sst.Rotation.from_rotvec([0.03, -0.05, 0.02]).as_matrix()
    vm[:3, 3] = [0.05, -0.02, 0.1]
    scales = np.exp(params["log_scales"])
    weight = np.random.default_rng(5).random(200).astype(np.float32)

    def j_loss(v):
        o = j_project(jnp.asarray(params["means"]), jnp.asarray(params["quats"]),
                      jnp.asarray(scales), v, jnp.asarray(K), w, h)
        return jnp.sum(_projection_loss_terms(o.means2d, o.depths, o.conics,
                                              o.valid, weight)), o

    (jl, jo), jg = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(vm))

    v = T(vm).requires_grad_(True)
    to = project_gaussians(T(params["means"]), T(params["quats"]), T(scales), v,
                           T(K), w, h)
    tl = torch.sum(_projection_loss_terms(to.means2d, to.depths, to.conics,
                                          to.valid, T(weight)))
    (tg,) = torch.autograd.grad(tl, v)

    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_array_equal(to.radii.numpy(), np.asarray(jo.radii))
    np.testing.assert_allclose(to.means2d.detach().numpy(), np.asarray(jo.means2d),
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(to.depths.detach().numpy(), np.asarray(jo.depths),
                               atol=1e-6)
    np.testing.assert_allclose(to.conics.detach().numpy(), np.asarray(jo.conics),
                               atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-3, rtol=1e-4)


# ---------------------------------------------------------------- binning


@pytest.mark.parametrize("case", ["roomy", "pair_overflow", "three_cameras"])
def test_compute_bins_tile_lists_equal(case, monkeypatch):
    # make_scene draws continuous depths: no two splats share one, so the
    # (tile, depth) order has no ties and the lists must match exactly
    params, vm, K, w, h = scene_np(6, n=150, width=96, height=64)
    kw = dict(tile_capacity=32)
    if case == "pair_overflow":
        kw.update(pairs_per_gaussian=1, tile_capacity=8)
    vms, Ks = vm[None], K[None]
    if case == "three_cameras":
        # two more cameras moved sideways; CPU tensors are binned camera by
        # camera through the plain bin_gaussians, and no CUDA library loads
        from gslam_tpu_torch.ops import cuda_build

        def no_build(name):
            raise AssertionError(f"CPU binning loaded the CUDA library {name}")

        monkeypatch.setattr(cuda_build, "load", no_build)
        vms = np.stack([vm, vm, vm])
        vms[1, 0, 3] += 0.05
        vms[2, 1, 3] -= 0.04
        Ks = np.stack([K] * 3)
    jb = j_compute_bins(
        *(jnp.asarray(params[k]) for k in ("means", "quats", "log_scales", "alive")),
        jnp.asarray(vms), jnp.asarray(Ks), w, h, JRenderConfig(**kw), radius_scale=1.5)
    fields = [torch.tensor(params[k]) for k in ("means", "quats", "log_scales", "alive")]
    tb = compute_bins(*fields, T(vms), T(Ks), w, h, RenderConfig(**kw), radius_scale=1.5)
    n_pairs = np.asarray(jb.n_pairs)
    if case == "pair_overflow":
        assert n_pairs[0] > 150, "the pair budget must overflow in this case"
    np.testing.assert_array_equal(tb.n_pairs.numpy(), n_pairs)
    mask = np.asarray(jb.tile_mask)
    np.testing.assert_array_equal(tb.tile_mask.numpy(), mask)
    np.testing.assert_array_equal(
        np.where(mask, tb.tile_gauss.numpy(), -1),
        np.where(mask, np.asarray(jb.tile_gauss), -1))
    if case == "three_cameras":
        from gslam_tpu_torch.ops.binning import bin_gaussians
        from gslam_tpu_torch.ops.rasterize import _bin_cameras, project_cameras

        cfg = RenderConfig(**kw)
        proj = project_cameras(fields[0], fields[1], torch.exp(fields[2]), fields[3],
                               T(vms), T(Ks), w, h, cfg)
        radii = proj.radii * 1.5
        bins = _bin_cameras(proj.means2d, radii, proj.depths, proj.valid, w, h, cfg)
        for c in range(3):
            b = bin_gaussians(proj.means2d[c], radii[c], proj.depths[c], proj.valid[c],
                              cfg.tile_size, -(-w // 16), -(-h // 16), 150 * 8,
                              cfg.tile_capacity, cfg.max_span)
            assert torch.equal(bins.tile_gauss[c], b.tile_gauss)
            assert torch.equal(bins.tile_mask[c], b.tile_mask)
            assert torch.equal(bins.n_pairs[c], b.n_pairs)


# (cameras, splats, width, height, pairs a splat, tile capacity, max_span,
#  mean radius in pixels, depth levels (0: continuous))
TORCH_OPS_CASES = {
    "roomy": (2, 300, 96, 64, 64, 256, 16, 6.0, 0),
    "budget_overflow": (3, 300, 96, 64, 1, 256, 16, 20.0, 0),
    "tiles_over_capacity": (2, 500, 96, 64, 64, 8, 16, 6.0, 0),
    "max_span_clamped": (2, 200, 100, 70, 64, 256, 3, 50.0, 0),
    "depth_ties": (2, 400, 96, 64, 16, 64, 16, 6.0, 2),
}


@pytest.mark.parametrize("case", list(TORCH_OPS_CASES))
def test_bin_cameras_torch_ops_equal_plain(case):
    """bench_binning.py's sync-free torch-ops binning (the kernels' algorithm,
    which chip_smoke.py times as their plain stages and bench_binning.py runs
    in a cell) gives the plain bin_gaussians's lists camera by camera, bit
    for bit, on culled and invalid splats, budget and tile overflow, clamped
    footprints, a ragged grid and tied depths."""
    from bench_binning import bin_cameras_torch

    from gslam_tpu_torch.ops.binning import bin_gaussians

    C, N, w, h, ppg, cap, span, radius, levels = TORCH_OPS_CASES[case]
    g = torch.Generator().manual_seed(list(TORCH_OPS_CASES).index(case))
    means = torch.rand((C, N, 2), generator=g) * torch.tensor([w + 40.0, h + 40.0]) - 20.0
    radii = torch.empty((C, N)).exponential_(1.0 / radius, generator=g)
    radii = torch.where(torch.rand((C, N), generator=g) < 0.1, 0.0, radii)
    valid = (radii > 0) & (torch.rand((C, N), generator=g) >= 0.1)
    means = torch.where((~valid & (torch.rand((C, N), generator=g) < 0.5))[..., None],
                        float("nan"), means)
    depths = (1.0 + torch.randint(0, levels, (C, N), generator=g).float() if levels
              else 0.5 + 5.0 * torch.rand((C, N), generator=g))
    args = (16, -(-w // 16), -(-h // 16), ppg * N, cap, span)
    got = bin_cameras_torch(means, radii, depths, valid, *args)
    plain = [bin_gaussians(means[c], radii[c], depths[c], valid[c], *args) for c in range(C)]
    for name, field in zip(got._fields, got):
        want = torch.stack([getattr(b, name) for b in plain])
        assert field.dtype == want.dtype and torch.equal(field, want), name
    if case == "budget_overflow":
        assert bool((got.n_pairs > ppg * N).all())
    if case == "tiles_over_capacity":
        assert bool((got.tile_counts > cap).any())
