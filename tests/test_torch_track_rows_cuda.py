"""The tracking projection's kernels (gslam_tpu_torch/csrc/track_rows.cu,
through ops/track_fused.py `tracking_rows`) against the plain versions on
the card: the rows bit for bit, the viewmat gradient against float64, two
backward calls bit for bit, and the whole fused render and its 11-vector
gradient against the plain path's. Inputs: the real rows of a 50,000-splat
map at 320x240 (T=300 x M=512) and small tile sets whose slots sit behind
`near`, beyond `far`, outside the tangent clamp, at det <= 0 and at invalid
slots (`edge_tiles`, also the CPU test's cases in tests/test_torch_track.py).

The gradient rule: per entry, |kernel - fp64| <= 2 |plain32 - fp64| + 1e-7
max|fp64|, where plain32 is float32 autograd through tracking_rows_plain and
fp64 is float64 autograd through it (the kernel's chain runs in float64
from the float32 forward's masks, so it sits much closer to fp64). No JAX
here: the card's host has none (`pytest --noconftest -m cuda
tests/test_torch_track_rows_cuda.py`).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu_torch.ops import track_fused as tf  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig  # noqa: E402
from gslam_tpu_torch.runtime import trace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# the edge_tiles cases: ordinary splats only, a third of the slots at one
# edge, or every edge at once
EDGE_CASES = ("ordinary", "behind_near", "beyond_far", "outside_clamp", "det_nonpositive",
              "invalid_slots", "all_edges")
EDGE_W, EDGE_H, EDGE_FX = 88, 56, 80.0
EDGE_CFG = RenderConfig(tile_capacity=48, far=6.0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the track_rows kernels have no CPU mode")


def edge_pose(dtype=torch.float32):
    """A viewmat a few degrees and centimetres from the identity."""
    import scipy.spatial.transform as sst

    M = np.eye(4)
    M[:3, :3] = sst.Rotation.from_rotvec([0.03, -0.02, 0.04]).as_matrix()
    M[:3, 3] = [0.05, -0.03, 0.08]
    return torch.tensor(M, dtype=dtype)


def edge_K(dtype=torch.float32):
    return torch.tensor([[EDGE_FX, 0, EDGE_W / 2 + 0.3], [0, EDGE_FX * 1.02, EDGE_H / 2 - 0.2],
                         [0, 0, 1]], dtype=dtype)


def edge_tiles(case, seed=0, T=6, M=48):
    """A TileGather of T tiles x M slots (float32, CPU) and row cotangents
    (g_xy, g_con, g_feat) drawn from N(0, 1). Ordinary slots hold splats at
    z 1.5-4.5 over the image with positive-definite covariances; in `case`
    a third of the slots (all_edges: every edge at once) sit behind near (z
    in -1..0.008), beyond EDGE_CFG.far (6-9), far outside the x/z and y/z
    clamp, on an indefinite world covariance (det <= 0), or are invalid
    (opacity 0 and slot 0's data, as the gather pads a short list)."""
    rng = np.random.default_rng(seed)
    n = T * M
    z = rng.uniform(1.5, 4.5, n)
    u, v = rng.uniform(-10, EDGE_W + 10, n), rng.uniform(-10, EDGE_H + 10, n)
    x, y = (u - EDGE_W / 2) * z / EDGE_FX, (v - EDGE_H / 2) * z / EDGE_FX
    A = rng.normal(size=(n, 3, 3)) * rng.uniform(0.01, 0.08, (n, 1, 1))
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3)
    opac = rng.uniform(0.1, 0.99, n)
    kinds = ["behind_near", "beyond_far", "outside_clamp", "det_nonpositive", "invalid_slots"]
    which = np.full(n, "", dtype=object)
    if case == "all_edges":
        which[:] = np.array(kinds + [""] * 2, dtype=object)[rng.integers(0, 7, n)]
    elif case != "ordinary":
        which[rng.random(n) < 1 / 3] = case
    sel = which == "behind_near"
    z[sel] = rng.uniform(-1.0, 0.008, sel.sum())
    sel = which == "beyond_far"
    z[sel] = rng.uniform(6.0, 9.0, sel.sum())
    sel = which == "outside_clamp"
    sgn = rng.choice([-1.0, 1.0], (n, 2))
    x = np.where(sel, sgn[:, 0] * rng.uniform(1.0, 3.0, n) * z, x)
    y = np.where(sel, sgn[:, 1] * rng.uniform(0.8, 3.0, n) * z, y)
    sel = which == "det_nonpositive"
    s = rng.uniform(0.01, 0.05, n)
    cov[sel] = np.einsum("n,ij->nij", s[sel], np.diag([1.0, -1.0, 0.2]))
    means = np.stack([x, y, z], -1)
    sel = which == "invalid_slots"
    means[sel], cov[sel], opac[sel] = means[0], cov[0], 0.0
    cov6 = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2],
                     cov[:, 2, 2]], -1)

    def rows(a):  # [n, c] -> [T, c, M]
        return torch.tensor(np.ascontiguousarray(
            a.reshape(T, M, -1).transpose(0, 2, 1)), dtype=torch.float32)

    tg = tf.TileGather(m3d=rows(means), cov6=rows(cov6), opac=rows(opac[:, None]),
                       color=rows(rng.uniform(0, 1, (n, 3))),
                       beta=rows(rng.uniform(0.01, 2.0, (n, 1))))
    g = [torch.tensor(rng.normal(size=(T, c, M)), dtype=torch.float32) for c in (2, 3, 5)]
    return tg, g


def moved(tg, device, dtype=torch.float32):
    return tf.TileGather(*(x.to(device=device, dtype=dtype) for x in tg))


def viewmat_grads(tg, viewmat, K, width, height, cfg, g):
    """(plain float32 autograd, float64 autograd) viewmat gradients of
    tracking_rows_plain under the row cotangents g = (g_xy, g_con, g_feat),
    on tg's device."""
    out = []
    for dt in (torch.float32, torch.float64):
        vm = viewmat.to(dt).detach().requires_grad_(True)
        rows = tf.tracking_rows_plain(moved(tg, tg.m3d.device, dt), vm, K.to(dt), width,
                                      height, cfg)
        loss = sum((r * c.to(dt)).sum() for r, c in zip(
            (rows[0], rows[1], rows[3]), g))
        out.append(torch.autograd.grad(loss, vm)[0])
    return out


def assert_gradient_rule(g, p32, r64, what):
    """Per entry |g - r64| <= 2 |p32 - r64| + 1e-7 max|r64|; a [4, 4]
    viewmat gradient's row 3 is zero."""
    g, p32, r64 = g.double().cpu(), p32.double().cpu(), r64.cpu()
    err, err_p = (g - r64).abs(), (p32 - r64).abs()
    limit = 2 * err_p + 1e-7 * r64.abs().max()
    assert bool((err <= limit).all()), (what, err, limit)
    if g.shape == (4, 4):
        assert torch.equal(g[3], torch.zeros(4, dtype=g.dtype)), what


# ---------------------------------------------------------------- the 50k map


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def map_tiles():
    """The gathered tiles of chip_smoke.py's 50,000-splat map at 320x240
    (BASELINE config 1, the tracking cells' kind: T=300 x M=512) at the
    identity, the viewmat a frame's step away, K and the render config."""
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import compute_bins

    cs = _chip_smoke()
    fields = cs.make_map_fields(cs.N_SPLATS, cs.N_SPLATS, np.random.default_rng(0))
    gmap = gaussian_map_from_numpy(fields, device="cuda")
    K = torch.tensor([[cs.FX, 0, cs.W / 2], [0, cs.FX, cs.H / 2], [0, 0, 1]], device="cuda")
    cfg = RenderConfig(tile_capacity=512, pairs_per_gaussian=8)
    eye = torch.eye(4, device="cuda")
    bins = compute_bins(gmap.means, gmap.quats, gmap.log_scales, gmap.alive, eye[None],
                        K[None], cs.W, cs.H, cfg, radius_scale=1.5)
    tg = tf.gather_tracking_tiles(gmap, bins)
    pose = edge_pose().cuda()
    pose[:3, 3] *= 0.1
    return tg, pose, K, cs.W, cs.H, cfg


def _cases():
    """(name, tg, viewmat, K, width, height, cfg, cotangents) on the card."""
    tg, pose, K, w, h, cfg = map_tiles()
    T, _, M = tg.m3d.shape
    assert (T, M) == (300, 512)
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = [torch.randn(T, c, M, device="cuda", generator=gen) / (w * h) for c in (2, 3, 5)]
    yield "map50k", tg, pose, K, w, h, cfg, g
    for case in EDGE_CASES:
        etg, eg = edge_tiles(case, seed=3)
        yield (case, moved(etg, "cuda"), edge_pose().cuda(), edge_K().cuda(), EDGE_W, EDGE_H,
               EDGE_CFG, [x.cuda() for x in eg])


@pytest.mark.cuda
def test_rows_bitwise_equal_plain():
    _need_card()
    before = trace.snapshot()["counters"].get("track.rows_kernel", 0)
    n = 0
    for name, tg, pose, K, w, h, cfg, _g in _cases():
        with torch.no_grad():
            got = tf.tracking_rows(tg, pose, K, w, h, cfg)
            want = tf.tracking_rows_plain(tg, pose, K, w, h, cfg)
        n += 1
        for label, a, b in zip(("xy", "con", "op", "feat"), got, want):
            assert a.shape == b.shape and a.is_contiguous(), (name, label)
            assert torch.equal(a.view(torch.int32), b.contiguous().view(torch.int32)), (
                name, label, (a - b).abs().max().item())
    assert trace.snapshot()["counters"]["track.rows_kernel"] - before == n


@pytest.mark.cuda
def test_viewmat_gradient_against_float64_and_repeatable():
    _need_card()
    for name, tg, pose, K, w, h, cfg, g in _cases():
        kern = [tf.tracking_rows_vjp_cuda(tg, pose, K, w, h, cfg, *g) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(kern[0].view(torch.int32), kern[1].view(torch.int32)), name
        p32, r64 = viewmat_grads(tg, pose, K, w, h, cfg, g)
        assert_gradient_rule(kern[0], p32, r64, name)
        # the plain VJP on the card is the same float64 chain
        plain = tf.tracking_rows_vjp_plain(tg, pose, K, w, h, cfg, *g)
        torch.testing.assert_close(kern[0], plain, rtol=1e-6, atol=1e-7 * r64.abs().max().item())
        # and autograd through the node gives the kernel's gradient
        vm = pose.detach().requires_grad_(True)
        rows = tf.tracking_rows(tg, vm, K, w, h, cfg)
        loss = sum((r * c).sum() for r, c in zip((rows[0], rows[1], rows[3]), g))
        (auto,) = torch.autograd.grad(loss, vm)
        assert torch.equal(auto, kern[0]), name


@pytest.mark.cuda
def test_render_and_x_gradient_equal_plain_path(monkeypatch):
    """render_tracking_fused through the kernels and through the plain rows
    (tracking_rows replaced by tracking_rows_plain): images bit for bit, the
    exposure gradient bit for bit, the pose gradient by the rule against
    float64 rows under the same row cotangents."""
    _need_card()
    from gslam_tpu_torch.core.transforms import PoseDelta, pose_matrix
    from gslam_tpu_torch.ops import losses

    tg, pose, K, w, h, cfg = map_tiles()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x0 = torch.cat([torch.randn(9, device="cuda", generator=gen) * 3e-3,
                    torch.tensor([0.05, -0.02], device="cuda")])
    with torch.no_grad():
        gt = tf.render_tracking_fused(tg, pose, K, w, h, cfg)[0] * 0.9 + 0.02

    def run():
        x = x0.clone().requires_grad_(True)
        vm = pose_matrix(PoseDelta(pose, x[:6], x[6:9]))
        imgs = tf.render_tracking_fused(tg, vm, K, w, h, cfg)
        loss = losses.tracking_photometric(losses.apply_exposure(imgs[0], x[9:11]), gt,
                                           imgs[2])
        return imgs, x, vm, loss

    imgs_k, x_k, _, loss_k = run()
    (gx_k,) = torch.autograd.grad(loss_k, x_k)
    cot = {}

    def plain_rows(tg_, vm, K_, w_, h_, cfg_):
        rows = tf.tracking_rows_plain(tg_, vm, K_, w_, h_, cfg_)
        for i, r in enumerate(rows):
            if r.requires_grad:
                r.register_hook(lambda g, i=i: cot.__setitem__(i, g))
        return rows

    with monkeypatch.context() as mp:
        mp.setattr(tf, "tracking_rows", plain_rows)
        imgs_p, x_p, vm_p, loss_p = run()
        (gx_p,) = torch.autograd.grad(loss_p, x_p)
    for a, b in zip(imgs_k, imgs_p):
        assert torch.equal(a, b)
    assert torch.equal(gx_k[9:], gx_p[9:])
    # float64: the same row cotangents through float64 rows and pose_matrix
    x64 = x0.double().requires_grad_(True)
    vm64 = pose_matrix(PoseDelta(pose.double(), x64[:6], x64[6:9]))
    rows64 = tf.tracking_rows_plain(moved(tg, "cuda", torch.float64), vm64, K.double(), w, h,
                                    cfg)
    loss64 = sum((rows64[i] * cot[i].double()).sum() for i in (0, 1, 3))
    (gx64,) = torch.autograd.grad(loss64, x64)
    assert_gradient_rule(gx_k[:9], gx_p[:9], gx64[:9], "x")


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take():
    _need_card()
    etg, g = edge_tiles("ordinary")
    tg = moved(etg, "cuda")
    pose, K = edge_pose().cuda(), edge_K().cuda()
    with pytest.raises(TypeError):
        tf.tracking_rows_cuda(moved(etg, "cuda", torch.float64), pose.double(), K.double(),
                              EDGE_W, EDGE_H, EDGE_CFG)
    with pytest.raises(ValueError):
        tf.tracking_rows_cuda(tg, pose.cpu(), K, EDGE_W, EDGE_H, EDGE_CFG)
    with pytest.raises(ValueError):
        tf.tracking_rows_vjp_cuda(tg, pose, K, EDGE_W, EDGE_H, EDGE_CFG,
                                  *(x.cuda()[:, :1] for x in g))
