"""The port's blend (plain PyTorch version on the CPU) against the Pallas
blend kernels run in interpret mode, and the CUDA kernels against the
plain version on the card.

Tolerances: the forward follows tests/test_pallas_and_sharding.py (rgb
atol 1e-5; depth and beta 1e-4, since depth features are ~3 and sums of
256 products differ in their last bits), n_touched exact. The VJP is held
to atol 1e-6, rtol 1e-4 as the Pallas-vs-jnp gradient tests are, under
cotangents of a mean loss over their 64x48 image.

The kernels' per-warp splat cull is held, through its plain version
`warp_cull_plain`, to never dropping a (warp, splat) pair that passes the
alpha test at one of the warp's pixels, for the backward's 16x2 and the
forward's 8x4 warp footprints: on synthetic rows, on the gathered rows of
a small scene and on rows built to sit on its edges. On the card, the
forward is also held to float64 at every depth-segment count on ragged,
empty, dead and saturating splat lists.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu_torch.ops import blend  # noqa: E402

CFG = (1.0 / 255.0, 0.999, 0.5)
TS = 16
MEAN_PIXELS = 64 * 48


def _jax_blend():
    """JAX is imported by the parity tests only: the card's host, where the
    CUDA test runs (`pytest --noconftest -m cuda`), has no JAX."""
    jax = pytest.importorskip("jax")
    from gslam_tpu.ops.blend_pallas import blend_tiles_rows

    return jax, jax.numpy, blend_tiles_rows


def make_rows(seed, tiles_x, tiles_y, M, F=5):
    """Splat-minor rows for a tiles_x x tiles_y grid: 2D means around each
    tile, positive-definite conics of 2-10 px footprints, some empty slots."""
    rng = np.random.default_rng(seed)
    T = tiles_x * tiles_y
    t = np.arange(T)
    ox = (t % tiles_x) * TS
    oy = (t // tiles_x) * TS
    xy = np.stack([ox[:, None] + rng.uniform(-8, 24, (T, M)),
                   oy[:, None] + rng.uniform(-8, 24, (T, M))], 1)
    sx = rng.uniform(2.0, 10.0, (T, M))
    sy = rng.uniform(2.0, 10.0, (T, M))
    rho = rng.uniform(-0.6, 0.6, (T, M))
    a, b, c = sx * sx, rho * sx * sy, sy * sy
    det = a * c - b * b
    con = np.stack([c / det, -b / det, a / det], 1)
    op = rng.uniform(0.05, 0.99, (T, 1, M)) * (rng.random((T, 1, M)) > 0.1)
    feat = rng.uniform(0.0, 1.0, (T, F, M))
    feat[:, 3] = rng.uniform(1.0, 4.0, (T, M))  # depth channel
    return [x.astype(np.float32) for x in (xy, con, op, feat)]


CASES = {  # name: (tiles_x, tiles_y, M)
    "M64": (2, 2, 64),
    "M512": (2, 1, 512),
    "ragged_5x4_M64": (5, 4, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_blend_forward_matches_pallas(case):
    tiles_x, tiles_y, M = CASES[case]
    jax, jnp, j_blend = _jax_blend()
    rows = make_rows(11, tiles_x, tiles_y, M)
    jo, jtf, jtouch = j_blend(*[jnp.asarray(x) for x in rows], TS, tiles_x, CFG)
    to, ttf, ttouch = blend.blend_tiles_rows(
        *[torch.from_numpy(x) for x in rows], TS, tiles_x, CFG)
    jo = np.asarray(jo)
    np.testing.assert_allclose(to[..., :3].numpy(), jo[..., :3], atol=1e-5)
    np.testing.assert_allclose(to[..., 3:].numpy(), jo[..., 3:], atol=1e-4)
    np.testing.assert_allclose(ttf.numpy(), np.asarray(jtf), atol=1e-5)
    np.testing.assert_array_equal(ttouch.numpy(), np.asarray(jtouch))
    assert ttouch.dtype == torch.int32
    assert np.asarray(jtouch).sum() > 0 and (ttf.numpy() < 0.5).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_blend_vjp_matches_pallas(case):
    tiles_x, tiles_y, M = CASES[case]
    jax, jnp, j_blend = _jax_blend()
    rows = make_rows(12, tiles_x, tiles_y, M)
    rng = np.random.default_rng(13)
    T, P = tiles_x * tiles_y, TS * TS
    # cotangents of a mean loss over the reference tests' 64x48 image
    g_out = (rng.normal(size=(T, P, 5)) / MEAN_PIXELS).astype(np.float32)
    g_tf = (rng.normal(size=(T, P)) / MEAN_PIXELS).astype(np.float32)

    _, vjp = jax.vjp(lambda *a: j_blend(*a, TS, tiles_x, CFG)[:2],
                     *[jnp.asarray(x) for x in rows])
    jg = vjp((jnp.asarray(g_out), jnp.asarray(g_tf)))

    tin = [torch.from_numpy(x).requires_grad_(True) for x in rows]
    to, ttf, _ = blend.blend_tiles_rows(*tin, TS, tiles_x, CFG)
    tg = torch.autograd.grad((to, ttf), tin,
                             (torch.from_numpy(g_out), torch.from_numpy(g_tf)))
    for name, a, b in zip(("dxy", "dcon", "dop", "dfeat"), jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def test_blend_refuses_unknown_device():
    x = torch.zeros(1, 2, 4, device="meta")
    with pytest.raises(ValueError):
        blend.blend_tiles_rows(x, x, x, x, TS, 1, CFG)


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


def _excess(k, r, rtol=1e-4):
    """max |k - r| - rtol |r|: the kernel sums up to M log1p terms one by
    one in float32 (512 * 6e-8 = 3e-5 relative), where torch sums pairwise."""
    return ((k.double() - r.double()).abs() - rtol * r.double().abs()).max().item()


def _hold_kernels_to_plain(rows, tiles_x, segments=None):
    """Each kernel output against the plain version run in float64: beyond
    a relative 1e-4, its error must be at most twice the float32 plain
    version's own error plus 1e-6 of the output's range (n_touched: off by
    one pixel at most, on at most 0.1% of slots, where T sits on
    visibility_min_T to rounding). `segments` fixes blend_fwd's depth
    segments per tile (None: the card's rule)."""
    rows = [torch.from_numpy(x).cuda() for x in rows]
    rows64 = [x.double() for x in rows]
    T, _, M = rows[0].shape
    P = TS * TS
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = [torch.randn(T, P, 5, device="cuda", generator=gen) / MEAN_PIXELS,
         torch.randn(T, P, device="cuda", generator=gen) / MEAN_PIXELS]
    g64 = [x.double() for x in g]
    outs = [
        (blend.blend_fwd_cuda(*rows, TS, tiles_x, *CFG, segments=segments),
         blend.blend_fwd_plain(*rows, TS, tiles_x, *CFG),
         blend.blend_fwd_plain(*rows64, TS, tiles_x, *CFG)),
        (blend.blend_bwd_cuda(*rows, *g, TS, tiles_x, *CFG[:2]),
         blend.blend_bwd_plain(*rows, *g, TS, tiles_x, *CFG[:2]),
         blend.blend_bwd_plain(*rows64, *g64, TS, tiles_x, *CFG[:2])),
    ]
    torch.cuda.synchronize()
    for kern, plain, ref in outs:
        for k, p, r in zip(kern, plain, ref):
            assert k.shape == r.shape and bool(torch.isfinite(k.float()).all())
            if k.numel() == 0:  # M = 0: no slots
                continue
            if k.dtype == torch.int32:
                diff = (k - p).abs()
                assert diff.max().item() <= 1
                assert (diff > 0).float().mean().item() <= 1e-3
                continue
            bound = 2 * _err(p, r) + 1e-6 * r.abs().max().item()
            assert _excess(k, r) <= bound, (M, _excess(k, r), bound)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blend kernels have no CPU mode")


@pytest.mark.cuda
def test_blend_kernels_match_plain_on_card():
    _need_card()
    for tiles_x, tiles_y, M in [(20, 15, 512), (10, 8, 512), (5, 4, 64)]:
        _hold_kernels_to_plain(make_rows(14, tiles_x, tiles_y, M), tiles_x)


@pytest.mark.cuda
def test_blend_kernels_match_plain_on_adversarial_rows():
    """The culled backward on rows at the cull's edges. Tangent splats sit
    1e-2 off the warp rectangle here: nearer, the alpha test of the touching
    pixel is decided by float32 rounding, which differs between the kernel
    and torch (the CPU cull tests take the gap to 1e-7)."""
    _need_card()
    _hold_kernels_to_plain(adversarial_rows(16, gaps=(-1e-2, 1e-2)), 2)


def saturating_rows(seed, tiles_x=2, tiles_y=2, M=100):
    """make_rows with 16 wide, nearly opaque splats in front, centred on each
    tile: every pixel's T falls below visibility_min_T in the first chunk."""
    xy, con, op, feat = make_rows(seed, tiles_x, tiles_y, M)
    t = np.arange(tiles_x * tiles_y)
    xy[:, 0, :16] = ((t % tiles_x) * TS + 8.0)[:, None]
    xy[:, 1, :16] = ((t // tiles_x) * TS + 8.0)[:, None]
    con[:, :, :16] = np.array([1e-3, 0.0, 1e-3], np.float32)[:, None]
    op[:, 0, :16] = 0.99
    return [xy, con, op, feat]


def dead_middle_rows(seed, tiles_x=2, tiles_y=2, M=128):
    """make_rows whose slots 32-95 touch no pixel of their tile (moved far
    away, some also with op = 0): the middle depth segments hold no live
    splat."""
    xy, con, op, feat = make_rows(seed, tiles_x, tiles_y, M)
    xy[:, :, 32:96] += 1000.0
    op[:, 0, 48:64] = 0.0
    return [xy, con, op, feat]


EDGE_SHAPES = {  # name: (rows, tiles_x)
    "M33": lambda: (make_rows(3, 2, 2, 33), 2),
    "M100": lambda: (make_rows(4, 3, 1, 100), 3),
    "M20": lambda: (make_rows(5, 2, 1, 20), 2),
    "M0": lambda: (make_rows(6, 2, 1, 0), 2),
    "dead_middle_segments": lambda: (dead_middle_rows(7), 2),
    "saturating": lambda: (saturating_rows(8), 2),
    "T1": lambda: (make_rows(9, 1, 1, 200), 1),
    "T20_pyramid": lambda: (make_rows(10, 5, 4, 512), 5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EDGE_SHAPES))
def test_blend_fwd_edge_shapes_on_card(case):
    """blend_fwd at every segment count a 256-pixel tile allows (1-4) and
    at the card's own choice, on ragged, empty, dead and saturating lists."""
    _need_card()
    rows, tiles_x = EDGE_SHAPES[case]()
    for segments in (None, 1, 2, 3, 4):
        _hold_kernels_to_plain(rows, tiles_x, segments)


# ---------------------------------------------------------------- warp cull


def _conic(sx, sy, theta):
    """(a, b, c) of the inverse of the covariance R diag(sx^2, sy^2) R^T."""
    cs, sn = np.cos(theta), np.sin(theta)
    R = np.array([[cs, -sn], [sn, cs]])
    inv = np.linalg.inv(R @ np.diag([sx * sx, sy * sy]) @ R.T)
    return inv[0, 0], inv[0, 1], inv[1, 1]


TIGHT_GAPS = (-1e-3, -1e-5, -1e-7, 0.0, 1e-7, 1e-5, 1e-4, 1e-3)


def adversarial_rows(seed, gaps=TIGHT_GAPS, tiles_x=2, tiles_y=2, F=5):
    """Rows on the edges of the cull, for a tiles_x x tiles_y grid: needle
    splats (conic determinant near 0), opacities just above and below
    alpha_cut and 0, means on the rows where one warp's pixels end and the
    next one's begin, conics that are not positive definite, and splats
    whose alpha_cut ellipse touches a warp's pixel rectangle to a relative
    gap (negative: the touching pixel lies inside)."""
    rng = np.random.default_rng(seed)
    cut = float(np.float32(CFG[0]))
    n_warps = TS * TS // 32
    rows_per_warp = 32 // TS
    tiles = []
    for t in range(tiles_x * tiles_y):
        ox, oy = (t % tiles_x) * TS, (t // tiles_x) * TS
        slots = []  # (x, y, a, b, c, op), tile-local means
        for _ in range(16):  # needles: condition numbers up to ~1e7
            sy = 10 ** rng.uniform(-2.0, 0.5)
            slots.append((*rng.uniform(-8, 24, 2),
                          *_conic(rng.uniform(15, 45), sy, rng.uniform(0, np.pi)),
                          rng.uniform(0.05, 1.0)))
        for _ in range(4):  # det of the float32 conic at 0 to rounding
            a, c = rng.uniform(0.01, 1.0, 2)
            slots.append((*rng.uniform(0, 16, 2), a, np.sqrt(a * c) * (1 - 1e-7), c, 0.9))
        for e in (-1e-2, -1e-4, -1e-6, -1e-7, 0.0, 1e-7, 1e-6, 1e-4, 1e-2):
            # sigma = 0 at the pixel under the mean: alpha_raw = op there
            slots.append((*rng.integers(0, TS, 2), *_conic(1.5, 1.5, 0.0), cut * (1 + e)))
        for _ in range(4):  # op = 0 (padding) on a splat that covers the tile
            slots.append((8.0, 8.0, *_conic(20.0, 20.0, 0.0), 0.0))
        for w in range(n_warps):  # means on warp row boundaries
            y = w * rows_per_warp
            for my in (y - 0.5, y, y + rows_per_warp - 1):
                slots.append((float(rng.integers(0, TS)), my,
                              *_conic(0.7, 0.7, 0.0), rng.uniform(0.05, 1.0)))
        for abc in ((1.0, 2.0, 1.0), (-1.0, 0.0, 1.0), (1.0, 0.0, -0.5),
                    (0.5, 0.5, 0.5), (0.0, 0.0, 0.0)):  # not positive definite
            slots.append((*rng.uniform(0, 16, 2), *abc, 0.8))
        for side, s, needle in itertools.product(range(4), gaps, (False, True)):
            # tangents to a warp's rectangle; a needle's float32 sigma is
            # off by up to ~1e-7 cond(conic) relative, which the margins cover
            if needle:
                a, b, c = _conic(rng.uniform(10, 40), 10 ** rng.uniform(-1.3, 0.0),
                                 rng.uniform(0, np.pi))
            else:
                a, b, c = _conic(*rng.uniform(0.5, 6.0, 2), rng.uniform(0, np.pi))
            op = rng.uniform(0.05, 1.0)
            L = np.log(op / cut)
            Qi = np.array([[c, -b], [-b, a]]) / (a * c - b * b)
            w = rng.integers(0, n_warps)
            x0, x1 = 0, TS - 1
            y0, y1 = w * rows_per_warp, w * rows_per_warp + rows_per_warp - 1
            # pixel on the side, and the mean beyond it: the ellipse's
            # extreme point along +-x or +-y lands (1 + s) from the pixel
            axis, sign = side % 2, (1 if side < 2 else -1)
            v = np.eye(2)[axis]
            d = -sign * np.sqrt(2 * L / (v @ Qi @ v)) * (Qi @ v)  # pixel - mean
            pix = np.array([x1 if sign > 0 else x0, rng.integers(y0, y1 + 1)]
                           if axis == 0 else
                           [rng.integers(x0, x1 + 1), y1 if sign > 0 else y0], float)
            slots.append((*(pix - (1 + s) * d), a, b, c, op))
        sl = np.array(slots, np.float64)
        sl[:, 0] += ox
        sl[:, 1] += oy
        tiles.append(sl)
    sl = np.stack(tiles)  # [T, M, 6]
    T, M = sl.shape[:2]
    feat = rng.uniform(0.0, 1.0, (T, F, M))
    feat[:, 3] = rng.uniform(1.0, 4.0, (T, M))
    rows = (sl[..., 0:2].transpose(0, 2, 1), sl[..., 2:5].transpose(0, 2, 1),
            sl[..., 5:6].transpose(0, 2, 1), feat)
    return [np.ascontiguousarray(x, np.float32) for x in rows]


def scene_rows():
    """Gathered tracking rows of a 96x64, 400-splat scene (6x4 tiles, 64
    slots), made with numpy and the port alone."""
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import RenderConfig, compute_bins
    from gslam_tpu_torch.ops.track_fused import gather_tracking_tiles, tracking_rows

    rng = np.random.default_rng(17)
    w, h, n, fx = 96, 64, 400, 86.4
    z = rng.uniform(2.0, 4.0, n)
    u, v = rng.uniform(4, w - 4, n), rng.uniform(4, h - 4, n)
    fields = dict(
        means=np.stack([(u - w / 2) * z / fx, (v - h / 2) * z / fx, z], -1),
        quats=rng.normal(size=(n, 4)), log_scales=np.log(rng.uniform(0.02, 0.12, (n, 3))),
        logit_opacities=rng.uniform(-1.0, 3.0, n), logit_colors=rng.normal(size=(n, 3)),
        log_uncertainties=rng.uniform(-0.5, 0.5, n), alive=np.ones(n, bool))
    fields = {k: x.astype(bool if k == "alive" else np.float32) for k, x in fields.items()}
    gmap = gaussian_map_from_numpy(fields, device="cpu")
    K = torch.tensor([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    pose = torch.eye(4)
    cfg = RenderConfig(tile_capacity=64)
    bins = compute_bins(gmap.means, gmap.quats, gmap.log_scales, gmap.alive,
                        pose[None], K[None], w, h, cfg, radius_scale=1.5)
    with torch.no_grad():
        rows = tracking_rows(gather_tracking_tiles(gmap, bins), pose, K, w, h, cfg)
    return [x.contiguous().numpy() for x in rows], -(-w // TS)


def _rows_for(case):
    if case in CASES:
        tiles_x, tiles_y, M = CASES[case]
        return make_rows(11, tiles_x, tiles_y, M), tiles_x
    if case == "scene":
        return scene_rows()
    return adversarial_rows(15), 2


FOOTPRINTS = {"bwd_16x2": None, "fwd_8x4": blend.FWD_FOOTPRINT}


@pytest.mark.parametrize("footprint", sorted(FOOTPRINTS))
@pytest.mark.parametrize("case", sorted(CASES) + ["scene", "adversarial"])
def test_warp_cull_keeps_every_live_pair(case, footprint):
    """Every (tile, pixel, slot) that passes the alpha test, in float32 or
    in float64, has its (tile, warp, slot) kept by the cull, for the
    backward's and the forward's warp footprints."""
    rows, tiles_x = _rows_for(case)
    fp = FOOTPRINTS[footprint]
    xy, con, op = (torch.from_numpy(x) for x in rows[:3])
    keep = blend.warp_cull_plain(xy, con, op, TS, tiles_x, CFG[0], footprint=fp)
    T, _, M = xy.shape
    assert keep.shape == (T, TS * TS // 32, M) and keep.dtype == torch.bool
    n_live = 0
    for dt in (torch.float32, torch.float64):
        ok = blend._alpha(xy.to(dt), con.to(dt), op.to(dt), TS, tiles_x, *CFG[:2])[4]
        live = ok[:, blend.warp_pixels(TS, fp)].any(2)
        assert not (live & ~keep).any(), (dt, torch.nonzero(live & ~keep)[:5])
        n_live = int(live.sum())
    assert n_live > 0


@pytest.mark.parametrize("footprint", sorted(FOOTPRINTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_cull_skips_pairs(case, footprint):
    """A predicate that kept every pair would pass the test above: on the
    synthetic rows the cull must drop a share of the (warp, slot) pairs,
    among them every empty slot."""
    rows, tiles_x = _rows_for(case)
    xy, con, op = (torch.from_numpy(x) for x in rows[:3])
    keep = blend.warp_cull_plain(xy, con, op, TS, tiles_x, CFG[0],
                                 footprint=FOOTPRINTS[footprint])
    assert keep.float().mean().item() < 0.9
    assert not keep.permute(0, 2, 1)[op[:, 0] == 0].any()


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_warp_pixels_layouts(ts):
    """Both layouts give each pixel of the tile to exactly one lane; the
    backward's warps hold 32 consecutive pixels, the forward's an 8x4
    block (the kernels' fwd_pixel)."""
    for fp, (w, h) in ((None, (min(ts, 32), 32 // min(ts, 32))), (blend.FWD_FOOTPRINT, (8, 4))):
        idx = blend.warp_pixels(ts, fp)
        assert idx.shape == (ts * ts // 32, 32)
        assert torch.equal(idx.flatten().sort().values, torch.arange(ts * ts))
        col, row = idx % ts, idx // ts
        assert (col.amax(1) - col.amin(1) == w - 1).all()
        assert (row.amax(1) - row.amin(1) == h - 1).all()
        assert torch.equal(idx[:, 0], idx[:, 0].sort().values)  # warps in row-major order


def test_library_hash_covers_included_files(tmp_path):
    from gslam_tpu_torch.ops import cuda_build

    (tmp_path / "sub").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "sub/a.cuh"\nint f();\n')
    (tmp_path / "sub" / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n')
    (tmp_path / "sub" / "b.cuh").write_text('#include "a.cuh"\nint g();\n')  # a cycle
    (tmp_path / "other.cuh").write_text("int h();\n")
    digests = [cuda_build.source_digest(src)]
    for path, text in ((tmp_path / "other.cuh", "int h2();\n"),
                       (tmp_path / "sub" / "b.cuh", '#include "a.cuh"\nint g2();\n'),
                       (tmp_path / "sub" / "a.cuh", '#pragma once\n#include "b.cuh"\n'),
                       (src, '#include "sub/a.cuh"\n')):
        path.write_text(text)
        digests.append(cuda_build.source_digest(src))
    # an unrelated file leaves the hash; each included file, nested too, moves it
    assert digests[1] == digests[0]
    assert len(set(digests[1:])) == 4
