"""The port's blend (plain PyTorch version on the CPU) against the Pallas
blend kernels run in interpret mode, and the CUDA kernels against the
plain version on the card.

Tolerances: the forward follows tests/test_pallas_and_sharding.py (rgb
atol 1e-5; depth and beta 1e-4, since depth features are ~3 and sums of
256 products differ in their last bits), n_touched exact. The VJP is held
to atol 1e-6, rtol 1e-4 as the Pallas-vs-jnp gradient tests are, under
cotangents of a mean loss over their 64x48 image.
"""

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


@pytest.mark.cuda
def test_blend_kernels_match_plain_on_card():
    """Each kernel output is held against the plain version run in float64:
    beyond a relative 1e-4, its error must be at most twice the float32
    plain version's own error plus 1e-6 of the output's range (n_touched:
    off by one pixel at most, on at most 0.1% of slots, where T sits on
    visibility_min_T to rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blend kernels have no CPU mode")
    for tiles_x, tiles_y, M in [(20, 15, 512), (10, 8, 512), (5, 4, 64)]:
        rows = [torch.from_numpy(x).cuda()
                for x in make_rows(14, tiles_x, tiles_y, M)]
        rows64 = [x.double() for x in rows]
        T, P = tiles_x * tiles_y, TS * TS
        gen = torch.Generator(device="cuda").manual_seed(0)
        g = [torch.randn(T, P, 5, device="cuda", generator=gen) / MEAN_PIXELS,
             torch.randn(T, P, device="cuda", generator=gen) / MEAN_PIXELS]
        g64 = [x.double() for x in g]
        outs = [
            (blend.blend_fwd_cuda(*rows, TS, tiles_x, *CFG),
             blend.blend_fwd_plain(*rows, TS, tiles_x, *CFG),
             blend.blend_fwd_plain(*rows64, TS, tiles_x, *CFG)),
            (blend.blend_bwd_cuda(*rows, *g, TS, tiles_x, *CFG[:2]),
             blend.blend_bwd_plain(*rows, *g, TS, tiles_x, *CFG[:2]),
             blend.blend_bwd_plain(*rows64, *g64, TS, tiles_x, *CFG[:2])),
        ]
        for kern, plain, ref in outs:
            for k, p, r in zip(kern, plain, ref):
                if k.dtype == torch.int32:
                    diff = (k - p).abs()
                    assert diff.max().item() <= 1
                    assert (diff > 0).float().mean().item() <= 1e-3
                    continue
                bound = 2 * _err(p, r) + 1e-6 * r.abs().max().item()
                assert _excess(k, r) <= bound, (M, _excess(k, r), bound)
