"""The binning kernels (gslam_tpu_torch/csrc/binning.cu, through
ops/binning.py `bin_cameras`) against the plain version, `bin_gaussians`
camera by camera, on the card: tile lists, masks, counts, wanted pairs and
the four pair counters equal, bit for bit, on roomy, overflowing, saturated,
clamped, ragged, culled and tied inputs, at 1 to 10 cameras and at the
mapping window's 2^20 slots at 640x480. A call holds no host sync, and
allocates a small multiple of its pair buffers. No JAX here: the card's
host has none (`pytest --noconftest -m cuda tests/test_torch_binning_cuda.py`).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gslam_tpu_torch.ops import binning  # noqa: E402
from gslam_tpu_torch.ops.binning import bin_cameras, bin_gaussians  # noqa: E402
from gslam_tpu_torch.runtime import trace  # noqa: E402

TS = 16
COUNTERS = ("pairs.wanted", "pairs.over_budget", "pairs.over_capacity", "tiles.over_capacity")

# name: (cameras, splats, width, height, pairs a splat, tile capacity, max_span,
#        inputs: mean radius in pixels, share invalid, depth levels (0: continuous))
CASES = {
    "roomy": (2, 400, 96, 64, 64, 256, 16, dict()),
    "budget_overflow": (2, 400, 96, 64, 1, 256, 16, dict(radius=24.0)),
    "tiles_over_capacity": (2, 600, 96, 64, 64, 8, 16, dict()),
    "sentinel_tail": (3, 300, 96, 64, 16, 64, 16, dict(radius=3.0)),
    "max_span_at_borders": (2, 300, 160, 128, 64, 256, 4, dict(radius=60.0, border=True)),
    "ragged_grid": (2, 300, 100, 70, 16, 64, 16, dict()),
    "culled_and_invalid": (2, 300, 96, 64, 16, 64, 16, dict(invalid=0.5)),
    "one_depth": (2, 500, 96, 64, 16, 512, 16, dict(depth_levels=1)),
    "one_camera": (1, 2000, 320, 240, 8, 64, 16, dict()),
    "ten_cameras": (10, 2000, 320, 240, 8, 64, 16, dict(depth_levels=7)),
    "vga_2p20": (10, 2**20, 640, 480, 4, 256, 16, dict(radius=12.0)),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the binning kernels have no CPU mode")


def make_inputs(seed, C, N, width, height, radius=10.0, invalid=0.1, depth_levels=0,
                border=False):
    """[C, N] projected splats on the card: means over the image and a margin
    (or, with border, within 2 px of its edges), exponential radii with 10%
    culled to 0, a share invalid (some with NaN means, as projection leaves
    splats behind the camera), depths continuous or from a few levels."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((C, N, 2), generator=g)
    size = torch.tensor([width, height], dtype=torch.float32)
    if border:
        side = torch.rand((C, N, 2), generator=g) < 0.5
        means = torch.where(side, u * 2.0, size - u * 2.0)
    else:
        means = u * (size + 40.0) - 20.0
    radii = torch.empty((C, N)).exponential_(1.0 / radius, generator=g)
    radii = torch.where(torch.rand((C, N), generator=g) < 0.1, 0.0, radii)
    valid = (radii > 0) & (torch.rand((C, N), generator=g) >= invalid)
    nan = ~valid & (torch.rand((C, N), generator=g) < 0.5)
    means = torch.where(nan[..., None], float("nan"), means)
    if depth_levels:
        depths = 1.0 + torch.randint(0, depth_levels, (C, N), generator=g).float()
    else:
        depths = 0.5 + 5.0 * torch.rand((C, N), generator=g)
    return [x.cuda() for x in (means, radii, depths, valid)]


def _args(width, height, N, ppg, capacity, max_span):
    return (TS, -(-width // TS), -(-height // TS), ppg * N, capacity, max_span)


def _counted(fn):
    """fn()'s result and the pair counters it counted under a profiler."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    torch.cuda.synchronize()
    return out, trace.snapshot()["session"]["counters"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_equal_plain_path(case):
    _need_card()
    C, N, width, height, ppg, capacity, max_span, kw = CASES[case]
    inputs = make_inputs(list(CASES).index(case), C, N, width, height, **kw)
    args = _args(width, height, N, ppg, capacity, max_span)
    got, got_counts = _counted(lambda: bin_cameras(*inputs, *args))
    plain, plain_counts = _counted(lambda: [bin_gaussians(*(x[c] for x in inputs), *args)
                                            for c in range(C)])
    for name, field in zip(got._fields, got):
        want = torch.stack([getattr(b, name) for b in plain])
        assert field.dtype == want.dtype and field.shape == want.shape, name
        assert torch.equal(field, want), name
    assert got_counts == plain_counts and set(got_counts) == set(COUNTERS)
    wanted, over_budget = got_counts["pairs.wanted"], got_counts["pairs.over_budget"]
    lists = int(got.tile_counts.sum())
    if case == "budget_overflow":
        assert over_budget > 0
    if case == "tiles_over_capacity":
        assert got_counts["tiles.over_capacity"] > 0
    if case in ("roomy", "sentinel_tail"):
        assert over_budget == 0 and lists == wanted < C * ppg * N
    if case == "vga_2p20":
        assert over_budget > 0 and got_counts["tiles.over_capacity"] > 0


@pytest.mark.cuda
def test_binning_holds_no_host_sync():
    """_bin_cameras under CUDA's sync debug mode "error" (a sync raises),
    and under a profiler, where the recorder counts none in `binning`."""
    _need_card()
    from gslam_tpu_torch.ops.rasterize import RenderConfig, _bin_cameras

    C, N, width, height = 10, 2000, 320, 240
    inputs = make_inputs(3, C, N, width, height)
    cfg = RenderConfig(tile_capacity=64, pairs_per_gaussian=8)
    want = _bin_cameras(*inputs, width, height, cfg)  # builds and loads the kernels
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    binning.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _bin_cameras(*inputs, width, height, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert set(binning.launches.values()) == {1}  # one pass of the kernels
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with profile(activities=[ProfilerActivity.CPU]):
        _bin_cameras(*inputs, width, height, cfg)
    spans = [s for s in trace.snapshot()["session"]["spans"] if s["name"] == "binning"]
    assert len(spans) == 1 and spans[0]["syncs"] == 0


@pytest.mark.cuda
def test_binning_memory_is_its_pair_buffers():
    """At the mapping window's shape the kernel path allocates at most three
    times the C * max_pairs 12-byte pairs beyond its inputs and outputs (it
    holds two buffers of pairs, the per-splat rectangles and offsets, and
    cub's scratch); the plain path's pair grid alone is 2 GiB a camera."""
    _need_card()
    C, N, width, height, ppg, capacity, max_span, kw = CASES["vga_2p20"]
    inputs = make_inputs(11, C, N, width, height, **kw)
    args = _args(width, height, N, ppg, capacity, max_span)
    bin_cameras(*inputs, *args)  # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = bin_cameras(*inputs, *args)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    outputs = sum(x.numel() * x.element_size() for x in out)
    pairs = C * ppg * N * 12
    print(f"binning allocated {extra} bytes: {extra / pairs:.3f} x the pairs "
          f"({pairs} bytes), outputs {outputs} bytes")
    assert extra <= 3 * pairs + outputs
