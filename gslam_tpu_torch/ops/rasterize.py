"""The generic differentiable multi-camera render and its tile binning.

Counterpart of gslam_tpu/ops/rasterize.py. `render_impl` projects the
splats into C cameras once (autograd carries gradients to every splat field
and to the viewmats), bins each camera's tiles on the detached outputs of
that same projection (or reuses given `CameraBins`), gathers splat-minor
[C*T, c, M] rows through the tile lists and blends them with the blend
kernel pair (ops/blend.py), one launch per camera. The splat gradients come
back per (tile, slot) and reach the [N] fields through the transpose of the
gather, which autograd of the indexing gives. Tracking with fused=True
renders through ops/track_fused.py instead.

`render_impl(forward_mode=True)` blends with plain torch ops instead, chunk
by chunk of tiles (`blend_tiles_forward`): the counterpart of the JAX
package's jnp blend, which its Gauss-Newton tracker pins through
`backend="xla"` because forward-mode AD cannot cross the blend kernel's
custom VJP. The kernel pair's autograd function has no forward-mode rule
either, so Gauss-Newton tracking, the only caller, takes this route on
every device; every other render keeps the kernels.

The compositing has no early termination: the reference declares a
`transmittance_cut` it never reads, so the port has no such field and
every splat of a tile's list is blended.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from gslam_tpu_torch import resolve_device, to_device
from gslam_tpu_torch.ops.binning import bin_gaussians
from gslam_tpu_torch.ops.blend import blend_fwd_plain, blend_tiles_rows
from gslam_tpu_torch.ops.projection import ProjectionOutput, project_gaussians
from gslam_tpu_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    tile_size: int = 16
    tile_capacity: int = 256  # max splats blended per tile (nearest kept)
    pairs_per_gaussian: int = 8  # pair budget = N * this
    max_span: int = 16  # max tile-footprint side per splat
    tile_chunk: int = 64  # tiles per chunk of blend_tiles_forward, its only reader
    near: float = 0.01
    far: float = 1e10
    eps2d: float = 0.3
    radius_clip: float = 0.0
    visibility_min_T: float = 0.5
    beta_background: float = math.e
    alpha_clamp: float = 0.999
    alpha_cut: float = 1.0 / 255.0


class CameraBins(NamedTuple):
    """Per-camera tile lists, reused across re-renders while the pose moves
    only a few pixels (the tracking line search)."""

    tile_gauss: torch.Tensor  # [C, T, M] int32
    tile_mask: torch.Tensor  # [C, T, M] bool
    n_pairs: torch.Tensor  # [C] int32


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # [C, H, W, 3]
    alpha: torch.Tensor  # [C, H, W]
    depth: torch.Tensor  # [C, H, W] accumulated depth
    beta: torch.Tensor  # [C, H, W] rendered uncertainty
    radii: torch.Tensor  # [C, N]
    means2d: torch.Tensor  # [C, N, 2]
    depths: torch.Tensor  # [C, N] per-splat camera depth
    n_touched: torch.Tensor  # [C, N] int32
    n_pairs: torch.Tensor  # [C] int32 binning load (monitor vs budget)


def project_cameras(means, quats, scales, alive, viewmats, Ks, width, height,
                    cfg: RenderConfig) -> ProjectionOutput:
    """project_gaussians into C cameras at once: every output gains a
    leading [C] axis. The cameras' matrices enter as [4, 4, C, 1] and
    [3, 3, C, 1], so each matrix entry the projection reads is a [C, 1]
    column that broadcasts against the [N] splat axis; the arithmetic is
    the single-camera projection's, element for element."""
    return project_gaussians(
        means, quats, scales, viewmats.permute(1, 2, 0)[..., None],
        Ks.permute(1, 2, 0)[..., None], width, height, near=cfg.near, far=cfg.far,
        eps2d=cfg.eps2d, radius_clip=cfg.radius_clip, alive=alive,
    )


@torch.no_grad()
def _bin_cameras(means2d, radii, depths, valid, width, height, cfg: RenderConfig
                 ) -> CameraBins:
    """Tile lists of each camera ([C, N] inputs), one camera at a time: the
    binning's pair grid (N by up to max_span^2) is the largest tensor of a
    render, and C of them at once would not pay for the launches they save.
    The span `binning` marks it on the profiler's timeline."""
    with trace.span("binning"):
        n = means2d.shape[1]
        ts = cfg.tile_size
        out = [bin_gaussians(means2d[c], radii[c], depths[c], valid[c], ts,
                             -(-width // ts), -(-height // ts),
                             int(cfg.pairs_per_gaussian * n), cfg.tile_capacity,
                             cfg.max_span)
               for c in range(means2d.shape[0])]
        return CameraBins(
            tile_gauss=torch.stack([b.tile_gauss for b in out]),
            tile_mask=torch.stack([b.tile_mask for b in out]),
            n_pairs=torch.stack([b.n_pairs for b in out]),
        )


@torch.no_grad()
def compute_bins(
    means: torch.Tensor,
    quats: torch.Tensor,
    log_scales: torch.Tensor,
    alive: torch.Tensor,
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    radius_scale: float = 1.0,
) -> CameraBins:
    """Tile binning only (no gradients). `radius_scale` > 1 inflates splat
    footprints so the lists stay valid as the pose shifts during a tracking
    refinement."""
    proj = project_cameras(means, quats, torch.exp(log_scales), alive, viewmats,
                           Ks, width, height, cfg)
    return _bin_cameras(proj.means2d, proj.radii * radius_scale, proj.depths,
                        proj.valid, width, height, cfg)


def untile(x: torch.Tensor, tiles_x: int, tiles_y: int, ts: int, width: int,
           height: int) -> torch.Tensor:
    """[C, T, P, ...] tile-major pixels -> [C, H, W, ...]; pixels of a ragged
    tile grid beyond the image are cropped (their gradient is zero)."""
    C, extra = x.shape[0], tuple(x.shape[3:])
    img = x.reshape((C, tiles_y, tiles_x, ts, ts) + extra).transpose(2, 3)
    return img.reshape((C, tiles_y * ts, tiles_x * ts) + extra)[:, :height, :width]


def blend_tiles_forward(xy, con, op, feat, ts: int, tiles_x: int, cfg: RenderConfig):
    """The blend in plain torch ops, `cfg.tile_chunk` tiles at a time, for
    forward-mode AD (torch.func.jvp under vmap): the counterpart of the jnp
    branch of the JAX package's `_blend_tiles`. Takes the kernels' row layout
    (xy [T, 2, M], con [T, 3, M], op [T, 1, M] with 0 at masked slots, feat
    [T, F, M]; row t is tile t of a tiles_x-wide grid) and returns the
    kernel's outputs, out [T, P, F], t_final [T, P] and n_touched [T, M]
    (int32). That branch's sum of the weights is left out: its render drops
    it for 1 - t_final. Chunking bounds the [chunk, P, M] temporaries, which
    each tangent multiplies."""
    args = (cfg.alpha_cut, cfg.alpha_clamp, cfg.visibility_min_T)
    parts = [blend_fwd_plain(*(x[s:s + cfg.tile_chunk] for x in (xy, con, op, feat)),
                             ts, tiles_x, *args, first_tile=s)
             for s in range(0, xy.shape[0], cfg.tile_chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


class RenderRows(NamedTuple):
    """The blend's inputs for C cameras, each [C*T, c, M] with camera c's
    tiles at rows c*T..(c+1)*T, and what the render keeps beside them."""

    xy: torch.Tensor  # [C*T, 2, M]
    con: torch.Tensor  # [C*T, 3, M]
    op: torch.Tensor  # [C*T, 1, M], 0 at masked slots and invalid splats
    feat: torch.Tensor  # [C*T, 5, M] rgb, depth, beta
    ids: torch.Tensor  # [C, T, M] int64 index into the [C*N] splat table
    proj: ProjectionOutput  # [C, N, ...], means2d with the probe added
    bins: CameraBins


def render_rows(means, quats, log_scales, logit_opacities, logit_colors,
                log_uncertainties, alive, viewmats, Ks, width: int, height: int,
                cfg: RenderConfig = RenderConfig(), probe2d=None,
                bins: CameraBins | None = None) -> RenderRows:
    """Projection (once per camera, with autograd), binning on its detached
    outputs unless `bins` is given, and the gather of splat-minor rows."""
    n, C = means.shape[0], viewmats.shape[0]
    opacities = torch.sigmoid(logit_opacities)
    colors = torch.sigmoid(logit_colors)
    betas = torch.clamp(torch.exp(log_uncertainties), min=0.01)
    proj = project_cameras(means, quats, torch.exp(log_scales), alive, viewmats, Ks,
                           width, height, cfg)
    if probe2d is not None:
        proj = proj._replace(means2d=proj.means2d + probe2d)
    if bins is None:
        bins = _bin_cameras(proj.means2d.detach(), proj.radii, proj.depths.detach(),
                            proj.valid, width, height, cfg)

    # Per-splat rows [C, N, 11]: xy, conic, opacity, rgb, depth, beta. Invalid
    # splats get opacity 0, so their gathered gradients are exact zeros. The
    # transpose of this gather (autograd's index backward) sums the blend's
    # per-(tile, slot) gradients into the [N] fields.
    table = torch.cat([
        proj.means2d, proj.conics, torch.where(proj.valid, opacities, 0.0)[..., None],
        colors.expand(C, n, 3), proj.depths[..., None], betas.expand(C, n)[..., None],
    ], dim=-1)
    M = bins.tile_gauss.shape[-1]
    ids = (bins.tile_gauss.to(torch.int64)
           + n * torch.arange(C, device=means.device)[:, None, None])
    g = table.reshape(C * n, 11)[ids].transpose(2, 3)  # [C, T, 11, M]

    def rows(a, b):  # channels a:b of every camera, [C*T, b-a, M], contiguous
        return g[:, :, a:b].reshape(-1, b - a, M).contiguous()

    op = torch.where(bins.tile_mask, g[:, :, 5], 0.0).reshape(-1, 1, M).contiguous()
    return RenderRows(rows(0, 2), rows(2, 5), op, rows(6, 11), ids, proj, bins)


def render_impl(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    log_scales: torch.Tensor,  # [N, 3]
    logit_opacities: torch.Tensor,  # [N]
    logit_colors: torch.Tensor,  # [N, 3]
    log_uncertainties: torch.Tensor,  # [N]
    alive: torch.Tensor,  # [N] bool
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    bg_rgb: torch.Tensor | None = None,  # [3]
    cfg: RenderConfig = RenderConfig(),
    probe2d: torch.Tensor | None = None,  # [C, N, 2] zeros; see means2d grads
    bins: CameraBins | None = None,  # reuse precomputed tile lists
    forward_mode: bool = False,  # plain-op blend for torch.func.jvp (see below)
) -> RenderOutput:
    """Render N splats into C cameras, differentiable in every splat field,
    the viewmats and `probe2d` (whose gradient is dL/dmeans2d).

    forward_mode=True blends through `blend_tiles_forward` instead of the
    kernel pair, so that torch.func.jvp and vmap can transform the render:
    the JAX package's `backend="xla"` pin, which only its Gauss-Newton
    tracker sets (tracking/track.py passes it there and nowhere else)."""
    n, C = means.shape[0], viewmats.shape[0]
    dev = means.device
    ts = cfg.tile_size
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    T = tiles_x * tiles_y
    r = render_rows(means, quats, log_scales, logit_opacities, logit_colors,
                    log_uncertainties, alive, viewmats, Ks, width, height, cfg,
                    probe2d, bins)
    # The kernels take pixel coordinates from the tile index and tiles_x, so
    # each camera is its own launch on its contiguous slice of rows. split's
    # backward concatenates the slices' gradients, with no zero-filled copy.
    cams = zip(*(x.split(T) for x in (r.xy, r.con, r.op, r.feat)))
    if forward_mode:
        parts = [blend_tiles_forward(*rows, ts, tiles_x, cfg) for rows in cams]
    else:
        parts = [blend_tiles_rows(*rows, ts, tiles_x,
                                  (cfg.alpha_cut, cfg.alpha_clamp, cfg.visibility_min_T))
                 for rows in cams]
    out, t_final, touched = (torch.cat(p) for p in zip(*parts))

    out = out.reshape(C, T, ts * ts, -1)
    t_final = t_final.reshape(C, T, ts * ts)
    if bg_rgb is None:
        bg_rgb = torch.zeros(3, device=dev)
    bg = torch.cat([bg_rgb.to(torch.float32), torch.zeros(1, device=dev),
                    torch.full((1,), cfg.beta_background, device=dev)])
    out = out + t_final[..., None] * bg

    def img(x):
        return untile(x, tiles_x, tiles_y, ts, width, height)

    # n_touched: the integer segment sum of touched * tile_mask over the ids
    counts = (touched.reshape(C, T, -1) * r.bins.tile_mask).reshape(-1)
    n_touched = torch.zeros(C * n, dtype=torch.int32, device=dev).index_add_(
        0, r.ids.reshape(-1), counts.to(torch.int32)).reshape(C, n)
    return RenderOutput(
        rgb=img(out[..., :3]), alpha=img(1.0 - t_final), depth=img(out[..., 3]),
        beta=img(out[..., 4]), radii=r.proj.radii, means2d=r.proj.means2d,
        depths=r.proj.depths, n_touched=n_touched, n_pairs=r.bins.n_pairs,
    )


def render(means, quats, log_scales, logit_opacities, logit_colors,
           log_uncertainties, alive, viewmats, Ks, width: int, height: int,
           bg_rgb=None, cfg: RenderConfig = RenderConfig(), probe2d=None,
           bins: CameraBins | None = None,
           device: str | torch.device | None = None) -> RenderOutput:
    """Public entry point: render_impl on `device` (CUDA by default).

    Array arguments may be tensors or numpy arrays; they are moved to the
    device (float32, `alive` bool)."""
    dev = resolve_device(device)
    f = [to_device(x, dev) for x in (means, quats, log_scales, logit_opacities,
                                     logit_colors, log_uncertainties)]
    return render_impl(
        *f, to_device(alive, dev, torch.bool), to_device(viewmats, dev),
        to_device(Ks, dev), width, height, to_device(bg_rgb, dev), cfg,
        to_device(probe2d, dev), bins)
