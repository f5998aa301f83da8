"""Fused tracking render: per-tile projection + the blend kernel, with no
per-evaluation gathers or scatters.

Counterpart of gslam_tpu/ops/track_fused.py. Tracking re-renders the same
frozen map up to ~200 times per frame while only the camera pose changes,
and the tile lists are frozen per frame. So the pose-independent splat data
is gathered ONCE per frame into splat-minor [T, c, M] rows, and each
evaluation projects per (tile, slot) elementwise and blends the rows.

The projection, `tracking_rows`, is one autograd node whose only
differentiable input is the viewmat: its gradient is the 12 numbers dL/dR
and dL/dt, a reduction over [T, M]. For CUDA tensors the node runs the
kernels of csrc/track_rows.cu: rows equal to `tracking_rows_plain`'s bit
for bit in one launch, and the VJP `tracking_rows_vjp_plain` writes in
torch ops (a float64 chain, summed in a fixed order) in two. For CPU
tensors it runs `tracking_rows_plain` (the elementwise expression in torch
ops) and autograd's own graph of it, so the CPU path's rows and gradient
are the unfused path's bit for bit. The node has no forward-mode rule:
nothing calls it under `jvp` or `vmap` (Gauss-Newton renders through
`render_impl(forward_mode=True)`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gslam_tpu_torch.mapping.gaussians import GaussianMap
from gslam_tpu_torch.ops import cuda_build
from gslam_tpu_torch.ops.blend import _check, blend_tiles_rows
from gslam_tpu_torch.ops.projection import (
    _camera_point, _clamped_tangent, _cov3d_components, _ewa_conic, _rotate_cov,
)
from gslam_tpu_torch.ops.rasterize import CameraBins, RenderConfig, untile
from gslam_tpu_torch.runtime import trace

# Launches of each entry point in this process (the wrapper adds one per
# call; track_rows_bwd launches two kernels a call).
launches = {"track_rows_fwd": 0, "track_rows_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class TileGather(NamedTuple):
    """Per-frame, pose-independent gathered tile data (splat-minor rows)."""

    m3d: torch.Tensor  # [T, 3, M] world means
    cov6: torch.Tensor  # [T, 6, M] world covariance components
    opac: torch.Tensor  # [T, 1, M] sigmoid opacity, 0 at invalid slots
    color: torch.Tensor  # [T, 3, M] sigmoid colors
    beta: torch.Tensor  # [T, 1, M] clamped uncertainties


@torch.no_grad()
def gather_tracking_tiles(
    gmap: GaussianMap, bins: CameraBins, cam: int = 0
) -> TileGather:
    """Build row-layout per-tile tensors from the map + one camera's bins."""
    ids = bins.tile_gauss[cam].to(torch.int64)  # [T, M]
    mask = bins.tile_mask[cam]
    cov6 = torch.stack(_cov3d_components(gmap.quats, torch.exp(gmap.log_scales)))

    def rows(x_cn):  # [C_rows, N] -> [T, C_rows, M]
        return x_cn[:, ids].transpose(0, 1).contiguous()

    opac = torch.sigmoid(gmap.logit_opacities)
    opac = torch.where(gmap.alive, opac, 0.0)
    color = torch.sigmoid(gmap.logit_colors)
    beta = torch.clamp(torch.exp(gmap.log_uncertainties), min=0.01)
    return TileGather(
        m3d=rows(gmap.means.T),
        cov6=rows(cov6),
        opac=torch.where(mask, opac[ids], 0.0)[:, None, :],
        color=rows(color.T),
        beta=rows(beta[None, :]),
    )


def tracking_rows_plain(
    tg: TileGather,
    viewmat: torch.Tensor,  # [4, 4] (differentiable)
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: RenderConfig,
):
    """Per-(tile, slot) EWA projection at `viewmat` in torch ops: the blend's
    row inputs xy [T,2,M], con [T,3,M], op [T,1,M] and feat [T,5,M] (rgb,
    depth, beta). The CPU forward of `tracking_rows`, and what its kernel is
    held to bit for bit."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    px, py, z = _camera_point(R, t, tg.m3d[:, 0], tg.m3d[:, 1], tg.m3d[:, 2])
    in_depth = (z > cfg.near) & (z < cfg.far)
    z_safe = torch.where(in_depth, z, torch.ones_like(z))
    tx, ty = _clamped_tangent(px, py, z_safe, fx, fy, width, height)
    c_cam = _rotate_cov(R, tuple(tg.cov6[:, i] for i in range(6)))
    inv_z = 1.0 / z_safe
    a, b, cc, det = _ewa_conic(c_cam, tx, ty, inv_z, fx, fy, cfg.eps2d)
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))

    xy_rows = torch.stack([fx * px * inv_z + cx, fy * py * inv_z + cy], dim=1)
    con_rows = torch.stack([cc / det_safe, -b / det_safe, a / det_safe], dim=1)
    op_rows = torch.where(in_depth & det_ok, tg.opac[:, 0], 0.0)[:, None, :]
    feat_rows = torch.cat([tg.color, z[:, None, :], tg.beta], dim=1)
    return xy_rows, con_rows, op_rows, feat_rows


def _forward_masks(tg, viewmat, K, width, height, cfg):
    """The masks tracking_rows_plain's gradient passes through, in its
    precision: in_depth (near < z < far), in_x, in_y (x/z and y/z within
    the clamp's closed interval, where torch.clamp passes the gradient) and
    det_ok (det > 0 of the EWA conic)."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    fx, fy = K[0, 0], K[1, 1]
    px, py, z = _camera_point(R, t, tg.m3d[:, 0], tg.m3d[:, 1], tg.m3d[:, 2])
    in_depth = (z > cfg.near) & (z < cfg.far)
    z_safe = torch.where(in_depth, z, torch.ones_like(z))
    rx, ry = px / z_safe, py / z_safe
    lim_x = 1.3 * 0.5 * width / fx
    lim_y = 1.3 * 0.5 * height / fy
    in_x = (rx >= -lim_x) & (rx <= lim_x)
    in_y = (ry >= -lim_y) & (ry <= lim_y)
    tx, ty = _clamped_tangent(px, py, z_safe, fx, fy, width, height)
    c_cam = _rotate_cov(R, tuple(tg.cov6[:, i] for i in range(6)))
    det = _ewa_conic(c_cam, tx, ty, 1.0 / z_safe, fx, fy, cfg.eps2d)[3]
    return in_depth, in_x, in_y, det > 0.0


def tracking_rows_vjp_plain(tg, viewmat, K, width, height, cfg, g_xy, g_con, g_feat):
    """The [4, 4] viewmat gradient of tracking_rows_plain under the row
    cotangents g_xy [T,2,M], g_con [T,3,M] and g_feat [T,5,M] (op and feat's
    rgb and beta channels do not depend on the pose), in torch ops: the
    chain `tracking_rows`'s backward kernel computes, and what the tests and
    chip_smoke.py hold the kernel to.

    The masks are the forward's own (`_forward_masks`); the chain runs in
    float64 from the inputs, through the conic, the Jacobian, the camera
    covariance R Sigma R^T and the camera point, and its sum over every
    (tile, slot) is cast to viewmat's dtype. Row 3 is zero."""
    in_depth, in_x, in_y, det_ok = _forward_masks(tg, viewmat, K, width, height, cfg)
    f64 = torch.float64
    R = viewmat[:3, :3].to(f64)
    t = viewmat[:3, 3].to(f64)
    fx, fy = K[0, 0].to(f64), K[1, 1].to(f64)
    m = [tg.m3d[:, i].to(f64) for i in range(3)]
    w00, w01, w02, w11, w12, w22 = (tg.cov6[:, i].to(f64) for i in range(6))
    Sg = ((w00, w01, w02), (w01, w11, w12), (w02, w12, w22))
    gu, gv = g_xy[:, 0].to(f64), g_xy[:, 1].to(f64)
    gc0, gc1, gc2 = (g_con[:, i].to(f64) for i in range(3))
    gz = g_feat[:, 3].to(f64)

    px, py, z = (R[i, 0] * m[0] + R[i, 1] * m[1] + R[i, 2] * m[2] + t[i] for i in range(3))
    zs = torch.where(in_depth, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz
    rx, ry = px / zs, py / zs
    lx, ly = 1.3 * 0.5 * width / fx, 1.3 * 0.5 * height / fy
    rcx = torch.where(in_x, rx, torch.clamp(rx, -lx, lx))
    rcy = torch.where(in_y, ry, torch.clamp(ry, -ly, ly))
    tx, ty = zs * rcx, zs * rcy
    # S = R Sigma; the camera covariance is S R^T
    S = [[R[i, 0] * Sg[0][l] + R[i, 1] * Sg[1][l] + R[i, 2] * Sg[2][l] for l in range(3)]
         for i in range(3)]

    def cdot(i, j):
        return S[i][0] * R[j, 0] + S[i][1] * R[j, 1] + S[i][2] * R[j, 2]

    c00, c01, c02, c11, c12, c22 = (cdot(0, 0), cdot(0, 1), cdot(0, 2), cdot(1, 1),
                                    cdot(1, 2), cdot(2, 2))
    j00, j11 = fx * iz, fy * iz
    j02, j12 = -fx * tx * iz2, -fy * ty * iz2
    u0, u1 = j00 * c00 + j02 * c02, j00 * c02 + j02 * c22
    v0, v1 = j11 * c01 + j12 * c02, j11 * c12 + j12 * c22
    w0 = j11 * c11 + j12 * c12
    a = j00 * u0 + j02 * u1 + cfg.eps2d
    b = j00 * v0 + j02 * v1
    cc = j11 * w0 + j12 * v1 + cfg.eps2d
    ds = torch.where(det_ok, a * cc - b * b, 1.0)
    # con = (cc, -b, a) / det_safe
    g_det = torch.where(det_ok, -(gc0 * cc - gc1 * b + gc2 * a) / (ds * ds), 0.0)
    g_a = gc2 / ds + g_det * cc
    g_cc = gc0 / ds + g_det * a
    g_b = -gc1 / ds - 2.0 * g_det * b
    # the Jacobian [[j00, 0, j02], [0, j11, j12]] and the camera covariance
    g_j00 = 2.0 * g_a * u0 + g_b * v0
    g_j02 = 2.0 * g_a * u1 + g_b * v1
    g_j11 = 2.0 * g_cc * w0 + g_b * (j00 * c01 + j02 * c12)
    g_j12 = 2.0 * g_cc * v1 + g_b * u1
    # dL/dC as a symmetric matrix (off-diagonal entries halved): dL/dR = 2 G S
    G01 = 0.5 * g_b * j00 * j11
    G02 = g_a * j00 * j02 + 0.5 * g_b * j00 * j12
    G12 = 0.5 * g_b * j02 * j11 + g_cc * j11 * j12
    G = ((g_a * j00 * j00, G01, G02), (G01, g_cc * j11 * j11, G12),
         (G02, G12, g_a * j02 * j02 + g_b * j02 * j12 + g_cc * j12 * j12))
    # through 1/z, the clamp and the camera point
    g_iz2 = -(g_j02 * fx * tx + g_j12 * fy * ty)
    g_tx, g_ty = -g_j02 * fx * iz2, -g_j12 * fy * iz2
    g_iz = g_j00 * fx + g_j11 * fy + 2.0 * iz * g_iz2 + gu * fx * px + gv * fy * py
    g_rx = torch.where(in_x, g_tx * zs, 0.0)
    g_ry = torch.where(in_y, g_ty * zs, 0.0)
    g_px = gu * fx * iz + g_rx / zs
    g_py = gv * fy * iz + g_ry / zs
    g_zs = g_tx * rcx + g_ty * rcy - g_iz * iz * iz - (g_rx * rx + g_ry * ry) / zs
    g_z = torch.where(in_depth, g_zs, 0.0) + gz
    gp = (g_px, g_py, g_z)
    terms = [2.0 * (G[i][0] * S[0][l] + G[i][1] * S[1][l] + G[i][2] * S[2][l]) + gp[i] * m[l]
             for i in range(3) for l in range(3)] + list(gp)
    sums = torch.stack(terms).sum(dim=(1, 2))
    g = torch.zeros((4, 4), dtype=f64, device=sums.device)
    g[:3, :3] = sums[:9].reshape(3, 3)
    g[:3, 3] = sums[9:]
    return g.to(viewmat.dtype)


# ---------------------------------------------------------------- CUDA kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "track_rows_fwd": [_P] * 11 + [_I] * 2 + [_F] * 5 + [_P],
    "track_rows_bwd": [_P] * 9 + [_I] * 2 + [_F] * 5 + [_P],
    "track_rows_bwd_scratch": [_I, _I, ctypes.POINTER(ctypes.c_longlong)],
}


def _kernel(fn_name: str):
    return cuda_build.function("track_rows", fn_name, _SIGNATURES[fn_name])


def _scalars(width, height, cfg):
    """The kernels' float arguments: near, far, the clamp limits'
    numerators 1.3 * 0.5 * width and height, eps2d (ctypes rounds each to
    float32, as torch casts a Python scalar)."""
    return (cfg.near, cfg.far, 1.3 * 0.5 * width, 1.3 * 0.5 * height, cfg.eps2d)


def _check_inputs(tg, viewmat, K):
    """Checks the kernels' inputs; returns (T, M, viewmat, K) with viewmat
    and K contiguous."""
    dev = tg.m3d.device
    if dev.type != "cuda":
        raise ValueError(f"the track_rows kernels take CUDA tensors, got {dev}")
    if tg.m3d.dim() != 3:
        raise ValueError(f"m3d must be [T, 3, M], got {tuple(tg.m3d.shape)}")
    T, _, M = tg.m3d.shape
    f32 = torch.float32
    viewmat, K = viewmat.contiguous(), K.contiguous()
    _check("viewmat", viewmat, (4, 4), f32, dev)
    _check("K", K, (3, 3), f32, dev)
    _check("m3d", tg.m3d, (T, 3, M), f32, dev)
    _check("cov6", tg.cov6, (T, 6, M), f32, dev)
    return T, M, viewmat, K


def tracking_rows_cuda(tg, viewmat, K, width, height, cfg):
    """Launch track_rows_fwd: tracking_rows_plain's rows, bit for bit."""
    T, M, viewmat, K = _check_inputs(tg, viewmat, K)
    dev = tg.m3d.device
    for name, x, c in (("opac", tg.opac, 1), ("color", tg.color, 3), ("beta", tg.beta, 1)):
        _check(name, x, (T, c, M), torch.float32, dev)
    kw = dict(dtype=torch.float32, device=dev)
    xy, con = torch.empty((T, 2, M), **kw), torch.empty((T, 3, M), **kw)
    op, feat = torch.empty((T, 1, M), **kw), torch.empty((T, 5, M), **kw)
    if T * M == 0:
        return xy, con, op, feat
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("track_rows_fwd")(
            viewmat.data_ptr(), K.data_ptr(), *(x.data_ptr() for x in tg),
            xy.data_ptr(), con.data_ptr(), op.data_ptr(), feat.data_ptr(), T, M,
            *_scalars(width, height, cfg), stream)
    cuda_build.check(err, "track_rows_fwd")
    launches["track_rows_fwd"] += 1
    trace.count("track.rows_kernel")
    return xy, con, op, feat


def tracking_rows_vjp_cuda(tg, viewmat, K, width, height, cfg, g_xy, g_con, g_feat):
    """Launch track_rows_bwd: the [4, 4] viewmat gradient, float32."""
    T, M, viewmat, K = _check_inputs(tg, viewmat, K)
    dev = tg.m3d.device
    for name, x, c in (("g_xy", g_xy, 2), ("g_con", g_con, 3), ("g_feat", g_feat, 5)):
        _check(name, x, (T, c, M), torch.float32, dev)
    if T * M == 0:
        return torch.zeros((4, 4), dtype=torch.float32, device=dev)
    n = ctypes.c_longlong()
    cuda_build.check(_kernel("track_rows_bwd_scratch")(T, M, ctypes.byref(n)),
                     "track_rows_bwd_scratch")
    scratch = torch.empty(n.value, dtype=torch.float64, device=dev)
    g = torch.empty((4, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("track_rows_bwd")(
            viewmat.data_ptr(), K.data_ptr(), tg.m3d.data_ptr(), tg.cov6.data_ptr(),
            g_xy.data_ptr(), g_con.data_ptr(), g_feat.data_ptr(), scratch.data_ptr(),
            g.data_ptr(), T, M, *_scalars(width, height, cfg), stream)
    cuda_build.check(err, "track_rows_bwd")
    launches["track_rows_bwd"] += 1
    return g


# ---------------------------------------------------------------- dispatch


def _route(x: torch.Tensor, plain, kernel):
    """The plain version serves CPU tensors only; CUDA gets the kernel."""
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return kernel
    raise ValueError(f"tracking_rows: unsupported device {x.device}")


def _forward_plain(ctx, tg, viewmat, K, width, height, cfg):
    """The CPU forward. Where the viewmat needs a gradient it keeps
    autograd's graph of tracking_rows_plain for the backward, so the CPU
    gradient is the unfused path's, bit for bit."""
    if not ctx.needs_input_grad[0]:
        return tracking_rows_plain(tg, viewmat, K, width, height, cfg)
    vm = viewmat.detach().requires_grad_(True)
    with torch.enable_grad():
        rows = tracking_rows_plain(tg, vm, K, width, height, cfg)
    ctx.graph = (vm, rows)
    return tuple(r.detach() for r in rows)


def _forward_cuda(ctx, tg, viewmat, K, width, height, cfg):
    rows = tracking_rows_cuda(tg, viewmat, K, width, height, cfg)
    ctx.save_for_backward(viewmat, K, tg.m3d, tg.cov6)
    return rows


class _TrackRowsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, viewmat, K, m3d, cov6, opac, color, beta, width, height, cfg):
        tg = TileGather(*(x.contiguous() for x in (m3d, cov6, opac, color, beta)))
        fwd = _route(m3d, _forward_plain, _forward_cuda)
        xy, con, op, feat = fwd(ctx, tg, viewmat, K, width, height, cfg)
        ctx.cfg = (width, height, cfg)
        ctx.mark_non_differentiable(op)
        ctx.set_materialize_grads(False)
        return xy, con, op, feat

    @staticmethod
    def backward(ctx, g_xy, g_con, _g_op, g_feat):
        if hasattr(ctx, "graph"):  # CPU: autograd through the plain rows
            vm, (xy, con, _op, feat) = ctx.graph
            pairs = [(r, g) for r, g in ((xy, g_xy), (con, g_con), (feat, g_feat))
                     if g is not None]
            (g,) = torch.autograd.grad([r for r, _ in pairs], vm, [g for _, g in pairs])
        else:
            viewmat, K, m3d, cov6 = ctx.saved_tensors
            T, _, M = m3d.shape
            g_xy, g_con, g_feat = (m3d.new_zeros((T, c, M)) if g is None else g.contiguous()
                                   for c, g in ((2, g_xy), (3, g_con), (5, g_feat)))
            g = tracking_rows_vjp_cuda(TileGather(m3d, cov6, None, None, None), viewmat, K,
                                       *ctx.cfg, g_xy, g_con, g_feat)
        return (g,) + (None,) * 9


def tracking_rows(
    tg: TileGather,
    viewmat: torch.Tensor,  # [4, 4] (differentiable)
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: RenderConfig,
):
    """Per-(tile, slot) EWA projection at `viewmat`: the blend's row inputs
    xy [T,2,M], con [T,3,M], op [T,1,M] and feat [T,5,M] (rgb, depth, beta),
    as tracking_rows_plain computes them. One autograd node, differentiable
    in `viewmat` alone (op is not differentiable); CPU tensors take the
    plain rows and autograd through them, CUDA tensors the kernels (each
    forward there counts one `track.rows_kernel`). No forward-mode rule: not
    for `jvp` or `vmap`."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (K, *tg)):
        raise ValueError("tracking_rows differentiates the viewmat alone: K and the "
                         "gathered tiles must not require grad")
    return _TrackRowsFn.apply(viewmat, K, *tg, width, height, cfg)


def render_tracking_fused(
    tg: TileGather,
    viewmat: torch.Tensor,  # [4, 4] (differentiable)
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: RenderConfig,
):
    """Differentiable render of the pre-gathered tiles at `viewmat`.

    Returns (rgb [H,W,3], depth [H,W], beta [H,W], alpha [H,W]).
    """
    ts = cfg.tile_size
    tiles_x = -(-width // ts)
    tiles_y = -(-height // ts)
    out, t_final, _touched = blend_tiles_rows(
        *tracking_rows(tg, viewmat, K, width, height, cfg), ts, tiles_x,
        (cfg.alpha_cut, cfg.alpha_clamp, cfg.visibility_min_T),
    )
    # background: black rgb, zero depth, beta_background in the beta channel
    beta = out[..., 4] + t_final * cfg.beta_background

    def img(x):
        return untile(x[None], tiles_x, tiles_y, ts, width, height)[0]

    return img(out[..., :3]), img(out[..., 3]), img(beta), img(1.0 - t_final)
