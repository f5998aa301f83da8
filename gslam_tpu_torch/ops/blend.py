"""Per-tile alpha compositing (forward + analytic VJP): CUDA kernels and
their plain PyTorch versions.

Counterpart of gslam_tpu/ops/blend_pallas.py. Per tile of P = ts*ts pixels
against its M depth-sorted splats (splat-minor rows):

  forward:  sigma -> alpha -> T = exp(exclusive prefix-sum log1p(-alpha))
            -> w = alpha T -> out = sum_m w feat;  t_final = exp(sum log1p(-alpha));
            n_touched[m] = #pixels with ok and T > visibility_min_T
  backward: dfeat = sum_p g_out w;  G = g_out . feat;  S = strict suffix of w G;
            g_alpha = T G - S/(1-alpha) - g_tf t_final/(1-alpha) on live pairs,
            chained to opacity, conic and 2D-mean cotangents per (tile, slot).

The kernels live in gslam_tpu_torch/csrc/blend.cu. `blend_fwd_plain` and
`blend_bwd_plain` write the same math with torch.cumsum over [T, P, M];
`warp_cull_plain` is the kernels' per-warp splat cull.
The autograd function takes the plain versions for CPU tensors only; a
CUDA tensor gets the kernel or an error.
"""

from __future__ import annotations

import ctypes

import torch

from gslam_tpu_torch.ops import cuda_build

F_KERNEL = 5  # blend features the kernels take: rgb, depth, beta

# Launches of each kernel in this process (the wrappers add one per launch).
launches = {"blend_fwd": 0, "blend_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------- plain torch


def _pixel_grid(T: int, ts: int, tiles_x: int, device, first_tile: int = 0) -> tuple:
    """Pixel coordinates [T, P, 1] of the ts*ts pixels of tiles
    first_tile .. first_tile + T - 1."""
    t = torch.arange(first_tile, first_tile + T, device=device)
    k = torch.arange(ts * ts, device=device)
    px = ((t % tiles_x) * ts)[:, None] + (k % ts)[None, :]
    py = ((t // tiles_x) * ts)[:, None] + (k // ts)[None, :]
    return px.to(torch.float32)[..., None], py.to(torch.float32)[..., None]


def _alpha(xy, con, op, ts, tiles_x, alpha_cut, alpha_clamp, first_tile=0):
    """[T, P, M] effective alpha and what its gradient needs; row t is tile
    first_tile + t."""
    px, py = _pixel_grid(xy.shape[0], ts, tiles_x, xy.device, first_tile)
    dx = px - xy[:, 0:1, :]
    dy = py - xy[:, 1:2, :]
    ca, cb, cc = con[:, 0:1, :], con[:, 1:2, :], con[:, 2:3, :]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha_raw = op * torch.exp(-sigma)
    ok = (sigma >= 0.0) & (alpha_raw >= alpha_cut)
    alpha = torch.where(ok, torch.clamp(alpha_raw, max=alpha_clamp), 0.0)
    return alpha, alpha_raw, dx, dy, ok, (ca, cb, cc)


def _transmittance(alpha):
    log1m = torch.log1p(-alpha)
    T = torch.exp(torch.cumsum(log1m, dim=-1) - log1m)  # exclusive
    t_final = torch.exp(torch.sum(log1m, dim=-1))  # [T, P]
    return T, t_final


def blend_fwd_plain(xy, con, op, feat, ts, tiles_x, alpha_cut, alpha_clamp, min_t,
                    first_tile=0):
    """Plain forward: out [T,P,F], t_final [T,P], n_touched [T,M] int32;
    row t is tile first_tile + t."""
    alpha, _, _, _, ok, _ = _alpha(xy, con, op, ts, tiles_x, alpha_cut, alpha_clamp,
                                   first_tile)
    T, t_final = _transmittance(alpha)
    w = alpha * T
    out = torch.einsum("tpm,tfm->tpf", w, feat)
    touched = torch.sum(ok & (T > min_t), dim=1, dtype=torch.int32)
    return out, t_final, touched


def blend_bwd_plain(xy, con, op, feat, g_out, g_tf, ts, tiles_x, alpha_cut,
                    alpha_clamp):
    """Plain backward: dxy [T,2,M], dcon [T,3,M], dop [T,1,M], dfeat [T,F,M]."""
    alpha, alpha_raw, dx, dy, ok, (ca, cb, cc) = _alpha(
        xy, con, op, ts, tiles_x, alpha_cut, alpha_clamp)
    T, t_final = _transmittance(alpha)
    w = alpha * T
    dfeat = torch.einsum("tpf,tpm->tfm", g_out, w)
    G = torch.einsum("tpf,tfm->tpm", g_out, feat)
    wG = w * G
    S = torch.sum(wG, dim=-1, keepdim=True) - torch.cumsum(wG, dim=-1)
    one_m = 1.0 - alpha
    g_alpha = T * G - S / one_m - (g_tf * t_final)[..., None] / one_m
    g_alpha = torch.where(ok & (alpha_raw < alpha_clamp), g_alpha, 0.0)
    g_sigma = -alpha * g_alpha
    dop = torch.sum(g_alpha * alpha, dim=1, keepdim=True) / torch.clamp(op, min=1e-12)
    dcon = torch.cat([
        torch.sum(0.5 * dx * dx * g_sigma, dim=1, keepdim=True),
        torch.sum(dx * dy * g_sigma, dim=1, keepdim=True),
        torch.sum(0.5 * dy * dy * g_sigma, dim=1, keepdim=True),
    ], dim=1)
    # sigma depends on d = pix - xy: dsigma/dxy = -(ca dx + cb dy, cb dx + cc dy)
    dxy = torch.cat([
        torch.sum(-(ca * dx + cb * dy) * g_sigma, dim=1, keepdim=True),
        torch.sum(-(cb * dx + cc * dy) * g_sigma, dim=1, keepdim=True),
    ], dim=1)
    return dxy, dcon, dop, dfeat


CULL_GAMMA = 32.0 / 2.0**24  # float32 rounding of sigma, per unit of cond(conic)
FWD_FOOTPRINT = (8, 4)  # blend_fwd's warps cover 8x4 pixel blocks (csrc/blend.cu fwd_pixel)


def warp_pixels(ts, footprint=None, device=None):
    """long [P // 32, 32]: the row-major tile pixels of each warp's lanes.
    footprint None is blend_bwd's layout, 32 consecutive pixels (16x2 rows
    at ts=16); (fw, fh) is blocks of fw x fh pixels in row-major order, as
    blend_fwd's FWD_FOOTPRINT."""
    P = ts * ts
    k = torch.arange(P, device=device)
    if footprint is None:
        return k.reshape(P // 32, 32)
    fw, fh = footprint
    w, lane = k // 32, k % 32
    bx, by = w % (ts // fw), w // (ts // fw)
    return ((by * fh + lane // fw) * ts + bx * fw + lane % fw).reshape(P // 32, 32)


def warp_cull_plain(xy, con, op, ts, tiles_x, alpha_cut, footprint=None):
    """bool [T, P // 32, M]: whether warp w of tile t (pixels
    warp_pixels(ts, footprint)[w]) must visit splat m. The kernels' per-warp
    cull (csrc/blend.cu cull_keep), in torch: False only where the alpha test
    provably fails at every pixel of the warp's pixel rectangle, with the
    kernel's margins against float32 rounding. footprint None is blend_bwd's
    warps, FWD_FOOTPRINT blend_fwd's. Used by the tests and chip_smoke.py,
    not by the blend."""
    T, _, M = xy.shape
    P = ts * ts
    if not 0.0 < alpha_cut <= torch.finfo(torch.float32).max:
        return torch.ones((T, P // 32, M), dtype=torch.bool, device=xy.device)
    px, py = _pixel_grid(T, ts, tiles_x, xy.device)
    idx = warp_pixels(ts, footprint, xy.device)
    px, py = px[:, idx, 0], py[:, idx, 0]  # [T, W, 32]
    x0, x1 = px.amin(-1, keepdim=True), px.amax(-1, keepdim=True)  # [T, W, 1]
    y0, y1 = py.amin(-1, keepdim=True), py.amax(-1, keepdim=True)
    f32 = dict(dtype=torch.float32, device=xy.device)
    xy, con, op = xy.float(), con.float(), op.float()
    L = torch.log(op) - torch.log(torch.tensor(alpha_cut, **f32))  # [T, 1, M]
    Lm = L + 2e-5 + 1e-6 * L.abs()
    live = Lm >= 0.0  # False for op = 0 (-inf) and NaN
    a, b, c = con[:, 0:1], con[:, 1:2], con[:, 2:3]
    det = a * c - b * b
    q = CULL_GAMMA * ((a + c) * (a + c) / det)
    bounded = (a > 0) & (c > 0) & (det > 0) & (q <= 0.25)  # else keep
    Le = Lm / (1.0 - q)
    det_lo = det * (1.0 - q)
    ex = torch.sqrt(2.0 * Le * c / det_lo) * (1.0 + 1e-5)
    ey = torch.sqrt(2.0 * Le * a / det_lo) * (1.0 + 1e-5)
    mx, my = xy[:, 0:1], xy[:, 1:2]
    zero = torch.zeros((), **f32)
    gx = torch.fmax(torch.fmax(x0 - mx, mx - x1), zero)  # fmax: as fmaxf
    gy = torch.fmax(torch.fmax(y0 - my, my - y1), zero)
    return live & (~bounded | ((gx <= ex) & (gy <= ey)))


# ---------------------------------------------------------------- CUDA kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "blend_fwd": [_P] * 7 + [_I] * 4 + [_F] * 3 + [_P],
    "blend_fwd_split": [_P] * 7 + [_I] * 4 + [_F] * 3 + [_I, _P],
    "blend_fwd_segments": [_I] * 3 + [ctypes.POINTER(_I)],
    "blend_bwd": [_P] * 10 + [_I] * 4 + [_F] * 2 + [_P],
}


def _kernel(fn_name: str):
    return cuda_build.function("blend", fn_name, _SIGNATURES[fn_name])


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(xy, con, op, feat, ts):
    if xy.device.type != "cuda":
        raise ValueError(f"the blend kernels take CUDA tensors, got {xy.device}")
    if xy.dim() != 3:
        raise ValueError(f"xy must be [T, 2, M], got {tuple(xy.shape)}")
    T, _, M = xy.shape
    P = ts * ts
    if P % 32 or P > 1024:
        raise ValueError(f"tile_size {ts}: the kernels need ts*ts a multiple of "
                         "32 and at most 1024")
    f32 = torch.float32
    _check("xy", xy, (T, 2, M), f32, xy.device)
    _check("con", con, (T, 3, M), f32, xy.device)
    _check("op", op, (T, 1, M), f32, xy.device)
    _check("feat", feat, (T, F_KERNEL, M), f32, xy.device)
    return T, M, P


def fwd_segments(T, M, ts):
    """The depth segments per tile that blend_fwd takes for T tiles of M
    slots on the current card (csrc/blend.cu blend_fwd_segments)."""
    S = _I()
    cuda_build.check(_kernel("blend_fwd_segments")(T, M, ts, ctypes.byref(S)),
                     "blend_fwd_segments")
    return S.value


def blend_fwd_cuda(xy, con, op, feat, ts, tiles_x, alpha_cut, alpha_clamp, min_t,
                   segments=None):
    """Launch blend_fwd; returns out [T,P,F], t_final [T,P], n_touched [T,M].
    `segments` fixes the depth segments per tile for tests and benchmarks;
    None (the blend's path) leaves them to the card's rule, fwd_segments."""
    T, M, P = _check_rows(xy, con, op, feat, ts)
    if segments is not None and not 1 <= segments <= 1024 // P:
        raise ValueError(f"segments {segments}: need 1 <= S and {P} * S <= 1024")
    out = torch.empty((T, P, F_KERNEL), dtype=torch.float32, device=xy.device)
    tf = torch.empty((T, P), dtype=torch.float32, device=xy.device)
    touched = torch.empty((T, M), dtype=torch.int32, device=xy.device)
    if T == 0:
        return out, tf, touched
    stream = torch.cuda.current_stream(xy.device).cuda_stream
    args = (xy.data_ptr(), con.data_ptr(), op.data_ptr(), feat.data_ptr(),
            out.data_ptr(), tf.data_ptr(), touched.data_ptr(),
            T, M, ts, tiles_x, alpha_cut, alpha_clamp, min_t)
    # the C interface launches on the current card: make it the tensors'
    with torch.cuda.device(xy.device):
        if segments is None:
            err = _kernel("blend_fwd")(*args, stream)
        else:
            err = _kernel("blend_fwd_split")(*args, segments, stream)
    cuda_build.check(err, "blend_fwd")
    launches["blend_fwd"] += 1
    return out, tf, touched


def blend_bwd_cuda(xy, con, op, feat, g_out, g_tf, ts, tiles_x, alpha_cut,
                   alpha_clamp):
    """Launch blend_bwd; returns dxy, dcon, dop, dfeat (per tile and slot)."""
    T, M, P = _check_rows(xy, con, op, feat, ts)
    _check("g_out", g_out, (T, P, F_KERNEL), torch.float32, xy.device)
    _check("g_tf", g_tf, (T, P), torch.float32, xy.device)
    kw = dict(dtype=torch.float32, device=xy.device)
    dxy = torch.empty((T, 2, M), **kw)
    dcon = torch.empty((T, 3, M), **kw)
    dop = torch.empty((T, 1, M), **kw)
    dfeat = torch.empty((T, F_KERNEL, M), **kw)
    if T == 0:
        return dxy, dcon, dop, dfeat
    fn = _kernel("blend_bwd")
    stream = torch.cuda.current_stream(xy.device).cuda_stream
    with torch.cuda.device(xy.device):
        err = fn(xy.data_ptr(), con.data_ptr(), op.data_ptr(), feat.data_ptr(),
                 g_out.data_ptr(), g_tf.data_ptr(), dxy.data_ptr(), dcon.data_ptr(),
                 dop.data_ptr(), dfeat.data_ptr(), T, M, ts, tiles_x, alpha_cut,
                 alpha_clamp, stream)
    cuda_build.check(err, "blend_bwd")
    launches["blend_bwd"] += 1
    return dxy, dcon, dop, dfeat


# ---------------------------------------------------------------- dispatch


def _route(x: torch.Tensor, plain, kernel):
    """The plain version serves CPU tensors only; CUDA gets the kernel."""
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return kernel
    raise ValueError(f"blend: unsupported device {x.device}")


class _BlendFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xy, con, op, feat, ts, tiles_x, cfg_tuple):
        alpha_cut, alpha_clamp, min_t = cfg_tuple
        xy, con, op, feat = (x.contiguous() for x in (xy, con, op, feat))
        fwd = _route(xy, blend_fwd_plain, blend_fwd_cuda)
        out, tf, touched = fwd(xy, con, op, feat, ts, tiles_x, alpha_cut,
                               alpha_clamp, min_t)
        ctx.save_for_backward(xy, con, op, feat)
        ctx.cfg = (ts, tiles_x, alpha_cut, alpha_clamp)
        ctx.mark_non_differentiable(touched)
        return out, tf, touched

    @staticmethod
    def backward(ctx, g_out, g_tf, _g_touched):
        xy, con, op, feat = ctx.saved_tensors
        ts, tiles_x, alpha_cut, alpha_clamp = ctx.cfg
        bwd = _route(xy, blend_bwd_plain, blend_bwd_cuda)
        dxy, dcon, dop, dfeat = bwd(
            xy, con, op, feat, g_out.contiguous(), g_tf.contiguous(), ts,
            tiles_x, alpha_cut, alpha_clamp)
        return dxy, dcon, dop, dfeat, None, None, None


def blend_tiles_rows(xy_rows, con_rows, op_rows, feat_rows, ts, tiles_x,
                     cfg_tuple):
    """Row-layout entry point: every per-splat quantity is splat-minor.

    Args:
      xy_rows [T, 2, M], con_rows [T, 3, M], op_rows [T, 1, M] (0 for invalid
      slots), feat_rows [T, F, M]; cfg_tuple = (alpha_cut, alpha_clamp,
      visibility_min_T).
    Returns:
      out [T, P, F], t_final [T, P], n_touched [T, M] (int32).
    """
    return _BlendFn.apply(xy_rows, con_rows, op_rows, feat_rows, ts, tiles_x,
                          tuple(float(c) for c in cfg_tuple))
