"""Plain float32 reference of the work the benchmark's cells time.

Written from the semantics the configurations state, in plain torch, and
importing nothing of the program: the EWA projection of 3D Gaussians, the
tile binning (footprints clamped to a max_span window, the pair budget
filled in splat order, each tile's list sorted by depth and cut to its
capacity), front-to-back alpha compositing, the tracking objective
('active-nerf': per-pixel squared colour error over the rendered
uncertainty squared, after an affine exposure) and the mapping step
(photometric + SSIM + isotropic + edge-aware depth TV loss, masked Adam on
the splats, Adam on the window poses, opacity decay). Gradients come from
autograd of the plain forward pass, not from an analytic backward.

Matrix products are written as products (`@`, `einsum`, `conv2d`), so
that the control, this reference with TF32 switched on (`precision(True)`),
differs from it where a lower precision would.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
TRAINABLE = ("means", "quats", "log_scales", "logit_opacities", "logit_colors",
             "log_uncertainties")


@dataclasses.dataclass(frozen=True)
class RenderSpec:
    """The render settings a configuration states (every field the
    configuration file's `render` object may hold)."""

    tile_size: int = 16
    tile_capacity: int = 256
    pairs_per_gaussian: int = 8
    max_span: int = 16
    tile_chunk: int = 64  # a chunking choice of the program; no effect on the result
    near: float = 0.01
    far: float = 1e10
    eps2d: float = 0.3
    radius_clip: float = 0.0
    visibility_min_T: float = 0.5
    beta_background: float = math.e
    alpha_clamp: float = 0.999
    alpha_cut: float = 1.0 / 255.0


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 matrix products and convolutions (TF32 off), or TF32 on for
    the control; the flags are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ poses


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """se(3) exponential in float64: [6] (rho, w) -> [4, 4]."""
    rho, w = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-8:
        a, b, c = 1.0, 0.5, 1.0 / 6.0
    else:
        a, b, c = math.sin(th) / th, (1 - math.cos(th)) / th**2, (th - math.sin(th)) / th**3
    R = np.eye(3) + a * K + b * K @ K
    V = np.eye(3) + b * K + c * K @ K
    out = np.eye(4)
    out[:3, :3], out[:3, 3] = R, V @ rho
    return out


def rot6_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al.'s 6D rotation [..., 6] -> [..., 3, 3], rows the
    Gram-Schmidt basis of the two 3-vectors."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-12)
    u = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-2)


def pose_from_delta(base: torch.Tensor, d_rot6: torch.Tensor, d_t: torch.Tensor
                    ) -> torch.Tensor:
    """base @ [R(d_rot6 + identity) | d_t]: the world-to-camera pose a
    learnable delta stands for."""
    ident = torch.tensor(IDENTITY_6D, dtype=d_rot6.dtype, device=d_rot6.device)
    R = rot6_to_matrix(d_rot6 + ident)
    top = torch.cat([R, d_t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return base @ torch.cat([top, bottom], dim=-2)


def pose_errors(est: torch.Tensor, gt: torch.Tensor) -> tuple[float, float]:
    """Camera-centre distance (m) and rotation angle (rad) between two
    world-to-camera poses, in float64."""
    est, gt = est.double().cpu(), gt.double().cpu()
    c_est = -est[:3, :3].T @ est[:3, 3]
    c_gt = -gt[:3, :3].T @ gt[:3, 3]
    dR = est[:3, :3] @ gt[:3, :3].T
    ang = math.atan2(float(torch.linalg.norm(dR - dR.T)) / math.sqrt(2.0),
                     float(torch.trace(dR)) - 1.0)
    return float(torch.linalg.norm(c_est - c_gt)), abs(ang)


# ------------------------------------------------------------- projection


class Projection(NamedTuple):
    means2d: torch.Tensor  # [N, 2]
    depths: torch.Tensor  # [N]
    conics: torch.Tensor  # [N, 3] inverse 2D covariance (A, B, C)
    radii: torch.Tensor  # [N] 0 where culled
    core: torch.Tensor  # [N] depth in range and a positive determinant
    valid: torch.Tensor  # [N] core, inside the image, alive


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def project(fields: dict, viewmat: torch.Tensor, K: torch.Tensor, width: int, height: int,
            spec: RenderSpec) -> Projection:
    """EWA projection into one camera: the 2D covariance J W Sigma W^T J^T
    (+eps2d on its diagonal) with gsplat's frustum clamp of x/z and y/z in
    the Jacobian, and a radius of ceil(3 sigma_max)."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    cam = fields["means"] @ R.T + t
    z = cam[:, 2]
    in_depth = (z > spec.near) & (z < spec.far)
    zs = torch.where(in_depth, z, torch.ones_like(z))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    lim_x, lim_y = 1.3 * 0.5 * width / fx, 1.3 * 0.5 * height / fy
    tx = zs * torch.clamp(cam[:, 0] / zs, -lim_x, lim_x)
    ty = zs * torch.clamp(cam[:, 1] / zs, -lim_y, lim_y)

    M = quat_to_rotmat(fields["quats"]) * torch.exp(fields["log_scales"])[:, None, :]
    W = R @ M  # camera-frame square root of the covariance
    zero = torch.zeros_like(zs)
    J = torch.stack([torch.stack([fx / zs, zero, -fx * tx / zs**2], -1),
                     torch.stack([zero, fy / zs, -fy * ty / zs**2], -1)], -2)
    JW = J @ W
    cov = JW @ JW.transpose(-1, -2)
    a = cov[:, 0, 0] + spec.eps2d
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + spec.eps2d
    det = a * c - b * b
    det_ok = det > 0
    det_s = torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([c / det_s, -b / det_s, a / det_s], -1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    v_max = torch.maximum(mid + disc, mid - disc)
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(v_max, min=0.0))).detach()
    means2d = torch.stack([fx * cam[:, 0] / zs + cx, fy * cam[:, 1] / zs + cy], -1)
    inside = ((means2d[:, 0] + radius > 0) & (means2d[:, 0] - radius < width)
              & (means2d[:, 1] + radius > 0) & (means2d[:, 1] - radius < height))
    core = in_depth & det_ok
    valid = core & inside & (radius > spec.radius_clip) & fields["alive"]
    return Projection(means2d, z, conics, torch.where(valid, radius, 0.0), core, valid)


# ---------------------------------------------------------------- binning


class Bins(NamedTuple):
    ids: torch.Tensor  # [T, M] int64 splat ids, nearest first
    mask: torch.Tensor  # [T, M] bool
    n_pairs: int  # (tile, splat) pairs requested before the budget


def bin_tiles(means2d, radii, depths, valid, width: int, height: int, spec: RenderSpec
              ) -> Bins:
    """Tile lists of one camera. Each splat covers the tiles of its radius
    box, clamped to a max_span window centred on its tile; its pairs, row
    by row, take the next places of a budget of pairs_per_gaussian * N in
    splat order, and pairs past the budget are dropped; each tile keeps its
    tile_capacity nearest splats (ties in depth: the earlier pair)."""
    ts, n = spec.tile_size, means2d.shape[0]
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    dev = means2d.device
    x, y, r = means2d[:, 0], means2d[:, 1], radii

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi - 1).long()

    x0, x1, y0, y1 = tile_of(x - r, tiles_x), tile_of(x + r, tiles_x), \
        tile_of(y - r, tiles_y), tile_of(y + r, tiles_y)
    sx, sy = x1 - x0 + 1, y1 - y0 + 1
    big_x, big_y = sx > spec.max_span, sy > spec.max_span
    half = spec.max_span // 2
    x0 = torch.where(big_x, torch.clamp(tile_of(x, tiles_x) - half, 0,
                                        tiles_x - spec.max_span), x0)
    y0 = torch.where(big_y, torch.clamp(tile_of(y, tiles_y) - half, 0,
                                        tiles_y - spec.max_span), y0)
    sx = torch.where(big_x, spec.max_span, sx)
    sy = torch.where(big_y, spec.max_span, sy)
    counts = torch.where(valid, sx * sy, 0)
    n_pairs = int(counts.sum())
    budget = int(spec.pairs_per_gaussian * n)

    owner = torch.repeat_interleave(torch.arange(n, device=dev), counts)[:budget]
    start = torch.cumsum(counts, 0) - counts
    j = torch.arange(owner.shape[0], device=dev) - start[owner]
    tile = (y0[owner] + j // sx[owner]) * tiles_x + x0[owner] + j % sx[owner]
    depth = depths.detach()[owner]
    order = torch.argsort(depth, stable=True)
    order = order[torch.argsort(tile[order], stable=True)]
    tile, owner = tile[order], owner[order]

    num_tiles = tiles_x * tiles_y
    per_tile = torch.bincount(tile, minlength=num_tiles)
    first = torch.cumsum(per_tile, 0) - per_tile
    slot = torch.arange(spec.tile_capacity, device=dev)
    mask = slot[None, :] < per_tile[:, None]
    ids = owner[torch.where(mask, first[:, None] + slot[None, :], 0).clamp(
        max=max(owner.shape[0] - 1, 0))] if owner.numel() else \
        torch.zeros(mask.shape, dtype=torch.long, device=dev)
    return Bins(torch.where(mask, ids, 0), mask, n_pairs)


# ---------------------------------------------------------------- blending


class Render(NamedTuple):
    rgb: torch.Tensor  # [H, W, 3]
    depth: torch.Tensor  # [H, W]
    beta: torch.Tensor  # [H, W]
    alpha: torch.Tensor  # [H, W]
    radii: torch.Tensor  # [N]
    pairs: int  # listed (tile, splat) entries times the tile's pixels
    ok_pairs: int  # (pixel, splat) pairs that pass the alpha test


def _composite(xy, con, op, feat, t0: int, tiles_x: int, spec: RenderSpec):
    """Front-to-back compositing of tiles t0.. of a row of tile lists:
    xy [B, M, 2], con [B, M, 3], op [B, M], feat [B, M, F] ->
    out [B, P, F], t_final [B, P], and the count of pairs passing the
    alpha test. Pixel (u, v) sits at integer coordinates."""
    ts = spec.tile_size
    dev = xy.device
    t = torch.arange(t0, t0 + xy.shape[0], device=dev)
    k = torch.arange(ts * ts, device=dev)
    px = (((t % tiles_x) * ts)[:, None] + (k % ts)[None, :]).float()
    py = (((t // tiles_x) * ts)[:, None] + (k // ts)[None, :]).float()
    dx = px[:, :, None] - xy[:, None, :, 0]
    dy = py[:, :, None] - xy[:, None, :, 1]
    A, B, C = (con[:, None, :, i] for i in range(3))
    sigma = 0.5 * (A * dx * dx + C * dy * dy) + B * dx * dy
    alpha_raw = op[:, None, :] * torch.exp(-sigma)
    ok = (sigma >= 0) & (alpha_raw >= spec.alpha_cut)
    clamp = torch.tensor(spec.alpha_clamp, dtype=alpha_raw.dtype, device=dev)
    alpha = torch.where(ok, torch.where(alpha_raw < spec.alpha_clamp, alpha_raw, clamp), 0.0)
    trans = torch.cumprod(1.0 - alpha, dim=-1)
    T = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    out = torch.einsum("bpm,bmf->bpf", alpha * T, feat)
    return out, trans[..., -1], int(ok.sum())


def _untile(x: torch.Tensor, tiles_x: int, tiles_y: int, ts: int, width: int, height: int):
    """[T, P, ...] -> [H, W, ...]."""
    extra = tuple(x.shape[2:])
    img = x.reshape((tiles_y, tiles_x, ts, ts) + extra).transpose(1, 2)
    return img.reshape((tiles_y * ts, tiles_x * ts) + extra)[:height, :width]


def render(fields: dict, viewmat, K, width: int, height: int, spec: RenderSpec,
           bins: Bins | None = None, opacity_rule: str = "visible",
           bg_rgb=(0.0, 0.0, 0.0), block_elems: int = 1 << 25) -> Render:
    """One camera's render. `bins` given: those tile lists (as binned at
    another pose); else binned at this pose. opacity_rule "visible": a
    listed splat blends where it projects validly at this pose (in depth,
    positive determinant, inside the image, alive); "core": where it is in
    depth with a positive determinant (and alive), whatever its radius box.
    Differentiable in every field and in viewmat; tiles are composited in
    blocks of about `block_elems` (pixel, slot) pairs."""
    proj = project(fields, viewmat, K, width, height, spec)
    if bins is None:
        bins = bin_tiles(proj.means2d.detach(), proj.radii, proj.depths, proj.valid,
                         width, height, spec)
    ts = spec.tile_size
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    live = proj.valid if opacity_rule == "visible" else proj.core & fields["alive"]
    opac = torch.where(live, torch.sigmoid(fields["logit_opacities"]), 0.0)
    beta = torch.clamp(torch.exp(fields["log_uncertainties"]), min=0.01)
    table = torch.cat([proj.means2d, proj.conics, opac[:, None],
                       torch.sigmoid(fields["logit_colors"]), proj.depths[:, None],
                       beta[:, None]], dim=-1)  # [N, 11]
    rows = table[bins.ids]  # [T, M, 11]
    op = torch.where(bins.mask, rows[..., 5], 0.0)
    M, P = bins.ids.shape[1], ts * ts
    step = max(1, block_elems // (P * M))
    outs, tfs, ok = [], [], 0
    for s in range(0, rows.shape[0], step):
        o, tf, n_ok = _composite(rows[s:s + step, :, 0:2], rows[s:s + step, :, 2:5],
                                 op[s:s + step], rows[s:s + step, :, 6:11], s, tiles_x, spec)
        outs.append(o)
        tfs.append(tf)
        ok += n_ok
    out, t_final = torch.cat(outs), torch.cat(tfs)
    bg = torch.tensor(tuple(bg_rgb) + (0.0, spec.beta_background), device=out.device)
    out = out + t_final[..., None] * bg

    def img(v):
        return _untile(v, tiles_x, tiles_y, ts, width, height)

    return Render(img(out[..., :3]), img(out[..., 3]), img(out[..., 4]), img(1.0 - t_final),
                  proj.radii, int(bins.mask.sum()) * P, ok)


# ---------------------------------------------------------------- tracking


def exposure(rgb, exp_ab):
    return rgb * torch.exp(exp_ab[..., 0]) + exp_ab[..., 1]


def tracking_loss(fields: dict, image, prior, pose, exp_ab, K, width: int, height: int,
                  spec: RenderSpec, bin_radius_scale: float, opacity_rule: str,
                  fixed_beta: bool = False):
    """The tracking objective at `pose`: tile lists binned once at `prior`
    with footprints inflated by bin_radius_scale, the render at `pose`,
    the affine exposure, then mean over pixels of |rgb - image|^2 / beta^2.
    fixed_beta: beta is held as a constant (no gradient flows through it),
    as Gauss-Newton's weights are at the linearization point.
    Returns (loss, Render)."""
    with torch.no_grad():
        p0 = project(fields, prior, K, width, height, spec)
        bins = bin_tiles(p0.means2d, p0.radii * bin_radius_scale, p0.depths, p0.valid,
                         width, height, spec)
    out = render(fields, pose, K, width, height, spec, bins=bins, opacity_rule=opacity_rule)
    err2 = torch.sum((exposure(out.rgb, exp_ab) - image) ** 2, dim=-1)
    beta = out.beta.detach() if fixed_beta else out.beta
    return torch.mean(err2 / beta**2), out


def tracking_gradient(fields: dict, image, base, exposure0, K, width: int, height: int,
                      spec: RenderSpec, bin_radius_scale: float, opacity_rule: str,
                      learn_exposure: bool = True, fixed_beta: bool = False) -> torch.Tensor:
    """The gradient of the tracking objective in the tracker's variables
    (the pose delta's 6D rotation and translation, then the exposure's
    (a, b) where it is learned) at the zero delta on `base` with the
    exposure `exposure0`; tile lists binned at `base`."""
    x = torch.zeros(11 if learn_exposure else 9, dtype=torch.float32, device=K.device)
    if learn_exposure:
        x[9:] = exposure0
    x.requires_grad_(True)
    pose = pose_from_delta(base, x[:6], x[6:9])
    exp_ab = x[9:] if learn_exposure else exposure0
    loss, _ = tracking_loss(fields, image, base, pose, exp_ab, K, width, height, spec,
                            bin_radius_scale, opacity_rule, fixed_beta)
    (g,) = torch.autograd.grad(loss, x)
    return g


# ----------------------------------------------------------------- mapping


def _gauss_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [H, W, C] images: an 11-tap Gaussian window
    (sigma 1.5), 'valid' borders, C1 = 0.01^2, C2 = 0.03^2."""
    g = torch.as_tensor(_gauss_window(), device=img1.device)
    win = (g[:, None] * g[None, :])[None, None].repeat(img1.shape[-1], 1, 1, 1)

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[None], win, groups=img1.shape[-1])

    mu1, mu2 = filt(img1), filt(img2)
    s1 = filt(img1 * img1) - mu1 * mu1
    s2 = filt(img2 * img2) - mu2 * mu2
    s12 = filt(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    return torch.mean((2 * mu1 * mu2 + c1) * (2 * s12 + c2)
                      / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)))


def depth_tv(depth, rgb, mask):
    """Edge-aware total variation of one camera's depth where mask."""
    gdx = torch.abs(depth[:, :-1] - depth[:, 1:]) * torch.exp(
        -torch.mean(torch.abs(rgb[:, :-1] - rgb[:, 1:]), dim=-1))
    gdy = torch.abs(depth[:-1] - depth[1:]) * torch.exp(
        -torch.mean(torch.abs(rgb[:-1] - rgb[1:]), dim=-1))
    return (torch.sum(torch.where(mask[:, :-1], gdx, 0.0))
            + torch.sum(torch.where(mask[:-1], gdy, 0.0)))


@dataclasses.dataclass(frozen=True)
class MapSpec:
    """The mapping step's loss weights and rates, as a configuration
    states them."""

    ssim_weight: float = 0.2
    isotropic_weight: float = 0.0005
    depth_tv_weight: float = 0.000001
    pose_lr: float = 0.003
    opacity_decay: float = 0.995
    tv_alpha: float = 0.4


class MapState(NamedTuple):
    fields: dict  # TRAINABLE -> tensor, and "alive"
    mu: dict
    nu: dict
    count: int
    pose_vec: torch.Tensor  # [Wn, 9] window pose deltas (rot6, t)
    pose_mu: torch.Tensor
    pose_nu: torch.Tensor
    pose_count: torch.Tensor  # [Wn] float


def init_map_state(fields: dict, n_window: int) -> MapState:
    dev = fields["means"].device
    z = {f: torch.zeros_like(fields[f]) for f in TRAINABLE}
    pz = torch.zeros((n_window, 9), device=dev)
    return MapState(dict(fields), z, {f: v.clone() for f, v in z.items()}, 0,
                    pz.clone(), pz.clone(), pz.clone(), torch.zeros(n_window, device=dev))


def _adam(p, g, m, v, t, lr):
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    step = lr * (m / (1 - 0.9**t)) / (torch.sqrt(v / (1 - 0.999**t)) + 1e-8)
    return p - step, m, v


def mapping_step(state: MapState, images, pose_base, exposures, K, width: int, height: int,
                 spec: RenderSpec, mspec: MapSpec, lrs: dict):
    """One mapping step over a window of cameras (pose_base [Wn, 4, 4],
    images [Wn, H, W, 3], exposures [Wn, 2]), every window camera updated;
    `lrs` are the masked Adam's per-field learning rates. The loss is summed
    camera by camera, each camera's part back-propagated before the next is
    rendered. Returns (state, total loss, {leaf: grad}, per camera
    (pairs, ok_pairs, projected splats))."""
    fields = state.fields
    Wn = images.shape[0]
    params = {f: fields[f].detach().clone().requires_grad_(True) for f in TRAINABLE}
    live = dict(params, alive=fields["alive"])
    pose_vec = state.pose_vec.detach().clone().requires_grad_(True)
    denom = Wn * height * width
    total = 0.0
    seen = torch.zeros(fields["alive"].shape, dtype=torch.int32, device=K.device)
    work = []
    for c in range(Wn):
        view = pose_from_delta(pose_base[c], pose_vec[c, :6], pose_vec[c, 6:])
        out = render(live, view, K, width, height, spec)
        err2 = torch.sum((exposure(out.rgb, exposures[c]) - images[c]) ** 2, dim=-1)
        photo = (torch.sum(err2 / (2.0 * out.beta**2))
                 + torch.sum(torch.log(out.beta) ** 2 * 0.5)) / denom
        loss = ((1.0 - mspec.ssim_weight) * photo
                - mspec.ssim_weight * ssim(out.rgb, images[c]) / Wn
                + mspec.depth_tv_weight * depth_tv(out.depth, out.rgb,
                                                   out.alpha > mspec.tv_alpha))
        loss.backward()
        total += float(loss.detach())
        seen += (out.radii > 0).to(torch.int32)
        work.append((out.pairs, out.ok_pairs, int((out.radii > 0).sum())))
        del out, loss, err2, photo
    visible = (seen > 0) & fields["alive"]
    ls = params["log_scales"]
    iso = torch.sum(torch.where(visible[:, None], torch.abs(
        torch.exp(ls) - torch.exp(torch.mean(ls, dim=1, keepdim=True).detach())), 0.0))
    (mspec.isotropic_weight * iso).backward()
    total += mspec.ssim_weight + mspec.isotropic_weight * float(iso.detach())

    grads = {f: params[f].grad for f in TRAINABLE}
    grads["pose_rot6"], grads["pose_t"] = pose_vec.grad[:, :6], pose_vec.grad[:, 6:]
    with torch.no_grad():
        t = state.count + 1
        new, mu, nu = {}, {}, {}
        alive = fields["alive"]
        for f in TRAINABLE:
            p, m, v = _adam(fields[f], grads[f], state.mu[f], state.nu[f], t, lrs[f])
            keep = alive if p.dim() == 1 else alive[:, None]
            new[f] = torch.where(keep, p, fields[f])
            mu[f] = torch.where(keep, m, state.mu[f])
            nu[f] = torch.where(keep, v, state.nu[f])
        pc = state.pose_count + 1
        pv, pm, pn = _adam(state.pose_vec, pose_vec.grad, state.pose_mu, state.pose_nu,
                           pc[:, None], mspec.pose_lr)
        decay = (seen > 1) & alive
        new["logit_opacities"] = torch.where(decay, new["logit_opacities"] * mspec.opacity_decay,
                                             new["logit_opacities"])
        new["alive"] = alive
    return MapState(new, mu, nu, t, pv, pm, pn, pc), total, grads, work
