"""Raytraced synthetic dataset: ground-truth imagery not produced by the
port's own splat renderer.

Counterpart of gslam_tpu/io/raytrace.py. Quality numbers from the splat
scenes of io/synthetic.py partly measure self-consistency (the frames are
rendered by the same rasterizer the SLAM system optimizes against). This
module generates frames with an independent image-formation model: a
pure-numpy raytracer over an analytically defined room (walls, floor,
ceiling and textured spheres), Lambertian albedo only. Exact per-pixel
z-depth and exact poses come for free, so the scene serves monocular and
RGB-D runs. Textures are band-limited sums of sines, so one sample per
pixel does not alias between views. The scene, the walk and the nuisances
are drawn in the JAX package's order from `np.random.default_rng(seed)`,
so both packages build the same frames from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.transforms import so3_exp
from gslam_tpu_torch.io.frames import Frame


def _texture(p: np.ndarray, seed_row: np.ndarray) -> np.ndarray:
    """Band-limited procedural RGB albedo at world points p [..., 3].

    Each channel is a bounded sum of sines of the world coordinates with
    per-surface random frequencies/phases (seed_row [k] floats) — smooth
    (anti-aliased by construction) yet with gradients everywhere, which is
    what photometric pose optimization needs to lock on.
    """
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    s = seed_row
    rgb = []
    for c in range(3):
        f = (
            0.5
            + 0.28 * np.sin(s[c] * 2.1 + x * (1.3 + s[c + 3]) + y * s[c + 6])
            + 0.18 * np.sin(y * (2.2 + s[c + 9]) + z * (1.1 + s[c + 12]) + s[c + 1])
            + 0.12 * np.sin(x * 3.1 * s[c + 15] + z * 2.3 + s[c + 2] * 5.0)
        )
        rgb.append(f)
    out = np.stack(rgb, axis=-1)
    return np.clip(out, 0.02, 0.98).astype(np.float32)


def _gaussian_blur(imgs: np.ndarray, sigma_px: float) -> np.ndarray:
    """Separable Gaussian blur over [N, H, W, 3] (defocus / motion-smear
    proxy). Pure numpy; reflect padding keeps borders unbiased."""
    r = max(1, int(np.ceil(3.0 * sigma_px)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma_px) ** 2)
    k /= k.sum()

    def conv(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (r, r)
        ap = np.pad(a, pad, mode="reflect")
        out = np.zeros_like(a)
        for j, w in enumerate(k):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(j, j + a.shape[axis])
            out += w * ap[tuple(sl)]
        return out

    return conv(conv(imgs, 1), 2)


def _make_spheres(rng, n: int, extent: float):
    centers = rng.uniform(-0.55 * extent, 0.55 * extent, (n, 3))
    centers[:, 2] = rng.uniform(0.25 * extent, 0.85 * extent, n)  # in front
    radii = rng.uniform(0.08 * extent, 0.22 * extent, n)
    return centers.astype(np.float32), radii.astype(np.float32)


def render_frame(
    c2w: np.ndarray,  # [4, 4] camera-to-world
    K: np.ndarray,
    width: int,
    height: int,
    extent: float,
    sphere_c: np.ndarray,
    sphere_r: np.ndarray,
    tex_seeds: np.ndarray,  # [n_surfaces, 18]
):
    """One RGB + z-depth frame. Rays are cast per pixel; the hit surface's
    procedural albedo is shaded with a soft headlight term (1/depth
    falloff folded into albedo would break photometric constancy, so
    shading depends on the WORLD position only)."""
    u, v = np.meshgrid(
        np.arange(width, dtype=np.float32) + 0.5,
        np.arange(height, dtype=np.float32) + 0.5,
    )
    Kinv = np.linalg.inv(K)
    dirs_cam = np.stack([u, v, np.ones_like(u)], axis=-1) @ Kinv.T  # z=1
    R, t = c2w[:3, :3], c2w[:3, 3]
    dirs = dirs_cam @ R.T  # world; NOT normalized: t_hit == z-depth
    origin = t

    e = extent
    # slabs: x=+-e, y=+-e, z=-0.2e (behind start) and z=+e (front wall)
    planes = [
        (0, +e), (0, -e), (1, +e), (1, -e), (2, +e), (2, -0.2 * e),
    ]
    t_best = np.full(u.shape, np.inf, np.float32)
    surf_id = np.full(u.shape, -1, np.int32)
    hit_pts = np.zeros(u.shape + (3,), np.float32)

    for si, (axis, offs) in enumerate(planes):
        d = dirs[..., axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            th = (offs - origin[axis]) / d
        # Interior of the box: accept hits in front of the camera whose
        # other two coordinates stay inside the slab bounds.
        pt = origin[None, None, :] + th[..., None] * dirs
        oa, ob = (axis + 1) % 3, (axis + 2) % 3
        lim_a = e if oa != 2 else 1.05 * e
        lim_b = e if ob != 2 else 1.05 * e
        ok = (
            (th > 1e-4)
            & np.isfinite(th)
            & (np.abs(pt[..., oa]) <= lim_a + 1e-3)
            & (np.abs(pt[..., ob]) <= lim_b + 1e-3)
            & (pt[..., 2] >= -0.2 * e - 1e-3)
            & (pt[..., 2] <= e + 1e-3)
            & (th < t_best)
        )
        t_best = np.where(ok, th.astype(np.float32), t_best)
        surf_id = np.where(ok, si, surf_id)
        hit_pts = np.where(ok[..., None], pt.astype(np.float32), hit_pts)

    for k in range(len(sphere_r)):
        oc = origin - sphere_c[k]
        b = np.sum(dirs * oc[None, None, :], axis=-1)
        a = np.sum(dirs * dirs, axis=-1)
        c0 = float(oc @ oc - sphere_r[k] ** 2)
        disc = b * b - a * c0
        with np.errstate(invalid="ignore"):
            th = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        ok = (disc > 0) & (th > 1e-4) & (th < t_best)
        pt = origin[None, None, :] + th[..., None] * dirs
        t_best = np.where(ok, th.astype(np.float32), t_best)
        surf_id = np.where(ok, len(planes) + k, surf_id)
        hit_pts = np.where(ok[..., None], pt.astype(np.float32), hit_pts)

    rgb = np.zeros(u.shape + (3,), np.float32)
    for si in range(len(planes) + len(sphere_r)):
        m = surf_id == si
        if not m.any():
            continue
        rgb[m] = _texture(hit_pts[m], tex_seeds[si])
    depth = np.where(np.isfinite(t_best), t_best, 0.0).astype(np.float32)
    return rgb, depth


class RaytracedDataset:
    """Frame-iterable dataset over the raytraced room scene, with the
    interface of SyntheticDataset (io/synthetic.py): FusedSlam, the actor
    runtime and save_dataset_npz take either."""

    def __init__(
        self,
        seq_len: int = 30,
        width: int = 160,
        height: int = 120,
        seed: int = 0,
        motion_scale: float = 0.02,
        extent: float = 3.0,
        n_spheres: int = 8,
        with_depth: bool = True,
        n_splats: int = 0,  # accepted for CLI interface parity; unused
        # Photometric nuisances of real sensor frames (noise, exposure
        # variation, defocus), which clean raytraced frames leave out; gt
        # poses and depth stay exact, as a TUM rig's mocap/ToF ground
        # truth does.
        noise_std: float = 0.0,  # per-pixel Gaussian sensor noise (std)
        exposure_drift: float = 0.0,  # per-frame log-gain walk scale
        blur_px: float = 0.0,  # Gaussian defocus blur sigma in pixels
    ):
        rng = np.random.default_rng(seed)
        fx = fy = 0.9 * width
        K = np.array(
            [[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32
        )
        self.camera = Camera(K=torch.from_numpy(K), height=height, width=width)
        self.length = seq_len
        self.with_depth = with_depth

        sphere_c, sphere_r = _make_spheres(rng, n_spheres, extent)
        tex_seeds = rng.uniform(0.3, 3.0, (6 + n_spheres, 18)).astype(
            np.float32)

        # Mean-reverting smooth walk on the camera CENTER + attitude
        # (handheld room-scanning motion). The unbounded momentum walk of
        # io/synthetic.py wanders ~5 m from the origin over 160 frames —
        # outside this 3 m room — so springs pull position back toward the
        # room center and attitude back toward the front wall. At
        # motion_scale=0.016 this gives a ~4.5 cm/frame median step with
        # the camera staying within ~0.8 m of the origin.
        kp, kr = 0.012, 0.03
        pos = np.zeros(3, np.float32)
        att = np.zeros(3, np.float32)
        vel = np.zeros(3, np.float32)
        att_vel = np.zeros(3, np.float32)
        poses = []
        for _ in range(seq_len):
            R_c2w = so3_exp(torch.as_tensor(att, dtype=torch.float32)).numpy()
            w2c = np.eye(4, dtype=np.float32)
            w2c[:3, :3] = R_c2w.T
            w2c[:3, 3] = -R_c2w.T @ pos
            poses.append(w2c)
            vel = (0.9 * vel - kp * pos
                   + rng.normal(scale=motion_scale, size=3) * [1, 1, 0.5])
            pos = pos + vel
            att_vel = (0.9 * att_vel - kr * att
                       + rng.normal(scale=motion_scale * 0.3, size=3))
            att = att + att_vel
        self.poses = np.stack(poses).astype(np.float32)  # world-to-camera

        imgs, deps = [], []
        for w2c in self.poses:
            c2w = np.linalg.inv(w2c)
            rgb, depth = render_frame(
                c2w, K, width, height, extent, sphere_c, sphere_r, tex_seeds)
            imgs.append(rgb)
            deps.append(depth)
        self.images = np.stack(imgs)
        self.depths = np.stack(deps) if with_depth else None

        # The spring containment above is only statistical: at
        # a large motion_scale or an unlucky seed the walk can leave the
        # room or enter a sphere, silently producing rays with no valid
        # hit (depth 0) or inside-out views in the very datasets the
        # quality gates consume. Fail construction loudly instead.
        ctrs = np.stack([-w[:3, :3].T @ w[:3, 3] for w in self.poses])
        if np.abs(ctrs).max() >= extent:
            raise ValueError(
                f"raytrace walk escaped the room: |center| max "
                f"{np.abs(ctrs).max():.2f} >= extent {extent}; lower "
                f"motion_scale or change the seed")
        inside = (np.linalg.norm(ctrs[:, None, :] - sphere_c[None], axis=-1)
                  < sphere_r[None] + 0.05)
        if inside.any():
            f, s = np.argwhere(inside)[0]
            raise ValueError(
                f"raytrace walk entered sphere {s} at frame {f}; lower "
                f"motion_scale or change the seed")
        dep_all = np.stack(deps)
        if not (dep_all > 0).all():
            bad = int((dep_all <= 0).sum())
            raise ValueError(
                f"raytraced gt has {bad} pixels with no surface hit "
                f"(depth<=0) — camera outside the room?")

        # photometric nuisances, applied AFTER the geometric sanity checks
        # (which must see the pristine render)
        if blur_px > 0.0:
            self.images = _gaussian_blur(self.images, blur_px)
        if exposure_drift > 0.0:
            # mean-reverting log-gain + bias walk: models auto-exposure
            # hunting; smooth frame to frame, as a rolling AE loop is
            log_gain = np.zeros(seq_len, np.float32)
            bias = np.zeros(seq_len, np.float32)
            g = b = 0.0
            for i in range(1, seq_len):
                g = 0.95 * g + rng.normal(scale=exposure_drift)
                b = 0.95 * b + rng.normal(scale=0.3 * exposure_drift)
                log_gain[i], bias[i] = g, b
            self.exposure_gt = np.stack([log_gain, bias], axis=1)
            self.images = (self.images * np.exp(log_gain)[:, None, None, None]
                           + bias[:, None, None, None])
        if noise_std > 0.0:
            self.images = self.images + rng.normal(
                scale=noise_std, size=self.images.shape)
        self.images = np.clip(self.images, 0.0, 1.0).astype(np.float32)

    def init(self):
        return

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        if idx >= self.length:
            raise IndexError(idx)
        return Frame(
            image=self.images[idx],
            timestamp=float(idx) / 30.0,
            camera=self.camera,
            index=idx,
            gt_pose=self.poses[idx],
            gt_depth=self.depths[idx] if self.with_depth else None,
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
