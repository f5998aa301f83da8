"""The benchmark's one traffic generator: splat maps, camera paths and
keyframes made from a seed and the parameters of a configuration file and
a traffic file. Nothing here imports the program.

Copied and frozen, with their origins:
  * `make_map` is chip_smoke.py's `make_map_fields` (chip_smoke.py:210-230,
    bench.py's `_make_map`) and scripts/bench_1m_torch.py's `point_arrays`
    (bench_1m_torch.py:38-61, bench_1m.py:32-69), one function whose
    sizes come from the configuration; it draws on the device with a
    torch.Generator instead of numpy's, in a few large calls.
  * `pose_chain` is bench_torch.py's `tracking_point` pose loop
    (bench_torch.py:224-228): poses chained by se3_exp(xi) @ pose with
    xi ~ N(0, sigma) per component.
  * `keyframe_poses` is bench_1m_torch.py's `keyframe_pose`
    (bench_1m_torch.py:68-71): keyframe k sits k * spacing along x.
  * frames and keyframes are rendered from the seeded map by the plain
    reference (reference/splats.py), not drawn as uniform noise as
    bench_torch.py's `mapping_point` (bench_torch.py:352-363) does; the
    mapped state starts from the map with its colour logits perturbed by
    N(0, color_noise), as chip_smoke.py's `mapping_point`
    (chip_smoke.py:869-901) does.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import splats

# Seeds above 2**63 are folded into the generator's range; numpy's generator
# takes any non-negative integer.
_SEED_MOD = 2**63 - 1


def generator(seed: int, device, stream: int) -> torch.Generator:
    """An independent torch.Generator on `device` for one use of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % _SEED_MOD)
    return g


def camera_params(camera: dict) -> tuple[float, float, float, float]:
    """(fx, fy, cx, cy) of a configuration's camera; fy defaults to fx and
    the principal point to the image centre."""
    w, h, fx = camera["width"], camera["height"], camera["fx"]
    return fx, camera.get("fy", fx), camera.get("cx", w / 2), camera.get("cy", h / 2)


def intrinsics(camera: dict, device) -> torch.Tensor:
    fx, fy, cx, cy = camera_params(camera)
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def make_map(cfg: dict, seed: int, device) -> dict:
    """The configuration's splat map: `capacity` slots, the first `n_live`
    alive, spread over the frustum of its camera (its intrinsics) at
    depths U(depth_m), scales U(scale_over_depth) * depth, random
    rotations, colour logits N(0, color_std), one logit opacity, unit
    uncertainty."""
    m, cam = cfg["map"], cfg["camera"]
    n = int(m["capacity"])
    w, h = cam["width"], cam["height"]
    fx, fy, cx, cy = camera_params(cam)
    g = generator(seed, device, 1)
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    u = torch.rand((n, 3), **f32)
    z = m["depth_m"][0] + (m["depth_m"][1] - m["depth_m"][0]) * u[:, 0]
    means = torch.stack([(u[:, 1] * w - cx) * z / fx, (u[:, 2] * h - cy) * z / fy, z], -1)
    lo, hi = m["scale_over_depth"]
    scales = (lo + (hi - lo) * torch.rand((n, 3), **f32)) * z[:, None]
    alive = torch.zeros(n, dtype=torch.bool, device=device)
    alive[: int(m["n_live"])] = True
    return {
        "means": means,
        "quats": torch.randn((n, 4), **f32),
        "log_scales": torch.log(scales),
        "logit_opacities": torch.full((n,), float(m["logit_opacity"]), dtype=torch.float32,
                                      device=device),
        "logit_colors": torch.randn((n, 3), **f32) * float(m["color_std"]),
        "log_uncertainties": torch.zeros(n, dtype=torch.float32, device=device),
        "alive": alive,
    }


def pose_chain(seed: int, n: int, sigma: float) -> np.ndarray:
    """[n, 4, 4] float64 world-to-camera poses: pose_k = se3_exp(xi_k) @
    pose_{k-1} from the identity, xi_k ~ N(0, sigma) per component."""
    rng = np.random.default_rng([int(seed), 2])
    xis = rng.normal(scale=sigma, size=(n, 6))
    poses, cur = [], np.eye(4)
    for xi in xis:
        cur = splats.se3_exp(xi) @ cur
        poses.append(cur)
    return np.stack(poses)


def keyframe_poses(n: int, spacing: float) -> np.ndarray:
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = spacing * np.arange(n)
    return poses


def walk(k: int, n: int) -> int:
    """The k-th frame of a closed loop over n frames walked forth and back
    (0, 1, .., n-1, n-2, .., 0, 1, ..): consecutive frames stay one motion
    step apart however long the window runs."""
    if n == 1:
        return 0
    k %= 2 * (n - 1)
    return k if k < n else 2 * (n - 1) - k


@torch.no_grad()
def render_views(fields: dict, poses: np.ndarray, K: torch.Tensor, cfg: dict,
                 spec: splats.RenderSpec) -> torch.Tensor:
    """[n, H, W, 3] renders of the map at `poses` by the plain reference,
    clipped to [0, 1], in float32."""
    w, h = cfg["camera"]["width"], cfg["camera"]["height"]
    out = []
    with splats.precision(False):
        for p in poses:
            view = torch.as_tensor(p, dtype=torch.float32, device=K.device)
            rgb = splats.render(fields, view, K, w, h, spec, block_elems=1 << 24).rgb
            out.append(torch.clamp(rgb, 0.0, 1.0))
    return torch.stack(out)


def perturb_colors(fields: dict, seed: int, sigma: float) -> dict:
    """The map with its colour logits moved by N(0, sigma)."""
    g = generator(seed, fields["means"].device, 3)
    noise = torch.randn(fields["logit_colors"].shape, dtype=torch.float32,
                        device=fields["means"].device, generator=g)
    return dict(fields, logit_colors=fields["logit_colors"] + sigma * noise)
