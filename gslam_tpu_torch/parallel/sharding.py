"""Multi-device scaling over a list of torch devices.

Counterpart of gslam_tpu/parallel/sharding.py. The JAX package drives
every device of a `jax.sharding.Mesh` from one process through
`jit`/`shard_map`; here one process drives a grid of `torch.device`s, and
what XLA's partitioner inserts is written out:

  * camera data parallelism ("cam"): the window's cameras are split over
    the devices, the splat buffer and its optimizer state are held once, on
    the mesh's first device, and copied under autograd to each camera's
    device. Backward's accumulation of the copies' gradients onto the
    master is the gradient all-reduce.
  * splat sharding ("gauss"): the buffer and its Adam moments are split by
    DEPTH BAND into contiguous bands, one per device (`split_bands`). Each
    band renders into premultiplied (rgb, alpha, depth, beta) layers on its
    own device; the layers are copied to the first device under autograd
    (the all_gather) and composed front to back (`_compose_bands`). The
    composite is exact because the bands partition the same per-splat depth
    key the in-band sort uses (`partition_by_depth`). A splat's gradient
    only flows through its own band's layer, so splat gradients stay on
    their band; the pose and exposure gradients are summed on the way back
    through the copies (the psum of JAX's transpose).

A device may repeat in a mesh (["cpu"] * 8, ["cuda:0"] * 2): a copy to the
device a tensor already lies on is the identity, and the math is the same.
A "banded" map is a list of GaussianMap, band b on the mesh's b-th device
along "gauss"; a banded optimizer state a list of MaskedAdamState.
"""

from __future__ import annotations

import numpy as np
import torch

from gslam_tpu_torch.core.transforms import PoseDelta, pose_matrix
from gslam_tpu_torch.mapping.backend_ops import MapConfig, _background
from gslam_tpu_torch.mapping.gaussians import FIELDS, GaussianMap
from gslam_tpu_torch.mapping.optimizer import MaskedAdamState, adam_step
from gslam_tpu_torch.ops.losses import apply_exposure, mapping_photometric
from gslam_tpu_torch.ops.rasterize import RenderConfig, RenderOutput, render_impl
from gslam_tpu_torch.ops.ssim import ssim_per_image


class Mesh:
    """A grid of devices with named axes, read through jax.sharding.Mesh's
    names: `axis_names`, `shape[axis]` and `devices`, an object array of
    torch.device shaped like the axes."""

    def __init__(self, devices, axis_names: tuple):
        grid = np.array([torch.device(d) for d in np.asarray(devices, dtype=object).flat],
                        dtype=object)
        self.devices = grid.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """Where the master copies and the composites live."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        index = tuple(slice(None) if j == k else 0 for j in range(self.devices.ndim))
        return list(self.devices[index])

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _mesh_devices(n: int | None, devices) -> list[torch.device]:
    """The first n of `devices`, CUDA's devices by default (no CPU
    fallback: the caller names the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh defaults to the CUDA devices and none is available; pass "
                "devices=['cpu'] * n to build it on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n is not None:
        if n > len(devs):
            raise ValueError(f"a mesh of {n} devices from {len(devs)}")
        devs = devs[:n]
    return devs


def make_mesh(n_devices: int | None = None, axis: str = "cam", devices=None) -> Mesh:
    return Mesh(_mesh_devices(n_devices, devices), (axis,))


def make_hybrid_mesh(n_gauss: int, n_cam: int, devices=None) -> Mesh:
    """2D mesh for hybrid splat-band x camera-DP parallelism, axes
    ('gauss', 'cam'): band g's master lies on devices[g, 0] and is copied
    along its row to each camera chunk's device."""
    devs = _mesh_devices(n_gauss * n_cam, devices)
    return Mesh(np.array(devs, dtype=object).reshape(n_gauss, n_cam), ("gauss", "cam"))


def camera_dp_shardings(mesh: Mesh):
    """(replicate, split): replicate(x) copies x to every device of the
    mesh; split(x) cuts a [C, ...] tensor into contiguous camera chunks
    along 'cam', chunk k on the k-th device along it. Both copy under
    autograd."""
    cam_devs = mesh.axis_devices("cam")

    def replicate(x):
        return [x.to(d) for d in mesh.devices.flat]

    def split(x):
        n = len(cam_devs)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} cameras over {n} devices")
        return [c.to(d) for c, d in zip(torch.split(x, x.shape[0] // n), cam_devs)]

    return replicate, split


# ------------------------- bands: split and join -------------------------


def split_bands(tree, devices: list):
    """A GaussianMap or MaskedAdamState cut into len(devices) contiguous
    bands along the splat axis, band b moved to devices[b] (the Adam step
    count is copied to each)."""
    n = len(devices)

    def cut(x):
        if x.shape[0] % n:
            raise ValueError(f"capacity {x.shape[0]} does not split into {n} bands")
        return [c.to(d) for c, d in zip(torch.split(x, x.shape[0] // n), devices)]

    if isinstance(tree, GaussianMap):
        cols = [cut(getattr(tree, f)) for f in FIELDS]
        return [GaussianMap(*(c[b] for c in cols)) for b in range(n)]
    mu = {f: cut(v) for f, v in tree.mu.items()}
    nu = {f: cut(v) for f, v in tree.nu.items()}
    return [MaskedAdamState({f: v[b] for f, v in mu.items()},
                            {f: v[b] for f, v in nu.items()}, tree.count.to(d))
            for b, d in enumerate(devices)]


def join_bands(bands: list, device):
    """The bands concatenated on `device` (the inverse of split_bands)."""
    if isinstance(bands[0], GaussianMap):
        return GaussianMap(*(torch.cat([getattr(b, f).to(device) for b in bands])
                             for f in FIELDS))
    return MaskedAdamState(
        {f: torch.cat([b.mu[f].to(device) for b in bands]) for f in bands[0].mu},
        {f: torch.cat([b.nu[f].to(device) for b in bands]) for f in bands[0].nu},
        bands[0].count.to(device))


# ------------------- splat-axis ("gauss") sharding -------------------


def partition_by_depth(gmap: GaussianMap, viewmat: torch.Tensor,
                       opt_state: MaskedAdamState | None = None,
                       vis: torch.Tensor | None = None):
    """Permute the splat buffer into ascending camera-depth order for the
    given reference view (dead splats sort last). Split into bands in this
    order, the buffer is partitioned into contiguous depth bands, the
    invariant the band composite relies on. A pure permutation: it never
    changes a single-device render.

    `vis` ([..., capacity], e.g. the per-keyframe visibility snapshots of
    the pose graph) rides the same permutation along its LAST axis. The
    sort is stable, as jnp.argsort: the dead splats (key +inf) keep their
    order."""
    p = gmap.means @ viewmat[:3, :3].T + viewmat[:3, 3]
    key = torch.where(gmap.alive, p[:, 2], torch.inf)
    order = torch.argsort(key, stable=True)
    g2 = GaussianMap(*(x[order] for x in gmap))
    if opt_state is None:
        return g2
    o2 = MaskedAdamState(
        mu={k: v[order] for k, v in opt_state.mu.items()},
        nu={k: v[order] for k, v in opt_state.nu.items()},
        count=opt_state.count,
    )
    if vis is None:
        return g2, o2
    return g2, o2, vis[..., order]


def _compose_bands(rgbs, alphas, depths, betas, beta_bg):
    """Front-to-back composite of per-band premultiplied layers stacked on
    axis 0 (band index = depth order): each band rendered with a zero
    background, so the background's share of beta is taken off each band's
    layer and added back once, behind the whole composite."""
    t_cum = torch.cumprod(1.0 - alphas, dim=0)
    t_prev = torch.cat([torch.ones_like(t_cum[:1]), t_cum[:-1]], dim=0)
    rgb = torch.sum(t_prev[..., None] * rgbs, dim=0)
    depth = torch.sum(t_prev * depths, dim=0)
    beta_p = betas - (1.0 - alphas) * beta_bg
    t_final = t_cum[-1]
    beta = torch.sum(t_prev * beta_p, dim=0) + t_final * beta_bg
    return rgb, 1.0 - t_final, depth, beta


def _band_outputs(bands: list, viewmats, Ks, width: int, height: int, rcfg: RenderConfig,
                  probes: list | None = None) -> list[RenderOutput]:
    """render_impl of each band on its own device, zero background; the
    cameras are copied there under autograd."""
    outs = []
    for b, g in enumerate(bands):
        dev = g.means.device
        outs.append(render_impl(
            **g.render_kwargs(), viewmats=viewmats.to(dev), Ks=Ks.to(dev),
            width=width, height=height, cfg=rcfg,
            probe2d=None if probes is None else probes[b]))
    return outs


def compose_outputs(layers: list, device, beta_bg: float):
    """Copy each band's (rgb, alpha, depth, beta) to `device` under autograd
    and compose them there."""
    stacks = [torch.stack([x.to(device) for x in xs]) for xs in zip(*layers)]
    return _compose_bands(*stacks, beta_bg)


def _band_render(bands: list, viewmats, Ks, width: int, height: int, cfg: MapConfig,
                 device, probes: list | None = None):
    """Render each band into premultiplied layers on its device and compose
    them on `device`. Exactness: the per-pixel blending order, (band index,
    in-band depth sort), is the global depth sort, the key single-device
    binning uses."""
    outs = _band_outputs(bands, viewmats, Ks, width, height, cfg.render, probes)
    return compose_outputs([(o.rgb, o.alpha, o.depth, o.beta) for o in outs], device,
                           cfg.render.beta_background)


def gauss_render(mesh: Mesh, bands: list, viewmats, Ks, width: int, height: int,
                 cfg: MapConfig = MapConfig(), bg_rgb=None):
    """Splat-sharded render of a banded map (bands in depth order, see
    partition_by_depth, on the mesh's first axis). Returns (rgb, alpha,
    depth, beta) on the mesh's first device."""
    dev = mesh.first
    rgb, alpha, depth, beta = _band_render(bands, viewmats, Ks, width, height, cfg, dev)
    if bg_rgb is not None:
        rgb = rgb + (1.0 - alpha)[..., None] * torch.as_tensor(
            bg_rgb, dtype=torch.float32, device=dev)
    return rgb, alpha, depth, beta


def _mapping_loss(rgb, beta, gt_imgs, exposures, cfg: MapConfig):
    rendered = apply_exposure(rgb, exposures)
    photo = mapping_photometric(rendered, gt_imgs, beta, active_gs=cfg.active_gs)
    ssim_loss = 1.0 - torch.mean(ssim_per_image(rgb, gt_imgs))
    return (1.0 - cfg.ssim_weight) * photo + cfg.ssim_weight * ssim_loss


def _banded_step(bands, opts, pose_vec, loss_of, pose_lr: float, probes=()):
    """Gradients of loss_of(band params, pose_vec, *probes) to every band's
    params, to pose_vec and to the probes (zero tensors whose gradient is
    wanted, such as the means2d probe); one adam_step per band on its own
    moments; pose_vec steps by -pose_lr * g. Returns (bands, opts,
    pose_vec, probe gradients)."""
    params = [{f: v.detach().requires_grad_(True) for f, v in b.trainable().items()}
              for b in bands]
    pv = pose_vec.detach().requires_grad_(True)
    probes = [x.detach().requires_grad_(True) for x in probes]
    loss = loss_of(params, pv, *probes)
    flat = [v for p in params for v in p.values()]
    leaves = flat + [pv] + probes
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    out_b, out_o, k = [], [], 0
    for b, o, p in zip(bands, opts, params):
        b2, o2 = adam_step(b, dict(zip(p, grads[k:k + len(p)])), o)
        k += len(p)
        out_b.append(b2)
        out_o.append(o2)
    with torch.no_grad():
        pv2 = pv - pose_lr * grads[len(flat)]
    return out_b, out_o, pv2, grads[len(flat) + 1:]


def dp_mapping_train_step(
    gmap: GaussianMap,
    opt_state: MaskedAdamState,
    pose_vec: torch.Tensor,  # [C, 9]
    pose_base: torch.Tensor,  # [C, 4, 4]
    gt_imgs: torch.Tensor,  # [C, H, W, 3]
    exposures: torch.Tensor,  # [C, 2]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    cfg: MapConfig = MapConfig(),
    *,
    mesh: Mesh,
):
    """One camera-DP mapping iteration over the mesh's 'cam' axis. The
    master copies of the map and its state live on the mesh's first device;
    each camera chunk renders on its device from a copy of the map made
    under autograd, the per-camera outputs are gathered back, and the loss
    is computed once over all C cameras. Returns (gmap, opt_state, pose_vec)
    on the first device."""
    dev = mesh.first
    _, split = camera_dp_shardings(mesh)
    gmap = GaussianMap(*(x.to(dev) for x in gmap))
    opt_state = join_bands([opt_state], dev)  # a copy on dev
    pose_vec, pose_base, gt_imgs, exposures, Ks = (
        x.to(dev) for x in (pose_vec, pose_base, gt_imgs, exposures, Ks))
    bg = _background(cfg, dev)

    def loss_of(params, pv):
        viewmats = pose_matrix(PoseDelta(pose_base, pv[:, :6], pv[:, 6:9]))
        rgbs, betas = [], []
        for vm, k in zip(split(viewmats), split(Ks)):
            d = vm.device
            g = GaussianMap(*(x.to(d) for x in gmap.with_trainable(params[0])))
            out = render_impl(**g.render_kwargs(), viewmats=vm, Ks=k, width=width,
                              height=height, bg_rgb=bg.to(d), cfg=cfg.render)
            rgbs.append(out.rgb.to(dev))
            betas.append(out.beta.to(dev))
        return _mapping_loss(torch.cat(rgbs), torch.cat(betas), gt_imgs, exposures, cfg)

    (gmap,), (opt_state,), pose_vec, _ = _banded_step([gmap], [opt_state], pose_vec,
                                                      loss_of, cfg.pose_lr)
    return gmap, opt_state, pose_vec


def make_gauss_mapping_step(mesh: Mesh, width: int, height: int,
                            cfg: MapConfig = MapConfig()):
    """The splat-sharded mapping train step over the mesh's first axis:
    step(bands, opt_bands, pose_vec, pose_base, gt_imgs, exposures, Ks) ->
    (bands, opt_bands, pose_vec). Splat params and Adam moments stay on
    their band end to end; the cameras and the pose live on the mesh's
    first device. The loss is dp_mapping_train_step's on the zero-background
    composite."""
    dev = mesh.first

    def step(bands, opt_bands, pose_vec, pose_base, gt_imgs, exposures, Ks):
        pose_vec, pose_base, gt_imgs, exposures, Ks = (
            x.to(dev) for x in (pose_vec, pose_base, gt_imgs, exposures, Ks))

        def loss_of(params, pv):
            viewmats = pose_matrix(PoseDelta(pose_base, pv[:, :6], pv[:, 6:9]))
            gs = [b.with_trainable(p) for b, p in zip(bands, params)]
            rgb, _alpha, _depth, beta = _band_render(gs, viewmats, Ks, width, height, cfg,
                                                     dev)
            return _mapping_loss(rgb, beta, gt_imgs, exposures, cfg)

        return _banded_step(bands, opt_bands, pose_vec, loss_of, cfg.pose_lr)[:3]

    return step


def make_hybrid_mapping_step(mesh: Mesh, width: int, height: int,
                             cfg: MapConfig = MapConfig()):
    """Hybrid 2D parallel mapping step over a ('gauss', 'cam') mesh: the
    buffer and Adam moments in depth bands along 'gauss' (band g's master on
    devices[g, 0]), the window's cameras in chunks along 'cam'. Camera
    chunk c composes its bands on devices[0, c] from the band copies on
    devices[g, c]; the chunks' composites are gathered on the first device
    for the loss, which matches make_gauss_mapping_step. Backward sums each
    band's copies onto its master (the all-reduce over 'cam'); splat
    gradients never cross 'gauss'."""
    if not {"gauss", "cam"} <= set(mesh.axis_names):
        raise ValueError(f"a hybrid step needs axes 'gauss' and 'cam', got {mesh.axis_names}")
    grid = mesh.devices if mesh.axis_names == ("gauss", "cam") else mesh.devices.T
    dev = mesh.first
    n_cam = grid.shape[1]

    def step(bands, opt_bands, pose_vec, pose_base, gt_imgs, exposures, Ks):
        pose_vec, pose_base, gt_imgs, exposures, Ks = (
            x.to(dev) for x in (pose_vec, pose_base, gt_imgs, exposures, Ks))
        if pose_vec.shape[0] % n_cam:
            raise ValueError(f"{pose_vec.shape[0]} cameras over {n_cam} devices")
        chunk = pose_vec.shape[0] // n_cam

        def loss_of(params, pv):
            viewmats = pose_matrix(PoseDelta(pose_base, pv[:, :6], pv[:, 6:9]))
            rgbs, betas = [], []
            for c in range(n_cam):
                cams = slice(c * chunk, (c + 1) * chunk)
                copies = [GaussianMap(*(x.to(grid[g, c]) for x in b.with_trainable(p)))
                          for g, (b, p) in enumerate(zip(bands, params))]
                rgb, _a, _d, beta = _band_render(copies, viewmats[cams], Ks[cams], width,
                                                 height, cfg, grid[0, c])
                rgbs.append(rgb.to(dev))
                betas.append(beta.to(dev))
            return _mapping_loss(torch.cat(rgbs), torch.cat(betas), gt_imgs, exposures, cfg)

        return _banded_step(bands, opt_bands, pose_vec, loss_of, cfg.pose_lr)[:3]

    return step
