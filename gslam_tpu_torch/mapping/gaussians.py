"""Fixed-capacity Gaussian map buffer.

Counterpart of gslam_tpu/mapping/gaussians.py: splats live in fixed-size
tensors with a live mask, so insertion writes into dead slots and pruning
clears live bits; `compact_map` moves the live splats to a dense prefix and
`grow_map` copies the buffer into a larger one. The carry-across functions
move a map between the two packages as numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gslam_tpu_torch import resolve_device

# Fields optimized by the mapping backend (everything but ages/alive).
TRAINABLE_FIELDS = (
    "means", "quats", "log_scales", "logit_opacities", "logit_colors",
    "log_uncertainties",
)
FIELDS = (
    "means", "quats", "log_scales", "logit_opacities", "logit_colors",
    "log_uncertainties", "ages", "alive",
)


class GaussianMap(NamedTuple):
    means: torch.Tensor  # [cap, 3]
    quats: torch.Tensor  # [cap, 4] wxyz, unnormalized
    log_scales: torch.Tensor  # [cap, 3]
    logit_opacities: torch.Tensor  # [cap]
    logit_colors: torch.Tensor  # [cap, 3]
    log_uncertainties: torch.Tensor  # [cap]
    ages: torch.Tensor  # [cap] int32: frame index at insertion
    alive: torch.Tensor  # [cap] bool

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def n_live(self) -> torch.Tensor:
        return torch.sum(self.alive.to(torch.int32))

    def render_kwargs(self) -> dict:
        """Keyword arguments for gslam_tpu_torch.ops.rasterize.render_impl."""
        return {f: getattr(self, f) for f in TRAINABLE_FIELDS + ("alive",)}

    def trainable(self) -> dict:
        return {f: getattr(self, f) for f in TRAINABLE_FIELDS}

    def with_trainable(self, params: dict) -> "GaussianMap":
        return self._replace(**params)


def empty_map(capacity: int, device: str | torch.device | None = None) -> GaussianMap:
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    quats = torch.zeros((capacity, 4), **f32)
    quats[:, 0] = 1.0
    return GaussianMap(
        means=torch.zeros((capacity, 3), **f32),
        quats=quats,
        log_scales=torch.full((capacity, 3), -10.0, **f32),
        logit_opacities=torch.full((capacity,), -10.0, **f32),
        logit_colors=torch.zeros((capacity, 3), **f32),
        log_uncertainties=torch.zeros((capacity,), **f32),
        ages=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def gaussian_map_from_numpy(
    d: dict[str, np.ndarray], device: str | torch.device | None = None
) -> GaussianMap:
    """Build a map from the JAX map's fields given as numpy arrays.

    `ages` may be missing (zeros); every other field of GaussianMap is
    required. Dtypes follow the JAX map: float32, int32 ages, bool alive.
    """
    dev = resolve_device(device)
    n = np.asarray(d["means"]).shape[0]
    out = {}
    for name in FIELDS:
        if name == "ages" and name not in d:
            arr = np.zeros((n,), np.int32)
        else:
            arr = np.asarray(d[name])
        dtype = {"ages": np.int32, "alive": np.bool_}.get(name, np.float32)
        out[name] = torch.from_numpy(np.array(arr, dtype=dtype)).to(dev)
    return GaussianMap(**out)


def gaussian_map_to_numpy(gmap: GaussianMap) -> dict[str, np.ndarray]:
    """The map's fields as numpy arrays (the inverse of the above)."""
    return {name: getattr(gmap, name).detach().cpu().numpy() for name in FIELDS}


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median over `values[mask]` (values [n] or [n, d], along axis 0);
    inf where the mask is empty."""
    fill = mask if values.dim() == 1 else mask[:, None]
    v = torch.sort(torch.where(fill, values, torch.inf), dim=0).values
    k = torch.clamp(torch.sum(mask.to(torch.int32)) - 1, min=0) // 2
    return v[k]


def nonzero_fixed(mask: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """int64 indices of the first `size` True entries of a 1-D mask, in
    order, padded with `fill_value`: jnp.nonzero(mask, size=, fill_value=).
    A stable sort in place of a count, so the host never waits for it."""
    order = torch.argsort((~mask).to(torch.int32), stable=True)[:size]
    idx = torch.where(mask[order], order, fill_value)
    pad = torch.full((size - idx.shape[0],), fill_value, dtype=idx.dtype,
                     device=mask.device)
    return torch.cat([idx, pad])


def compact_free_slots(alive: torch.Tensor, n: int) -> torch.Tensor:
    """int32 indices of the first `n` dead slots; capacity (out of range)
    where there are fewer."""
    return nonzero_fixed(~alive, n, alive.shape[0]).to(torch.int32)


def compact_map(gmap: GaussianMap, opt_state=None, stable: bool = True,
                return_order: bool = False):
    """Permute the live splats to a dense prefix (a pure gather).

    Returns (gmap, opt_state) with the same shapes, the optimizer moments
    permuted like the parameters; with `return_order` also the permutation.
    """
    # torch sorts no bool tensor: dead (1) after live (0), stably
    order = torch.argsort((~gmap.alive).to(torch.int32), stable=stable)
    gmap2 = GaussianMap(*(x[order] for x in gmap))
    opt2 = None
    if opt_state is not None:
        opt2 = type(opt_state)(
            mu={f: v[order] for f, v in opt_state.mu.items()},
            nu={f: v[order] for f, v in opt_state.nu.items()},
            count=opt_state.count,
        )
    if return_order:
        return gmap2, opt2, order
    return gmap2, opt2


def grow_map(gmap: GaussianMap, opt_state, new_capacity: int):
    """Copy the compacted map into a buffer of `new_capacity` slots; new
    slots are dead and their optimizer moments zero."""
    if new_capacity < gmap.capacity:
        raise ValueError("grow_map cannot shrink")
    gmap, opt_state = compact_map(gmap, opt_state)
    pad = new_capacity - gmap.capacity
    big = empty_map(pad, device=gmap.means.device)
    gmap2 = GaussianMap(*(torch.cat([a, b]) for a, b in zip(gmap, big)))
    if opt_state is None:
        return gmap2, None

    def grow(v):
        return torch.cat([v, torch.zeros((pad,) + tuple(v.shape[1:]), dtype=v.dtype,
                                         device=v.device)])

    opt2 = type(opt_state)(
        mu={f: grow(v) for f, v in opt_state.mu.items()},
        nu={f: grow(v) for f, v in opt_state.nu.items()},
        count=opt_state.count,
    )
    return gmap2, opt2
