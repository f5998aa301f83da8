"""Fixed-capacity Gaussian map buffer.

Counterpart of gslam_tpu/mapping/gaussians.py: splats live in fixed-size
tensors with a live mask, so insertion writes into dead slots and pruning
clears live bits. This slice only reads a frozen map; the carry-across
functions move a map between the two packages as numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gslam_tpu_torch import resolve_device

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
