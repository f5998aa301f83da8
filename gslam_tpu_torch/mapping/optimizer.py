"""Masked Adam over the fixed-capacity Gaussian buffer.

Counterpart of gslam_tpu/mapping/optimizer.py, the same loop rather than
torch.optim.Adam: moments live in tensors shaped like the parameters, one
step count is shared by every slot, inserted slots get zeroed moments while
the count keeps running, and slots outside the update mask (dead ones by
default) keep their parameters and moments.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gslam_tpu_torch import resolve_device
from gslam_tpu_torch.mapping.gaussians import TRAINABLE_FIELDS, GaussianMap


class MaskedAdamState(NamedTuple):
    mu: dict  # field -> first moment, same shape as param
    nu: dict  # field -> second moment
    count: torch.Tensor  # [] int32 shared step counter


# Per-field learning rates (the JAX package's DEFAULT_LRS).
DEFAULT_LRS = {
    "means": 0.0016,
    "quats": 0.005,
    "log_scales": 0.005,
    "logit_opacities": 0.025,
    "logit_colors": 0.01,
    "log_uncertainties": 0.0025,
}


def init_adam(gmap: GaussianMap) -> MaskedAdamState:
    """Zero moments on the map's device."""
    return MaskedAdamState(
        mu={f: torch.zeros_like(getattr(gmap, f)) for f in TRAINABLE_FIELDS},
        nu={f: torch.zeros_like(getattr(gmap, f)) for f in TRAINABLE_FIELDS},
        count=torch.zeros((), dtype=torch.int32, device=gmap.means.device),
    )


@torch.no_grad()
def adam_step(
    gmap: GaussianMap,
    grads: dict,
    state: MaskedAdamState,
    lrs: dict | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    update_mask: torch.Tensor | None = None,  # [cap] bool; default = alive
) -> tuple[GaussianMap, MaskedAdamState]:
    if lrs is None:
        lrs = DEFAULT_LRS
    if update_mask is None:
        update_mask = gmap.alive
    count = state.count + 1
    t = count.to(torch.float32)
    c1 = 1.0 - b1**t
    c2 = 1.0 - b2**t

    new_params, new_mu, new_nu = {}, {}, {}
    for f in TRAINABLE_FIELDS:
        p = getattr(gmap, f)
        g = grads[f]
        m = b1 * state.mu[f] + (1.0 - b1) * g
        v = b2 * state.nu[f] + (1.0 - b2) * g * g
        step = lrs[f] * (m / c1) / (torch.sqrt(v / c2) + eps)
        mask = update_mask if p.dim() == 1 else update_mask[:, None]
        new_params[f] = torch.where(mask, p - step, p)
        new_mu[f] = torch.where(mask, m, state.mu[f])
        new_nu[f] = torch.where(mask, v, state.nu[f])
    return gmap.with_trainable(new_params), MaskedAdamState(new_mu, new_nu, count)


def zero_state_at(state: MaskedAdamState, slots) -> MaskedAdamState:
    """Zero the Adam moments at `slots` (used on insertion); out-of-range
    slots are dropped, as the JAX scatter's mode="drop" does."""
    ref = next(iter(state.mu.values()))
    idx = torch.as_tensor(slots, device=ref.device).to(torch.int64).reshape(-1)
    idx = idx[(idx >= 0) & (idx < ref.shape[0])]

    def zero(v):
        v = v.clone()
        v[idx] = 0.0
        return v

    return MaskedAdamState({f: zero(v) for f, v in state.mu.items()},
                           {f: zero(v) for f, v in state.nu.items()}, state.count)


def adam_state_to_numpy(state: MaskedAdamState) -> dict[str, np.ndarray]:
    """The state as numpy arrays: `mu/<field>`, `nu/<field>` and `count`."""
    out = {f"{k}/{f}": v.detach().cpu().numpy()
           for k in ("mu", "nu") for f, v in getattr(state, k).items()}
    out["count"] = state.count.detach().cpu().numpy()
    return out


def adam_state_from_numpy(d: dict, device: str | torch.device | None = None
                          ) -> MaskedAdamState:
    """Inverse of adam_state_to_numpy."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)

    return MaskedAdamState(
        mu={f: t(d[f"mu/{f}"], np.float32) for f in TRAINABLE_FIELDS},
        nu={f: t(d[f"nu/{f}"], np.float32) for f in TRAINABLE_FIELDS},
        count=t(d["count"], np.int32),
    )


class VectorAdamState(NamedTuple):
    """Adam over a flat vector (poses / exposure)."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor


def init_vector_adam(x: torch.Tensor) -> VectorAdamState:
    return VectorAdamState(torch.zeros_like(x), torch.zeros_like(x),
                           torch.zeros((), dtype=torch.int32, device=x.device))


@torch.no_grad()
def vector_adam_step(
    x: torch.Tensor, g: torch.Tensor, s: VectorAdamState, lr: float,
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> tuple[torch.Tensor, VectorAdamState]:
    count = s.count + 1
    t = count.to(torch.float32)
    m = b1 * s.mu + (1 - b1) * g
    v = b2 * s.nu + (1 - b2) * g * g
    step = lr * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + eps)
    return x - step, VectorAdamState(m, v, count)
