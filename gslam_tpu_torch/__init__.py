"""PyTorch / CUDA (Hopper) port of gslam_tpu.

The JAX package `gslam_tpu` is the reference; this package mirrors its
layout (core/, mapping/, ops/, opt/, tracking/) so each module's
counterpart is found under the same path. It imports torch only.

Precision: the JAX geometry code asks for float32 `Precision.HIGHEST` on
every matmul. PyTorch on Hopper would round float32 matmuls and cuDNN
convolutions to TF32 when these flags are on, so they are pinned off here,
for every importer of the package.

Devices: entry points run on CUDA unless the caller passes
`device="cpu"`; with no device given and no CUDA present they raise.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no device is named and CUDA is absent; never falls back to
    the CPU on its own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gslam_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_device(x, device: torch.device, dtype: torch.dtype = torch.float32):
    """A tensor or numpy array as a tensor of `dtype` on `device` (None
    stays None); numpy input is copied."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)
