"""Device and dtype resolution for every constructor of the port.

No counterpart in ``blf_tpu`` (JAX places arrays by its default backend).
The rule: ``device=None`` means the GPU, and a missing GPU is an error, never
a silent CPU run. The CPU is used only when the caller names it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "resolve_dtype"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; raises if CUDA is asked for
    (explicitly or by default) and not available."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "blf_tpu_torch runs on a CUDA device"
            + (" by default (device=None)" if device is None else "")
            + " and torch.cuda.is_available() is False; pass device='cpu'"
              " explicitly to run the plain PyTorch path on the CPU")
    return dev


def resolve_dtype(dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """``None`` -> ``torch.float32``; only floating dtypes are accepted."""
    dt = torch.float32 if dtype is None else dtype
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise TypeError(f"expected a floating torch.dtype, got {dtype!r}")
    return dt
