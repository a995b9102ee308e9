"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``cuda`` and raise when no card is present — there is
no path that quietly carries on on the CPU.  A caller that cannot pass
``device`` down (``configs.classical.build(trained=True)`` calls ``train``
with none) asks inside :func:`default_device`.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["resolve_device", "default_device", "as_tensor"]

_DEFAULT: contextvars.ContextVar[torch.device | None] = contextvars.ContextVar(
    "repro_torch_default_device", default=None)


@contextlib.contextmanager
def default_device(device: torch.device | str) -> Iterator[torch.device]:
    """Within the block, ``device=None`` means ``device`` instead of the card."""
    token = _DEFAULT.set(resolve_device(device))
    try:
        yield _DEFAULT.get()
    finally:
        _DEFAULT.reset(token)


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; None means the card (or the
    device of an enclosing :func:`default_device`)."""
    if device is None:
        device = _DEFAULT.get()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


_CANON = {torch.float64: torch.float32, torch.int64: torch.int32}


def as_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """An input array as a tensor on ``device`` with JAX's canonical dtypes
    (64-bit → 32-bit), the types the reference computes in."""
    t = value if torch.is_tensor(value) else torch.as_tensor(np.asarray(value))
    return t.to(device=device, dtype=_CANON.get(t.dtype, t.dtype))
