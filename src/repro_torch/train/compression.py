"""int8 error-feedback gradient compression for the cross-pod all-reduce.

The port of the JAX package's ``train/compression.py``.  Per tensor and
step::

    c      = g + ef                      # carry forward last step's residual
    scale  = max|c| / 127
    q      = round(c / scale)  ∈ int8
    ĝ      = mean over pods of (q·scale) # the only cross-pod traffic
    ef'    = c − q·scale                 # local residual for next step

:func:`quantize_int8` and :func:`dequantize_int8` give the reference's
values bit for bit (both frameworks round half to even).  The cross-pod
reduce (:func:`pod_allreduce_int8`, :func:`compressed_mean`) needs a process
group across pods, which the port does not have yet: both raise
(ROADMAP.md, Queue A item 9).
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["quantize_int8", "dequantize_int8", "ef_init",
           "pod_allreduce_int8", "compressed_mean"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.amax(torch.abs(xf)) / 127.0
    scale = torch.clamp_min(scale, 1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(grads_like: Any) -> Any:
    """Zero float32 residuals shaped like a (nested dict) gradient tree."""
    if isinstance(grads_like, dict):
        return {k: ef_init(v) for k, v in grads_like.items()}
    return torch.zeros_like(grads_like, dtype=torch.float32)


def _needs_pods(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name}: the cross-pod int8 reduce needs a process group over pods, "
        "which is not ported (ROADMAP.md, Queue A item 9)")


def pod_allreduce_int8(g: torch.Tensor, ef: torch.Tensor, axis_name: str
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-pod mean of one gradient tensor with int8 EF compression."""
    raise _needs_pods("pod_allreduce_int8")


def compressed_mean(grads: Any, ef: Any, axis_name: str) -> tuple[Any, Any]:
    """Tree version of :func:`pod_allreduce_int8`."""
    raise _needs_pods("compressed_mean")
