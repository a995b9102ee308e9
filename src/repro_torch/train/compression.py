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
reduce (:func:`pod_allreduce_int8`, :func:`compressed_mean`) runs over the
ranks along one axis of the installed mesh (:func:`repro_torch.sharding.
ctx.use_mesh`), as the reference's runs inside a ``shard_map`` over
``pod``: the int8 payload and the per-tensor scale go through
``all_gather_into_tensor`` (int8 on the wire: 4x fewer bytes an element
than a float32 all-reduce), then every rank dequantizes and takes the mean
over pods in pod order, ``(((q_0 s_0 + q_1 s_1) + ...) / n``, the same
values on every rank and on any device (each division a division, also on
the card).  Where a rank holds a tensor's shard over ``model`` (the dense
split, :mod:`repro_torch.sharding.tp`), ``max|c|`` is the whole tensor's,
reduced over ``model`` (``scale_group``), as GSPMD reduces it across the
auto axes inside the reference's ``shard_map``: every shard quantizes on
the same scale as the unsplit tensor.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_group
from repro_torch.sharding.ctx import all_gather_flat, current_mesh

__all__ = ["quantize_int8", "dequantize_int8", "ef_init",
           "pod_allreduce_int8", "compressed_mean", "divide"]


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device: PyTorch's CUDA kernels
    multiply by the reciprocal of a Python scalar divisor, one ulp off the
    reference's division at times; a divisor on the device is divided."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale) of ``x`` on the scale ``amax / 127`` (None: ``x``'s own
    largest magnitude)."""
    xf = x.float()
    if amax is None:
        amax = torch.amax(torch.abs(xf))
    scale = divide(amax, 127.0)
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


def pod_allreduce_int8(g: torch.Tensor, ef: torch.Tensor, axis_name: str,
                       scale_group: Any = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-pod mean of one gradient tensor with int8 EF compression over
    the installed mesh's ``axis_name``; with ``scale_group`` (the ranks
    holding the tensor's other shards) the scale is the whole tensor's.
    Returns (mean gradient fp32, new EF residual)."""
    c = g.float() + ef
    amax = None
    if scale_group is not None:
        amax = torch.amax(torch.abs(c))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=scale_group)
    q, scale = quantize_int8(c, amax)
    group = axis_group(current_mesh(), (axis_name,))
    n = dist.get_world_size(group)
    # int8 payload on the wire; scales are scalar per tensor
    q_all = q.new_empty((n * q.numel(),))
    all_gather_flat(q_all, q, group)
    q_all = q_all.view((n,) + tuple(q.shape))
    s_all = scale.new_empty((n,))
    all_gather_flat(s_all, scale, group)
    acc = dequantize_int8(q_all[0], s_all[0])
    for i in range(1, n):
        acc = acc + dequantize_int8(q_all[i], s_all[i])
    ef_new = c - dequantize_int8(q, scale)
    return divide(acc, n), ef_new


def compressed_mean(grads: Any, ef: Any, axis_name: str,
                    scale_groups: Any = None) -> tuple[Any, Any]:
    """Tree version of :func:`pod_allreduce_int8` (nested dicts);
    ``scale_groups``, a tree like ``grads`` (None: no group anywhere),
    gives each tensor's ``scale_group``."""
    if isinstance(grads, dict):
        out = {k: compressed_mean(grads[k], ef[k], axis_name,
                                  None if scale_groups is None
                                  else scale_groups[k]) for k in grads}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    return pod_allreduce_int8(grads, ef, axis_name, scale_groups)
