"""GQA decode attention: one new token per sequence against a KV cache.

:func:`decode_attention` computes, for q (B, H, dh) and the caches k and v
(B, S, KV, dh) of which the first ``cache_len[b]`` positions are valid, the
attention of each query head h over KV head h // (H / KV) → (B, H, dh) in
q's dtype.  On CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.decode_attention_ref`; on CUDA tensors the
hand-written kernel ``csrc/decode_attention.cu`` or it raises.  The kernel
reads the caches in this layout through their strides (a layer's slice of
a stacked cache needs no copy) and only their valid prefix.
``LAUNCHES["decode_attention"]`` counts launches.

``cache_len`` must lie in [1, S].  Given on the host (a CPU tensor, numpy
array or sequence), it is checked there and copied to the card without a
synchronisation; given on the card, checking it costs one.  ``round_p``
(default True, what the TPU kernel does) rounds the probabilities to v's
dtype before P·V; False keeps them fp32, as the model's ``gqa_decode`` does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import check_launch, load
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["decode_attention"]

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.da_launch.argtypes = ([vp] * 5 + [ci] * 5 + [cl] * 8 + [ctypes.c_float]
                              + [ci] * 3 + [vp])
    lib.da_launch.restype = ci
    lib.da_tile.argtypes = [ci, ci]
    lib.da_tile.restype = ci


def _lengths(cache_len, B: int, S: int) -> torch.Tensor:
    """``cache_len`` as an int32 tensor of B lengths, each checked to lie
    in [1, S]; on the device it was given on (the host for a sequence)."""
    lens = (cache_len if torch.is_tensor(cache_len)
            else torch.as_tensor(np.asarray(cache_len)))
    if lens.shape != (B,):
        raise ValueError(f"decode_attention: cache_len of shape "
                         f"{tuple(lens.shape)}, expected ({B},)")
    lens = lens.to(torch.int32).contiguous()
    if B and bool(((lens < 1) | (lens > S)).any()):
        raise ValueError(f"decode_attention: cache_len must lie in [1, {S}], "
                         f"got {lens.tolist()}")
    return lens


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     round_p: bool = True) -> torch.Tensor:
    """One decode step of attention → (B, H, dh) in q's dtype."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q (B, H, dh) and caches (B, S, KV, "
                         f"dh) expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != dh or KV < 1 or H % KV:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} do "
                         f"not match q {tuple(q.shape)}")
    lens = _lengths(cache_len, B, S)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lens, round_p=round_p)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("decode_attention: q and the caches must share a device")
    if q.dtype not in _DTYPE or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype} (float32 or bfloat16, all the same)")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: the last axis of q and of the "
                         "caches must be contiguous")
    lib = load("decode_attention", _declare)
    if lib.da_tile(H // KV, dh) == 0:
        raise ValueError(f"decode_attention: G = {H // KV} rows of dh = {dh} do "
                         "not fit in a block's shared memory")
    lens = lens.to(q.device, non_blocking=True)
    out = torch.empty((B, H, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    words = 16 // q.element_size()
    vec = all(t.data_ptr() % 16 == 0 and all(s % words == 0 for s in t.stride()[:3])
              for t in (k_cache, v_cache)) and dh % words == 0
    err = lib.da_launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        out.data_ptr(), lens.data_ptr(), B, S, H, KV, dh,
                        q.stride(0), q.stride(1), *k_cache.stride()[:3],
                        *v_cache.stride()[:3], dh ** -0.5, int(round_p),
                        int(vec), _DTYPE[q.dtype],
                        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention", err)
    return out
