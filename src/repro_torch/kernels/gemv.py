"""Dense tiled matmul and batched GEMV.

:func:`matmul` computes ``a @ b`` (or ``a @ b.T``) with fp32 accumulation
and the result in ``a``'s dtype (float32 or bfloat16); :func:`gemv` is the
batched matrix–vector product ``x @ w.T`` through it.  On CPU tensors they
run their plain version; on CUDA tensors the hand-written kernel
``csrc/gemv.cu`` or they raise — the port never hands a product to
cuBLAS.  ``LAUNCHES["matmul"]`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load

__all__ = ["gemv", "matmul", "DEFAULT_T"]

DEFAULT_T = 128
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gm_launch.argtypes = [vp, vp, vp] + [ci] * 5 + [vp]
    lib.gm_launch.restype = ci


def _launch(a: torch.Tensor, b: torch.Tensor, transpose_b: bool) -> torch.Tensor:
    if b.device != a.device:
        raise ValueError(f"matmul: b on {b.device}, a on {a.device}")
    if a.dtype not in _DTYPE or b.dtype != a.dtype:
        raise TypeError(f"matmul: dtypes {a.dtype}, {b.dtype} not supported "
                        "(float32 or bfloat16, both the same)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: operands must be contiguous")
    M, K = a.shape
    N = b.shape[0] if transpose_b else b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    lib = load("gemv", _declare)
    err = lib.gm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                        int(transpose_b), _DTYPE[a.dtype],
                        torch.cuda.current_stream(a.device).cuda_stream)
    check_launch("matmul", err)
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *, transpose_b: bool = False,
           tile: int = DEFAULT_T) -> torch.Tensor:
    """Tiled ``a @ b`` (or ``a @ b.T``) with fp32 accumulation, the result
    in ``a.dtype``.  ``tile`` is the TPU kernel's tile bound, accepted for
    the reference's signature and ignored (the CUDA kernel's tiles are
    fixed)."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("matmul takes two matrices")
    K = a.shape[1]
    if (b.shape[1] if transpose_b else b.shape[0]) != K:
        raise ValueError(f"contraction mismatch: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, transpose_b={transpose_b}")
    if a.device.type == "cpu":
        bf = b.to(torch.float32)
        out = a.to(torch.float32) @ (bf.T if transpose_b else bf)
        return out.to(a.dtype)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu, not {a.device}")
    return _launch(a, b, transpose_b)


def gemv(w: torch.Tensor, x: torch.Tensor, *,
         tile: int = DEFAULT_T) -> torch.Tensor:
    """Batched GEMV: ``w`` (m, n), ``x`` (B, n) → (B, m) = x @ w.T."""
    return matmul(x, w, transpose_b=True, tile=tile)
