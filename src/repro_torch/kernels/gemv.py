"""Dense tiled matmul and batched GEMV.

:func:`matmul` computes ``a @ b`` (or ``a @ b.T``) with fp32 accumulation
and the result in ``a``'s dtype (float32 or bfloat16); :func:`gemv` is the
batched matrix–vector product ``x @ w.T`` through it.  On CPU tensors they
run their plain version; on CUDA tensors the hand-written kernels of
``csrc/gemv.cu`` or they raise — the port never hands a product to
cuBLAS.  bfloat16 runs on the tensor cores (``wgmma``), float32 on the CUDA
cores (the parity contract keeps TF32 off).  :func:`plan_matmul` makes
every choice of kernel, tile, staging and split-K, from the shapes, the
dtype, the operands' alignment and the card's SM count.
``LAUNCHES["matmul_wgmma"]`` (bfloat16) and ``LAUNCHES["matmul"]``
(float32) count calls that launched the product kernel (with its split-K
reduction, where there is one).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import check_launch, load

__all__ = ["gemv", "matmul", "plan_matmul", "MatmulPlan", "DEFAULT_T"]

DEFAULT_T = 128
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/gemv.cu's tiles: tc_kernel (bf16) BM x 128 x 64, sg_kernel (fp32)
# BM x 128 x 16, BM = 64 or 128.
TC_BN, TC_BK, SG_BN, SG_BK = 128, 64, 128, 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class MatmulPlan:
    """How ``csrc/gemv.cu`` runs one product.

    ``kernel`` is ``"wgmma"`` (bfloat16, tensor cores) or ``"simt"``
    (float32, CUDA cores); ``staging`` is ``"tma"`` or ``"threads"`` (the
    wgmma kernel's producer fills the ring by TMA or with its own loads) or
    ``"cp.async"`` (simt).  K is cut into ``k_tiles`` tiles of ``bk`` and
    split into ``splits`` slices of whole tiles (:meth:`k_bounds`)."""

    kernel: str
    staging: str
    bm: int
    bn: int
    bk: int
    tiles: int
    k_tiles: int
    splits: int

    def k_bounds(self) -> list[tuple[int, int]]:
        """The k-tiles ``[t0, t1)`` of each slice, in order — the kernel's
        ``gm_slice``."""
        s, n = self.splits, self.k_tiles
        return [(z * n // s, (z + 1) * n // s) for z in range(s)]


def plan_matmul(M: int, N: int, K: int, dtype: torch.dtype, transpose_b: bool,
                a_ptr: int, b_ptr: int, sms: int) -> MatmulPlan:
    """The plan of ``(M, K) @ b`` with b ``(N, K)`` if ``transpose_b`` else
    ``(K, N)``, both contiguous, at data pointers ``a_ptr`` and ``b_ptr``,
    on a card of ``sms`` SMs.

    bfloat16 always takes the wgmma kernel, TMA staging only where both
    bases and both row pitches (2 K bytes for a, 2 K or 2 N for b) are
    multiples of 16 bytes.  float32 takes the simt kernel.  Tiles have 64
    rows when M <= 64, else 128.  Split-K only where the output has fewer tiles
    than the card has SMs: enough slices for one wave, at most one per
    k-tile."""
    bm = 64 if M <= 64 else 128
    if dtype == torch.bfloat16:
        bn, bk, kernel = TC_BN, TC_BK, "wgmma"
        pitch_b = K if transpose_b else N
        aligned = (a_ptr % 16 == 0 and b_ptr % 16 == 0 and (2 * K) % 16 == 0
                   and (2 * pitch_b) % 16 == 0)
        staging = "tma" if aligned else "threads"
    elif dtype == torch.float32:
        bn, bk, kernel, staging = SG_BN, SG_BK, "simt", "cp.async"
    else:
        raise TypeError(f"matmul: dtype {dtype} not supported")
    tiles = _cdiv(M, bm) * _cdiv(N, bn)
    k_tiles = _cdiv(K, bk)
    splits = 1
    if 0 < tiles < sms:
        splits = max(1, min(k_tiles, _cdiv(sms, tiles)))
    return MatmulPlan(kernel, staging, bm, bn, bk, tiles, k_tiles, splits)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gm_launch.argtypes = [vp] * 4 + [ci] * 8 + [vp]
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
    if K == 0:
        return torch.zeros((M, N), dtype=a.dtype, device=a.device)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = plan_matmul(M, N, K, a.dtype, transpose_b, a.data_ptr(),
                       b.data_ptr(), sms)
    ws = (torch.empty((plan.splits, M, N), dtype=torch.float32, device=a.device)
          if plan.splits > 1 else None)
    lib = load("gemv", _declare)
    err = lib.gm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(), M, N, K,
                        int(transpose_b), _DTYPE[a.dtype], plan.bm,
                        int(plan.staging == "tma"), plan.splits,
                        torch.cuda.current_stream(a.device).cuda_stream)
    check_launch("matmul_wgmma" if plan.kernel == "wgmma" else "matmul", err)
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *, transpose_b: bool = False,
           tile: int = DEFAULT_T) -> torch.Tensor:
    """Tiled ``a @ b`` (or ``a @ b.T``) with fp32 accumulation, the result
    in ``a.dtype``.  ``tile`` is the TPU kernel's tile bound, accepted for
    the reference's signature and ignored (the CUDA kernels' tiles are
    :func:`plan_matmul`'s)."""
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
