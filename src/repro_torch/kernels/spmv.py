"""Block-sparse matrix–batch product (SpMV): block-CSR ``x @ W.T``.

:func:`pack_bcsr` cuts W into (bm × bk) tiles on the host, drops the
all-zero ones and lays out the survivors per row block, exactly as the JAX
package's packer does (same tile order, ``j_max``, ``col_idx``, ``valid``).
:func:`spmv` multiplies a batch by the packed weight: on a CPU tensor with
its plain version (the same sum over kept tiles in torch), on a CUDA tensor
by the hand-written kernel ``csrc/spmv.cu``, which reads only the kept
tiles, or it raises.  :func:`plan_spmv` decides the kernel's grid and how
far it splits each row block's kept tiles.  ``LAUNCHES["spmv"]`` counts
calls that launched the kernel (with its reduction, where there is one).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.device import as_tensor, resolve_device
from repro_torch.kernels.build import check_launch, load

__all__ = ["pack_bcsr", "PackedSpmv", "spmv", "plan_spmv", "SpmvPlan",
           "DEFAULT_BM", "DEFAULT_BK", "DEFAULT_BB"]

DEFAULT_BM = 128  # row tile
DEFAULT_BK = 128  # contraction tile
DEFAULT_BB = 128  # batch tile of the TPU kernel
# csrc/spmv.cu's block: 32 batch rows x one 64-row slice of a row block.
SP_BB, SP_BR = 32, 64
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_to(x: np.ndarray, axis: int, mult: int) -> np.ndarray:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


@dataclasses.dataclass(frozen=True)
class PackedSpmv:
    """Packed block-CSR weight on a device: the all-zero (bm × bk) tiles
    dropped."""

    data: torch.Tensor       # (row_blocks, J, bm, bk) surviving tiles (zero-padded)
    col_idx: torch.Tensor    # (row_blocks, J) int32 — column block of each tile
    valid: torch.Tensor      # (row_blocks, J) int32 — 1 for real tiles, 0 padding
    m: int                   # true output rows
    n: int                   # true input cols
    bm: int
    bk: int

    @property
    def row_blocks(self) -> int:
        return self.data.shape[0]

    @property
    def j_max(self) -> int:
        return self.data.shape[1]

    @property
    def density(self) -> float:
        """Fraction of tiles kept — the bandwidth saving vs a dense GEMV."""
        total = self.row_blocks * ((self.n + self.bk - 1) // self.bk)
        return float(self.valid.sum().item()) / max(1, total)


def pack_bcsr(w: np.ndarray, bm: int = DEFAULT_BM, bk: int = DEFAULT_BK, *,
              device: torch.device | str | None = None) -> PackedSpmv:
    """Pack ``w`` (m, n) on the host and place the tiles on ``device``
    (None: the card)."""
    dev = resolve_device(device)
    w = np.asarray(w)
    m, n = w.shape
    wp = _pad_to(_pad_to(w, 0, bm), 1, bk)
    rb, kb = wp.shape[0] // bm, wp.shape[1] // bk
    tiles = wp.reshape(rb, bm, kb, bk).swapaxes(1, 2)       # (rb, kb, bm, bk)
    keep = np.abs(tiles).sum(axis=(2, 3)) != 0               # (rb, kb)
    j_max = max(1, int(keep.sum(axis=1).max()))
    data = np.zeros((rb, j_max, bm, bk), wp.dtype)
    col_idx = np.zeros((rb, j_max), np.int32)
    valid = np.zeros((rb, j_max), np.int32)
    for r in range(rb):
        cols = np.nonzero(keep[r])[0]
        data[r, : len(cols)] = tiles[r, cols]
        col_idx[r, : len(cols)] = cols
        valid[r, : len(cols)] = 1
    return PackedSpmv(
        data=as_tensor(data, dev), col_idx=as_tensor(col_idx, dev),
        valid=as_tensor(valid, dev), m=m, n=n, bm=bm, bk=bk,
    )


def _spmv_plain(packed: PackedSpmv, x: torch.Tensor) -> torch.Tensor:
    """The plain version: each row block sums ``x``'s column block of every
    kept tile times the tile, over the packed layout."""
    B = x.shape[0]
    kb = -(-packed.n // packed.bk)
    xp = torch.nn.functional.pad(x, (0, kb * packed.bk - packed.n))
    xg = xp.reshape(B, kb, packed.bk)[:, packed.col_idx.long()]  # (B, rb, J, bk)
    w = packed.data.to(torch.float32) * packed.valid[..., None, None]
    out = torch.einsum("brjk,rjmk->brm", xg, w)
    return out.reshape(B, -1)[:, :packed.m]


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """How ``csrc/spmv.cu`` runs one product: ``batch_tiles`` × ``slices``
    blocks of 32 batch rows × 64 W rows, ``slices`` counting only the 64-row
    slices of each row block that hold rows below m; each row block's kept
    tiles split into ``splits`` slices of whole tiles (:meth:`tile_bounds`),
    summed in order by a second pass when ``splits`` > 1."""

    batch_tiles: int
    slices: int
    splits: int

    def tile_bounds(self, kept: int) -> list[tuple[int, int]]:
        """The kept tiles ``[t0, t1)`` of each slice of a row block that
        keeps ``kept`` tiles, in order (the kernel's t0, t1)."""
        s = self.splits
        return [(z * kept // s, (z + 1) * kept // s) for z in range(s)]


def plan_spmv(B: int, m: int, bm: int, j_max: int,
              sms: int = H100_SMS) -> SpmvPlan:
    """The plan of a batch of B rows against a packed (m, ·) weight of row
    tile ``bm`` and ``j_max`` tile slots per row block, on ``sms`` SMs: the
    shapes alone decide it.  Splits only where the blocks without a split
    are fewer than the SMs: enough slices for one wave, at most one per
    tile slot."""
    rb = _cdiv(m, bm)
    sub = _cdiv(bm, SP_BR)
    slices = (rb - 1) * sub + _cdiv(m - (rb - 1) * bm, SP_BR) if m else 0
    tiles = _cdiv(B, SP_BB) * slices
    splits = 1
    if 0 < tiles < sms:
        splits = max(1, min(j_max, _cdiv(sms, tiles)))
    return SpmvPlan(_cdiv(B, SP_BB), slices, splits)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sp_launch.argtypes = [vp] * 6 + [ci] * 8 + [vp]
    lib.sp_launch.restype = ci


def _launch(packed: PackedSpmv, x: torch.Tensor) -> torch.Tensor:
    for t in (packed.data, packed.col_idx, packed.valid):
        if t.device != x.device:
            raise ValueError(f"spmv: packed weight on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("spmv: packed tensors must be contiguous")
    if packed.col_idx.dtype != torch.int32 or packed.valid.dtype != torch.int32:
        raise TypeError("spmv: col_idx and valid must be int32")
    if not x.is_contiguous():
        raise ValueError("spmv: x must be contiguous")
    data = packed.data.to(torch.float32)
    B = int(x.shape[0])
    out = torch.empty((B, packed.m), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = plan_spmv(B, packed.m, packed.bm, packed.j_max, sms)
    ws = (torch.empty((plan.splits, B, packed.m), dtype=torch.float32,
                      device=x.device) if plan.splits > 1 else None)
    lib = load("spmv", _declare)
    err = lib.sp_launch(x.data_ptr(), data.data_ptr(), packed.col_idx.data_ptr(),
                        packed.valid.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(), B, packed.n,
                        packed.m, packed.row_blocks, packed.j_max, packed.bm,
                        packed.bk, plan.splits,
                        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("spmv", err)
    return out


def spmv(packed: PackedSpmv, x: torch.Tensor, *,
         bb: int = DEFAULT_BB) -> torch.Tensor:
    """Batched block-sparse product: ``x`` (B, n) → (B, m) = x @ W.T in
    float32.  ``bb`` is the TPU kernel's batch tile, accepted for the
    reference's signature and ignored (the CUDA kernel's tiles are fixed)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (B, n), got {tuple(x.shape)}")
    if x.shape[1] != packed.n:
        raise ValueError(f"x cols {x.shape[1]} != packed n {packed.n}")
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return _spmv_plain(packed, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmv runs on cuda or cpu, not {x.device}")
    return _launch(packed, x)
