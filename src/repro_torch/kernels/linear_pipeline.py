"""Fused linear-time pipeline (paper §IV-G): stage chains in one kernel.

A chain is a compile-time stage program (the :mod:`repro_torch.kernels.ref`
vocabulary) applied to a streaming value: the lowering pipeline's
chain-decompose pass emits one per fused cluster when a program is compiled
with ``use_pallas=True``.  Two variants:

* :func:`fused_linear_chain` — float stages (``ref.apply_stage``);
* :func:`fused_linear_chain_q` — the fixed-point twin on the int32 carrier
  (``ref.apply_stage_q``), saturated to the stream's dtype on the single
  write-back.

On a CPU tensor each runs its plain version (``ref.linear_chain_ref`` /
``ref.linear_chain_q_ref``); on a CUDA tensor it launches the hand-written
kernel ``csrc/linear_chain.cu`` (one generic elementwise kernel per variant
over a packed stage table) or raises.  ``LAUNCHES["linear_chain"]`` and
``LAUNCHES["linear_chain_q"]`` count launches.

The budget half, :func:`chain_vmem_bytes`, prices a chain's resident
footprint for the cost-guided chain splitter
(:func:`repro_torch.core.cost_model.chain_live_bytes`), so the port splits
chains exactly where the reference does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.kernels.build import DTYPE_CODES as _DTYPE
from repro_torch.kernels.build import STAGE_CODES as _STAGE
from repro_torch.kernels.build import UNARY_CODES as _UNARY
from repro_torch.kernels.build import check_launch, load, segment_cache

__all__ = ["DEFAULT_BB", "DEFAULT_BN", "Chain", "chain_ref", "chain_vmem_bytes",
           "fused_linear_chain", "fused_linear_chain_q", "pack_chain",
           "run_chain", "set_tuned_tiles", "tuned_tiles"]

DEFAULT_BB = 256   # batch tile
DEFAULT_BN = 512   # feature tile

# Process-wide tile override (the reference's autotuner installs one);
# tiling never changes per-element arithmetic.
_TUNED: dict[str, int] = {}


def set_tuned_tiles(bb: int | None = None, bn: int | None = None) -> None:
    """Install (or with both None, clear) the process-wide tuned tile sizes
    used when a chain call does not pass ``bb``/``bn`` explicitly."""
    _TUNED.clear()
    if bb is not None:
        _TUNED["bb"] = int(bb)
    if bn is not None:
        _TUNED["bn"] = int(bn)


def tuned_tiles() -> tuple[int, int]:
    """The effective default ``(bb, bn)`` — tuned override or the builtins."""
    return _TUNED.get("bb", DEFAULT_BB), _TUNED.get("bn", DEFAULT_BN)


def chain_vmem_bytes(n: int, n_vec: int, n_arr: int, *,
                     bb: int | None = None, bn: int | None = None,
                     itemsize: int = 4) -> int:
    """Peak bytes one fused-chain launch keeps resident: the stream tile,
    the output tile and one ``(bb, bn)`` tile per ``*_arr`` extra, plus one
    ``(1, bn)`` row per ``*_vec`` operand — the unit of the chain splitter's
    ``chain_split_bytes`` budget."""
    tb, tn = tuned_tiles()
    bb = tb if bb is None else bb
    bn = tn if bn is None else bn
    bn_eff = min(bn, max(128, 1 << max(0, int(n) - 1).bit_length()))
    return (2 + n_arr) * bb * bn_eff * itemsize + n_vec * bn_eff * itemsize


# ------------------------------------------------------------------ kernel
_NI, _NF = 6, 4
_FLOAT_VEC = ("add_vec", "sub_vec", "hadamard_vec")


@dataclasses.dataclass(frozen=True, eq=False)
class Chain:
    """A stage program with its static operands: float ``stages`` embed
    their ``*_vec`` operands; ``q_*`` stages index ``vecs``.  Device data
    derived from it (the kernel's pack, the plain version's operands) is
    made once per device and lives as long as the object."""

    stages: tuple[Any, ...]
    vecs: tuple[Any, ...] = ()
    quantized: bool = False
    bits: int = 8


def _host(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def pack_chain(chain: Chain) -> dict[str, Any]:
    """Host-side packing of ``chain`` into the kernel's int32 stage table,
    float side table and one pool of 32-bit vec words (numpy)."""
    carrier = np.int32 if chain.quantized else np.float32
    pool: list[np.ndarray] = []
    words = 0

    def vec(v: Any) -> tuple[int, int]:
        nonlocal words
        a = _host(v).astype(carrier).reshape(-1)
        pool.append(a)
        words += a.size
        return words - a.size, a.size

    rows, frows = [], []
    vec_at = [vec(v) for v in chain.vecs] if chain.quantized else []
    for name, sop in chain.stages:
        if name not in _STAGE or name.startswith("q_") != chain.quantized:
            raise ValueError(f"stage {name!r} is not in the "
                             f"{'fixed-point' if chain.quantized else 'float'} "
                             "chain vocabulary")
        t = [_STAGE[name], 0, 0, 0, 0, 0]
        g = [0.0] * _NF
        if name == "scalar_mul":
            g[0] = float(np.float32(sop))
        elif name in _FLOAT_VEC:
            t[1], t[2] = vec(sop)
        elif name.endswith("_arr") and not name.startswith("q_"):
            t[1] = int(sop)
        elif name == "q_scalar_mul":
            t[3], t[4] = int(sop[0]), int(sop[1])
        elif name in ("q_add_vec", "q_sub_vec", "q_add_arr", "q_sub_arr"):
            i, sa, sb, rq = sop
            t[3], t[4], t[5] = int(sa), int(sb), int(rq)
            t[1], t[2] = vec_at[i] if name.endswith("_vec") else (int(i), 0)
        elif name in ("q_hadamard_vec", "q_hadamard_arr"):
            i, rq = sop
            t[5] = int(rq)
            t[1], t[2] = vec_at[i] if name.endswith("_vec") else (int(i), 0)
        elif name == "q_unary":
            uname, e_in, e_out = sop
            t[3] = _UNARY[uname]
            g[1], g[2] = 2.0 ** (-e_in), 2.0 ** e_out
        rows.append(t)
        frows.append(g)
    vecs = np.concatenate(pool) if pool else np.zeros(1, carrier)
    return dict(table=np.asarray(rows, np.int32).reshape(-1, _NI),
                ftable=np.asarray(frows, np.float32).reshape(-1, _NF),
                vecs=vecs, n_stages=len(rows),
                vec_lens=tuple(a.size for a in pool))


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    pvp, pci = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    lib.lc_launch_float.argtypes = [vp, vp, ci, vp, vp, vp, pvp, pci, ci,
                                    cl, ci, vp]
    lib.lc_launch_q.argtypes = [vp, vp, ci, vp, vp, vp, ci, pvp, pci, ci,
                                cl, ci, ci, vp]
    lib.lc_launch_float.restype = lib.lc_launch_q.restype = ci
    lib.lc_max_stages.restype = lib.lc_max_arr.restype = ci


def _device_pack(chain: Chain, device: torch.device) -> dict[str, Any]:
    h = pack_chain(chain)
    for k in ("table", "ftable", "vecs"):
        h[k] = torch.from_numpy(h[k]).to(device)
    return h


def _launch(chain: Chain, x: torch.Tensor,
            extras: Sequence[torch.Tensor]) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel."""
    name = "linear_chain_q" if chain.quantized else "linear_chain"
    dts = ((torch.int8, torch.int16, torch.int32) if chain.quantized
           else (torch.float32,))
    for t in (x, *extras):
        if t.device != x.device:
            raise ValueError(f"{name}: operand on {t.device}, stream on {x.device}")
        if t.dtype not in dts:
            raise TypeError(f"{name}: dtype {t.dtype} not supported")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.shape != x.shape:
            raise ValueError(f"{name}: extra of shape {tuple(t.shape)}, "
                             f"stream {tuple(x.shape)}")
    pk = segment_cache("chain", chain, x.device,
                       lambda: _device_pack(chain, x.device))
    n = int(x.shape[-1]) if x.dim() else 1
    if any(w not in (1, n) for w in pk["vec_lens"]):
        raise ValueError(f"{name}: vec operands must have length 1 or {n}")
    lib = load("linear_chain", _declare)
    if pk["n_stages"] > lib.lc_max_stages() or len(extras) > lib.lc_max_arr():
        raise ValueError(f"{name}: more stages or extras than the kernel takes")
    out = torch.empty_like(x)
    arr_p = (ctypes.c_void_p * max(1, len(extras)))(*[e.data_ptr() for e in extras])
    arr_d = (ctypes.c_int * max(1, len(extras)))(*[_DTYPE[e.dtype] for e in extras])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    common = (pk["table"].data_ptr(), pk["ftable"].data_ptr(), pk["n_stages"],
              pk["vecs"].data_ptr(), x.data_ptr(), out.data_ptr())
    if chain.quantized:
        err = lib.lc_launch_q(*common, _DTYPE[x.dtype], arr_p, arr_d,
                              len(extras), x.numel(), n, chain.bits, stream)
    else:
        err = lib.lc_launch_float(*common, arr_p, arr_d, len(extras),
                                  x.numel(), n, stream)
    check_launch(name, err)
    return out


def chain_ref(chain: Chain, x: torch.Tensor,
           extras: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain version of :func:`run_chain` (``ref.linear_chain_ref`` or
    ``ref.linear_chain_q_ref``), with the static operands as tensors on
    ``x``'s device, made once per chain and device."""
    from repro_torch.kernels.ref import linear_chain_q_ref, linear_chain_ref

    def operands():
        if chain.quantized:
            return [torch.from_numpy(_host(v)).to(x.device) for v in chain.vecs]
        return [(n, torch.from_numpy(_host(s).astype(np.float32)).to(x.device)
                 if n in _FLOAT_VEC else
                 float(np.float32(s)) if n == "scalar_mul" else s)
                for n, s in chain.stages]

    ops = segment_cache("chain_ref", chain, x.device, operands)
    if chain.quantized:
        return linear_chain_q_ref(x, chain.stages, ops, extras, bits=chain.bits)
    return linear_chain_ref(x, ops, extras)


def run_chain(chain: Chain, x: torch.Tensor,
              extras: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Apply ``chain`` to ``x`` (any rank ≥ 1; the last axis is the feature
    axis, leading axes flatten onto rows).  ``extras`` are shaped like
    ``x``.  A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises."""
    if x.device.type == "cpu":
        return chain_ref(chain, x, extras)
    if x.device.type != "cuda":
        raise ValueError(f"the chain kernels run on cuda or cpu, not {x.device}")
    return _launch(chain, x, list(extras))


def fused_linear_chain(x: torch.Tensor, stages: Sequence[Any],
                       extras: Sequence[torch.Tensor] = (), *,
                       bb: int | None = None,
                       bn: int | None = None) -> torch.Tensor:
    """Apply a float stage chain to ``x`` in one fused kernel.

    ``stages`` operands: scalars stay static; ``*_vec`` operands are (n,)
    arrays (or length 1); ``*_arr`` operands index ``extras`` (each shaped
    like ``x``).  ``bb``/``bn`` are the TPU kernel's tiles, accepted for
    the reference's signature and ignored: the CUDA kernel runs one thread
    per element, and tiling never changes per-element arithmetic."""
    return run_chain(Chain(tuple(stages)), x, extras)


def fused_linear_chain_q(x: torch.Tensor, stages: Sequence[Any],
                         vecs: Sequence[Any] = (),
                         extras: Sequence[torch.Tensor] = (), *,
                         bits: int = 8, bb: int | None = None,
                         bn: int | None = None) -> torch.Tensor:
    """Apply a fixed-point stage chain to the int8/int16 stream ``x`` in
    one fused kernel: ``q_*`` stages whose ``*_vec`` operands index
    ``vecs`` and ``*_arr`` operands index ``extras``; every value rides the
    int32 carrier and the result is saturated to ``x``'s dtype on the
    single write-back.  ``bb``/``bn`` are accepted and ignored, as in
    :func:`fused_linear_chain`."""
    return run_chain(Chain(tuple(stages), tuple(vecs), True, bits), x, extras)
