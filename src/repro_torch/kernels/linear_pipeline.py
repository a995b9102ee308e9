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
kernel ``csrc/linear_chain.cu`` (one generic kernel per variant; the stage
table and every operand arrive in one bulk-copy round trip, laid out by
:func:`plan_chain`) or raises.  What no operand
changes is resolved once per chain and device; a call checks its operands
and makes one ctypes call.  ``LAUNCHES["linear_chain"]`` and
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

__all__ = ["DEFAULT_BB", "DEFAULT_BN", "Chain", "ChainPlan", "chain_ref",
           "chain_vmem_bytes", "fused_linear_chain", "fused_linear_chain_q",
           "pack_chain", "plan_chain", "run_chain", "set_tuned_tiles",
           "tuned_tiles"]

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
_FLOAT_VEC = ("add_vec", "sub_vec", "hadamard_vec")

# csrc/linear_chain.cu's limits and block shape
LC_MAX_STAGES, LC_MAX_ARR = 64, 16
LC_THREADS = 256     # threads of a block at most
LC_RUN = 4           # consecutive elements a thread takes at a time
# A block's shared memory at most (operands and staged vecs): two blocks
# fit an SM.  The vec pool is staged in shared memory up to LC_VEC_SMEM
# bytes; a larger pool is read from global memory.
LC_SMEM = 96 * 1024
LC_VEC_SMEM = 48 * 1024
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


# csrc/linear_chain.cu's LcStage: a row of the stage table (code, operand,
# vec length, p0..p2; scalar, s_in, s_out, -)
STAGE_ROW = np.dtype([("i", "<i4", 6), ("f", "<f4", 4)])


class LcChain(ctypes.Structure):
    """``csrc/linear_chain.cu``'s ``LcChain``: the addresses of the stage
    table and of the vec pool on the device, the stage count, bits, the
    table's and the pool's bytes and the variant."""

    _fields_ = [("table", ctypes.c_void_p), ("vecs", ctypes.c_void_p),
                ("n_stages", ctypes.c_int32), ("bits", ctypes.c_int32),
                ("table_bytes", ctypes.c_int32), ("vec_bytes", ctypes.c_int32),
                ("quantized", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _Op(ctypes.Structure):
    _fields_ = [("dt", ctypes.c_int32), ("sh", ctypes.c_int32),
                ("head", ctypes.c_int32), ("off", ctypes.c_int32)]


class LcPlan(ctypes.Structure):
    """``csrc/linear_chain.cu``'s ``LcPlan``: a :class:`ChainPlan` with, per
    operand, its dtype code and base address mod 16."""

    _fields_ = [("chunk", ctypes.c_int32), ("blocks", ctypes.c_int32),
                ("threads", ctypes.c_int32), ("smem", ctypes.c_int32),
                ("n_ops", ctypes.c_int32), ("vec_at", ctypes.c_int32),
                ("op", _Op * (LC_MAX_ARR + 1))]


def _padded(a: np.ndarray) -> np.ndarray:
    """``a``'s bytes, zero-padded to a multiple of 16 (a bulk copy's unit)."""
    raw = np.frombuffer(a.tobytes(), np.uint8)
    return np.concatenate([raw, np.zeros(-raw.size % 16, np.uint8)])


def pack_chain(chain: Chain) -> dict[str, Any]:
    """Host-side packing of ``chain`` for the kernel (numpy): ``table``, the
    stage table (``STAGE_ROW`` rows), and ``vecs``, one pool of 32-bit words
    (float32 or int32), each as bytes padded to 16; ``params``, the
    ``LcChain`` with the device addresses left 0; ``vec_lens`` (each vec's
    length) and ``n_arr`` (the extras the chain reads).  Raises ValueError
    on a stage of the other vocabulary or beyond the kernel's limits
    (``LC_MAX_STAGES`` stages, ``LC_MAX_ARR`` extras)."""
    carrier = np.int32 if chain.quantized else np.float32
    pool: list[np.ndarray] = []
    words = 0

    def vec(v: Any) -> tuple[int, int]:
        nonlocal words
        a = _host(v).astype(carrier).reshape(-1)
        pool.append(a)
        words += a.size
        return words - a.size, a.size

    if len(chain.stages) > LC_MAX_STAGES:
        raise ValueError(f"a chain of {len(chain.stages)} stages: the kernel "
                         f"takes at most {LC_MAX_STAGES}")
    rows = np.zeros(len(chain.stages), STAGE_ROW)
    n_arr = 0
    vec_at = [vec(v) for v in chain.vecs] if chain.quantized else []
    for r, (name, sop) in enumerate(chain.stages):
        if name not in _STAGE or name.startswith("q_") != chain.quantized:
            raise ValueError(f"stage {name!r} is not in the "
                             f"{'fixed-point' if chain.quantized else 'float'} "
                             "chain vocabulary")
        t = [_STAGE[name], 0, 0, 0, 0, 0]
        g = [0.0] * 4
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
        if name.endswith("_arr"):
            n_arr = max(n_arr, t[1] + 1)
        rows[r] = (t, g)
    if n_arr > LC_MAX_ARR:
        raise ValueError(f"a chain reading {n_arr} extras: the kernel takes "
                         f"at most {LC_MAX_ARR}")
    table = _padded(rows)
    vecs = _padded(np.concatenate(pool) if pool else np.zeros(0, carrier))
    params = LcChain(n_stages=len(rows), bits=int(chain.bits),
                     table_bytes=table.size, vec_bytes=vecs.size,
                     quantized=int(chain.quantized))
    return dict(params=params, table=table, vecs=vecs, n_arr=n_arr,
                vec_lens=tuple(a.size for a in pool))


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """How ``csrc/linear_chain.cu`` runs one call.  Block b takes elements
    ``[b * chunk, min((b + 1) * chunk, numel))`` of the flattened stream and
    the same elements of every extra, with ``threads`` threads of
    ``LC_RUN`` elements at a time.  Operand k (the stream, then the extras)
    lands in shared memory from byte ``regions[k]`` + its base address mod
    16: its elements from ``heads[k]`` of a chunk on start on a 16-byte
    boundary and arrive by one bulk copy of whole 16-byte units, the rest
    by the threads' own loads.  The vec pool sits at ``vec_at`` (-1: read
    from global memory).  ``smem`` bytes in all."""

    chunk: int
    blocks: int
    threads: int
    heads: tuple[int, ...]
    regions: tuple[int, ...]
    vec_at: int
    smem: int


def plan_chain(numel: int, itemsizes: Sequence[int], offsets: Sequence[int],
               vec_bytes: int = 0, sms: int = H100_SMS) -> ChainPlan:
    """The plan of a chain call over ``numel`` elements whose operands (the
    stream, then the extras) have ``itemsizes`` bytes an element and base
    addresses ``offsets`` mod 16, with a vec pool of ``vec_bytes``.

    Chunks are a multiple of 16 bytes of every operand, so every block sees
    the same alignment.  A stream of up to ``LC_THREADS * LC_RUN`` elements
    is one block (one turn of its threads); a longer one is cut into at most
    ``sms`` chunks, one wave, unless the operands' shared memory
    (``LC_SMEM`` in all) makes chunks smaller."""
    if len(itemsizes) != len(offsets) or not 1 <= len(itemsizes) <= LC_MAX_ARR + 1:
        raise ValueError(f"linear_chain: {len(itemsizes)} operands "
                         f"(1 to {LC_MAX_ARR + 1}), {len(offsets)} offsets")
    if any(s not in (1, 2, 4) or o % s for s, o in zip(itemsizes, offsets)):
        raise ValueError(f"linear_chain: item sizes {tuple(itemsizes)} with "
                         f"offsets {tuple(offsets)}")
    g = 16 // min(itemsizes)
    staged = 0 < vec_bytes <= LC_VEC_SMEM
    room = LC_SMEM - 16 * len(itemsizes) - (vec_bytes if staged else 0)
    cap = max(g, room // sum(itemsizes) // g * g)
    if numel <= LC_THREADS * LC_RUN:
        chunk = max(g, _cdiv(numel, g) * g)
    else:
        chunk = _cdiv(_cdiv(numel, sms), g) * g
    chunk = min(chunk, cap)
    regions, at = [], 0
    for s in itemsizes:
        regions.append(at)
        at += chunk * s + 16
    return ChainPlan(
        chunk=chunk, blocks=max(1, _cdiv(numel, chunk)),
        threads=min(LC_THREADS, _cdiv(_cdiv(chunk, LC_RUN), 32) * 32),
        heads=tuple((16 - o) % 16 // s for o, s in zip(offsets, itemsizes)),
        regions=tuple(regions), vec_at=at if staged else -1,
        smem=at + (vec_bytes if staged else 0))


_ITEM = {0: 4, 1: 4, 2: 1, 3: 2}     # dtype code -> bytes an element


def _plan_struct(numel: int, sig: Sequence[int], vec_bytes: int,
                 sms: int = H100_SMS) -> LcPlan:
    """The kernel's ``LcPlan`` for operands whose ``sig`` is dtype code * 16
    + base address mod 16, the stream first."""
    codes, offsets = [c >> 4 for c in sig], [c & 15 for c in sig]
    plan = plan_chain(numel, [_ITEM[c] for c in codes], offsets, vec_bytes, sms)
    s = LcPlan(chunk=plan.chunk, blocks=plan.blocks, threads=plan.threads,
               smem=plan.smem, n_ops=len(sig), vec_at=plan.vec_at)
    for k, op in enumerate(zip(codes, offsets, plan.heads, plan.regions)):
        s.op[k] = op
    return s


def _declare(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.lc_launch.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong,
                              ctypes.c_int, vp]
    lib.lc_launch.restype = lib.lc_launch_empty.restype = ctypes.c_int
    lib.lc_launch_empty.argtypes = [vp]
    lib.lc_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.lc_layout.restype = None
    got = (ctypes.c_int * 7)()
    lib.lc_layout(got)
    want = [ctypes.sizeof(LcChain), LcChain.n_stages.offset,
            ctypes.sizeof(LcPlan), LcPlan.op.offset, STAGE_ROW.itemsize,
            LC_MAX_STAGES, LC_MAX_ARR]
    if list(got) != want:
        raise RuntimeError(f"csrc/linear_chain.cu's layout {list(got)} is not "
                           f"the wrapper's {want}")


def _device_pack(chain: Chain, device: torch.device) -> dict[str, Any]:
    """Everything a call of ``chain`` on ``device`` needs that no operand
    changes: the library, the stage table and the vec pool on the device
    and the ``LcChain`` that points at them, the dtypes it takes, and caches
    of the checked widths and of the plans by (numel, dtypes, offsets)."""
    h = pack_chain(chain)
    lib = load("linear_chain", _declare)
    table, vecs = (torch.from_numpy(a if a.size else np.zeros(16, np.uint8))
                   .to(device) for a in (h["table"], h["vecs"]))
    params = h["params"]
    params.table, params.vecs = table.data_ptr(), vecs.data_ptr()
    return dict(
        lib=lib, table=table, vecs=vecs, params=params,
        addr=ctypes.addressof(params), vec_bytes=params.vec_bytes,
        vec_lens=h["vec_lens"], n_arr=h["n_arr"],
        name="linear_chain_q" if chain.quantized else "linear_chain",
        codes={d: _DTYPE[d] for d in ((torch.int8, torch.int16, torch.int32)
                                      if chain.quantized else (torch.float32,))},
        widths=set(), plans={})


_raw_stream = None


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream."""
    global _raw_stream
    if _raw_stream is None:
        get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        _raw_stream = get or (lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(device.index)


def _reject(name: str, x: torch.Tensor, t: torch.Tensor,
            codes: dict[torch.dtype, int]) -> None:
    """Raise the error an operand ``t`` the kernel does not take earns."""
    if t.device != x.device:
        raise ValueError(f"{name}: operand on {t.device}, stream on {x.device}")
    if t.dtype not in codes:
        raise TypeError(f"{name}: dtype {t.dtype} not supported")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")
    raise ValueError(f"{name}: extra of shape {tuple(t.shape)}, stream "
                     f"{tuple(x.shape)}")


def _launch(chain: Chain, x: torch.Tensor,
            extras: Sequence[torch.Tensor]) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel with
    one ctypes call; what no operand changes comes from the chain's pack,
    the plan from a cache keyed by (numel, dtypes, base addresses mod 16)."""
    dev, shape = x.device, x.shape
    pk = segment_cache("chain", chain, dev, lambda: _device_pack(chain, dev))
    codes = pk["codes"]
    ptrs, sig = [], [x.numel()]
    for t in (x, *extras):
        c = codes.get(t.dtype)
        if c is None or t.device != dev or t.shape != shape or not t.is_contiguous():
            _reject(pk["name"], x, t, codes)
        p = t.data_ptr()
        ptrs.append(p)
        sig.append(c << 4 | p & 15)
    if not pk["n_arr"] <= len(extras) <= LC_MAX_ARR:
        raise ValueError(f"{pk['name']}: {len(extras)} extras for a chain "
                         f"reading {pk['n_arr']} (at most {LC_MAX_ARR})")
    n = int(shape[-1]) if shape else 1
    if n not in pk["widths"]:
        if any(w not in (1, n) for w in pk["vec_lens"]):
            raise ValueError(f"{pk['name']}: vec operands must have length 1 "
                             f"or {n}")
        pk["widths"].add(n)
    key = tuple(sig)
    plan = pk["plans"].get(key)
    if plan is None:
        if len(pk["plans"]) >= 64:         # shapes and offsets seldom vary
            pk["plans"].clear()
        plan = pk["plans"][key] = _plan_struct(
            sig[0], sig[1:], pk["vec_bytes"],
            torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty_like(x)
    err = pk["lib"].lc_launch(
        pk["addr"], ctypes.addressof(plan), ptrs[0], out.data_ptr(),
        (ctypes.c_void_p * max(1, len(extras)))(*ptrs[1:]), sig[0], n,
        _stream(dev))
    check_launch(pk["name"], err)
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
    the reference's signature and ignored: :func:`plan_chain` cuts the
    stream for the card, and tiling never changes per-element arithmetic."""
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
