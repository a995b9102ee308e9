"""Time kernels on the card under other plans and variants than their own.

    PYTHONPATH=src python -m repro_torch.launch.profile_kernels [--chains | --chain-trace | --flash-bwd | --served-attention | --bwd-ab]

First the chain kernels (``csrc/linear_chain.cu``): the launch floor (an
empty kernel with the chain kernels' parameter block) and the six served
chain calls (bonsai/curet-m's two chains and protonn/curet-m's, float32 and
int8, a bucket of 64), with protonn's stages one at a time: device time,
time per call between CUDA events, host time to enqueue a call, byte bound
(``--chains`` stops here, and runs on an older tree too); the six calls on
variants of the kernel (``_CHAIN_VARIANTS``: the stage dispatched by a
switch per element, cp.async by every thread in place of the bulk copies);
and SM cycles of each phase of block 0 from a clock-stamped build, beside
the floors of a call with no launch and with an empty kernel
(``--chain-trace`` stops here).  Then decode attention at qwen2.5-3b's
decode shape (B 8, S 2048, H 16, KV 2,
dh 128), float32 and bfloat16, at the lengths of ``chip_smoke.py``'s last
served decode step, at full caches and with every length 1, for chunks of
32 to 2048 keys (``plan_decode`` picks 32); spmv on bonsai/curet-m's Zx
(24 × 610) and on a 4096² weight keeping 10 % of its 128² tiles, batch 64,
for every split count up to the tile slots (``plan_spmv`` picks by its
wave rule).  The megakernel on the four served cells (bonsai/curet-m and
protonn/curet-m, float32 and int8, a bucket of 64 and one sample) as
packed, with every matrix read from global memory (no ``LOAD_MAT``
buffers), and with a barrier before every instruction; and the float32
flash kernel at qwen2.5-3b's 1,024-token prefill (B 1, H 16, KV 2, dh 128,
causal) as it runs and with k and v staged by element loads instead of
cp.async.  ``--flash-bwd`` runs only the flash backward: ``ptxas``'s
registers and spills of its kernels (the instances with p rounded to
bfloat16 marked); both routes (``flash_attention_bwd``
as it routes the call, and with ``route="simt"``) against the plain version on
qwen2.5-3b's heads (causal, a window of 256, full), G 1, G 128, dh 64, and
the DHP 256 and whole-token shapes (deepseek-v2's MLA, zamba2's dh 224 with
its window, internvl2's G 6, G 7, dh 256), bfloat16 and float32 (the
tensor cores: two scaled fp16 terms of each operand; the float32 limits),
and float32 with q and k five times larger at qwen2.5-3b's and internvl2's
heads, S 4,096 (``BWD_PEAKED``), two calls bitwise equal; then float32 with
q and k 8, 12 and 16 times larger at the four ``BWD_HEADS``, S 1,024,
against the plain version and the exact gradient (float64), a reading
held to nothing (``BWD_PEAKS``); then each route at ``BWD_HEADS``
(qwen2.5-3b's, MLA, zamba2's, internvl2's), causal, S 4,096 and 1,024,
bfloat16 and float32: time per call between CUDA events
and each kernel's device time, beside the five-product bound (float32: at
the fp32 peak, and on the tensor cores three 16-bit products for each of
the five, and the products the kernels issue, as ``fbt_query`` states
them) and SDPA's backward alone (k and v expanded over G).
``--served-attention`` runs only the served attention kernels at
``PERF.md`` §6's shapes (flash forward, p fp32, B 1, S 1,024, causal, at
every served head shape; decode at B 8, S 2,048 and the served lengths),
bfloat16 and float32: device time and time per call; then internvl2's G 6
in bfloat16 at S 1,024 and 4,096 on both forward kernels (``fa_tc_kernel``
as the call routes, ``fa_kernel`` through the library's own entry) beside
SDPA; it uses only entry points that every tree with the flash window
has, so ``PYTHONPATH=<tree>/src python
src/repro_torch/launch/profile_kernels.py --served-attention`` times an
older tree's kernels in the same call.  ``--bwd-ab`` does the same for
the training attention: the backward at qwen2.5-3b's heads (bfloat16 and
float32) and internvl2's (float32), S 4,096 and 1,024, zamba2's and the
MLA's (float32, S 1,024: ``fb_*`` in trees before the float32 DHP-256
route), at qwen2.5-3b's heads also with p rounded to bfloat16 (bfloat16
on the tensor cores in trees that have that route; else, and float32
always, ``fb_*``), and the forward at
qwen2.5-3b's heads, bfloat16, S 4,096, p fp32, rounded against a key
tile's running max and rounded to bfloat16 (the row's max in trees that
have it): time per call
and device time, and a digest of each output (equal digests: bitwise equal
outputs) — run it once per tree, parent, change, change, parent.  Then the megakernel's
walk instruction by instruction: SM cycles from clock stamps in a build of
``csrc/megakernel.cu`` that adds them (thread 0 of block 0, a bucket of
64).  These variants say what dominates each kernel.  Each line gives the device time
of each kernel of a call, from a ``torch.profiler`` trace of 50 calls, per
call.  Needs a card; it exits with 1 without one.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import torch

SERVED_LENS = [905, 689, 562, 319, 357, 88, 122, 63]
CHUNKS = (32, 64, 128, 256, 2048)


def device_parts(fn, reps: int = 50) -> dict[str, float]:
    """Device ms per call of each kernel (and copy) ``fn`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts: dict[str, float] = {}
    for e in p.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0].split("<")[0].replace("void ", "")
            parts[name] = parts.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return parts


def _fmt(parts: dict[str, float]) -> str:
    return ", ".join(f"{k} {v:.5f}" for k, v in parts.items()) + \
        f"; total {sum(parts.values()):.5f} ms"


def profile_decode(dev: torch.device) -> None:
    from repro_torch.kernels import decode_attention as da

    planned = da.plan_decode
    for dt in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
                   for s in ((8, 16, 128), (8, 2048, 2, 128), (8, 2048, 2, 128)))
        for name, lens in (("served", SERVED_LENS), ("full", [2048] * 8),
                           ("every length 1", [1] * 8)):
            for chunk in CHUNKS:
                def plan(B, KV, G, S, dh, dtype, sms=132, window=0,
                         chunk=chunk):
                    p = planned(B, KV, G, S, dh, dtype, sms)
                    return da.DecodePlan(chunk, -(-S // chunk), p.warps, p.rows)
                with mock.patch.object(da, "plan_decode", plan):
                    parts = device_parts(
                        lambda: da.decode_attention(q, k, v, lens, round_p=False))
                print(f"decode_attention {str(dt)[6:]} {name} lens, chunk "
                      f"{chunk}: {_fmt(parts)}", flush=True)


def profile_spmv(dev: torch.device) -> None:
    from repro_torch.configs.classical import build
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmv as sp

    zx = next(np.asarray(n.params["matrix"], np.float32)
              for n in build("bonsai/curet-m")[0].nodes.values() if n.id == "Zx")
    g = torch.Generator(device=dev).manual_seed(6)
    w = torch.randn((4096, 4096), generator=g, device=dev)
    keep = torch.rand((32, 32), generator=g, device=dev) < 0.1
    w = (w * keep.repeat_interleave(128, 0).repeat_interleave(128, 1)).cpu().numpy()
    planned = sp.plan_spmv
    for label, wn in (("Zx (24, 610)", zx), ("(4096, 4096) at 10 %", w)):
        packed = ops.pack_bcsr(wn, device=dev)
        x = torch.randn((64, wn.shape[1]), generator=g, device=dev)
        own = planned(64, packed.m, packed.bm, packed.j_max)
        for splits in range(1, packed.j_max + 1):
            def plan(B, m, bm, j_max, sms=132, splits=splits):
                p = planned(B, m, bm, j_max, sms)
                return sp.SpmvPlan(p.batch_tiles, p.slices, splits)
            with mock.patch.object(sp, "plan_spmv", plan):
                parts = device_parts(lambda: ops.spmv(packed, x))
            mark = " (the plan's)" if splits == own.splits else ""
            print(f"spmv {label} B=64, {splits} splits{mark}: {_fmt(parts)}",
                  flush=True)


def profile_megakernel(dev: torch.device) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels import megakernel as mk
    from repro_torch.serve.classical_engine import get_program

    packer = mk.pack_segment

    def every_barrier(seg):
        h = packer(seg)
        h["instrs"] = h["instrs"].copy()
        h["instrs"][:, 12] |= mk.MK_SYNC
        return h

    def from_global(seg):
        with mock.patch.object(mk, "SMEM_WORDS", 0):
            return packer(seg)

    for bench in ("bonsai/curet-m", "protonn/curet-m"):
        for prec in ("float32", "int8"):
            prog = get_program(bench, precision=prec,
                               exec_mode="megakernel_grid", device=dev)
            (seg,) = prog.plan.megakernel.segments
            (name, spec), = prog.dfg.graph_inputs.items()
            g = torch.Generator(device=dev).manual_seed(3)
            x = torch.randn((64,) + tuple(spec.shape), generator=g, device=dev)
            if prec != "float32":
                from repro_torch.core.quantize import quantize_t
                x = quantize_t(x, prog.plan.input_exps[name], prog.plan.bits)
            x = x.reshape(64, -1).contiguous()
            def repack():                  # drop the segment's cached pack
                for key in [k for k in build._CACHE
                            if k[0] == "pack" and k[1] == id(seg)]:
                    del build._CACHE[key]

            for variant, pack in (("as packed", packer),
                                  ("matrices from global memory", from_global),
                                  ("a barrier before every instruction",
                                   every_barrier)):
                for nb in (64, 1):
                    repack()
                    with mock.patch.object(mk, "pack_segment", pack):
                        parts = device_parts(
                            lambda: mk.run_segment_grid(seg, [x[:nb]]))
                    print(f"megakernel {bench} {prec} nb={nb}, {variant}: "
                          f"{_fmt(parts)}", flush=True)
            repack()


# The clock64 trace of csrc/megakernel.cu: thread 0 of block 0 stamps the
# SM clock at the start of every instruction and after the last one.
_TRACE_PATCHES = (
    ("__global__ void mk_segment_kernel(",
     "__device__ long long mk_trace[1024];\n"
     "extern \"C\" int mk_read_trace(long long* host, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, mk_trace, n * sizeof(long long));\n"
     "}\n__global__ void mk_segment_kernel("),
    ("    if (flags & MK_SYNC) __syncthreads();\n",
     "    if (flags & MK_SYNC) __syncthreads();\n"
     "    if (tid == 0 && b == 0) mk_trace[p] = clock64();\n"),
    ("      default:\n        break;\n    }\n  }\n}",
     "      default:\n        break;\n    }\n  }\n  __syncthreads();\n"
     "  if (tid == 0 && b == 0) mk_trace[n_instr] = clock64();\n}"),
)


def profile_megakernel_trace(dev: torch.device) -> None:
    """SM cycles of each instruction of one sample's walk (block 0 of a
    bucket of 64), from a build of csrc/megakernel.cu with clock stamps
    added; the kernel is otherwise the one the port runs."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import megakernel as mk
    from repro_torch.serve.classical_engine import get_program

    lib = _patched_build("megakernel", _TRACE_PATCHES, "mk_trace")
    mk._declare(lib)
    lib.mk_read_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    names = {v: k for k, v in mk._OPC.items() if k != "SPMV"}
    saved = build._LIBS.get("megakernel")
    build._LIBS["megakernel"] = lib
    try:
        for bench, prec in (("bonsai/curet-m", "float32"), ("bonsai/curet-m", "int8"),
                            ("protonn/curet-m", "float32")):
            prog = get_program(bench, precision=prec, exec_mode="megakernel_grid",
                               device=dev)
            (seg,) = prog.plan.megakernel.segments
            (name, spec), = prog.dfg.graph_inputs.items()
            g = torch.Generator(device=dev).manual_seed(3)
            x = torch.randn((64,) + tuple(spec.shape), generator=g, device=dev)
            if prec != "float32":
                from repro_torch.core.quantize import quantize_t
                x = quantize_t(x, prog.plan.input_exps[name], prog.plan.bits)
            x = x.reshape(64, -1).contiguous()
            for key in [k for k in build._CACHE if k[0] == "pack" and k[1] == id(seg)]:
                del build._CACHE[key]
            for _ in range(3):
                mk.run_segment_grid(seg, [x])
            torch.cuda.synchronize()
            pk = mk.pack_segment(seg)
            n = pk["n_instr"]
            stamps = (ctypes.c_longlong * (n + 1))()
            if lib.mk_read_trace(ctypes.addressof(stamps), n + 1):
                raise RuntimeError("megakernel trace: reading the stamps failed")
            cyc = np.diff(np.array(list(stamps)))
            print(f"megakernel trace {bench} {prec}, block 0 of 64: "
                  f"{int(stamps[n] - stamps[0])} SM cycles", flush=True)
            for i, f in enumerate(pk["instrs"]):
                print(f"  {i:3d} {names[int(f[0])]:11s} n={int(f[4]):5d} "
                      f"k={int(f[5]):4d} sync={int(f[12]) & mk.MK_SYNC} "
                      f"{int(cyc[i]):6d} cycles", flush=True)
    finally:
        if saved is None:
            build._LIBS.pop("megakernel", None)
        else:
            build._LIBS["megakernel"] = saved


def profile_flash(dev: torch.device) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.build import load

    g = torch.Generator(device=dev).manual_seed(0)
    B, S, H, KV, dh = 1, 1024, 16, 2, 128
    q = torch.randn((B, S, H, dh), generator=g, device=dev)
    k, v = (torch.randn((B, S, KV, dh), generator=g, device=dev)
            for _ in range(2))
    out = torch.empty_like(q)
    lib = load("flash_attention", fa._declare)

    def launch(vec: bool):
        err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), B, S, S, H, KV, dh, H // KV, 0,
                            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                            dh ** -0.5, 1, 0, int(vec), 0, 0,
                            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"fa_launch: CUDA error {err}")

    for variant, vec in (("as it runs", True), ("k, v by element loads", False)):
        parts = device_parts(lambda: launch(vec))
        print(f"flash_attention float32 B=1 S=1024 H=16 KV=2 dh=128 causal, "
              f"{variant}: {_fmt(parts)}", flush=True)


# (H, KV, dh, mla) the flash backward is timed at: qwen2.5-3b's heads,
# deepseek-v2's MLA (v and the output's gradient zero past column 128, as
# the model pads v), zamba2-7b's shared block, internvl2-26b's G 6
BWD_HEADS = ((16, 2, 128, False), (128, 128, 192, True), (32, 32, 224, False),
             (48, 8, 128, False))


# (S, H, KV, dh, causal, window) the backward's routes are checked at:
# qwen2.5-3b's heads (causal, a window of 256, full; cut in pieces at S
# 300), a window of 33 at G 1, dh 64, G 128, dh 8, the MLA, zamba2 (a
# window) and internvl2 (G 6, also ragged with a window) heads, G 7, dh 256
BWD_CHECKS = ((1024, 16, 2, 128, True, 0), (1024, 16, 2, 128, True, 256),
              (1024, 16, 2, 128, False, 0), (300, 16, 2, 128, True, 0),
              (257, 16, 16, 128, True, 33), (200, 24, 24, 64, True, 0),
              (77, 128, 1, 64, True, 0), (33, 4, 1, 8, True, 0),
              (1024, 128, 128, 192, True, 0), (1024, 32, 32, 224, True, 256),
              (1024, 48, 8, 128, True, 0), (301, 48, 8, 128, True, 40),
              (77, 7, 1, 64, True, 0), (97, 2, 1, 256, False, 0))


# float32 with q and k BWD_PEAK times larger (scaled scores of standard
# deviation 25): qwen2.5-3b's and internvl2-26b's heads at S 4,096
BWD_PEAKED = ((4096, 16, 2, 128, True, 0), (4096, 48, 8, 128, True, 0))
BWD_PEAK = 5.0
# the readings beyond it: q and k this many times larger at BWD_HEADS, S 1,024
BWD_PEAKS = (8.0, 12.0, 16.0)


def exact_flash_bwd(q, k, v, g, causal: bool = True, window: int = 0):
    """The flash backward in float64 from the same inputs, a head at a
    time (the plain version's arithmetic, exact but for float64's
    rounding): dq, dk, dv and lse, each rounded once to float32."""
    q, k, v, g = (t.double() for t in (q, k, v, g))
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    lse = torch.empty((B, H, S), dtype=torch.float64, device=q.device)
    i = torch.arange(S, device=q.device)
    hide = torch.zeros((S, S), dtype=torch.bool, device=q.device)
    if causal:
        hide |= i[None, :] > i[:, None]
    if window:
        hide |= i[None, :] <= i[:, None] - window
    for h in range(H):
        kh, vh = k[:, :, h // G], v[:, :, h // G]
        s = (torch.einsum("bqd,bkd->bqk", q[:, :, h], kh) * dh ** -0.5).masked_fill(
            hide, -np.inf)
        lse[:, h] = torch.logsumexp(s, -1)
        p = torch.exp(s - lse[:, h, :, None])
        dp = torch.einsum("bqd,bkd->bqk", g[:, :, h], vh)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq[:, :, h] = torch.einsum("bqk,bkd->bqd", ds, kh) * dh ** -0.5
        dk[:, :, h // G] += torch.einsum("bqk,bqd->bkd", ds, q[:, :, h]) * dh ** -0.5
        dv[:, :, h // G] += torch.einsum("bqk,bqd->bkd", p, g[:, :, h])
    return dq.float(), dk.float(), dv.float(), lse.float()


def rounded_bwd_faults(q, k, v, g, causal: bool = True, window: int = 0):
    """The plain gradient of the attention with p rounded to bfloat16 (the
    row max attached, ``flash_attention_bwd_ref(round_p=torch.bfloat16)``)
    from the inputs upcast to float32, so not rounded to their dtype, and
    beside it the two faults a rounded-p backward can make that stay within
    its bfloat16 limit: ``fp32 p`` (the rounding ignored: the gradient of p
    in fp32) and ``detached max`` (the row max held constant, so no argmax
    share reaches dq or dk).  Returns (rounded, {fault: gradient}), each
    (dq, dk, dv) in float32."""
    from repro_torch.kernels.ref import _flash_scores, flash_attention_bwd_ref

    up = [t.float() for t in (q, k, v, g)]
    rounded = flash_attention_bwd_ref(*up, causal=causal, window=window,
                                      round_p=torch.bfloat16)[:3]
    fp32 = flash_attention_bwd_ref(*up, causal=causal, window=window)[:3]
    B, Sq, H, dh = q.shape
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in up[:3])
        s = _flash_scores(qq, kk, causal, window)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
        out = torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16().float(), vv)
        out = (out / p.sum(dim=-1, keepdim=True)).permute(0, 3, 1, 2, 4)
        detached = torch.autograd.grad(out.reshape(B, Sq, H, dh), (qq, kk, vv), up[3])
    return rounded, {"fp32 p": fp32, "detached max": detached}


def fault_shares(got, rounded, faults) -> dict[str, dict[str, tuple | None]]:
    """How far a rounded-p gradient ``got`` (dq, dk, dv) has moved from
    ``rounded`` towards each of ``faults`` (:func:`rounded_bwd_faults`),
    over the whole tensor: with e = got - rounded and d = fault - rounded,
    the share <e, d> / <d, d> in float64.  0 where ``got`` is the rounded
    gradient plus noise that does not lean towards the fault (the output's
    own rounding, flipped roundings of p), 1 where it makes the fault;
    above 1/2 ``got`` lies nearer the fault than the rounded gradient.
    Beside each share its noise, the spread the output's rounding alone
    gives it: sqrt(sum n^2 d^2) / <d, d> with n = ``rounded`` rounded to
    ``got``'s dtype, less itself (0 in float32).  Returns {fault: {name:
    (share, noise)}}, None where the fault leaves the gradient as it is
    (dv and the detached max)."""
    out: dict[str, dict[str, tuple | None]] = {}
    for fault, grads in faults.items():
        out[fault] = {}
        for name, a, r, f in zip(("dq", "dk", "dv"), got, rounded, grads):
            r64 = r.double().flatten()
            d = f.double().flatten() - r64
            dd = float(d @ d)
            if dd == 0.0:
                out[fault][name] = None
                continue
            n = r.to(a.dtype).double().flatten() - r64
            out[fault][name] = (float((a.double().flatten() - r64) @ d) / dd,
                                float((n * d).norm()) / dd)
    return out


def argmax_inputs(S: int, H: int, KV: int, dh: int, dtype, device, seed: int,
                  dhv: int | None = None):
    """q, k, v, g (bfloat16 values) whose causal attention is one-hot: row
    t's scores peak at one key, chosen among the keys j <= t with j = t
    (mod dh) by a permutation of j // dh, at least 2,560 / sqrt(dh) above
    every other score (2^-149 and less in exp2, fp32's least), and the scores
    are inexact fp32 sums.  There p is 1 at the argmax and 0 elsewhere,
    the rounded-p gradient's ds, dq and dk are 0 up to fp32 rounding, and
    without the argmax share each is r(x) - x (x = g . v at the argmax
    key): so dq and dk show whether each row's share reached the key where
    its kernel found the row's max (``sc == m``, bitwise).  v and g zero
    past ``dhv``."""
    rng = np.random.default_rng(seed)
    n = -(-S // dh)
    level = rng.permutation(n) + 1                  # 20 x 1..n at j // dh
    t = np.arange(S)
    q = 0.25 * rng.standard_normal((1, S, H, dh))
    q[0, t, :, t % dh] += 128.0
    k = 0.25 * rng.standard_normal((1, S, KV, dh))
    k[0, t, :, t % dh] += 20.0 * level[t // dh][:, None]
    v, g = (rng.standard_normal((1, S, h, dh)) for h in (KV, H))
    if dhv is not None:
        v[..., dhv:] = 0
        g[..., dhv:] = 0
    return [torch.from_numpy(a.astype(np.float32)).to(device).to(torch.bfloat16).to(dtype)
            for a in (q, k, v, g)]


def profile_flash_bwd(dev: torch.device) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    build.build(("flash_attention",))
    if not any(x.startswith("flash_attention.cu:") for x in build.BUILD_LOG):
        # built before this process: compile a copy for ptxas's report
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
            build._nvcc("flash_attention", Path(d) / "report.so")
    lines = "\n".join(build.BUILD_LOG).splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and any(
                x in line for x in ("fbt_", "fb_d", "fbs_")):
            # the last template flag of fbt_* and fb_* is RP: p rounded
            name = line.split("for ")[-1]
            rp = " (p rounded)" if "Lb1EE" in name else ""
            print("  ptxas:", name + rp, "|", lines[i + 1].strip(),
                  "|", lines[i + 2].strip(), flush=True)

    def ulp(x: float) -> float:
        return 2.0 ** (np.floor(np.log2(x)) - 7)

    def inputs(S, H, KV, dh, seed, mla=False, dt=torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(seed)
        q, go = (torch.randn((1, S, H, dh), generator=g, device=dev)
                 .to(dt) for _ in range(2))
        k, v = (torch.randn((1, S, KV, dh), generator=g, device=dev)
                .to(dt) for _ in range(2))
        if mla:
            v[..., 128:] = 0
            go[..., 128:] = 0
        return q, k, v, go

    bad = 0
    for S, H, KV, dh, causal, w, dt, peak in (
            [c + (torch.bfloat16, 1.0) for c in BWD_CHECKS]
            + [c + (torch.float32, 1.0) for c in BWD_CHECKS]
            + [c + (torch.float32, BWD_PEAK) for c in BWD_PEAKED]):
        q, k, v, go = inputs(S, H, KV, dh, S + dh, mla=dh == 192, dt=dt)
        q, k = q * peak, k * peak
        want = flash_attention_bwd_ref(q, k, v, go, causal=causal, window=w)
        plan = fa.plan_flash_bwd(1, S, S, H, KV, dh, causal, w, dt)
        if fa.flash_bwd_route(q, k, v) != "wgmma":
            raise RuntimeError(f"S {S} H {H} KV {KV} dh {dh}: not the tensor cores")
        for route in (None, "simt"):
            got = fa.flash_attention_bwd(q, k, v, go, causal=causal, window=w,
                                         route=route)
            again = fa.flash_attention_bwd(q, k, v, go, causal=causal,
                                           window=w, route=route)
            torch.cuda.synchronize()
            errs = []
            for name, a, b, c in zip(("dq", "dk", "dv", "lse"), got, want, again):
                top = float(b.float().abs().max())
                lim = (1e-5 * max(top, 1.0) if name == "lse" else 1e-4 * top
                       if dt == torch.float32 else 2 * ulp(top))
                err = float((a.float() - b.float()).abs().max())
                same = torch.equal(a, c)
                ok = err <= lim and same
                bad += not ok
                errs.append(f"{name} {err:.3g}/{lim:.3g}"
                            + ("" if same else " NOT BITWISE"))
            print(f"flash_attention_bwd {route or 'wgmma'} {str(dt)[6:]} B=1 S={S} "
                  f"H={H} KV={KV} dh={dh} "
                  f"{'causal' if causal else 'full'}{f' window {w}' if w else ''}"
                  f"{f' q, k x{peak:g}' if peak != 1.0 else ''}"
                  f" ({plan.pieces} pieces, {plan.tile_rows} rows a tile): "
                  + ", ".join(errs), flush=True)
    print(f"flash_attention_bwd checks: {bad} over their limits", flush=True)

    def shares(got, want):
        out = []
        for name, a, b in zip(("dq", "dk", "dv", "lse"), got, want):
            top = float(b.abs().max())
            lim = 1e-5 * max(top, 1.0) if name == "lse" else 1e-4 * top
            out.append(f"{name} {float((a - b).abs().max()) / lim:.3f}")
        return ", ".join(out)

    for H, KV, dh, mla in BWD_HEADS:
        for peak in BWD_PEAKS:
            q, k, v, go = inputs(1024, H, KV, dh, 1024 + dh, mla=mla, dt=torch.float32)
            q, k = q * peak, k * peak
            exact = exact_flash_bwd(q, k, v, go)
            plain = flash_attention_bwd_ref(q, k, v, go, causal=True)
            got = fa.flash_attention_bwd(q, k, v, go)
            torch.cuda.synchronize()
            print(f"peaked float32 B=1 S=1024 H={H} KV={KV} dh={dh} q, k x{peak:g}, "
                  f"share of the limits: wgmma vs plain [{shares(got, plain)}], "
                  f"wgmma vs exact [{shares(got, exact)}], plain vs exact "
                  f"[{shares(plain, exact)}]", flush=True)
            del q, k, v, go, exact, plain, got
            torch.cuda.empty_cache()

    for H, KV, dh, mla, dt in [h + (torch.bfloat16,) for h in BWD_HEADS] + [
            h + (torch.float32,) for h in BWD_HEADS]:
        for S in (4096, 1024):
            q, k, v, go = inputs(S, H, KV, dh, S, mla, dt)
            pairs = sum(t + 1 for t in range(S))
            flops = 10 * H * dh * pairs
            bound = flops / (989e12 if dt == torch.bfloat16 else 67e12) * 1e3
            shape = (f"{str(dt)[6:]} B=1 S={S} H={H} KV={KV} dh={dh} causal"
                     + (" mla v 128->192" if mla else ""))
            extra = ""
            if dt == torch.float32:     # the tensor cores' bounds
                facts = fa.bwd_kernel_facts(dh, dt)
                issued = facts["dq_products"] + facts["dkdv_products"]
                extra = (f"; on the tensor cores 3 x 5 16-bit products "
                         f"{flops * 3 / 989e12 * 1e3:.5f} ms, the {issued} "
                         f"issued {flops * issued / 5 / 989e12 * 1e3:.5f} ms")
            for route in (None, "simt"):
                def call(route=route):
                    fa.flash_attention_bwd(q, k, v, go, route=route)
                ms = call_ms(call, 20)
                print(f"flash_attention_bwd {route or 'wgmma'} {shape}: {ms:.5f} ms "
                      f"a call (events), bound {bound:.5f} ms (operations){extra}; "
                      f"{_fmt(device_parts(call, 10))}", flush=True)
            # SDPA's backward alone (its forward once, outside the timer)
            qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                 enable_gqa=H != KV)
            gs = go.transpose(1, 2)
            ms = call_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), gs,
                                                     retain_graph=True), 20)
            print(f"SDPA backward {shape}: {ms:.5f} ms a call (events)", flush=True)
            del q, k, v, go, qs, ks, vs, gs, out


def profile_bwd_ab(dev: torch.device) -> None:
    import hashlib

    import repro_torch
    from repro_torch.kernels import flash_attention as fa

    print(f"tree {Path(repro_torch.__file__).resolve().parents[2]}", flush=True)

    def digest(ts) -> str:
        h = hashlib.sha256()
        for t in ts:
            h.update(t.float().cpu().numpy().tobytes())
        return h.hexdigest()[:12]

    for H, KV, dh, dt, lens in ((16, 2, 128, torch.bfloat16, (4096, 1024)),
                                (16, 2, 128, torch.float32, (4096, 1024)),
                                (48, 8, 128, torch.float32, (4096, 1024)),
                                (32, 32, 224, torch.float32, (1024,)),
                                (128, 128, 192, torch.float32, (1024,))):
        for S in lens:
            g = torch.Generator(device=dev).manual_seed(S + H)
            q, go = (torch.randn((1, S, H, dh), generator=g, device=dev).to(dt)
                     for _ in range(2))
            k, v = (torch.randn((1, S, KV, dh), generator=g, device=dev).to(dt)
                    for _ in range(2))
            # p in fp32; at qwen2.5-3b's heads also p rounded to bfloat16
            # (attn_probs_bf16: v rounded to bfloat16 as the model rounds it)
            for rp in (False, torch.bfloat16) if H == 16 else (False,):
                vv = v.bfloat16().to(dt) if rp else v
                out = fa.flash_attention_bwd(q, k, vv, go, round_p=rp)

                def call(vv=vv, rp=rp):
                    fa.flash_attention_bwd(q, k, vv, go, round_p=rp)
                print(f"backward {str(dt)[6:]} S={S} H={H} KV={KV} dh={dh} p "
                      f"{'rounded' if rp else 'fp32'}: "
                      f"{call_ms(call, 20):.5f} ms a call (events); "
                      f"{_fmt(device_parts(call, 10))}; outputs {digest(out)}",
                      flush=True)
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((1, 4096, 16, 128), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((1, 4096, 2, 128), generator=g, device=dev).bfloat16()
            for _ in range(2))
    # p rounded: to v's dtype (True, a key tile's running max) and to
    # bfloat16 (attn_probs_bf16: the row's max where the tree has it)
    for rp in (False, True, torch.bfloat16):
        def fwd(rp=rp):
            return fa.flash_attention_fused(q, k, v, round_p=rp)
        print(f"forward bfloat16 S=4096 H=16 KV=2 dh=128 p "
              f"{'fp32' if rp is False else 'rounded' if rp is True else 'bfloat16'}: "
              f"{call_ms(fwd, 50):.5f} ms a call "
              f"(events); {_fmt(device_parts(fwd, 20))}; outputs {digest([fwd()])}",
              flush=True)


# (H, KV, dh, window, mla) of the served prefills and decodes (PERF.md §6
# rows 7 and 8): qwen2.5-3b, olmoe, granite, codeqwen, deepseek-v2's MLA,
# command-r, internvl2 (G 6), musicgen, zamba2's shared block with and
# without its window
SERVED_HEADS = ((16, 2, 128, 0, False), (16, 16, 128, 0, False),
                (32, 8, 128, 0, False), (32, 32, 128, 0, False),
                (128, 128, 192, 0, True), (64, 8, 128, 0, False),
                (48, 8, 128, 0, False), (24, 24, 64, 0, False),
                (32, 32, 224, 0, False), (32, 32, 224, 256, False))


def profile_served_attention(dev: torch.device) -> None:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention_fused

    g = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        for H, KV, dh, w, mla in SERVED_HEADS:
            q = torch.randn((1, 1024, H, dh), generator=g, device=dev).to(dt)
            k, v = (torch.randn((1, 1024, KV, dh), generator=g, device=dev)
                    .to(dt) for _ in range(2))
            if mla:
                v[..., 128:] = 0

            def fwd():
                flash_attention_fused(q, k, v, window=w, round_p=False)

            parts = device_parts(fwd, 20)
            print(f"flash_attention {name} B=1 S=1024 H={H} KV={KV} dh={dh} causal"
                  f"{f' window {w}' if w else ''} p fp32: {call_ms(fwd, 50):.5f} "
                  f"ms a call (events); {_fmt(parts)}", flush=True)
            if mla or w:
                continue
            B, S = 8, 2048
            qd = torch.randn((B, H, dh), generator=g, device=dev).to(dt)
            kc, vc = (torch.randn((B, S, KV, dh), generator=g, device=dev)
                      .to(dt) for _ in range(2))
            lens = torch.tensor(SERVED_LENS, dtype=torch.int32, device=dev)

            def dec():
                decode_attention(qd, kc, vc, lens, round_p=False)

            parts = device_parts(dec, 20)
            print(f"decode_attention {name} B=8 S=2048 H={H} KV={KV} dh={dh} "
                  f"served lens p fp32: {call_ms(dec, 50):.5f} ms a call "
                  f"(events); {_fmt(parts)}", flush=True)
    # internvl2's G 6, bfloat16: both forward kernels on the same call
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    for S in (1024, 4096):
        q = torch.randn((1, S, 48, 128), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((1, S, 8, 128), generator=g, device=dev).bfloat16()
                for _ in range(2))
        out = torch.empty_like(q)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        for name, fn in (
                (f"{fa.flash_route(q, k, v)} (as routed)",
                 lambda: flash_attention_fused(q, k, v, round_p=False)),
                ("fa_kernel", lambda: _fa_kernel(q, k, v, out)),
                ("SDPA", lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))):
            parts = device_parts(fn, 20)
            print(f"flash_attention bfloat16 B=1 S={S} H=48 KV=8 dh=128 causal "
                  f"p fp32, {name}: {call_ms(fn, 50):.5f} ms a call (events); "
                  f"{_fmt(parts)}", flush=True)


def _fa_kernel(q, k, v, out, causal: bool = True, round_p: int = 0) -> None:
    """``fa_kernel`` (the CUDA-core forward) through the library's own
    entry, whatever ``flash_route`` gives the call: to time the two forward
    kernels on the same inputs.  Counts no launch."""
    from repro_torch.kernels import flash_attention as fa

    lib = fa.load("flash_attention", fa._declare)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    words = 16 // q.element_size()
    vec = all(t.data_ptr() % 16 == 0 and all(s % words == 0 for s in t.stride()[:3])
              for t in (k, v)) and dh % words == 0
    err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        B, Sq, Sk, H, KV, dh, H // KV, 0, *q.stride()[:3],
                        *k.stride()[:3], *v.stride()[:3], dh ** -0.5, int(causal),
                        round_p,
                        int(vec), fa._DTYPE[q.dtype], 0,
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"fa_kernel launch failed: CUDA error {err}")


def call_ms(fn, reps: int = 200) -> float:
    """Median ms of one call between CUDA events (the wrapper's host work
    included), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def host_ms(fn, reps: int = 500) -> float:
    """Host-clock ms to enqueue one call: ``reps`` calls back to back, no
    synchronisation between them (the card keeps up with these kernels)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def served_chains(dev: torch.device):
    """The six served chain calls: bonsai/curet-m's chains 0 and 1 and
    protonn/curet-m's chain, float32 and int8, each on a bucket of 64 seeded
    as ``chip_smoke.chain_case`` seeds it: ``(label, step, bits, x,
    extras)``.  Uses only what every version of the port has."""
    from repro_torch.core.lowering import ChainStep
    from repro_torch.serve.classical_engine import get_program

    for bench in ("bonsai/curet-m", "protonn/curet-m"):
        for prec in ("float32", "int8"):
            prog = get_program(bench, precision=prec, use_pallas=True, device=dev)
            bits = prog.plan.bits or 8
            steps = [s for s in prog.plan.steps if isinstance(s, ChainStep)]
            for i, step in enumerate(steps):
                shape = (64,) + tuple(prog.dfg.out_shape(step.terminal))
                rng = np.random.default_rng(i)
                qm = (1 << (bits - 1)) - 1
                ops = [torch.from_numpy(
                    rng.integers(-qm, qm + 1, size=shape).astype(f"int{bits}")
                    if step.quantized else
                    rng.standard_normal(shape).astype(np.float32)).to(dev)
                    for _ in range(1 + len(step.extras))]
                yield (f"{bench} {prec} {i} {[s[0] for s in step.stages]} "
                       f"{shape}", step, bits, ops[0], ops[1:])


def profile_chains(dev: torch.device) -> None:
    """The six served chain calls and protonn's chains one stage at a time:
    device time, time per call between CUDA events, host time to enqueue a
    call, and the byte bound (each operand read once, the output written
    once, over 3.35 TB/s).  First the launch floor: an empty kernel with the
    chain kernels' parameter block, where the library has one.  Runs on an
    older tree too (``PYTHONPATH=<tree>/src python
    src/repro_torch/launch/profile_kernels.py --chains``)."""
    from repro_torch.kernels import linear_pipeline as lp
    from repro_torch.kernels.build import load

    lib = load("linear_chain", lp._declare)
    empty = getattr(lib, "lc_launch_empty", None)
    if empty is not None:
        stream = torch.cuda.current_stream(dev).cuda_stream
        floor = lambda: empty(stream)                       # noqa: E731
        print(f"chain launch floor (empty kernel): device "
              f"{sum(device_parts(floor).values()):.5f} ms, per call "
              f"{call_ms(floor):.5f} ms, host {host_ms(floor):.5f} ms",
              flush=True)
    for label, step, bits, x, extras in served_chains(dev):
        cases = [("", lp.Chain(step.stages, step.vecs, step.quantized, bits))]
        if label.startswith("protonn"):
            cases += [(f", stage {st[0]} alone",
                       lp.Chain((st,), step.vecs, step.quantized, bits))
                      for st in step.stages]
        nbytes = (2 + len(extras)) * x.numel() * x.element_size()
        for alone, chain in cases:
            fn = lambda: lp.run_chain(chain, x, extras)     # noqa: E731
            print(f"chain {label}{alone}: device "
                  f"{sum(device_parts(fn).values()):.5f} ms, per call "
                  f"{call_ms(fn):.5f} ms, host {host_ms(fn):.5f} ms, bound "
                  f"{nbytes / 3.35e12 * 1e3:.7f} ms (bytes)", flush=True)


def _patched_build(name: str, patches, tag: str):
    """A build of ``csrc/<name>.cu`` with ``patches`` applied (each old
    text must occur once), loaded with ctypes."""
    import ctypes

    from repro_torch.kernels import build

    src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{tag}: {old!r} not found once")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(dir=build.BUILD_DIR)) / f"{tag}.so"
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(build.CSRC),
                    "-o", str(out), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


# Variants of csrc/linear_chain.cu: the stage's code dispatched by a switch
# once per element (float_stage's and q_stage's own switches, a jump table
# read from the constant bank); the operands and the table copied by every
# thread with cp.async (16 bytes, or 4) in place of the bulk copies and the
# mbarrier; every call on the kernel instance for LC_MAX_OPS operands.
_CHAIN_VARIANTS = {
    "the instance for 17 operands": (
        ("  const bool few = a.n_ops <= LC_FEW_OPS;",
         "  const bool few = false;"),),
    "a switch per element": (
        ("      if constexpr (Q) lc_q_step(code, v, o, st, bits);\n"
         "      else lc_float_step(code, v, o, st, bits);\n",
         "#pragma unroll\n      for (int j = 0; j < LC_RUN; ++j) {\n"
         "        if constexpr (Q)\n"
         "          v[j] = q_stage(code, v[j], o[j], st.p0, st.p1, st.p2, st.f[1],"
         " st.f[2], bits);\n"
         "        else\n          v[j] = float_stage(code, v[j], o[j]);\n      }\n"),),
    "cp.async by every thread": (
        ('#include "hopper.cuh"\n',
         '#include "hopper.cuh"\n#define hp_bulk_load(...) ((void)0)\n'
         '#define hp_bar_expect_tx(...) ((void)0)\n'),
        ("  // the elements outside each operand's bulk range",
         "  for (int i = tid; i * 16 < a.table_bytes; i += blockDim.x)\n"
         "    hp_cp16((unsigned char*)s_st + i * 16,"
         " (const unsigned char*)a.table + i * 16, true);\n"
         "  if (a.vec_at >= 0)\n"
         "    for (int i = tid; i * 16 < a.vec_bytes; i += blockDim.x)\n"
         "      hp_cp16(lc_smem + a.vec_at + i * 16,"
         " (const unsigned char*)a.vecs + i * 16, true);\n"
         "  for (int j0 = tid * LC_RUN; j0 < len; j0 += step) {\n"
         "    const int j1 = min(j0 + LC_RUN, len);\n#pragma unroll\n"
         "    for (int k = 0; k < NOPS; ++k) {\n      if (k >= n_ops) break;\n"
         "      const int lg = (a.op[k].meta >> 4) & 3, rb = LC_RUN << lg;\n"
         "      const unsigned char* g = (const unsigned char*)a.op[k].src"
         " + ((c0 + j0) << lg);\n"
         "      unsigned char* s = lc_smem + a.op[k].off + (j0 << lg);\n"
         "      if (j1 - j0 == LC_RUN && (uintptr_t)g % rb == 0) {\n"
         "        if (rb == 16) hp_cp16(s, g, true);\n"
         "        else { hp_cp4(s, g, true); if (rb == 8) hp_cp4(s + 4, g + 4, true); }\n"
         "      } else {\n        for (int j = 0; j < j1 - j0; ++j) {\n"
         "          if (lg == 0) s[j] = g[j];\n"
         "          else if (lg == 1) ((uint16_t*)s)[j] = ((const uint16_t*)g)[j];\n"
         "          else ((uint32_t*)s)[j] = ((const uint32_t*)g)[j];\n"
         "        }\n      }\n    }\n  }\n  hp_cp_commit();\n  hp_cp_wait<0>();\n"
         "  // the elements outside each operand's bulk range"),
        ("  hp_bar_wait(&bar, 0);\n", "")),
}


def profile_chain_variants(dev: torch.device) -> None:
    """The six served chain calls' device time on the kernel as built and on
    each of ``_CHAIN_VARIANTS`` (the wrapper unchanged), in turns."""
    from repro_torch.kernels import build
    from repro_torch.kernels import linear_pipeline as lp

    libs = {"as built": build.load("linear_chain", lp._declare)}
    for name, patches in _CHAIN_VARIANTS.items():
        libs[name] = _patched_build("linear_chain", patches,
                                    "lc_" + "".join(c for c in name if c.isalnum()))
        lp._declare(libs[name])
    saved = build._LIBS["linear_chain"]
    try:
        for label, step, bits, x, extras in served_chains(dev):
            times = {}
            for name, lib in libs.items():
                build._LIBS["linear_chain"] = lib
                chain = lp.Chain(step.stages, step.vecs, step.quantized, bits)
                got = lp.run_chain(chain, x, extras)
                if not torch.equal(got, lp.run_chain(lp.Chain(
                        step.stages, step.vecs, step.quantized, bits), x, extras)):
                    raise RuntimeError(f"chain variant {name}: two calls differ")
                times[name] = sum(device_parts(
                    lambda: lp.run_chain(chain, x, extras)).values())
            print(f"chain variants {label}: device " + ", ".join(
                f"{k} {v:.5f} ms" for k, v in times.items()), flush=True)
    finally:
        build._LIBS["linear_chain"] = saved


# The clock64 trace of csrc/linear_chain.cu: thread 0 of block 0 stamps SM
# cycles since its start after expecting the bytes (7), after its copies
# (0), after its edge loads and its reads of the parameter block for the
# walk (1), after the barrier (2), after the mbarrier wait (3), before its
# first run's walk (6), at the start and the end of each of that walk's
# first 8 stages (8 + 2 s, 9 + 2 s; the end once the stage's result
# exists), after the walk (5) and at its end (4); plus an empty kernel with
# no parameters.
_CHAIN_TRACE_PATCHES = (
    ("template <typename T, bool Q, int NOPS>\n"
     "__global__ void __launch_bounds__(LC_THREADS) lc_kernel(",
     "__device__ long long lc_trace[32];\n"
     "extern \"C\" int lc_read_trace(long long* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, lc_trace, 32 * sizeof(long long));\n"
     "}\n__global__ void lc_empty_small() {}\n"
     "extern \"C\" int lc_launch_empty_small(void* s) {\n"
     "  lc_empty_small<<<1, 32, 0, (cudaStream_t)s>>>();\n"
     "  return (int)cudaGetLastError();\n}\n"
     "template <typename T, bool Q, int NOPS>\n"
     "__global__ void __launch_bounds__(LC_THREADS) lc_kernel("),
    ("  const int step = blockDim.x * LC_RUN;\n",
     "  const int step = blockDim.x * LC_RUN;\n"
     "  const long long lc_t0 = clock64();\n"
     "  const bool lc_me = blockIdx.x == 0 && threadIdx.x == 0;\n"),
    ("    hp_bar_expect_tx(&bar, bytes);\n",
     "    hp_bar_expect_tx(&bar, bytes);\n"
     "    if (lc_me) lc_trace[7] = clock64() - lc_t0;\n"),
    ("  // the elements outside each operand's bulk range",
     "  if (lc_me) lc_trace[0] = clock64() - lc_t0;\n"
     "  // the elements outside each operand's bulk range"),
    ("  __syncthreads();              // s_base and s_dt\n",
     "  if (lc_me) lc_trace[1] = clock64() - lc_t0;\n"
     "  __syncthreads();\n  if (lc_me) lc_trace[2] = clock64() - lc_t0;\n"),
    ("  hp_bar_wait(&bar, 0);\n",
     "  hp_bar_wait(&bar, 0);\n  if (lc_me) lc_trace[3] = clock64() - lc_t0;\n"),
    ("    for (int s = 0; s < n_stages; ++s) {\n",
     "    if (lc_me && j0 == 0) lc_trace[6] = clock64() - lc_t0;\n"
     "    for (int s = 0; s < n_stages; ++s) {\n"
     "      if (lc_me && j0 == 0 && s < 8) lc_trace[8 + 2 * s] = clock64() - lc_t0;\n"),
    ("      else lc_float_step(code, v, o, st, bits);\n",
     "      else lc_float_step(code, v, o, st, bits);\n"
     "      if (lc_me && j0 == 0 && s < 8 && v[0] != (C)123456)\n"
     "        lc_trace[9 + 2 * s] = clock64() - lc_t0;\n"),
    ("    if (vec_out && j0 + LC_RUN <= len) {\n",
     "    if (lc_me && j0 == 0) lc_trace[5] = clock64() - lc_t0;\n"
     "    if (vec_out && j0 + LC_RUN <= len) {\n"),
    ("  }\n}\n\n// The launch floor",
     "  }\n  if (lc_me) lc_trace[4] = clock64() - lc_t0;\n}\n\n// The launch floor"),
)


def profile_chain_trace(dev: torch.device) -> None:
    """Where a served chain call's device time goes: SM cycles of each
    phase of block 0, from a clock-stamped build of ``csrc/linear_chain.cu``
    (``_CHAIN_TRACE_PATCHES``), for the six served chain calls; and the
    floors of a call: no launch, an empty kernel with no parameters and one
    with the chain kernels' parameter block (time per call between CUDA
    events, device time)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import linear_pipeline as lp

    lib = _patched_build("linear_chain", _CHAIN_TRACE_PATCHES, "lc_trace")
    lp._declare(lib)
    lib.lc_read_trace.argtypes = [ctypes.c_void_p]
    lib.lc_launch_empty_small.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, fn in (("no launch", lambda: None),
                      ("empty kernel, no parameters",
                       lambda: lib.lc_launch_empty_small(stream)),
                      ("empty kernel, the chain parameter block",
                       lambda: lib.lc_launch_empty(stream))):
        print(f"chain floor, {label}: per call {call_ms(fn):.5f} ms, device "
              f"{sum(device_parts(fn).values()):.5f} ms", flush=True)
    saved = build._LIBS["linear_chain"]
    build._LIBS["linear_chain"] = lib
    try:
        for label, step, bits, x, extras in served_chains(dev):
            chain = lp.Chain(step.stages, step.vecs, step.quantized, bits)
            dev_ms = sum(device_parts(lambda: lp.run_chain(chain, x, extras)).values())
            st = (ctypes.c_longlong * 32)()
            if lib.lc_read_trace(ctypes.addressof(st)):
                raise RuntimeError("chain trace: reading the stamps failed")
            phases = (("expected", 7), ("copies issued", 0), ("edges", 1),
                      ("barrier", 2), ("waited", 3), ("walk start", 6))
            stages = "; ".join(f"{s[0]} {st[8 + 2 * j]}-{st[9 + 2 * j]}"
                               for j, s in enumerate(step.stages[:8]))
            print(f"chain trace {label}: device {dev_ms:.5f} ms (this build); "
                  "block 0 SM cycles " + ", ".join(f"{k} {st[j]}" for k, j in phases)
                  + f", stages {stages}, walked {st[5]}, end {st[4]}", flush=True)
    finally:
        build._LIBS["linear_chain"] = saved


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    if argv == ["--flash-bwd"]:
        profile_flash_bwd(dev)
        print(card)
        return 0
    if argv == ["--served-attention"]:
        profile_served_attention(dev)
        print(card)
        return 0
    if argv == ["--bwd-ab"]:
        profile_bwd_ab(dev)
        print(card)
        return 0
    profile_chains(dev)
    if argv == ["--chains"]:
        return 0
    profile_chain_variants(dev)
    profile_chain_trace(dev)
    if argv == ["--chain-trace"]:
        return 0
    profile_decode(dev)
    profile_spmv(dev)
    profile_megakernel(dev)
    profile_megakernel_trace(dev)
    profile_flash(dev)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
