"""Time kernels on the card under other plans and variants than their own.

    PYTHONPATH=src python -m repro_torch.launch.profile_kernels

Decode attention at qwen2.5-3b's decode shape (B 8, S 2048, H 16, KV 2,
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
cp.async.  Then the megakernel's
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
                def plan(B, KV, G, S, dh, dtype, sms=132, chunk=chunk):
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
    import tempfile
    from pathlib import Path

    from repro_torch.kernels import build
    from repro_torch.kernels import megakernel as mk
    from repro_torch.serve.classical_engine import get_program

    src = (build.CSRC / "megakernel.cu").read_text()
    for old, new in _TRACE_PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"megakernel trace: {old!r} not found once")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(dir=build.BUILD_DIR)) / "mk_trace.so"
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(build.CSRC),
                    "-o", str(out), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
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
                            out.data_ptr(), B, S, S, H, KV, dh, *q.stride()[:3],
                            *k.stride()[:3], *v.stride()[:3], dh ** -0.5, 1, 0,
                            int(vec), 0, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"fa_launch: CUDA error {err}")

    for variant, vec in (("as it runs", True), ("k, v by element loads", False)):
        parts = device_parts(lambda: launch(vec))
        print(f"flash_attention float32 B=1 S=1024 H=16 KV=2 dh=128 causal, "
              f"{variant}: {_fmt(parts)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    profile_decode(dev)
    profile_spmv(dev)
    profile_megakernel(dev)
    profile_megakernel_trace(dev)
    profile_flash(dev)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
