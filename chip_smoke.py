#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:

1. device   — require CUDA, print the card's name and power limit, turn
              TF32 off;
2. build    — build the four kernels (``src/repro_torch/csrc/*.cu``) into
              ``build/kernels/``, one nvcc per source, all started together;
3. kernel   — each kernel against its plain PyTorch version on the card:
              the megakernel on all 20 Table-I programs × {float32, int8,
              int16} at a seeded bucket of 64 (grid vs per-sample bitwise;
              integer outputs exact, 1 LSB only after a float PE) and on a
              segment built to land on rounding ties (numpy's half to even,
              exactly); the chain kernels on every chain step of the same
              60 programs compiled with ``use_pallas=True`` and on random
              programs over every stage (rank 3, ragged n); spmv at tile
              densities 0, 0.1 and 1 and on ragged shapes; matmul/gemv in
              float32 and bfloat16 up to 4096³;
4. serve    — the two served paths: ``ClassicalServeEngine`` on
              bonsai/curet-m and protonn/curet-m, float32 and int8, 256
              requests each, with ``exec_mode="megakernel_grid"`` (the
              megakernel) and with ``use_pallas=True`` on the interpret
              lane (the chain kernels); predictions must agree with the
              port's ``use_pallas=False`` interpret lane on ≥ 99 % of
              requests; each path's launches are counted over its own run
              and the chain launches must equal chains × buckets;
5. ops      — the kernel library's entry point ``repro_torch.kernels.ops``:
              ``spmv``, ``gemv`` and ``matmul`` once each at the report's
              shapes, their launches counted over this phase, the results
              checked against the plain versions;
6. report   — the device time of every kernel, its plain version and,
              where one PyTorch call computes the same function, that call
              (kernel durations from a ``torch.profiler`` trace, per call);
              each kernel's time per call between CUDA events, which
              includes the wrapper's host work; the bounds; the engines'
              serving rate on the host clock and the megakernel's share of
              it; the ``kernels`` JSON line, the card line, and last
              ``{"ok": true, "device": {...}}``.

Needs only the repository (``src/`` on the path) and one card.  Writes the
full per-case report to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # fp32 outside the tensor cores
            "bfloat16": 989e12,    # dense bf16 tensor-core peak
            "int8": 1979e12, "int16": 1979e12}   # int8 tensor-core peak
BUCKET = 64
SERVE_REQUESTS = 256
F32_RTOL = F32_ATOL = 1e-5


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def fail(name: str, msg: str) -> int:
    print(f"[{name}] FAILED: {msg}", flush=True)
    return 1


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def median_ms(fn, reps: int, warm: int = 3) -> float:
    """Median of per-call times between CUDA events, after a warm-up."""
    import torch

    for _ in range(warm):
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
    return statistics.median(ts)


def device_ms(fn, reps: int, warm: int = 3) -> tuple[float, str]:
    """Device time per call: the summed durations of the kernels, copies
    and sets the card ran during ``reps`` calls, from a ``torch.profiler``
    (CUPTI) trace, over ``reps``.  Where the trace shows no device
    activity, the time between CUDA events around the ``reps`` calls run
    back to back, over ``reps``.  Returns ``(ms, "profiler" | "events")``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in p.events()
             if e.device_type == DeviceType.CUDA)
    if us > 0:
        return us / 1e3 / reps, "profiler"
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, "events"


def serve_wall_s(eng, X) -> float:
    """Host-clock seconds for the engine to drain ``X`` (queued first):
    stacking, the copy in, one launch per bucket, the copy out."""
    import torch

    for row in X:
        eng.submit(row)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def segment_work(seg, nb: int) -> tuple[float, float]:
    """(bytes, operations) one bucket of ``seg`` needs: each input, matrix
    and constant read once at the width of its values, each output written
    once; two operations per multiply-add, three per squared-distance term,
    one per other element.

    On the integer lanes the compiler holds weights, vectors and shifts as
    int32 words, but their values are narrow (``seg.bits``): they count at
    that width.  Matvec biases (int32 at the accumulator scale) and SQL2
    points (float32) count at four bytes."""
    import numpy as np

    item = seg.bits // 8 if seg.quantized else 4
    widths = seg.slot_widths
    wide_consts = {ins.operand[1] for ins in seg.instrs
                   if ins.op in ("MATVEC", "SPMV") and ins.operand[1] is not None}
    float_mats = {ins.operand[0] for ins in seg.instrs if ins.op == "SQL2"}
    nbytes = sum(np.size(m) * (4 if mi in float_mats else item)
                 for mi, m in enumerate(seg.matrices))
    nbytes += sum(np.size(c) * (4 if ci in wide_consts else item)
                  for ci, c in enumerate(seg.consts))
    ops = 0
    for ins in seg.instrs:
        if ins.op == "LOAD_VEC" and ins.operand[0] == "in":
            nbytes += nb * widths[ins.dst] * item
        elif ins.op == "STORE":
            dt = (seg.out_dtypes[ins.operand] if seg.out_dtypes else
                  ("float32" if not seg.quantized else f"int{seg.bits}"))
            nbytes += nb * seg.out_widths[ins.operand] * np.dtype(dt).itemsize
        elif ins.op in ("MATVEC", "SPMV"):
            m, k = np.shape(seg.matrices[ins.operand[0]])
            ops += nb * 2 * m * k
        elif ins.op == "SQL2":
            d, m = np.shape(seg.matrices[ins.operand[0]])
            ops += nb * 3 * d * m
        elif ins.op in ("ELEMENTWISE", "REQUANTIZE"):
            ops += nb * widths[ins.dst]
        elif ins.op in ("REDUCE", "ARGMAX", "DOT"):
            ops += nb * widths[ins.src[0]] * (2 if ins.op == "DOT" else 1)
    return float(nbytes), float(ops)


def bound_ms(seg, nb: int, precision: str) -> tuple[float, str]:
    nbytes, ops = segment_work(seg, nb)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[precision] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bucket_inputs(prog, seed: int, n: int = BUCKET):
    """One seeded bucket as the executor hands it to the segment: float32
    rows, quantized at the plan's input scales on the integer lanes."""
    import numpy as np
    import torch

    from repro_torch.core.quantize import quantize_t

    (name, spec), = prog.dfg.graph_inputs.items()
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n,) + tuple(spec.shape)).astype(np.float32)
    x = torch.from_numpy(X).to(prog.device)
    if prog.precision != "float32":
        x = quantize_t(x, prog.plan.input_exps[name], prog.plan.bits)
    return X, x.reshape(n, -1).contiguous()


def compare(seg, kern, plain) -> tuple[bool, float, int]:
    """(within tolerance, max abs err, count of 1-LSB elements) over the
    outputs of one segment.  Integer outputs agree exactly, except that an
    output with a float PE on its path (``float_pe_outputs``) may differ by
    1 LSB; index outputs (int32) always agree exactly."""
    import torch

    from repro_torch.kernels.ref import float_pe_outputs

    ok, err, lsb = True, 0.0, 0
    for a, b, pe in zip(kern, plain, float_pe_outputs(seg)):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False, float("inf"), 0
        d = (a.double() - b.double()).abs()
        if d.numel():
            err = max(err, float(d.max()))
        if a.dtype == torch.float32:
            ok &= bool(torch.allclose(a, b, rtol=F32_RTOL, atol=F32_ATOL))
        elif pe and a.dtype != torch.int32:
            lsb += int((d == 1).sum())
            ok &= bool((d <= 1).all())
        else:
            ok &= bool(torch.equal(a, b))
    return ok, err, lsb


def tie_segment():
    """A two-output int8 segment over every int8 value: ``relu(x / 2)``
    through ``q_unary`` lands on a tie at every odd positive ``x`` (so it
    tells half-to-even from half-away-from-zero), and ``q_scalar_mul`` by 3
    with a requantizing shift of 1 exercises the rounding add.  Returns the
    segment, its input rows and the outputs numpy expects."""
    import numpy as np

    from repro_torch.kernels.megakernel import Instr, MegakernelSegment

    seg = MegakernelSegment(
        instrs=(Instr("LOAD_VEC", dst=0, operand=("in", 0)),
                Instr("ELEMENTWISE", dst=1, src=(0,),
                      operand=(("q_unary", ("relu", 1, 0)), ())),
                Instr("ELEMENTWISE", dst=2, src=(0,),
                      operand=(("q_scalar_mul", (3, 1)), ())),
                Instr("STORE", src=(1,), operand=0),
                Instr("STORE", src=(2,), operand=1)),
        slot_widths=(256, 256, 256), consts=(), matrices=(), in_refs=("x",),
        out_refs=("half", "triple"), out_widths=(256, 256),
        out_shapes=((256,), (256,)), quantized=True, bits=8)
    x = np.arange(-128, 128, dtype=np.int8)
    x = np.stack([x, x[::-1]])
    half = np.clip(np.rint(np.maximum(x, 0) * np.float32(0.5)), -127, 127)
    triple = np.clip((x.astype(np.int32) * 3 + 1) >> 1, -127, 127)
    return seg, x, [half.astype(np.int8), triple.astype(np.int8)]


FLOAT_STAGES = ("scalar_mul", "add_vec", "sub_vec", "hadamard_vec", "tanh",
                "sigmoid", "relu", "exp", "add_arr", "sub_arr", "hadamard_arr")
Q_STAGES = ("q_scalar_mul", "q_add_vec", "q_sub_vec", "q_hadamard_vec",
            "q_add_arr", "q_sub_arr", "q_hadamard_arr", "q_unary")


def random_chain(rng, names, n: int, bits: int | None = None):
    """A well-formed stage program over ``names`` with seeded operands and
    small shifts: ``(stages, vecs, n_extras)``.  Float programs (``bits``
    None) embed their ``*_vec`` operands (float32, length ``n``); ``q_*``
    programs index ``vecs`` (int8/int16 values, length ``n``).  Each
    ``*_arr`` stage reads a new extra."""
    import numpy as np

    stages, vecs, n_extras = [], [], 0
    qm = None if bits is None else (1 << (bits - 1)) - 1
    for op in names:
        if op == "scalar_mul":
            stages.append((op, float(rng.uniform(-1.5, 1.5))))
        elif op in ("add_vec", "sub_vec", "hadamard_vec"):
            stages.append((op, (0.5 * rng.standard_normal(n))
                           .astype(np.float32)))
        elif op in ("add_arr", "sub_arr", "hadamard_arr"):
            stages.append((op, n_extras))
            n_extras += 1
        elif op in ("tanh", "sigmoid", "relu", "exp"):
            stages.append((op, None))
        elif op == "q_scalar_mul":
            stages.append((op, (int(rng.integers(-5, 6)),
                                int(rng.integers(-2, 4)))))
        elif op == "q_unary":
            stages.append((op, (str(rng.choice(["tanh", "sigmoid", "relu",
                                                "exp"])),
                                int(rng.integers(3, 7)),
                                int(rng.integers(3, 7)))))
        else:
            if op.endswith("_vec"):
                vecs.append(rng.integers(-qm, qm + 1, size=n)
                            .astype(f"int{bits}"))
                idx = len(vecs) - 1
            else:
                idx = n_extras
                n_extras += 1
            if op.startswith("q_hadamard"):
                stages.append((op, (idx, int(rng.integers(1, 5)))))
            else:
                stages.append((op, (idx, int(rng.integers(-2, 3)),
                                    int(rng.integers(-2, 3)),
                                    int(rng.integers(-1, 3)))))
    return stages, vecs, n_extras


def random_stream(rng, shape, bits: int | None = None):
    """Seeded stream values: float32 normals, or int8/int16 over the whole
    saturated range."""
    import numpy as np

    if bits is None:
        return rng.standard_normal(shape).astype(np.float32)
    qm = (1 << (bits - 1)) - 1
    return rng.integers(-qm, qm + 1, size=shape).astype(f"int{bits}")


def chain_case(prog, step, seed: int, nb: int = BUCKET):
    """A served chain step with one seeded bucket: ``(chain, x, extras)``
    on the program's device, at the shape the interpret lane gives it."""
    import numpy as np
    import torch

    from repro_torch.kernels.linear_pipeline import Chain

    bits = prog.plan.bits if step.quantized else None
    shape = (nb,) + tuple(prog.dfg.out_shape(step.terminal))
    rng = np.random.default_rng(seed)
    x, *extras = [torch.from_numpy(random_stream(rng, shape, bits))
                  .to(prog.device) for _ in range(1 + len(step.extras))]
    return Chain(step.stages, step.vecs, step.quantized, bits or 8), x, extras


def chain_work(chain, x, extras) -> tuple[float, float]:
    """(bytes, operations) of one chain call: the stream and each extra
    read once and the output written once at their width, each vec read
    once at the width of its values; one operation per element per stage."""
    import numpy as np

    item = x.element_size()
    nbytes = (2 + len(extras)) * x.numel() * item
    vecs = (chain.vecs if chain.quantized else
            [s for n, s in chain.stages if n.endswith("_vec")])
    nbytes += sum(np.size(v) for v in vecs) * item
    return float(nbytes), float(x.numel() * len(chain.stages))


def work_bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_chain(chain, got, want) -> tuple[bool, float, int]:
    """(within tolerance, max abs err, 1-LSB count) of a chain kernel's
    output against its plain version: float32 ``rtol=atol=1e-5``; integer
    outputs exact, except 1 LSB on a chain with a ``q_unary`` stage."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        return False, float("inf"), 0
    fin = torch.isfinite(want.double())
    d = (got.double() - want.double()).abs()
    err = float(d[fin].max()) if bool(fin.any()) else 0.0
    if got.dtype == torch.float32:
        return bool(torch.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL,
                                   equal_nan=True)), err, 0
    if any(op == "q_unary" for op, _ in chain.stages):
        return bool((d <= 1).all()), err, int((d == 1).sum())
    return bool(torch.equal(got, want)), err, 0


def product_tol(dtype, k: int) -> tuple[float, float]:
    """(rtol, atol) of a product with k-term fp32 sums against its plain
    version, whose sums run in another order: ``tests/test_kernels.py``'s
    tolerances (spmv/matmul float32 ``rtol=5e-4, atol=1e-4``, bfloat16
    ``3e-2``), with the float32 atol grown as sqrt(k / 16) beyond k = 16
    for the random walk of the rounding errors of long sums."""
    import torch

    if dtype == torch.bfloat16:
        return 3e-2, 3e-2
    return 5e-4, 1e-4 * max(1.0, math.sqrt(k / 16))


def compare_product(got, want, k: int) -> tuple[bool, float]:
    """(within ``product_tol``, max abs err) of a product's output."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        return False, float("inf")
    g, w = got.float(), want.float()
    rtol, atol = product_tol(got.dtype, k)
    err = float((g - w).abs().max()) if g.numel() else 0.0
    return bool(torch.allclose(g, w, rtol=rtol, atol=atol)), err


def tile_sparse(m: int, n: int, density: float, bm: int, bk: int, seed: int,
                device):
    """A seeded (m, n) float32 matrix on ``device`` whose (bm × bk) tiles
    are each non-zero with probability ``density`` (normal values inside)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((m, n), generator=g, device=device)
    keep = torch.rand((-(-m // bm), -(-n // bk)), generator=g,
                      device=device) < density
    mask = keep.repeat_interleave(bm, 0)[:m].repeat_interleave(bk, 1)[:, :n]
    return w * mask


def spmv_work(packed, B: int) -> tuple[float, float]:
    """(bytes, operations) of one spmv call on this data: x read once, each
    kept tile and the tile tables read once, the output written once; two
    operations per multiply-add of the kept tiles."""
    kept = int(packed.valid.sum().item())
    tile = packed.bm * packed.bk
    nbytes = 4 * (B * packed.n + kept * tile + 2 * packed.valid.numel()
                  + B * packed.m)
    return float(nbytes), float(2 * B * kept * tile)


def matmul_work(M: int, N: int, K: int, item: int) -> tuple[float, float]:
    """(bytes, operations) of ``(M, K) @ (K, N)``: each operand read once,
    the output written once; two operations per multiply-add."""
    return float(item * (M * K + K * N + M * N)), float(2 * M * N * K)


def main() -> int:
    t0 = time.perf_counter()
    # ------------------------------------------------------------ 1. device
    try:
        import numpy as np
        import torch
    except ImportError as e:
        return fail("device", f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("device", "CUDA is not available; this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind} x{count}",
          flush=True)
    phase("device", t0, card)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.configs.classical import BENCHMARKS, build
        from repro_torch.core.lowering import ChainStep
        from repro_torch.kernels import build as kb
        from repro_torch.kernels import linear_pipeline as lp
        from repro_torch.kernels import megakernel as mk
        from repro_torch.kernels import ops
        from repro_torch.kernels.ref import (gemv_ref, matmul_ref,
                                             run_segment_grid_ref, spmv_ref)
        from repro_torch.serve.classical_engine import (ClassicalServeEngine,
                                                        get_program)
    except ImportError as e:
        return fail("device", f"the port is not importable: {e}")
    dev = torch.device("cuda")
    LAUNCHES = kb.LAUNCHES

    # ------------------------------------------------------------- 2. build
    t = time.perf_counter()
    try:
        libs = kb.build()
    except Exception as e:                     # noqa: BLE001 — report, exit 1
        return fail("build", str(e))
    for name, path in libs.items():
        secs = kb.BUILD_SECONDS.get(name)
        print(f"  {name}.cu: " + ("already built" if secs is None
                                  else f"{secs:.1f} s") +
              f" -> {os.path.relpath(path, ROOT)}")
    for line in "\n".join(kb.BUILD_LOG).splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or line.endswith(".cu:")):
            print("  ptxas:", line.strip())
    phase("build", t, f"{len(libs)} libraries")

    # ------------------------------------------------- 3. kernel vs plain
    t = time.perf_counter()
    report: dict = {"card": card, "kind": kind, "cases": [], "checks": {}}
    worst: dict[str, dict] = {}
    for bench in (b.name for b in BENCHMARKS):
        for prec in ("float32", "int8", "int16"):
            prog = get_program(bench, precision=prec,
                               exec_mode="megakernel_grid", device=dev)
            mkp = prog.plan.megakernel
            if mkp.n_islands or len(mkp.segments) != 1:
                return fail("kernel", f"{bench}/{prec}: {mkp.summary()}")
            (seg,) = mkp.segments
            _, x = bucket_inputs(prog, seed=1)
            grid = mk.run_segment_grid(seg, [x])
            per = [mk.run_segment(seg, [x[i]]) for i in range(BUCKET)]
            plain = run_segment_grid_ref(seg, [x])
            torch.cuda.synchronize()
            for j, g in enumerate(grid):
                if not torch.equal(g, torch.stack([p[j] for p in per])):
                    return fail("kernel", f"{bench}/{prec}: grid vs per-sample "
                                f"differ on output {seg.out_refs[j]}")
            ok, err, lsb = compare(seg, grid, plain)
            report["cases"].append(dict(bench=bench, precision=prec,
                                        max_abs_err=err, lsb_1=lsb, ok=ok))
            w = worst.setdefault(prec, {"max_abs_err": 0.0, "lsb_1": 0})
            w["max_abs_err"] = max(w["max_abs_err"], err)
            w["lsb_1"] += lsb
            if not ok:
                return fail("kernel", f"{bench}/{prec}: kernel vs plain out of "
                            f"tolerance (max abs err {err}, 1-LSB count {lsb})")
    for prec, w in worst.items():
        print(f"  megakernel {prec}: worst max abs err {w['max_abs_err']:.3g}, "
              f"1-LSB elements {w['lsb_1']}")
    seg, x, want = tie_segment()
    x = torch.from_numpy(x).to(dev)
    for lane, got in (("kernel", mk.run_segment_grid(seg, [x])),
                      ("plain", run_segment_grid_ref(seg, [x]))):
        for name, g, w in zip(seg.out_refs, got, want):
            if not np.array_equal(g.cpu().numpy(), w):
                return fail("kernel", f"ties: the {lane} version's {name!r} "
                            "is not numpy's round-half-to-even result")
    print("  ties: kernel and plain version round half to even, exactly")
    checks = {k: {"cases": 0, "max_abs_err": 0.0, "lsb_1": 0}
              for k in ("linear_chain", "linear_chain_q", "spmv", "matmul")}
    report["checks"] = checks

    def note(kernel: str, label: str, ok: bool, err: float, lsb: int = 0):
        c = checks[kernel]
        c["cases"] += 1
        c["max_abs_err"] = max(c["max_abs_err"], err)
        c["lsb_1"] += lsb
        if not ok:
            raise AssertionError(f"{kernel} {label}: kernel vs plain out of "
                                 f"tolerance (max abs err {err}, 1-LSB {lsb})")

    def check_chain(label, chain, x, extras):
        got = lp.run_chain(chain, x, extras)
        want = lp.chain_ref(chain, x, extras)
        torch.cuda.synchronize()
        note("linear_chain_q" if chain.quantized else "linear_chain", label,
             *compare_chain(chain, got, want))

    try:
        for bench in (b.name for b in BENCHMARKS):
            for prec in ("float32", "int8", "int16"):
                prog = get_program(bench, precision=prec, use_pallas=True,
                                   device=dev)
                steps = [s for s in prog.plan.steps if isinstance(s, ChainStep)]
                if not steps:
                    return fail("kernel", f"{bench}/{prec}: no chain step")
                for i, step in enumerate(steps):
                    check_chain(f"{bench}/{prec} chain {i}",
                                *chain_case(prog, step, seed=i))
        for bits in (None, 8, 16):
            for seed, shape in ((0, (4, 16, 976)), (1, (3, 5, 40)),
                                (2, (2, 7, 129))):
                rng = np.random.default_rng(seed)
                pool = FLOAT_STAGES if bits is None else Q_STAGES
                names = (list(rng.permutation(pool))
                         + list(rng.choice(pool, len(pool))))
                stages, vecs, n_arr = random_chain(rng, names, shape[-1], bits)
                x, *extras = [torch.from_numpy(random_stream(rng, shape, bits))
                              .to(dev) for _ in range(1 + n_arr)]
                check_chain(f"random bits={bits} {shape}",
                            lp.Chain(tuple(stages), tuple(vecs),
                                     bits is not None, bits or 8), x, extras)
        gx = torch.Generator(device=dev).manual_seed(11)
        zx = next(np.asarray(n.params["matrix"], np.float32)
                  for n in build("bonsai/curet-m")[0].nodes.values()
                  if n.id == "Zx")
        spmv_cases = [(torch.from_numpy(zx).to(dev), 64, 128),
                      (tile_sparse(1000, 3000, 0.3, 64, 64, 3, dev), 37, 64),
                      (tile_sparse(300, 200, 0.5, 16, 16, 4, dev), 5, 16)]
        spmv_cases += [(tile_sparse(4096, 4096, d, 128, 128, 5, dev), 64, 128)
                       for d in (0.0, 0.1, 1.0)]
        for w, B, bm in spmv_cases:
            x = torch.randn((B, w.shape[1]), generator=gx, device=dev)
            packed = ops.pack_bcsr(w.cpu().numpy(), bm=bm, bk=bm, device=dev)
            got, want = ops.spmv(packed, x), spmv_ref(w, x)
            torch.cuda.synchronize()
            note("spmv", f"{tuple(w.shape)} B={B} tiles {bm} density "
                 f"{packed.density:.3f}", *compare_product(got, want, w.shape[1]))
        for dt in (torch.float32, torch.bfloat16):
            for M, K, N in ((129, 65, 70), (4096, 4096, 4096)):
                a, b, bt = (torch.randn(s, generator=gx, device=dev).to(dt)
                            for s in ((M, K), (K, N), (N, K)))
                for tb, got, want in (
                        (False, ops.matmul(a, b),
                         matmul_ref(a.float(), b.float())),
                        (True, ops.matmul(a, bt, transpose_b=True),
                         matmul_ref(a.float(), bt.float().T))):
                    torch.cuda.synchronize()
                    note("matmul", f"{dt} {(M, K, N)} transpose_b={tb}",
                         *compare_product(got, want.to(dt), K))
    except AssertionError as e:
        return fail("kernel", str(e))
    for k, c in checks.items():
        print(f"  {k}: {c['cases']} cases, worst max abs err "
              f"{c['max_abs_err']:.3g}, 1-LSB elements {c['lsb_1']}")
    phase("kernel", t, f"{len(report['cases'])} megakernel program x precision "
          "cases (grid == per-sample bitwise) and every chain, spmv and matmul "
          "case within tolerance of its plain version")

    # ------------------------------------------------------- 4. serve (main)
    t = time.perf_counter()

    def requests(eng):
        shape = eng.program.dfg.graph_inputs["x"].shape
        rng = np.random.default_rng(7)
        return rng.standard_normal((SERVE_REQUESTS,) + tuple(shape)).astype(
            np.float32)

    def agree(bench, prec, eng, done, X, lane):
        ref = get_program(bench, precision=prec, exec_mode="interpret",
                          device=dev)
        preds = [r.pred for r in done]
        want = ref.batch(BUCKET, mode="vmap")(x=X)["Pred"].reshape(-1).cpu().tolist()
        n_ok = sum(int(a == b) for a, b in zip(preds, want))
        logits = [r.outputs[next(k for k in r.outputs if k != "Pred")]
                  for r in done]
        finite = all(bool(np.isfinite(v).all()) for v in logits)
        print(f"  {lane} {bench} {prec}: {len(done)} requests, {n_ok}/"
              f"{len(want)} predictions agree with the interpret lane",
              flush=True)
        ok = len(done) == SERVE_REQUESTS and finite and n_ok >= 0.99 * len(want)
        return ok, dict(lane=lane, bench=bench, precision=prec,
                        requests=len(done), agree=n_ok, finite=finite)

    served = []
    engines = [(bench, prec, ClassicalServeEngine(
                    bench, exec_mode="megakernel_grid", max_batch=BUCKET,
                    precision=prec, device=dev))
               for bench in ("bonsai/curet-m", "protonn/curet-m")
               for prec in ("float32", "int8")]
    LAUNCHES["megakernel"] = 0
    results = []
    for bench, prec, eng in engines:
        X = requests(eng)
        for row in X:
            eng.submit(row)
        results.append((bench, prec, eng, X, eng.run_to_completion()))
    torch.cuda.synchronize()
    launches = {"megakernel": LAUNCHES["megakernel"]}
    for bench, prec, eng, X, done in results:
        ok, rec = agree(bench, prec, eng, done, X, "megakernel_grid")
        served.append(rec)
        if not ok:
            return fail("serve", f"megakernel_grid {bench}/{prec}: {rec}")
    if launches["megakernel"] <= 0:
        return fail("serve", "the main path launched the megakernel 0 times")

    chain_engines = []
    launches.update(linear_chain=0, linear_chain_q=0)
    for bench in ("bonsai/curet-m", "protonn/curet-m"):
        for prec in ("float32", "int8"):
            eng = ClassicalServeEngine(bench, use_pallas=True,
                                       exec_mode="interpret", max_batch=BUCKET,
                                       precision=prec, device=dev)
            n_chains = sum(isinstance(s, ChainStep)
                           for s in eng.program.plan.steps)
            X = requests(eng)
            LAUNCHES["linear_chain"] = LAUNCHES["linear_chain_q"] = 0
            for row in X:
                eng.submit(row)
            done = eng.run_to_completion()
            torch.cuda.synchronize()
            mine = "linear_chain" if prec == "float32" else "linear_chain_q"
            other = "linear_chain_q" if prec == "float32" else "linear_chain"
            got, expect = LAUNCHES[mine], n_chains * (SERVE_REQUESTS // BUCKET)
            launches[mine] += got
            print(f"  use_pallas {bench} {prec}: {n_chains} chains per "
                  f"forward, {mine} launches {got} (expected {expect})")
            if got != expect or LAUNCHES[other] != 0:
                return fail("serve", f"use_pallas {bench}/{prec}: {mine} "
                            f"launched {got} times, expected {expect}")
            ok, rec = agree(bench, prec, eng, done, X, "use_pallas")
            served.append(rec)
            if not ok:
                return fail("serve", f"use_pallas {bench}/{prec}: {rec}")
            chain_engines.append((bench, prec, eng))
    phase("serve", t, f"{len(served)} engines; launches {launches}")

    # ---------------------------------------------------------- 5. ops (main)
    t = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(13)
    w_zx = torch.from_numpy(zx).to(dev)
    w_sp = tile_sparse(4096, 4096, 0.1, 128, 128, 6, dev)
    w_dn = torch.randn((4096, 4096), generator=g, device=dev)
    x_zx = torch.randn((BUCKET, 610), generator=g, device=dev)
    x_4k = torch.randn((BUCKET, 4096), generator=g, device=dev)
    a_4k = torch.randn((4096, 4096), generator=g, device=dev)
    p_zx = ops.pack_bcsr(zx, device=dev)
    p_sp = ops.pack_bcsr(w_sp.cpu().numpy(), device=dev)
    LAUNCHES["spmv"] = LAUNCHES["matmul"] = 0
    outs = [(ops.spmv(p_zx, x_zx), spmv_ref(w_zx, x_zx)),
            (ops.spmv(p_sp, x_4k), spmv_ref(w_sp, x_4k)),
            (ops.gemv(w_zx, x_zx), gemv_ref(w_zx, x_zx)),
            (ops.gemv(w_dn, x_4k), gemv_ref(w_dn, x_4k)),
            (ops.matmul(a_4k, w_dn), matmul_ref(a_4k, w_dn))]
    torch.cuda.synchronize()
    launches.update(spmv=LAUNCHES["spmv"], matmul=LAUNCHES["matmul"])
    for (got, want), k in zip(outs, (610, 4096, 610, 4096, 4096)):
        ok, err = compare_product(got, want, k)
        if not ok or not bool(torch.isfinite(got).all()):
            return fail("ops", f"result of shape {tuple(got.shape)} off its "
                        f"plain version by {err}")
    if launches["spmv"] != 2 or launches["matmul"] != 3:
        return fail("ops", f"launches {launches}: expected spmv 2, matmul 3")
    phase("ops", t, f"spmv x2, gemv x2, matmul x1 through repro_torch.kernels."
          f"ops; launches spmv {launches['spmv']}, matmul {launches['matmul']}")

    # ------------------------------------------------------------ 6. report
    t = time.perf_counter()
    saved = dict(LAUNCHES)
    timed = []
    for bench, prec, eng, X, done in results:
        (seg,) = eng.program.plan.megakernel.segments
        _, x = bucket_inputs(eng.program, seed=3)
        k_ms = median_ms(lambda: mk.run_segment_grid(seg, [x]), reps=50)
        k1_ms = median_ms(lambda: mk.run_segment_grid(seg, [x[:1]]), reps=50)
        d_ms, timer = device_ms(lambda: mk.run_segment_grid(seg, [x]), reps=50)
        d1_ms, _ = device_ms(lambda: mk.run_segment_grid(seg, [x[:1]]), reps=50)
        p_ms, _ = device_ms(lambda: run_segment_grid_ref(seg, [x]), reps=3,
                            warm=1)
        p1_ms, _ = device_ms(lambda: run_segment_grid_ref(seg, [x[:1]]),
                             reps=3, warm=1)
        b_ms, b_by = bound_ms(seg, BUCKET, prec)
        b1_ms, b1_by = bound_ms(seg, 1, prec)
        wall = statistics.median(serve_wall_s(eng, X) for _ in range(3))
        buckets = len(X) // BUCKET
        timed.append(dict(bench=bench, precision=prec, ms=d_ms, ms_nb1=d1_ms,
                          timer=timer, call_ms=k_ms, call_ms_nb1=k1_ms,
                          plain_ms=p_ms, plain_ms_nb1=p1_ms, bound_ms=b_ms,
                          bound_by=b_by, bound_ms_nb1=b1_ms, bound_by_nb1=b1_by,
                          serve_rps=len(X) / wall,
                          serve_bucket_ms=wall / buckets * 1e3,
                          device_busy=buckets * d_ms / (wall * 1e3)))
        print(f"  megakernel {bench} {prec}: bucket of {BUCKET}: kernel "
              f"{d_ms:.5f} ms on the device ({timer}; nb=1 {d1_ms:.5f}), "
              f"{k_ms:.4f} ms per call (nb=1 {k1_ms:.4f}), plain {p_ms:.3f} ms "
              f"(nb=1 {p1_ms:.3f}), bound {b_ms:.6f} ms ({b_by}; nb=1 "
              f"{b1_ms:.7f}, {b1_by}); served {len(X) / wall:.0f} requests/s, "
              f"{wall / buckets * 1e3:.3f} ms per bucket on the host clock, "
              f"kernel busy {buckets * d_ms / (wall * 1e3):.1%}", flush=True)

    def row(kernel, shape, fn, plain, library, reps, work, dtype):
        """Device times of the kernel, its plain version and the library
        call (None: there is none), the kernel's time per call between
        CUDA events, and the bound."""
        k_ms, timer = device_ms(fn, reps)
        call_ms = median_ms(fn, reps)
        p_ms, _ = device_ms(plain, reps)
        lib_ms = None if library is None else device_ms(library, reps)[0]
        b_ms, b_by = work_bound(*work, dtype)
        print(f"  {kernel} {shape}: kernel {k_ms:.5f} ms on the device "
              f"({timer}), {call_ms:.5f} ms per call, plain {p_ms:.5f} ms, "
              f"library " + ("none" if lib_ms is None else f"{lib_ms:.5f} ms")
              + f", bound {b_ms:.7f} ms ({b_by})", flush=True)
        return dict(shape=shape, ms=k_ms, timer=timer, call_ms=call_ms,
                    plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by)

    rows: dict[str, list] = {k: [] for k in checks}
    for bench, prec, eng in chain_engines:
        wall = statistics.median(serve_wall_s(eng, requests(eng))
                                 for _ in range(3))
        steps = [s for s in eng.program.plan.steps if isinstance(s, ChainStep)]
        for i, step in enumerate(steps):
            chain, x, extras = chain_case(eng.program, step, seed=i)
            kname = "linear_chain_q" if chain.quantized else "linear_chain"
            r = row(kname, f"{bench} {prec} chain {i} "
                    f"{[s[0] for s in chain.stages]} {tuple(x.shape)}",
                    lambda: lp.run_chain(chain, x, extras),
                    lambda: lp.chain_ref(chain, x, extras), None, 50,
                    chain_work(chain, x, extras),
                    "float32" if not chain.quantized else prec)
            r["serve_rps"] = SERVE_REQUESTS / wall
            rows[kname].append(r)
        print(f"  use_pallas {bench} {prec}: served "
              f"{SERVE_REQUESTS / wall:.0f} requests/s on the host clock")
    F = torch.nn.functional
    for label, packed, w, x in (("bonsai/curet-m Zx (24, 610) B=64", p_zx,
                                 w_zx, x_zx),
                                ("(4096, 4096) tile density 0.1 B=64", p_sp,
                                 w_sp, x_4k)):
        rows["spmv"].append(row(
            "spmv", f"{label} tiles 128", lambda: ops.spmv(packed, x),
            lambda: spmv_ref(w, x), lambda: F.linear(x, w), 50,
            spmv_work(packed, int(x.shape[0])), "float32"))
    for label, w, x in (("gemv (24, 610) B=64", w_zx, x_zx),
                        ("gemv (4096, 4096) B=64", w_dn, x_4k)):
        m, n = w.shape
        rows["matmul"].append(row(
            "matmul", label, lambda: ops.gemv(w, x),
            lambda: gemv_ref(w, x), lambda: F.linear(x, w), 50,
            matmul_work(int(x.shape[0]), m, n, 4), "float32"))
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        a, b = a_4k.to(dt), w_dn.to(dt)
        rows["matmul"].append(row(
            "matmul", f"matmul 4096^3 {name}", lambda: ops.matmul(a, b),
            lambda: matmul_ref(a.float(), b.float()).to(dt),
            lambda: torch.matmul(a, b), 10,
            matmul_work(4096, 4096, 4096, a.element_size()), name))
    LAUNCHES.update(saved)
    phase("report", t, "device times from the profiler trace; per-call times "
          "between CUDA events; serving wall time on the host clock")
    report.update(served=served, timed=timed, launches=launches, rows=rows)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    head = timed[0]                    # bonsai/curet-m float32, bucket of 64
    kernels = [{
        "name": "megakernel", "route": "cuda",
        "source": "src/repro_torch/csrc/megakernel.cu",
        "replaces": "src/repro/kernels/megakernel.py:230",
        "launches": launches["megakernel"],
        "max_abs_err": max(c["max_abs_err"] for c in report["cases"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"{head['bench']} {head['precision']} bucket {BUCKET}",
        "cases": timed,
    }]
    for name, source, replaces, pick in (
            ("linear_chain", "linear_chain.cu", "linear_pipeline.py:142",
             lambda r: "(64, 976)" in r["shape"] and "bonsai" in r["shape"]),
            ("linear_chain_q", "linear_chain.cu", "linear_pipeline.py:197",
             lambda r: "(64, 976)" in r["shape"] and "bonsai" in r["shape"]),
            ("spmv", "spmv.cu", "spmv.py:95", lambda r: "4096" in r["shape"]),
            ("matmul", "gemv.cu", "gemv.py:25",
             lambda r: r["shape"] == "matmul 4096^3 float32")):
        h = next(r for r in rows[name] if pick(r))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"],
            "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "shape": h["shape"], "cases": rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
