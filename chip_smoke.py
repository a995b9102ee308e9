#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:

1. device   — require CUDA, print the card's name and power limit, turn
              TF32 off;
2. build    — build the megakernel (``src/repro_torch/csrc/megakernel.cu``)
              into ``build/kernels/`` with nvcc;
3. kernel   — for all 20 Table-I programs × {float32, int8, int16}: compile
              on the host, run one seeded bucket of 64 through the kernel
              at nb=64, the kernel at nb=1 per sample, and the plain
              PyTorch version on the card; grid vs per-sample must be
              bitwise, kernel vs plain within tolerance (integer outputs
              exact, 1 LSB only after a float PE); then a segment built
              to land on rounding ties must give numpy's half-to-even
              result exactly;
4. serve    — the main path: ``ClassicalServeEngine`` on bonsai/curet-m and
              protonn/curet-m, ``exec_mode="megakernel_grid"``, float32 and
              int8, 256 requests each; predictions must agree with the
              port's interpret lane on ≥ 99 % of requests; the kernel's
              launches are counted over exactly this phase;
5. report   — median bucket times (CUDA events) of the kernel and of the
              plain version at nb=64 and nb=1, the bounds at both sizes,
              the engines' serving rate on
              the host clock and the kernel's share of it, the ``kernels``
              JSON line, the card line, and last
              ``{"ok": true, "device": {...}}``.

Needs only the repository (``src/`` on the path) and one card.  Writes the
full per-case report to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # fp32 outside the tensor cores
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
        from repro_torch.configs.classical import BENCHMARKS
        from repro_torch.kernels import megakernel as mk
        from repro_torch.kernels.ref import run_segment_grid_ref
        from repro_torch.serve.classical_engine import (ClassicalServeEngine,
                                                        get_program)
    except ImportError as e:
        return fail("device", f"the port is not importable: {e}")
    dev = torch.device("cuda")

    # ------------------------------------------------------------- 2. build
    t = time.perf_counter()
    try:
        lib = mk.build_library()
    except Exception as e:                     # noqa: BLE001 — report, exit 1
        return fail("build", str(e))
    for line in "\n".join(mk.BUILD_LOG).splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())
    phase("build", t, f"{os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t:.1f} s")

    # ------------------------------------------------- 3. kernel vs plain
    t = time.perf_counter()
    report: dict = {"card": card, "kind": kind, "cases": []}
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
        print(f"  {prec}: worst max abs err {w['max_abs_err']:.3g}, "
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
    phase("kernel", t, f"{len(report['cases'])} program x precision cases: "
          "grid == per-sample bitwise, kernel vs plain within tolerance")

    # ------------------------------------------------------ 4. serve (main)
    t = time.perf_counter()
    served = []
    engines = []
    for bench in ("bonsai/curet-m", "protonn/curet-m"):
        for prec in ("float32", "int8"):
            eng = ClassicalServeEngine(bench, exec_mode="megakernel_grid",
                                       max_batch=BUCKET, precision=prec,
                                       device=dev)
            ref = get_program(bench, precision=prec, exec_mode="interpret",
                              device=dev)
            engines.append((bench, prec, eng, ref))
    mk.LAUNCHES["megakernel"] = 0
    results = []
    for bench, prec, eng, ref in engines:
        shape = eng.program.dfg.graph_inputs["x"].shape
        rng = np.random.default_rng(7)
        X = rng.standard_normal((SERVE_REQUESTS,) + tuple(shape)).astype(np.float32)
        for row in X:
            eng.submit(row)
        done = eng.run_to_completion()
        results.append((bench, prec, eng, ref, X, done))
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["megakernel"]
    for bench, prec, eng, ref, X, done in results:
        preds = [r.pred for r in done]
        out = ref.batch(BUCKET, mode="vmap")(x=X)
        want = out["Pred"].reshape(-1).cpu().tolist()
        agree = sum(int(a == b) for a, b in zip(preds, want))
        logits = [r.outputs[next(k for k in r.outputs if k != "Pred")] for r in done]
        finite = all(bool(np.isfinite(v).all()) for v in logits)
        served.append(dict(bench=bench, precision=prec, requests=len(done),
                           agree=agree, finite=finite))
        print(f"  {bench} {prec}: {len(done)} requests, {agree}/{len(want)} "
              f"predictions agree with the interpret lane", flush=True)
        if len(done) != SERVE_REQUESTS or not finite or agree < 0.99 * len(want):
            return fail("serve", f"{bench}/{prec}: {agree}/{len(want)} agree, "
                        f"finite={finite}")
    if launches <= 0:
        return fail("serve", "the main path launched the megakernel 0 times")
    phase("serve", t, f"{len(served)} engines, megakernel launches {launches}")

    # ------------------------------------------------------------ 5. report
    t = time.perf_counter()
    timed = []
    saved = mk.LAUNCHES["megakernel"]
    for bench, prec, eng, ref, X, done in results:
        (seg,) = eng.program.plan.megakernel.segments
        _, x = bucket_inputs(eng.program, seed=3)
        k_ms = median_ms(lambda: mk.run_segment_grid(seg, [x]), reps=50)
        k1_ms = median_ms(lambda: mk.run_segment_grid(seg, [x[:1]]), reps=50)
        p_ms = median_ms(lambda: run_segment_grid_ref(seg, [x]), reps=5, warm=1)
        p1_ms = median_ms(lambda: run_segment_grid_ref(seg, [x[:1]]), reps=5,
                          warm=1)
        b_ms, b_by = bound_ms(seg, BUCKET, prec)
        b1_ms, b1_by = bound_ms(seg, 1, prec)
        wall = statistics.median(serve_wall_s(eng, X) for _ in range(3))
        buckets = len(X) // BUCKET
        timed.append(dict(bench=bench, precision=prec, ms=k_ms, ms_nb1=k1_ms,
                          plain_ms=p_ms, plain_ms_nb1=p1_ms, bound_ms=b_ms,
                          bound_by=b_by, bound_ms_nb1=b1_ms, bound_by_nb1=b1_by,
                          serve_rps=len(X) / wall,
                          serve_bucket_ms=wall / buckets * 1e3,
                          device_busy=buckets * k_ms / (wall * 1e3)))
        print(f"  {bench} {prec}: bucket of {BUCKET}: kernel {k_ms:.4f} ms "
              f"(nb=1 {k1_ms:.4f} ms), plain {p_ms:.3f} ms (nb=1 {p1_ms:.3f}), "
              f"bound {b_ms:.6f} ms ({b_by}; nb=1 {b1_ms:.7f}, {b1_by}); "
              f"served {len(X) / wall:.0f} requests/s, "
              f"{wall / buckets * 1e3:.3f} ms per bucket on the host clock, "
              f"kernel busy {buckets * k_ms / (wall * 1e3):.1%}", flush=True)
    mk.LAUNCHES["megakernel"] = saved
    phase("report", t, "median bucket times over CUDA events; serving wall "
          "time on the host clock")
    report.update(served=served, timed=timed, launches=launches)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    head = timed[0]                    # bonsai/curet-m float32, bucket of 64
    kernels = [{
        "name": "megakernel", "route": "cuda",
        "source": "src/repro_torch/csrc/megakernel.cu",
        "replaces": "src/repro/kernels/megakernel.py:230",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in report["cases"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"{head['bench']} {head['precision']} bucket {BUCKET}",
        "cases": timed,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
