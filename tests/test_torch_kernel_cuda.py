"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and ``nvcc``; without them each one
skips with the reason.  Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py

This file imports neither JAX nor the JAX package: the plain version
(``repro_torch.kernels.ref``) is the reference on the card.  Tolerances:
the bucket on the grid and the per-sample launches agree bit for bit;
kernel vs plain version is bitwise on the integer lanes, except 1 LSB on an
output with a float PE on its path (``q_unary``, ``SQL2``, ``REDUCE``,
``DOT``: the card's ``tanhf``/``expf`` and torch's may differ by an ulp),
and ``rtol=atol=1e-5`` at float32.  Rounding ties are checked exactly.

The chain kernels follow the same rule (1 LSB only on a chain with a
``q_unary`` stage).  spmv and matmul are held against ``x @ W.T`` and
``a @ b`` in float32 at ``tests/test_kernels.py``'s tolerances (spmv
``rtol=5e-4, atol=1e-4``; matmul ``1e-4`` in float32, ``3e-2`` in
bfloat16): their sums run in another order than the plain version's.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs.classical import BENCHMARKS
from repro_torch.core.compiler import MafiaCompiler
from repro_torch.core.quantize import quantize_t
from repro_torch.kernels import linear_pipeline as lp
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.ref import (float_pe_outputs, gemv_ref, matmul_ref,
                                     run_segment_grid_ref, spmv_ref)
from repro_torch.serve.classical_engine import get_program
from test_torch_pack import _chip_smoke, _isa_dfg

pytestmark = pytest.mark.cuda

BENCHES = ["bonsai/usps-b", "protonn/usps-b", "bonsai/cr-m", "protonn/cr-m"]
PRECISIONS = ["float32", "int8", "int16"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    if not (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("needs nvcc to build csrc/megakernel.cu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bucket(prog, n, seed):
    (name, spec), = prog.dfg.graph_inputs.items()
    X = np.random.default_rng(seed).standard_normal((n,) + tuple(spec.shape))
    x = torch.from_numpy(X.astype(np.float32)).to(prog.device)
    if prog.precision != "float32":
        x = quantize_t(x, prog.plan.input_exps[name], prog.plan.bits)
    return x.reshape(n, -1).contiguous()


def _check(seg, x):
    grid = mk.run_segment_grid(seg, [x])
    per = [mk.run_segment(seg, [x[i]]) for i in range(x.shape[0])]
    plain = run_segment_grid_ref(seg, [x])
    torch.cuda.synchronize()
    for j, (g, pe) in enumerate(zip(grid, float_pe_outputs(seg))):
        assert torch.equal(g, torch.stack([p[j] for p in per])), seg.out_refs[j]
        p = plain[j]
        assert g.dtype == p.dtype and g.shape == p.shape
        if g.dtype == torch.float32:
            torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-5)
        elif pe and g.dtype != torch.int32:
            assert (g.long() - p.long()).abs().max().item() <= 1
        else:
            assert torch.equal(g, p), seg.out_refs[j]


def test_ties_round_half_to_even(card):
    seg, x, want = _chip_smoke().tie_segment()
    got = mk.run_segment_grid(seg, [torch.from_numpy(x).to(card)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("bench", BENCHES)
def test_table1_kernel_matches_plain(card, bench, precision):
    prog = get_program(bench, precision=precision, exec_mode="megakernel_grid",
                       device=card)
    (seg,) = prog.plan.megakernel.segments
    _check(seg, _bucket(prog, 64, seed=1))


@pytest.mark.parametrize("precision,per_channel", [
    ("float32", False), ("int8", False), ("int16", False), ("int16", True)])
def test_full_isa_kernel_matches_plain(card, precision, per_channel):
    calib = np.random.default_rng(9).standard_normal((64, 24)).astype(np.float32)
    prog = MafiaCompiler(precision=precision, per_channel=per_channel,
                         exec_mode="megakernel_grid",
                         device=card).compile(_isa_dfg(), calib=calib)
    mkp = prog.plan.megakernel
    assert mkp.n_islands == 0
    (seg,) = mkp.segments
    ops = {i.op for i in seg.instrs}
    assert {"MATVEC", "SPMV", "SQL2", "REDUCE", "DOT", "ARGMAX"} <= ops
    _check(seg, _bucket(prog, 33, seed=2))


def test_wrapper_checks_and_counts(card):
    prog = get_program("protonn/usps-b", exec_mode="megakernel_grid",
                       device=card)
    (seg,) = prog.plan.megakernel.segments
    x = _bucket(prog, 8, seed=0)
    before = mk.LAUNCHES["megakernel"]
    mk.run_segment_grid(seg, [x])
    mk.run_segment(seg, [x[0]])
    assert mk.LAUNCHES["megakernel"] == before + 2
    with pytest.raises(TypeError):
        mk.run_segment_grid(seg, [x.double()])
    with pytest.raises(ValueError):
        mk.run_segment_grid(seg, [x[:, :-1]])
    with pytest.raises(ValueError):
        mk._launch(seg, [x.t()], 8, card)
    assert mk.LAUNCHES["megakernel"] == before + 2


# ------------------------------------------------------------ chain kernels
def _check_chain(chain, x, extras):
    got = lp.run_chain(chain, x, extras)
    want = lp.chain_ref(chain, x, extras)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
    elif any(op == "q_unary" for op, _ in chain.stages):
        assert (got.long() - want.long()).abs().max().item() <= 1
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 3, 40), (64, 976)])
@pytest.mark.parametrize("bits", [None, 8, 16], ids=["float", "int8", "int16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_kernel_matches_plain(card, seed, bits, shape):
    cs = _chip_smoke()
    rng = np.random.default_rng(seed)
    pool = cs.FLOAT_STAGES if bits is None else cs.Q_STAGES
    names = list(rng.permutation(pool)) + list(rng.choice(pool, len(pool)))
    stages, vecs, n_arr = cs.random_chain(rng, names, shape[-1], bits)
    x, *extras = [torch.from_numpy(cs.random_stream(rng, shape, bits)).to(card)
                  for _ in range(1 + n_arr)]
    _check_chain(lp.Chain(tuple(stages), tuple(vecs), bits is not None,
                          bits or 8), x, extras)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("bench", BENCHES)
def test_served_chains_match_plain(card, bench, precision):
    prog = get_program(bench, precision=precision, use_pallas=True,
                       device=card)
    steps = [s for s in prog.plan.steps if type(s).__name__ == "ChainStep"]
    assert steps
    for i, step in enumerate(steps):
        _check_chain(*_chip_smoke().chain_case(prog, step, seed=i))


@pytest.mark.parametrize("bits", [None, 8, 16], ids=["float", "int8", "int16"])
def test_chain_kernel_reads_views_at_any_storage_offset(card, bits):
    """The stream and each extra at storage offsets of 0-15 bytes: the
    elements outside an operand's 16-byte-aligned middle are the threads'
    own loads."""
    cs = _chip_smoke()
    rng = np.random.default_rng(30 + (bits or 0))
    pool = cs.FLOAT_STAGES if bits is None else cs.Q_STAGES
    for shape in ((4, 16, 976), (3, 5, 40)):
        stages, vecs, n_arr = cs.random_chain(rng, list(rng.permutation(pool)),
                                              shape[-1], bits)
        chain = lp.Chain(tuple(stages), tuple(vecs), bits is not None, bits or 8)
        ops = [torch.from_numpy(cs.random_stream(rng, shape, bits)).to(card)
               for _ in range(1 + n_arr)]
        item = ops[0].element_size()
        for off in range(0, 16, item):
            x, *extras = [cs.at_offset(t, (off + 3 * k * item) % 16)
                          for k, t in enumerate(ops)]
            assert x.data_ptr() % 16 == off
            _check_chain(chain, x, extras)


@pytest.mark.parametrize("bits", [None, 8], ids=["float", "int8"])
def test_chain_kernel_at_its_limits(card, bits):
    """16 extras and 64 stages; a 1-element stream with length-1 vecs; an
    int8 stream with int16 and int32 extras."""
    cs = _chip_smoke()
    rng = np.random.default_rng(9)
    pool = cs.FLOAT_STAGES if bits is None else cs.Q_STAGES
    arr = [op for op in pool if op.endswith("_arr")]
    names = [arr[i % len(arr)] for i in range(lp.LC_MAX_ARR)] + list(
        rng.choice([op for op in pool if not op.endswith("_arr")],
                   lp.LC_MAX_STAGES - lp.LC_MAX_ARR))
    rng.shuffle(names)
    for shape, names_ in (((7, 333), names), ((1,), list(rng.permutation(pool)))):
        stages, vecs, n_arr = cs.random_chain(rng, names_, shape[-1], bits)
        x, *extras = [torch.from_numpy(cs.random_stream(rng, shape, bits)).to(card)
                      for _ in range(1 + n_arr)]
        if bits is not None and n_arr > 2:
            extras[1], extras[2] = extras[1].to(torch.int16), extras[2].int()
        _check_chain(lp.Chain(tuple(stages), tuple(vecs), bits is not None,
                              bits or 8), x, extras)


def test_chain_call_captured_in_a_graph_replays_bitwise(card):
    """A served chain call captured in a CUDA graph: its replay equals the
    eager call bitwise, also after new operands are copied in; the capture
    counts one launch."""
    cs = _chip_smoke()
    for precision in ("float32", "int8"):
        prog = get_program("bonsai/usps-b", precision=precision,
                           use_pallas=True, device=card)
        step = [s for s in prog.plan.steps if type(s).__name__ == "ChainStep"][-1]
        chain, x, extras = cs.chain_case(prog, step, seed=1)
        eager = lp.run_chain(chain, x, extras)
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            lp.run_chain(chain, x, extras)
        torch.cuda.current_stream(card).wait_stream(side)
        name = "linear_chain_q" if chain.quantized else "linear_chain"
        before = LAUNCHES[name]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = lp.run_chain(chain, x, extras)
        assert LAUNCHES[name] == before + 1
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        _, x2, extras2 = cs.chain_case(prog, step, seed=2)
        for t, t2 in zip((x, *extras), (x2, *extras2)):
            t.copy_(t2)
        graph.replay()
        want = lp.run_chain(chain, x, extras)
        torch.cuda.synchronize()
        assert torch.equal(captured, want)


def test_use_pallas_lane_launches_one_chain_per_bucket(card):
    prog = get_program("bonsai/usps-b", use_pallas=True, device=card)
    X = np.random.default_rng(0).standard_normal((40, 256)).astype(np.float32)
    before = LAUNCHES["linear_chain"]
    out = prog.batch(16)(x=X)                      # buckets of 16, 16, 8
    torch.cuda.synchronize()
    assert LAUNCHES["linear_chain"] == before + 2 * 3
    want = get_program("bonsai/usps-b", device=card).batch(16)(x=X)
    for k, v in want.items():
        torch.testing.assert_close(out[k], v, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- spmv and matmul
# (m, n, density, bm, zero): `zero` rows set to 0 make a row block with no
# kept tile; m = 24 at bm = 128 is Zx's single 64-row slice; n = 610 and 611
# leave x's rows unaligned (4-byte copies)
@pytest.mark.parametrize("m,n,density,bm,zero", [
    (100, 300, 0.1, 16, None), (64, 64, 1.0, 16, None),
    (33, 130, 0.4, 16, None), (8, 8, 0.0, 16, None), (24, 610, 1.0, 128, None),
    (300, 200, 0.3, 128, None), (256, 256, 1.0, 128, slice(0, 128)),
    (100, 300, 1.0, 16, slice(32, 48)), (24, 611, 1.0, 128, None)])
@pytest.mark.parametrize("batch", [1, 5, 64])
def test_spmv_kernel_matches_plain(card, m, n, density, bm, zero, batch):
    rng = np.random.default_rng(m + batch)
    w = rng.normal(size=(m, n)).astype(np.float32)
    w[rng.random((m, n)) >= density] = 0.0
    if zero is not None:
        w[zero] = 0.0
    x = torch.from_numpy(rng.normal(size=(batch, n)).astype(np.float32)).to(card)
    got = ops.spmv(ops.pack_bcsr(w, bm=bm, bk=bm, device=card), x)
    want = spmv_ref(torch.from_numpy(w).to(card), x)
    torch.cuda.synchronize()
    assert got.shape == (batch, m) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(129, 65, 70), (8, 8, 8), (255, 33, 60),
                                   (64, 610, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_kernel_matches_plain(card, dtype, shape):
    m, k, n = shape
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(k)
    a, b, bt = (torch.randn(s, generator=g).to(card, dt)
                for s in ((m, k), (k, n), (n, k)))
    tol = 1e-4 if dtype == "float32" else 3e-2
    for got, want in ((ops.matmul(a, b), matmul_ref(a.float(), b.float())),
                      (ops.matmul(a, bt, transpose_b=True),
                       matmul_ref(a.float(), bt.float().T)),
                      (ops.gemv(bt, a), gemv_ref(bt.float(), a.float()))):
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == (m, n)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


# The routes of plan_matmul at larger shapes: TMA-staged and thread-staged
# wgmma, split-K, and the float32 CUDA-core kernel.  Limits are
# chip_smoke.product_tol's: bfloat16 3e-2; float32 rtol 5e-4 and an atol of
# 1e-4 grown as sqrt(k / 16) for the random walk of long fp32 sums.
@pytest.mark.parametrize("shape,route", [
    ((128, 128, 128), "tma/split"), ((1024, 1024, 1024), "tma/split"),
    ((64, 4096, 4096), "tma/split"), ((4096, 4096, 4096), "tma"),
    ((2048, 1020, 2100), "threads"), ((64, 610, 24), "threads/split"),
    ((1, 4096, 4096), "tma/split"), ((65, 1001, 129), "threads/split")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_kernel_routes_match_plain(card, dtype, shape, route):
    from repro_torch.kernels.gemv import plan_matmul

    m, k, n = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(k)
    a, b, bt = (torch.randn(s, generator=g, device=card).to(dt)
                for s in ((m, k), (k, n), (n, k)))
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    rtol, atol = (3e-2, 3e-2) if dtype == "bfloat16" else \
        (5e-4, 1e-4 * max(1.0, (k / 16) ** 0.5))
    for tb, bb in ((False, b), (True, bt)):
        plan = plan_matmul(m, n, k, dt, tb, a.data_ptr(), bb.data_ptr(), sms)
        if dtype == "bfloat16":
            assert plan.kernel == "wgmma"
            assert plan.staging == route.split("/")[0]
        else:
            assert plan.kernel == "simt"
        assert (plan.splits > 1) == route.endswith("split")
        got = ops.matmul(a, bb, transpose_b=tb)
        want = matmul_ref(a.float(), bb.float().T if tb else bb.float())
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == (m, n)
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def test_bf16_served_shapes_run_on_the_tensor_cores(card):
    """The bf16 GEMV at B = 64 and qwen2.5-3b's bf16 prefill shapes launch
    the wgmma kernels and never the CUDA-core ones."""
    from repro_torch.kernels.flash_attention import flash_attention_fused

    before = dict(LAUNCHES)
    for m, n in ((4096, 4096), (24, 610)):
        ops.gemv(_randn(card, m, n, dtype=torch.bfloat16),
                 _randn(card, 64, n, dtype=torch.bfloat16))
    buckets = (8, 16, 64, 128, 512, 1024)
    for S in buckets:
        q = _randn(card, 1, S, 16, 128, dtype=torch.bfloat16)
        kv = _randn(card, 1, S, 2, 128, dtype=torch.bfloat16)
        flash_attention_fused(q, kv, kv, round_p=False)
    torch.cuda.synchronize()
    assert LAUNCHES["matmul_wgmma"] == before["matmul_wgmma"] + 2
    assert LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + len(buckets)
    for name in ("matmul", "flash_attention"):
        assert LAUNCHES[name] == before[name]


def test_new_wrappers_check_and_count(card):
    before = dict(LAUNCHES)
    x = torch.randn(4, 40, device=card)
    chain = lp.Chain((("tanh", None), ("add_arr", 0)))
    lp.run_chain(chain, x, [x])
    packed = ops.pack_bcsr(np.eye(40, dtype=np.float32), bm=16, bk=16,
                           device=card)
    ops.spmv(packed, x)
    ops.matmul(x, x, transpose_b=True)
    torch.cuda.synchronize()
    for name in ("linear_chain", "spmv", "matmul"):
        assert LAUNCHES[name] == before[name] + 1
    with pytest.raises(ValueError):
        lp.run_chain(chain, x, [x.cpu()])              # wrong device
    with pytest.raises(TypeError):
        lp.run_chain(chain, x.double(), [x.double()])  # wrong dtype
    with pytest.raises(ValueError):
        lp.run_chain(chain, x[:, ::2], [x[:, ::2]])    # not contiguous
    with pytest.raises(ValueError):
        ops.spmv(ops.pack_bcsr(np.eye(40, dtype=np.float32), device="cpu"), x)
    with pytest.raises(ValueError):
        ops.spmv(packed, torch.randn(40, 4, device=card).t())
    with pytest.raises(ValueError):
        ops.matmul(x, x.cpu(), transpose_b=True)
    with pytest.raises(TypeError):
        ops.matmul(x, x.bfloat16(), transpose_b=True)
    with pytest.raises(ValueError):
        ops.matmul(x.t(), x)
    for name in ("linear_chain", "spmv", "matmul"):
        assert LAUNCHES[name] == before[name] + 1


# ------------------------------------------------------- attention kernels
# Held against their plain versions (repro_torch.kernels.ref): float32
# rtol = atol = 1e-5; bfloat16 within one bf16 ulp of the largest output
# magnitude (the sums run in another order, so an output near a rounding
# boundary may round the other way).
def _attn_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        mag = float(want.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        assert float((got.float() - want.float()).abs().max()) <= ulp


def _randn(card, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=g, device=card).to(dtype)


@pytest.mark.parametrize("round_p", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,dh,causal", [
    (1, 8, 8, 16, 2, 128, True), (1, 100, 100, 16, 2, 128, True),
    (2, 64, 64, 4, 4, 32, True), (2, 33, 33, 4, 1, 128, True),
    (1, 16, 16, 2, 2, 256, True), (1, 70, 70, 8, 2, 100, True),
    (1, 257, 257, 8, 1, 64, True), (2, 40, 40, 4, 4, 32, False),
    (1, 24, 90, 8, 2, 64, False), (1, 50, 20, 4, 2, 16, True),
    (1, 1024, 1024, 16, 2, 128, True), (1, 300, 300, 8, 2, 256, True),
    (1, 1, 1, 16, 1, 72, True), (2, 37, 37, 16, 1, 200, False),
    (1, 130, 130, 32, 2, 64, True), (1, 600, 600, 16, 2, 128, True),
    (1, 70, 70, 8, 2, 320, True), (2, 33, 45, 4, 1, 320, False),
    (1, 64, 64, 12, 2, 64, True), (1, 90, 90, 12, 2, 128, False),
    (1, 1024, 1024, 16, 16, 128, True), (1, 1024, 1024, 32, 8, 128, True),
    (1, 1024, 1024, 32, 32, 128, True), (1, 1024, 1024, 128, 128, 192, True),
    (2, 77, 77, 128, 128, 192, True)])
def test_flash_attention_kernel_matches_plain(card, B, Sq, Sk, H, KV, dh,
                                              causal, dtype, round_p):
    from repro_torch.kernels.flash_attention import flash_attention_fused
    from repro_torch.kernels.ref import flash_attention_ref

    dt = getattr(torch, dtype)
    q = _randn(card, B, Sq, H, dh, dtype=dt, seed=1)
    k = _randn(card, B, Sk, KV, dh, dtype=dt, seed=2)
    v = _randn(card, B, Sk, KV, dh, dtype=dt, seed=3)
    got = flash_attention_fused(q, k, v, causal=causal, round_p=round_p)
    want = flash_attention_ref(q, k, v, causal=causal, round_p=round_p)
    torch.cuda.synchronize()
    _attn_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,window", [
    (1, 1024, 32, 32, 224, 256), (1, 100, 32, 32, 224, 0),
    (1, 1024, 32, 32, 224, 0), (1, 1024, 16, 2, 128, 256),
    (1, 300, 16, 2, 128, 64), (2, 100, 4, 4, 64, 1), (1, 257, 8, 1, 64, 100),
    (1, 130, 12, 2, 64, 33), (1, 70, 8, 2, 320, 16), (2, 77, 4, 4, 32, 500)])
def test_flash_attention_window_and_dh_224_match_plain(card, B, S, H, KV, dh,
                                                       window, dtype):
    """zamba2's shared block (H = KV = 32, dh 224) and sliding windows on
    both kernels: the key tiles below a block's window skipped, the edge
    tiles masked, rows that meet no key in their first tiles."""
    from repro_torch.kernels.flash_attention import flash_attention_fused
    from repro_torch.kernels.ref import flash_attention_ref

    dt = getattr(torch, dtype)
    q = _randn(card, B, S, H, dh, dtype=dt, seed=41)
    k = _randn(card, B, S, KV, dh, dtype=dt, seed=42)
    v = _randn(card, B, S, KV, dh, dtype=dt, seed=43)
    for rp in (False, True):
        got = flash_attention_fused(q, k, v, window=window, round_p=rp)
        want = flash_attention_ref(q, k, v, window=window, round_p=rp)
        torch.cuda.synchronize()
        _attn_close(got, want)


@pytest.mark.parametrize("B,S,H,KV,dh,window", [
    (1, 1024, 16, 2, 128, 0), (1, 300, 32, 32, 224, 0),
    (1, 1024, 32, 32, 224, 256), (2, 77, 8, 2, 320, 0)])
def test_flash_attention_rounds_p_to_bfloat16_at_float32(card, B, S, H, KV, dh,
                                                         window):
    """``round_p=torch.bfloat16`` on float32 (the model's ``probs_bf16``):
    ``fa_kernel`` rounds each p to bfloat16 against the row's max, as its
    plain version does, within float32's 1e-5 of it at dh <= 256; above,
    where the kernel splits the output columns and rounds against a key
    tile's running max, within one bf16 ulp of the output's largest
    magnitude."""
    from repro_torch.kernels.flash_attention import flash_attention_fused
    from repro_torch.kernels.ref import flash_attention_ref

    q = _randn(card, B, S, H, dh, seed=44)
    k = _randn(card, B, S, KV, dh, seed=45)
    v = _randn(card, B, S, KV, dh, seed=46).bfloat16().float()
    got = flash_attention_fused(q, k, v, window=window, round_p=torch.bfloat16)
    want = flash_attention_ref(q, k, v, window=window, round_p=torch.bfloat16)
    fp32 = flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    if dh <= 256:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    mag = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert not torch.equal(got, flash_attention_fused(q, k, v, window=window,
                                                      round_p=False))
    assert float((want - fp32).abs().max()) > 0


def test_flash_attention_reads_strided_views(card):
    """q, k, v as slices of one fused (B, S, H + 2 KV, dh) projection, the
    layout a fused QKV product gives: no copy, same result."""
    from repro_torch.kernels.flash_attention import flash_attention_fused
    from repro_torch.kernels.ref import flash_attention_ref

    qkv = _randn(card, 2, 75, 16 + 2 + 2, 128, seed=4)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:18], qkv[:, :, 18:]
    assert not q.is_contiguous()
    got = flash_attention_fused(q, k, v, round_p=False)
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    _attn_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_reads_a_strided_cache(card, dtype):
    """k and v as the first 200 positions of one layer of a stacked (L, B,
    S, KV, dh) cache: strided in batch and layer, read in place."""
    from repro_torch.kernels.flash_attention import flash_attention_fused
    from repro_torch.kernels.ref import flash_attention_ref

    dt = getattr(torch, dtype)
    kc = _randn(card, 3, 2, 300, 2, 128, dtype=dt, seed=11)
    vc = _randn(card, 3, 2, 300, 2, 128, dtype=dt, seed=12)
    q = _randn(card, 2, 200, 16, 128, dtype=dt, seed=13)
    k, v = kc[1, :, :200], vc[1, :, :200]
    assert not k.is_contiguous()
    for rp in (False, True):
        got = flash_attention_fused(q, k, v, round_p=rp)
        want = flash_attention_ref(q, k.contiguous(), v.contiguous(), round_p=rp)
        torch.cuda.synchronize()
        _attn_close(got, want)


SERVED_LENS = [905, 689, 562, 319, 357, 88, 122, 63]   # qwen2.5-3b, last step


@pytest.mark.parametrize("lens_on", ["host", "card"])
@pytest.mark.parametrize("round_p", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,lens", [
    (8, 2048, 16, 2, 128, None), (2, 64, 8, 4, 32, None),
    (3, 100, 4, 1, 64, None), (1, 32, 16, 2, 128, None),
    (2, 50, 8, 8, 256, None), (4, 77, 8, 2, 100, None),
    (8, 2048, 16, 2, 128, SERVED_LENS), (8, 2048, 16, 2, 128, [1] * 8),
    (2, 300, 32, 2, 64, None), (2, 5000, 16, 1, 128, [4999, 17]),
    (2, 64, 128, 1, 320, None), (3, 40, 100, 1, 64, None),
    (8, 2048, 16, 16, 128, SERVED_LENS), (8, 2048, 32, 8, 128, SERVED_LENS),
    (8, 2048, 32, 32, 128, SERVED_LENS)])
def test_decode_attention_kernel_matches_plain(card, B, S, H, KV, dh, lens,
                                               dtype, round_p, lens_on):
    """None: random lengths with a 1 and an S; then the served lengths,
    every length 1, G = 16 rows of 64, a long cache, and G = 128 with
    dh = 320 and G = 100 (two groups of query rows)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    dt = getattr(torch, dtype)
    q = _randn(card, B, H, dh, dtype=dt, seed=5)
    k = _randn(card, B, S, KV, dh, dtype=dt, seed=6)
    v = _randn(card, B, S, KV, dh, dtype=dt, seed=7)
    if lens is None:
        lens = np.random.default_rng(S).integers(1, S + 1, size=B)
        lens[0], lens[-1] = 1, S
    lens = np.asarray(lens, np.int32)
    given = lens if lens_on == "host" else torch.from_numpy(lens).to(card)
    got = decode_attention(q, k, v, given, round_p=round_p)
    want = decode_attention_ref(q, k, v, torch.from_numpy(lens).to(card),
                                round_p=round_p)
    torch.cuda.synchronize()
    _attn_close(got, want)


RING = 256
RING_POS = [905, 689, 562, 319, 357, 88, 122, 63]     # past and below the ring


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_on_a_ring_cache(card, dtype):
    """zamba2's shared decode (H = KV = 32, dh 224) against a ring of 256
    slots: the lengths are min(pos + 1, 256), given on the card; no
    synchronisation, and a CUDA graph's replay equals the eager call."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    dt = getattr(torch, dtype)
    q = _randn(card, 8, 32, 224, dtype=dt, seed=51)
    k = _randn(card, 8, RING, 32, 224, dtype=dt, seed=52)
    v = _randn(card, 8, RING, 32, 224, dtype=dt, seed=53)
    lens = torch.tensor(np.minimum(np.asarray(RING_POS) + 1, RING),
                        dtype=torch.int32, device=card)
    decode_attention(q, k, v, lens, round_p=False)      # build, plan, grant
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = decode_attention(q, k, v, lens, round_p=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _attn_close(eager, decode_attention_ref(q, k, v, lens))
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        decode_attention(q, k, v, lens, round_p=False)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention(q, k, v, lens, round_p=False)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


WINDOW_LENS = [1, 255, 256, 257, 2048, 1000, 33, 2047]


@pytest.mark.parametrize("window", [256, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,dh", [(16, 2, 128), (32, 32, 224)],
                         ids=["qwen", "zamba2"])
def test_decode_attention_with_a_window(card, H, KV, dh, dtype, window):
    """A window on a full-length cache (S 2,048): starts max(0, len - W)
    on the card, lengths 1, W - 1, W, W + 1 and S; the windowed grid
    (ceil(W / chunk) + 1 splits) within the attention limits of the plain
    version, no synchronisation, two calls and a CUDA graph's replay
    bitwise equal; and a piece of a sequence split over ranks (local
    starts, one piece wholly below its start) with ``return_lse``."""
    from repro_torch.kernels.decode_attention import decode_attention, plan_decode
    from repro_torch.kernels.ref import decode_attention_ref

    dt = getattr(torch, dtype)
    B, S = 8, 2048
    assert plan_decode(B, KV, H // KV, S, dh, dt, window=window).windowed
    q = _randn(card, B, H, dh, dtype=dt, seed=61)
    k = _randn(card, B, S, KV, dh, dtype=dt, seed=62)
    v = _randn(card, B, S, KV, dh, dtype=dt, seed=63)
    lens = torch.tensor(WINDOW_LENS, dtype=torch.int32, device=card)
    starts = (lens - window).clamp(min=0)
    kw = dict(cache_start=starts, window=window, round_p=False)
    decode_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = decode_attention(q, k, v, lens, **kw)
        again = decode_attention(q, k, v, lens, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _attn_close(eager, decode_attention_ref(q, k, v, lens, **kw))
    assert torch.equal(eager, again)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        decode_attention(q, k, v, lens, **kw)
    torch.cuda.current_stream(card).wait_stream(side)
    with torch.cuda.graph(graph):
        captured = decode_attention(q, k, v, lens, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    Sl = S // 4                                   # rank 1 of 4 over the sequence
    pl, ps = (lens - Sl).clamp(0, Sl), (starts - Sl).clamp(0, Sl)
    out, lse = decode_attention(q, k[:, Sl:2 * Sl], v[:, Sl:2 * Sl], pl,
                                cache_start=ps, window=window, round_p=False,
                                return_lse=True)
    wout, wlse = decode_attention_ref(q, k[:, Sl:2 * Sl], v[:, Sl:2 * Sl],
                                      pl, cache_start=ps, window=window,
                                      return_lse=True)
    torch.cuda.synchronize()
    empty = (ps >= pl).cpu()
    assert bool(empty.any()) and not bool(empty.all())
    assert bool((lse.cpu()[empty] == -torch.inf).all())
    _attn_close(out, wout)
    torch.testing.assert_close(lse[~empty.to(card)], wlse[~empty.to(card)],
                               rtol=1e-5, atol=1e-5)


def test_decode_attention_reads_a_layer_of_the_stacked_cache(card):
    """A layer's slice of the engine's (L, B, S, KV, dh) cache, and lengths
    given on the card."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    kc = _randn(card, 3, 4, 300, 2, 128, seed=8)
    vc = _randn(card, 3, 4, 300, 2, 128, seed=9)
    q = _randn(card, 4, 16, 128, seed=10)
    lens = torch.tensor([1, 64, 65, 300], dtype=torch.int32, device=card)
    got = decode_attention(q, kc[1], vc[1], lens, round_p=False)
    want = decode_attention_ref(q, kc[1], vc[1], lens)
    torch.cuda.synchronize()
    _attn_close(got, want)


def test_kernels_give_bitwise_equal_results_on_two_calls(card):
    """The split passes merge in a fixed order, without atomics."""
    from repro_torch.kernels.decode_attention import decode_attention

    for dt in (torch.float32, torch.bfloat16):
        q = _randn(card, 8, 16, 128, dtype=dt, seed=1)
        k = _randn(card, 8, 2048, 2, 128, dtype=dt, seed=2)
        v = _randn(card, 8, 2048, 2, 128, dtype=dt, seed=3)
        for rp in (False, True):
            a = decode_attention(q, k, v, SERVED_LENS, round_p=rp)
            b = decode_attention(q, k, v, SERVED_LENS, round_p=rp)
            torch.cuda.synchronize()
            assert torch.equal(a, b)
    rng = np.random.default_rng(0)
    for m, n, bm, B in ((24, 610, 128, 64), (4096, 4096, 128, 64)):
        w = rng.normal(size=(m, n)).astype(np.float32)
        keep = rng.random((-(-m // bm), -(-n // bm))) < (1.0 if m == 24 else 0.1)
        w *= np.kron(keep, np.ones((bm, bm), np.float32))[:m, :n]
        packed = ops.pack_bcsr(w, bm=bm, bk=bm, device=card)
        x = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32)).to(card)
        a, b = ops.spmv(packed, x), ops.spmv(packed, x)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [256, 1100])
@pytest.mark.parametrize("H,KV,dh,window,mla", [
    (128, 128, 192, 0, True),       # deepseek-v2's MLA, v zero past 128
    (32, 32, 224, 0, False),        # zamba2-7b's shared block
    (32, 32, 224, 256, False),      # ... with its long-context window
    (48, 8, 128, 0, False),         # internvl2-26b: G 6
])
def test_flash_backward_takes_the_tensor_cores_at_the_trained_heads(
        card, S, H, KV, dh, window, mla):
    """The bf16 heads the tensor-core backward took from the CUDA cores
    (DHP 256, G 6): routed to ``fbt_*``, counted, two calls bitwise equal,
    dq, dk, dv within two bf16 ulps of each one's largest magnitude of the
    plain version and lse within 1e-5 (``chip_smoke.py``'s limits)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    g = torch.Generator(device=card).manual_seed(S + dh + H)
    q, go = (torch.randn((1, S, H, dh), generator=g, device=card).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((1, S, KV, dh), generator=g, device=card).bfloat16()
            for _ in range(2))
    if mla:
        v[..., 128:] = 0
        go[..., 128:] = 0
    assert fa.flash_bwd_route(q, k, v) == "wgmma"
    before = LAUNCHES["flash_attention_bwd_wgmma"], LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, go, window=window)
    again = fa.flash_attention_bwd(q, k, v, go, window=window)
    torch.cuda.synchronize()
    assert (LAUNCHES["flash_attention_bwd_wgmma"], LAUNCHES["flash_attention_bwd"]) \
        == (before[0] + 2, before[1])
    want = flash_attention_bwd_ref(q, k, v, go, window=window)
    for name, a, b, c in zip(("dq", "dk", "dv", "lse"), got, want, again):
        assert torch.equal(a, c), f"{name}: two calls differ"
        top = float(b.float().abs().max())
        tol = (1e-5 * max(top, 1.0) if name == "lse"
               else 2 * 2.0 ** (np.floor(np.log2(top)) - 7))
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"


def test_attention_wrappers_check_and_count(card):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention_fused

    before = dict(LAUNCHES)
    q, k = _randn(card, 1, 9, 4, 32), _randn(card, 1, 9, 2, 32)
    flash_attention_fused(q, k, k)
    decode_attention(q[:, 0], k, k, [9])
    torch.cuda.synchronize()
    for name in ("flash_attention", "decode_attention"):
        assert LAUNCHES[name] == before[name] + 1
    with pytest.raises(TypeError):
        flash_attention_fused(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        flash_attention_fused(q, k.cpu(), k)
    with pytest.raises(ValueError):
        flash_attention_fused(q.transpose(1, 3).contiguous().transpose(1, 3), k, k)
    for bad in ([0], [10]):
        with pytest.raises(ValueError, match="cache_len"):
            decode_attention(q[:, 0], k, k, bad)
    with pytest.raises(TypeError):
        decode_attention(q[:, 0].bfloat16(), k, k, [9])
    for name in ("flash_attention", "decode_attention"):
        assert LAUNCHES[name] == before[name] + 1
    # lengths on the card are not read back: the kernel clamps them into
    # [0, S], and a length of 0 gives a zero row
    got = decode_attention(q[:, 0], k, k, torch.tensor([0], dtype=torch.int32,
                                                       device=card))
    big = decode_attention(q[:, 0], k, k, torch.tensor([99], dtype=torch.int32,
                                                       device=card))
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(big, decode_attention(q[:, 0], k, k, [9]))


def test_lm_engine_on_the_card_matches_the_cpu(card):
    """qwen2.5's SMOKE config in float32: the same greedy tokens on the card
    (both attention kernels) as on the CPU (their plain versions), and one
    flash launch per layer per prefill, one decode launch per layer per
    step."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch("qwen2.5-3b").smoke
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (5, 17, 40)]
    cpu_model = init_params(cfg, 0, "cpu")
    done = {}
    for dev in ("cpu", card):
        model = cpu_model if dev == "cpu" else init_params(cfg, 0, "cpu")
        if dev != "cpu":
            model = _to_card(model, cfg, card)
        eng = ServeEngine(cfg, model, max_batch=2, max_len=64, device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        before = dict(LAUNCHES)
        done[str(dev)] = [r.tokens for r in eng.run_to_completion()]
        if dev != "cpu":
            steps = eng.metrics.snapshot()["batches"]
            assert LAUNCHES["flash_attention"] - before["flash_attention"] \
                == cfg.n_layers * len(prompts)
            assert LAUNCHES["decode_attention"] - before["decode_attention"] \
                == cfg.n_layers * steps
    assert done["cpu"] == done[str(card)]


def test_mla_prefill_pads_v_for_the_flash_kernel(card):
    """deepseek-v2's prefill widths (H = 128, q and k of 128 + 64, v of 128
    zero-padded to 192): the kernel's first 128 columns against the plain
    attention with v of width 128, and its padded columns exactly zero."""
    from repro_torch.kernels.flash_attention import flash_attention_fused
    from repro_torch.models.attention import plain_attention

    for dt in (torch.float32, torch.bfloat16):
        q = _randn(card, 1, 300, 128, 192, dtype=dt, seed=31)
        k = _randn(card, 1, 300, 128, 192, dtype=dt, seed=32)
        v = _randn(card, 1, 300, 128, 128, dtype=dt, seed=33)
        got = flash_attention_fused(q, k, torch.nn.functional.pad(v, (0, 64)),
                                    round_p=False)
        want = plain_attention(q, k, v, scale=192 ** -0.5)
        torch.cuda.synchronize()
        assert torch.equal(got[..., 128:], torch.zeros_like(got[..., 128:]))
        _attn_close(got[..., :128].contiguous(), want)


@pytest.mark.parametrize("arch", ["granite-8b", "codeqwen1.5-7b", "olmoe-1b-7b",
                                  "deepseek-v2-236b", "command-r-35b",
                                  "musicgen-medium", "internvl2-26b"])
def test_family_engines_on_the_card_match_the_cpu(card, arch):
    """Each family's SMOKE config in float32 at its own capacity: the same
    greedy tokens on the card (both attention kernels; MLA decode in plain
    products) as on the CPU, one flash launch per layer per prefill and,
    for GQA, one decode launch per layer per step."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch(arch).smoke
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (5, 17, 40)]
    cpu_model = init_params(cfg, 0, "cpu")
    done = {}
    for dev in ("cpu", card):
        model = cpu_model if dev == "cpu" else _to_card(cpu_model, cfg, card)
        eng = ServeEngine(cfg, model, max_batch=2, max_len=64, device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        before = dict(LAUNCHES)
        done[str(dev)] = [r.tokens for r in eng.run_to_completion()]
        if dev != "cpu":
            steps = eng.metrics.snapshot()["batches"]
            assert LAUNCHES["flash_attention"] - before["flash_attention"] \
                == cfg.n_layers * len(prompts)
            assert LAUNCHES["decode_attention"] - before["decode_attention"] \
                == (0 if cfg.use_mla else cfg.n_layers * steps)
    assert done["cpu"] == done[str(card)]


@pytest.mark.parametrize("arch,window", [("mamba2-1.3b", 0), ("zamba2-7b", 0),
                                         ("zamba2-7b", 8)])
def test_state_families_on_the_card_match_the_cpu(card, arch, window):
    """mamba2's and zamba2's SMOKE configs in float32 (zamba2 also with a
    window of 8: a ring shorter than the prompts): the same greedy tokens
    on the card as on the CPU; flash launches = shared applications x
    prefills, decode launches = shared applications x steps (0 for the
    ssm); a decode step syncs nowhere and makes one host-to-device copy."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_arch(arch).smoke, attn_window=window)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (1, 5, 17, 40)]
    cpu_model = init_params(cfg, 0, "cpu")
    done = {}
    for dev in ("cpu", card):
        model = cpu_model if dev == "cpu" else _to_card(cpu_model, cfg, card)
        eng = ServeEngine(cfg, model, max_batch=2, max_len=64, device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        before = dict(LAUNCHES)
        done[str(dev)] = [r.tokens for r in eng.run_to_completion()]
        if dev != "cpu":
            steps = eng.metrics.snapshot()["batches"]
            G = cfg.hybrid_groups
            assert LAUNCHES["flash_attention"] - before["flash_attention"] \
                == G * len(prompts)
            assert LAUNCHES["decode_attention"] - before["decode_attention"] \
                == G * steps
            caches = init_cache(cfg, 2, 64, device=card)
            tok, pos = np.array([3, 4], np.int32), np.array([40, 2], np.int32)
            model.forward_decode(tok, caches, pos)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                model.forward_decode(tok, caches, pos)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    assert done["cpu"] == done[str(card)]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_decode_step_syncs_never(card, arch):
    """A MoE decode step (routing, the capacity dispatch by index_add_, the
    batched expert products, the gather) under CUDA's sync debug mode,
    which raises on a synchronisation; and the step's logits equal the same
    step's on the CPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import init_cache, init_params

    cfg = get_arch(arch).smoke
    cpu_model = init_params(cfg, 0, "cpu")
    model = _to_card(cpu_model, cfg, card)
    tok = np.array([3, 17, 42, 9], np.int32)
    pos = np.array([0, 1, 2, 5], np.int32)
    caches = init_cache(cfg, 4, 16, device=card)
    model.forward_decode(tok, caches, pos)              # warm: routes, grants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = model.forward_decode(tok, caches, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, _ = cpu_model.forward_decode(tok, init_cache(cfg, 4, 16, device="cpu"),
                                       pos)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-5, atol=1e-5)


def _to_card(model, cfg, card):
    from repro_torch.models.transformer import Transformer

    out = Transformer(cfg, card)
    with torch.no_grad():
        for a, b in zip(out.parameters(), model.parameters()):
            a.copy_(b)
    return out


def test_decode_attention_with_card_lengths_syncs_never_and_captures(card):
    """Lengths on the card: the call makes no synchronisation (CUDA's sync
    debug mode raises on one), and the call captured in a CUDA graph gives,
    on replay with new lengths copied in, what the eager call gives."""
    from repro_torch.kernels.decode_attention import decode_attention

    for dt in (torch.float32, torch.bfloat16):
        q = _randn(card, 8, 16, 128, dtype=dt, seed=21)
        k = _randn(card, 8, 2048, 2, 128, dtype=dt, seed=22)
        v = _randn(card, 8, 2048, 2, 128, dtype=dt, seed=23)
        lens = torch.tensor(SERVED_LENS, dtype=torch.int32, device=card)
        decode_attention(q, k, v, lens, round_p=False)     # build, plan, grant
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = decode_attention(q, k, v, lens, round_p=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            decode_attention(q, k, v, lens, round_p=False)
        torch.cuda.current_stream(card).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = LAUNCHES["decode_attention"]
        with torch.cuda.graph(graph):
            captured = decode_attention(q, k, v, lens, round_p=False)
        assert LAUNCHES["decode_attention"] == before + 1
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        lens.copy_(torch.tensor([1, 2048, 33, 64, 65, 7, 500, 1000],
                                dtype=torch.int32))
        graph.replay()
        want = decode_attention(q, k, v, lens, round_p=False)
        torch.cuda.synchronize()
        assert torch.equal(captured, want)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("bench", [b.name for b in BENCHMARKS])
def test_every_table1_program_matches_plain(card, bench, precision):
    """All 20 Table-I programs: the kernel against its plain version on a
    bucket of 64, grid equal to per-sample bit for bit."""
    prog = get_program(bench, precision=precision, exec_mode="megakernel_grid",
                       device=card)
    (seg,) = prog.plan.megakernel.segments
    _check(seg, _bucket(prog, 64, seed=3))


# ------------------- the front of the pipeline: training, MLPerf-Tiny islands
TINY = [("float32", False), ("int8", False), ("int8", True)]


def _tiny(card, name, precision, per_channel, lane="megakernel_grid"):
    from repro_torch.configs import mlperf_tiny as mt

    calib = ({"input": mt.sample_inputs(name, 128, seed=7)}
             if precision != "float32" else None)
    return MafiaCompiler(precision=precision, per_channel=per_channel,
                         exec_mode=lane, device=card).compile(
        mt.build(name), calib=calib)


@pytest.mark.parametrize("precision,per_channel", TINY,
                         ids=["float32", "int8", "int8-per-channel"])
@pytest.mark.parametrize("name", ["kws_mlp", "tiny_cnn"])
def test_mlperf_tiny_segment_matches_plain(card, name, precision, per_channel):
    """The MLPerf-Tiny segment on the values its islands hand it (kws_mlp's
    128 x 490 matrix streamed through a buffer): grid == per-sample bitwise,
    kernel vs plain version as every segment."""
    from repro_torch.configs import mlperf_tiny as mt

    prog = _tiny(card, name, precision, per_channel)
    (seg,) = prog.plan.megakernel.segments
    (x,), islands = _chip_smoke().walk_plan(prog, mt.sample_inputs(name, 64))
    assert len(islands) == {"kws_mlp": 2, "tiny_cnn": 8}[name]
    _check(seg, x)


@pytest.mark.parametrize("precision,per_channel", TINY,
                         ids=["float32", "int8", "int8-per-channel"])
@pytest.mark.parametrize("name", ["kws_mlp", "tiny_cnn"])
def test_mlperf_tiny_islands_run_on_the_card(card, name, precision,
                                             per_channel):
    """Islands on the card between grid launches: one megakernel launch per
    bucket, no synchronisation inside a bucket whose input is on the card,
    and the program within 1e-5 (float32) or 1 LSB of the output scale
    (int8) of the interpret lane on the card."""
    from repro_torch.configs import mlperf_tiny as mt

    prog = _tiny(card, name, precision, per_channel)
    ref = _tiny(card, name, precision, per_channel, lane="interpret")
    x = torch.from_numpy(mt.sample_inputs(name, 128)).to(card)
    batched = prog.batch(64)
    batched(input=x[:64])
    torch.cuda.synchronize()
    before = LAUNCHES["megakernel"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = next(iter(batched(input=x).values()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert LAUNCHES["megakernel"] == before + 2
    want = next(iter(ref.batch(64)(input=x).values()))
    if precision == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        (e_out,) = prog.plan.output_exps.values()
        assert (got.double() - want.double()).abs().max().item() <= 2.0 ** -e_out


@pytest.mark.parametrize("precision", ["float32", "int8"])
@pytest.mark.parametrize("bench", ["bonsai/curet-m", "protonn/curet-m"])
def test_trained_programs_match_plain(card, bench, precision):
    """Programs trained on the card (``get_program(trained=True)``): the
    segment and every chain step against their plain versions."""
    prog = get_program(bench, trained=True, precision=precision,
                       exec_mode="megakernel_grid", device=card)
    (seg,) = prog.plan.megakernel.segments
    _check(seg, _bucket(prog, 64, seed=4))
    chained = get_program(bench, trained=True, precision=precision,
                          use_pallas=True, device=card)
    steps = [s for s in chained.plan.steps if type(s).__name__ == "ChainStep"]
    assert steps
    for i, step in enumerate(steps):
        _check_chain(*_chip_smoke().chain_case(chained, step, seed=i))


@pytest.mark.parametrize("algo", ["bonsai", "protonn"])
def test_training_on_the_card_matches_the_cpu(card, algo):
    """20 steps of ``train`` on the card and on the CPU from the same
    initialisation: losses within ``rtol = 1e-4`` and parameters within
    ``atol = 1e-4`` (float32 sums in other orders, TF32 off)."""
    from repro_torch.data.datasets import get_spec, make_dataset
    from repro_torch.models import bonsai, protonn

    mod = bonsai if algo == "bonsai" else protonn
    spec = get_spec("usps-b")
    X, y, _, _ = make_dataset(spec, n_train=512, seed=0)
    cfg = mod.from_spec(spec)
    runs = {}
    for dev in ("cpu", card):
        hist: list[float] = []
        runs[str(dev)] = (mod.train(cfg, X, y, steps=20, device=dev,
                                    history=hist), hist)
    (p_cpu, h_cpu), (p_card, h_card) = runs.values()
    np.testing.assert_allclose(h_card, h_cpu, rtol=1e-4)
    for k in p_cpu:
        np.testing.assert_allclose(p_card[k], p_cpu[k], rtol=0, atol=1e-4)


@pytest.mark.parametrize("precision,per_channel", TINY,
                         ids=["float32", "int8", "int8-per-channel"])
@pytest.mark.parametrize("name", ["kws_mlp", "tiny_cnn"])
def test_mlperf_tiny_lanes_agree_on_the_card(card, name, precision,
                                             per_channel):
    """Islands on the card on every lane: per-sample calls, ``map``,
    ``vmap`` on the ``megakernel`` lane (islands ``vmap``'d, the segment per
    sample) and the grid.  ``map`` is bitwise with per-sample calls; the
    others are bitwise on the int8 lanes and within ``1e-5`` at float32."""
    from repro_torch.configs import mlperf_tiny as mt

    per_lane = _tiny(card, name, precision, per_channel, lane="megakernel")
    grid = _tiny(card, name, precision, per_channel)
    x = mt.sample_inputs(name, 8, seed=3)
    per = torch.stack([next(iter(per_lane(input=xi).values())) for xi in x])
    got = {"map": per_lane.batch(8, mode="map")(input=x),
           "vmap": per_lane.batch(8, mode="vmap")(input=x),
           "grid": grid.batch(8)(input=x)}
    got = {k: next(iter(v.values())) for k, v in got.items()}
    assert per.device.type == "cuda"
    assert torch.equal(got["map"], per)
    for lane in ("vmap", "grid"):
        if precision == "float32":
            torch.testing.assert_close(got[lane], per, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(got[lane], per), lane


@pytest.mark.parametrize("precision", ["float32", "int8"])
@pytest.mark.parametrize("lane", ["megakernel_grid", "use_pallas"])
@pytest.mark.parametrize("bench", ["bonsai/curet-m", "protonn/curet-m"])
def test_artifacts_cross_between_cpu_and_card(card, tmp_path, bench, lane,
                                              precision):
    """An artifact written on the CPU loads on the card and serves a bucket
    bitwise as a card compile does, through the kernels (megakernel: one
    launch; chains: one launch per chain); one written on the card loads on
    the CPU bitwise as a CPU compile."""
    from repro_torch.configs.classical import build, training_split
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.core.compiler import CompiledProgram

    kw = (dict(exec_mode="megakernel_grid") if lane == "megakernel_grid"
          else dict(use_pallas=True))
    calib = (None if precision == "float32"
             else training_split(bench, seed=0)[0][:64])
    store = ArtifactStore(tmp_path / "store")

    def compile_on(dev, **extra):
        return MafiaCompiler(precision=precision, device=dev, **kw,
                             **extra).compile(build(bench)[0], calib=calib)

    on_cpu = compile_on("cpu", artifact_store=store)
    on_card = compile_on(card)
    loaded = compile_on(card, artifact_store=store)
    assert loaded.pf_source == "artifact" and loaded.device.type == "cuda"
    (name, spec), = loaded.dfg.graph_inputs.items()
    X = np.random.default_rng(8).standard_normal(
        (64,) + tuple(spec.shape)).astype(np.float32)
    want = on_card.batch(64)(**{name: X})
    n_chains = sum(type(s).__name__ == "ChainStep" for s in loaded.plan.steps)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    got = loaded.batch(64)(**{name: X})
    torch.cuda.synchronize()
    if lane == "megakernel_grid":
        assert LAUNCHES["megakernel"] == 1
    else:
        assert n_chains and (LAUNCHES["linear_chain"]
                             + LAUNCHES["linear_chain_q"]) == n_chains
    for k in want:
        assert got[k].device.type == "cuda" and torch.equal(got[k], want[k])
    on_card.save(tmp_path / "card.mafia")
    back = CompiledProgram.load(tmp_path / "card.mafia", device="cpu")
    want_cpu = on_cpu.batch(64)(**{name: X})
    for k, v in back.batch(64)(**{name: X}).items():
        assert v.device.type == "cpu" and torch.equal(v, want_cpu[k]), k


def test_profiling_launches_the_chain_and_segment_kernels(card, tmp_path):
    """bench_chain is one chain-kernel launch a call, bench_segments one
    megakernel launch a call (nb = 1); a measured compile with a fresh table
    of this card keeps cost_source "measured" and the analytic outputs."""
    from repro_torch.configs.classical import build
    from repro_torch.core import autotune as at

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    s = at.bench_chain(400, 4, warmup=1, reps=3, device=card)
    assert LAUNCHES["linear_chain"] == 4 and s.wall_us > 0
    assert s.device_class == at.device_class(card)
    assert s.device_class.startswith("cuda:") and " " not in s.device_class
    (seg,) = at.bench_segments(("bonsai/usps-b",), warmup=1, reps=3,
                               device=card)
    assert LAUNCHES["megakernel"] == 4 and seg.extent > 0
    table = at.profile_device(quick=True, ops=("gemv", "add", "relu"),
                              reps=2, device=card)
    at.autotune_knobs(table, reps=2, device=card)
    assert "bb" not in table.knobs
    dfg = build("bonsai/curet-m")[0]
    pm = MafiaCompiler(use_pallas=True, cost_source="measured",
                       calibration=table, autotune=True,
                       chain_split_bytes="auto", device=card).compile(dfg)
    pa = MafiaCompiler(use_pallas=True, device=card).compile(
        build("bonsai/curet-m")[0])
    assert pm.cost_source == "measured"
    (name, spec), = pa.dfg.graph_inputs.items()
    X = np.random.default_rng(9).standard_normal(
        (64,) + tuple(spec.shape)).astype(np.float32)
    want = pa.batch(64)(**{name: X})
    for k, v in pm.batch(64)(**{name: X}).items():
        assert torch.equal(v, want[k]), k


# a rank's query heads under an uneven split over `model` (the planner's
# allow_uneven): (H, KV, G, offset, dh), head h reading KV head (offset + h)
# // G -- granite-8b's and qwen2.5-3b's ranks at model 3, and small shapes
OFFSET_CASES = ((11, 4, 4, 3, 128), (6, 2, 8, 6, 128), (4, 1, 8, 4, 128),
                (3, 2, 2, 1, 64), (5, 2, 6, 4, 96))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("H,KV,G,off,dh", OFFSET_CASES)
def test_attention_kernels_with_a_head_offset_match_plain(card, H, KV, G, off,
                                                          dh, dtype):
    """The forward (``fa_tc_kernel`` for bfloat16 where it routes,
    ``fa_kernel``), the backward on both routes and the decode kernel, with
    a head offset, against their plain versions: float32 1e-5 of the
    largest (the backward 1e-4, ``chip_smoke.FLASH_BWD_F32_REL``: its sums
    run in another order), bfloat16 2 bf16 ulps of the largest."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fused)
    from repro_torch.kernels.ref import (decode_attention_ref,
                                         flash_attention_bwd_ref,
                                         flash_attention_ref)

    gen = torch.Generator(device=card).manual_seed(H + off)
    rnd = lambda *s: torch.randn(s, generator=gen, device=card).to(dtype)  # noqa: E731
    kw = dict(group=G, head_offset=off)

    def close(a, b, rel=1e-5):
        a, b = a.float(), b.float()
        lim = rel if dtype == torch.float32 else 2 ** -7
        return float((a - b).abs().max()) <= lim * float(b.abs().max())

    Sq = 300
    q, k, v, g = rnd(2, Sq, H, dh), rnd(2, Sq, KV, dh), rnd(2, Sq, KV, dh), \
        rnd(2, Sq, H, dh)
    assert close(flash_attention_fused(q, k, v, round_p=False, **kw),
                 flash_attention_ref(q, k, v, **kw))
    want = flash_attention_bwd_ref(q, k, v, g, **kw)
    for route in (None, "simt"):
        got = flash_attention_bwd(q, k, v, g, route=route, **kw)
        assert all(close(a, b, 1e-4) for a, b in zip(got, want)), route
    qd, kd, vd = rnd(3, H, dh), rnd(3, 512, KV, dh), rnd(3, 512, KV, dh)
    lens = torch.tensor([1, 200, 512], dtype=torch.int32, device=card)
    assert close(decode_attention(qd, kd, vd, lens, round_p=False, **kw),
                 decode_attention_ref(qd, kd, vd, lens, **kw))
