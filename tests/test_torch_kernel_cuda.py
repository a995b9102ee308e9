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
@pytest.mark.parametrize("m,n,density,bm", [
    (100, 300, 0.1, 16), (64, 64, 1.0, 16), (33, 130, 0.4, 16),
    (8, 8, 0.0, 16), (24, 610, 1.0, 128), (300, 200, 0.3, 128)])
@pytest.mark.parametrize("batch", [1, 5, 64])
def test_spmv_kernel_matches_plain(card, m, n, density, bm, batch):
    rng = np.random.default_rng(m + batch)
    w = rng.normal(size=(m, n)).astype(np.float32)
    w[rng.random((m, n)) >= density] = 0.0
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
