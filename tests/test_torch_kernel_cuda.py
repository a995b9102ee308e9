"""The CUDA megakernel on the card, against its plain PyTorch version.

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
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core.compiler import MafiaCompiler
from repro_torch.core.quantize import quantize_t
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.ref import float_pe_outputs, run_segment_grid_ref
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
