"""Compile parity: the port's host compiler reproduces the JAX package's.

For each program the two compilers must agree on the rewritten graph's
structural hash, the PF assignment, the schedule's total cycles, the
``QuantPlan`` exponents (fixed-point lanes) and the linearized megakernel
program's fingerprint — which covers every instruction and the const and
matrix pools byte for byte.
"""

import numpy as np
import pytest
import torch

from repro.configs.classical import BENCHMARKS
from repro.serve.classical_engine import get_program as jget
from repro_torch.core.compiler import MafiaCompiler
from repro_torch.serve.classical_engine import get_program as tget

torch.set_num_threads(1)

NAMES = [b.name for b in BENCHMARKS]
FOUR = ["bonsai/usps-b", "protonn/usps-b", "bonsai/letter-m",
        "protonn/letter-m"]


def _check_parity(bench, precision):
    jp = jget(bench, precision=precision, exec_mode="megakernel_grid")
    tp = tget(bench, precision=precision, exec_mode="megakernel_grid",
              device="cpu")
    assert tp.dfg.structural_hash() == jp.dfg.structural_hash()
    assert tp.assignment == jp.assignment
    assert tp.schedule.total_cycles == jp.schedule.total_cycles
    assert tp.fused_clusters == jp.fused_clusters
    if precision != "float32":
        jq, tq = jp.qplan, tp.qplan
        assert tq.input_exps == jq.input_exps and tq.bits == jq.bits
        assert tq.nodes.keys() == jq.nodes.keys()
        for nid, jn in jq.nodes.items():
            tn = tq.nodes[nid]
            assert (tn.in_exps, tn.out_exp) == (jn.in_exps, jn.out_exp), nid
            for k, e in jn.param_exps.items():
                np.testing.assert_array_equal(np.asarray(tn.param_exps[k]),
                                              np.asarray(e))
    jm, tm = jp.plan.megakernel, tp.plan.megakernel
    assert tm.fingerprint() == jm.fingerprint()
    assert tm.n_islands == 0 and len(tm.segments) == 1


@pytest.mark.parametrize("precision", ["float32", "int8", "int16"])
@pytest.mark.parametrize("bench", FOUR)
def test_compile_parity_all_precisions(bench, precision):
    _check_parity(bench, precision)


@pytest.mark.parametrize("bench", NAMES)
def test_compile_parity_float32(bench):
    _check_parity(bench, "float32")


@pytest.mark.slow
@pytest.mark.parametrize("precision", ["int8", "int16"])
@pytest.mark.parametrize("bench", NAMES)
def test_compile_parity_full_sweep(bench, precision):
    _check_parity(bench, precision)


def test_unported_compile_options_raise():
    """Options whose machinery is not in the port yet refuse, by name."""
    from repro_torch.configs.classical import build

    for kw in (dict(use_pallas=True), dict(artifact_store=object()),
               dict(cost_source="measured"), dict(autotune=True),
               dict(calibration=object())):
        with pytest.raises(NotImplementedError):
            MafiaCompiler(device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        build("protonn/usps-b", trained=True)
