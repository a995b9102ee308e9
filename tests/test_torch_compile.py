"""Compile parity: the port's host compiler reproduces the JAX package's.

For each program the two compilers must agree on the rewritten graph's
structural hash, the PF assignment, the schedule's total cycles, the
``QuantPlan`` exponents (fixed-point lanes) and the linearized megakernel
program's fingerprint — which covers every instruction and the const and
matrix pools byte for byte.  With ``use_pallas=True`` the plans' fused
chain steps (members, stage programs and operands, extras, vecs, dead
members) must agree too, and the schedule must price the same chains.
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


def _same(a, b):
    """Stage operands and vecs: numpy/jax arrays by value, else equal."""
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, (str, int, float, type(None))):
        return type(a) is type(b) and a == b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _check_chains(jplan, tplan):
    from repro.core.lowering import ChainStep as JChain
    from repro_torch.core.lowering import ChainStep as TChain

    jc = [s for s in jplan.steps if isinstance(s, JChain)]
    tc = [s for s in tplan.steps if isinstance(s, TChain)]
    assert len(tc) == len(jc) > 0
    assert [type(s).__name__ for s in tplan.steps] == \
        [type(s).__name__ for s in jplan.steps]
    for j, t in zip(jc, tc):
        assert (t.members, t.stream, t.extras, t.terminal, t.dead,
                t.quantized) == (j.members, j.stream, j.extras, j.terminal,
                                 j.dead, j.quantized)
        assert _same(tuple(t.stages), tuple(j.stages)), t.members
        assert _same(tuple(t.vecs), tuple(j.vecs)), t.members


def _check_parity(bench, precision, use_pallas=False):
    mode = "interpret" if use_pallas else "megakernel_grid"
    jp = jget(bench, precision=precision, exec_mode=mode, use_pallas=use_pallas)
    tp = tget(bench, precision=precision, exec_mode=mode, use_pallas=use_pallas,
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
    if use_pallas:
        _check_chains(jp.plan, tp.plan)


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


@pytest.mark.parametrize("precision", ["float32", "int8", "int16"])
@pytest.mark.parametrize("bench", FOUR)
def test_compile_parity_use_pallas(bench, precision):
    _check_parity(bench, precision, use_pallas=True)


@pytest.mark.slow
@pytest.mark.parametrize("precision", ["float32", "int8", "int16"])
@pytest.mark.parametrize("bench", NAMES)
def test_compile_parity_use_pallas_full_sweep(bench, precision):
    _check_parity(bench, precision, use_pallas=True)


@pytest.mark.parametrize("bench", ["bonsai/usps-b", "protonn/usps-b"])
def test_use_pallas_prices_the_split_chains(bench):
    """Under a chain budget that splits every chain, a ``use_pallas``
    schedule prices the split sub-chains the plan executes, as the
    reference's does; the per-node model of the same program differs."""
    kw = dict(chain_split_bytes=1e5, device="cpu")
    on = tget(bench, use_pallas=True, **kw)
    off = tget(bench, **kw)
    jon = jget(bench, use_pallas=True, chain_split_bytes=1e5)
    assert on.plan.chain_splits == jon.plan.chain_splits > 0
    assert on.schedule.total_cycles == jon.schedule.total_cycles
    assert on.schedule.total_cycles != off.schedule.total_cycles


def test_compiled_program_needs_a_device_or_a_card():
    """A CompiledProgram built with no device means the card; with no card
    it raises instead of running on the CPU."""
    from repro_torch.core.compiler import CompiledProgram

    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    prog = tget("protonn/usps-b", device="cpu")
    fields = {f: getattr(prog, f) for f in ("dfg", "fn", "assignment",
              "pf_result", "schedule", "lut_true", "dsp_true", "backend",
              "budget")}
    with pytest.raises(RuntimeError, match="CUDA"):
        CompiledProgram(**fields)
    assert CompiledProgram(**fields, device="cpu").device == torch.device("cpu")


def test_unported_compile_options_raise(tmp_path):
    """Every compile option of the JAX package's compiler is ported: the
    artifact store and profile-guided compilation are accepted, and a
    calibration of the wrong type or an unknown cost source refuses, by
    name, as in the JAX package."""
    from repro_torch.configs.classical import build
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.core.autotune import CalibrationTable
    from repro_torch.core.lowering import DEFAULT_CHAIN_SPLIT_BYTES

    table = CalibrationTable(device_class="fpga:none")
    for kw in (dict(artifact_store=ArtifactStore(tmp_path)),
               dict(cost_source="measured", calibration=table),
               dict(autotune=True, calibration=table,
                    chain_split_bytes="auto")):
        comp = MafiaCompiler(device="cpu", **kw)
        assert comp.cost_source == "analytic"   # a foreign table degrades
        assert comp.chain_split_bytes == DEFAULT_CHAIN_SPLIT_BYTES
    with pytest.raises(TypeError, match="calibration"):
        MafiaCompiler(device="cpu", cost_source="measured",
                      calibration=object())
    with pytest.raises(ValueError, match="cost_source"):
        MafiaCompiler(device="cpu", cost_source="vibes")
    # training is ported: build(trained=True) trains where training runs,
    # the card unless the caller scopes another device
    from repro_torch.core.device import default_device

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build("protonn/usps-b", trained=True)
    with default_device("cpu"):
        dfg, params, _ = build("protonn/usps-b", trained=True)
    assert dfg.nodes and set(params) == {"W", "B", "Zs", "gamma"}
