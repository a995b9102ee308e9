"""The collectives a step sends, counted (``launch/op_analysis.py`` under a
fake process group, ``launch/dryrun.count_cell``), against the dry-run's
closed forms (``dryrun.split_collective_bytes``,
``routing_collective_bytes``, ``_train_collective_bytes``), exactly.

One child process (the fake group lives and dies in it) counts rank 0's
step of the SMOKE cells (S 16, batch 4) of the dense (qwen2.5-3b,
internvl2-26b with its vision prefix), MoE (olmoe-1b-7b, deepseek-v2-236b's
MLA), SSM (mamba2-1.3b) and hybrid (zamba2-7b) families, train, prefill
and decode, at (data 1, model 2), (1, 4) and (2, 2) under the SMOKE plans,
and the MoE and hybrid families again under the full configs' plans
applied at SMOKE widths (experts, MLA heads, the shared experts' columns
and zamba2's shared block split); the MoE routing at data 2 (train over
the microbatch's token group, decode over the batch's); the int8
cross-pod reduce at pod 2.  Where the full plan shards serving weights
over ``data`` (FSDP serving) the closed form refuses and only the count
runs.  The child also checks ``run_cell(count=True)``: a record with the
counted terms, no process group left behind, and a refusal while one
runs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ("qwen2.5-3b", "internvl2-26b", "olmoe-1b-7b", "deepseek-v2-236b",
         "mamba2-1.3b", "zamba2-7b")
FULL = ("olmoe-1b-7b", "deepseek-v2-236b", "zamba2-7b")
MESHES = ((1, 2), (1, 4), (2, 2))
KINDS = ("train", "prefill", "decode")
CELLS = ([(a, "smoke", m, k, "fp32") for a in SMOKE for m in MESHES
          for k in KINDS]
         + [(a, "full", m, k, "fp32") for a in FULL for m in ((1, 2), (2, 2))
            for k in KINDS]
         + [(a, "smoke", (2, 1), k, "fp32") for a in FULL[:2]
            for k in ("train", "decode")]
         + [(a, w, m, "train", "int8_ef")
            for a in ("qwen2.5-3b", "olmoe-1b-7b", "zamba2-7b")
            for w in ("smoke", "full") for m in ((2, 1, 1), (2, 1, 2))])


def _label(cell) -> str:
    arch, which, mesh, kind, reduce = cell
    return f"{arch}-{which}-{'x'.join(map(str, mesh))}-{kind}-{reduce}"


def child(out: str) -> None:
    """Count every cell of ``CELLS`` and write the readings to ``out``."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.launch import dryrun, steps

    real_plan_for = steps.plan_for
    full_plans: dict = {}

    def plan_for(spec, mesh, **kw):   # the full config's plan, SMOKE widths
        return real_plan_for(full_plans.get(spec.arch_id, spec), mesh, **kw)

    steps.plan_for = plan_for
    got = {}
    for cell in CELLS:
        arch, which, shape, kind, reduce = cell
        spec = get_arch(arch)
        full_plans.pop(arch, None)
        if which == "full":
            full_plans[arch] = spec
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        prog, cost = dryrun.count_cell(
            dataclasses.replace(spec, model=spec.smoke),
            ShapeCell("count", kind, 16, 4), shape, names, pod_reduce=reduce)
        axes = dict(zip(names, shape))
        try:
            formula = (dryrun._train_collective_bytes(prog, axes, reduce)
                       if kind == "train" else
                       dryrun.split_collective_bytes(prog, axes)
                       + dryrun.routing_collective_bytes(prog, axes))
        except NotImplementedError as e:
            formula = str(e)
        got[_label(cell)] = dict(sent=cost.coll_sent, formula=formula,
                                 counts=cost.coll_counts)
    steps.plan_for = real_plan_for
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", multi_pod=True,
                          count=True)
    got["run_cell"] = dict(rec=rec, initialized=dist.is_initialized())
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        dryrun.run_cell("qwen2.5-3b", "decode_32k", multi_pod=False,
                        count=True)
        got["refused"] = None
    except RuntimeError as e:
        got["refused"] = str(e)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(got, f, default=str)


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives") / "counts.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_op_collectives as t; t.child({str(out)!r})"],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("cell", CELLS, ids=[_label(c) for c in CELLS])
def test_sent_equals_closed_form(counted, cell):
    got = counted[_label(cell)]
    if isinstance(got["formula"], str):
        # FSDP serving: the closed form refuses, the count stands alone
        arch, which, mesh, kind, _ = cell
        assert which == "full" and mesh[0] > 1 and kind != "train"
        assert "FSDP serving" in got["formula"] and got["sent"] > 0
        return
    # every cell sends: a split over model, gradients, routing, int8
    assert got["sent"] == got["formula"] > 0


def test_run_cell_counts_and_leaves_no_group(counted):
    got = counted["run_cell"]
    rec = got["rec"]
    assert not got["initialized"] and rec["status"] == "ok", rec
    assert rec["flops"] > rec["products"] > 0 and rec["bytes"] > 0
    coll = rec["collectives"]
    assert set(coll) == {"total_bytes", "by_kind", "counts", "sent"}
    assert coll["counts"]["all-reduce"] > 0 and coll["sent"] > 0
    r = rec["roofline"]
    assert r["flops_per_device"] == rec["flops"]
    assert r["flops_global"] == rec["flops"] * 512
    assert r["useful_flops_ratio"] == r["model_flops"] / r["flops_global"]
    assert r["collective_bytes_per_device"] == coll["sent"]
    assert set(rec["absent"]) == {
        "lower_s", "compile_s", "mem_argument_size_in_bytes",
        "mem_output_size_in_bytes", "mem_temp_size_in_bytes",
        "mem_generated_code_size_in_bytes", "mem_alias_size_in_bytes",
        "xla_cost_flops", "xla_cost_bytes", "hlo_lines", "unknown_trip_loops"}
    assert "already running" in counted["refused"]
