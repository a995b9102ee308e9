"""The port's sharding planner, dry-run and roofline counts against the JAX
package's, on abstract meshes.

For every arch × {train_4k, prefill_32k, decode_32k} × {16×16, 2×16×16}:
``pf_report``, every parameter spec, the cache and activation specs, the
notes, the FSDP and data-parallel axes, ``layer_dfg``'s nodes and shapes,
``n_active_params`` and ``model_flops`` equal the reference's, and the
dry-run's ``arg_bytes_per_device`` equals the bytes of the reference
plan's shard shapes (each dim divided by its axes, rounded up).
``allow_uneven`` and ``replicate_embed`` are held the same way.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_arch as j_get_arch
from repro.launch import roofline as j_roofline
from repro.launch import steps as j_steps
from repro.launch.mesh import abstract_mesh as j_abstract_mesh
from repro.sharding import planner as j_planner
from repro.train.train_loop import state_specs as j_state_specs
from repro_torch.configs.registry import SHAPES as T_SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.sharding import planner
from repro_torch.sharding.spec import P

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = ("train_4k", "prefill_32k", "decode_32k")


def _j_flat(tree) -> dict:
    pairs = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in pairs}


def _t_flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_t_flat(v, f"{prefix}{k}/"))
        else:
            assert isinstance(v, P), (prefix + k, v)
            out[prefix + k] = tuple(v)
    return out


def _kw(cell) -> dict:
    serve = cell.kind != "train"
    return dict(mode=cell.kind, cell=cell,
                cache_batch=cell.global_batch if serve else None,
                cache_len=cell.seq_len if serve else None)


def _assert_same_plan(ref, got) -> None:
    assert got.pf_report == ref.pf_report
    assert _t_flat(got.param_specs) == _j_flat(ref.param_specs)
    if ref.cache_specs is None:
        assert got.cache_specs is None
    else:
        assert _t_flat(got.cache_specs) == _j_flat(ref.cache_specs)
    assert {k: tuple(v) for k, v in got.act_specs.items()} == {
        k: tuple(v) for k, v in ref.act_specs.items()}
    assert got.notes == ref.notes
    assert got.fsdp_axis == ref.fsdp_axis
    assert got.dp_axes == ref.dp_axes and got.dp_size == ref.dp_size
    assert got.model_size == ref.model_size and got.mode == ref.mode


def _ref_arg_bytes(spec, cell, plan, axes: dict) -> int:
    """The reference build_cell's arguments (its own abstract builders) at
    the reference plan's shard shapes."""
    cfg = spec.cell_config(cell)
    if cell.kind == "train":
        astate = j_steps.abstract_train_state(cfg)
        astate = type(astate)(astate.params, astate.m, astate.v, astate.step,
                              None)
        abatch = j_steps._batch_abstract(cfg, cell, cell.global_batch)
        args = (astate, abatch)
        specs = (j_state_specs(plan),
                 j_steps._batch_pspec(plan, cell.global_batch, abatch))
    elif cell.kind == "prefill":
        abatch = j_steps._batch_abstract(cfg, cell, cell.global_batch)
        args = (j_steps.abstract_params(cfg), abatch)
        specs = (plan.param_specs,
                 j_steps._batch_pspec(plan, cell.global_batch, abatch))
    else:
        B = cell.global_batch
        dp = plan.dp_axes if B % plan.dp_size == 0 else None
        tok = jax.ShapeDtypeStruct((B,), np.int32)
        args = (j_steps.abstract_params(cfg), tok,
                j_steps.init_cache(cfg, B, cell.seq_len, abstract=True), tok)
        specs = (plan.param_specs, JP(dp), plan.cache_specs, JP(dp))
    leaves = jax.tree.leaves(args)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, s in zip(leaves, spec_leaves):
        entries = tuple(s) + (None,) * (len(x.shape) - len(s))
        shard = [-(-n // math.prod(axes[a] for a in (
            () if e is None else (e,) if isinstance(e, str) else e)))
            for n, e in zip(x.shape, entries)]
        total += math.prod(shard) * np.dtype(x.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", CELLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_matches_reference(arch, shape_name, mesh_name):
    shape, names = MESHES[mesh_name]
    cell, t_cell = SHAPES[shape_name], T_SHAPES[shape_name]
    ref = j_planner.plan_for(j_get_arch(arch), j_abstract_mesh(shape, names),
                             **_kw(cell))
    got = planner.plan_for(get_arch(arch), abstract_mesh(shape, names),
                           **_kw(t_cell))
    _assert_same_plan(ref, got)

    # the layer DFG the PF report comes from: nodes, ops, inputs, dims
    j_cfg, t_cfg = j_get_arch(arch).model, get_arch(arch).model
    tokens = {"train": cell.seq_len * cell.global_batch // 64,
              "prefill": cell.seq_len * cell.global_batch,
              "decode": cell.global_batch}[cell.kind]
    jg = j_planner.layer_dfg(j_cfg, tokens, cell.seq_len)
    tg = planner.layer_dfg(t_cfg, tokens, cell.seq_len)
    assert list(tg.nodes) == list(jg.nodes)
    for nid, node in jg.nodes.items():
        t = tg.nodes[nid]
        assert (t.op, t.inputs, t.dims) == (node.op, node.inputs, node.dims)
    assert {k: tuple(v.shape) for k, v in tg.graph_inputs.items()} == {
        k: tuple(v.shape) for k, v in jg.graph_inputs.items()}

    # the roofline counts
    j_cell_cfg = j_get_arch(arch).cell_config(cell)
    t_cell_cfg = get_arch(arch).cell_config(t_cell)
    assert roofline.n_active_params(t_cell_cfg) == j_roofline.n_active_params(
        j_cell_cfg)
    assert roofline.model_flops(t_cell_cfg, t_cell) == j_roofline.model_flops(
        j_cell_cfg, cell)

    # the dry-run's argument bytes against the reference plan's shards
    rec = dryrun.run_cell(arch, shape_name, multi_pod=mesh_name == "2x16x16")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["arg_bytes_per_device"] == _ref_arg_bytes(
        j_get_arch(arch), cell, ref, dict(zip(names, shape)))
    assert rec["meta"]["notes"] == ref.notes
    assert "compile_s" not in rec and "compile_s" in rec["absent"]


@pytest.mark.parametrize("arch,option", [
    ("musicgen-medium", "allow_uneven"),
    ("qwen2.5-3b", "replicate_embed"),
    ("command-r-35b", "replicate_embed"),
])
def test_plan_options_match_reference(arch, option):
    for shape, names in MESHES.values():
        for shape_name in CELLS:
            cell = SHAPES[shape_name]
            kw = {**_kw(cell), option: True}
            ref = j_planner.plan_for(j_get_arch(arch),
                                     j_abstract_mesh(shape, names), **kw)
            got = planner.plan_for(get_arch(arch), abstract_mesh(shape, names),
                                   **{**_kw(T_SHAPES[shape_name]), option: True})
            _assert_same_plan(ref, got)
    if option == "allow_uneven":
        assert any("UNEVENLY" in n for n in got.notes)
    else:
        assert tuple(got.param_specs["embed"])[0] is None


def test_dryrun_covers_every_cell_on_both_meshes():
    """Every cell of the registry plans (or is skipped with its reason) on
    both production meshes, with the int8 cross-pod reduce too."""
    counts: dict[str, int] = {}
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            for multi_pod in (False, True):
                rec = dryrun.run_cell(arch, shape_name, multi_pod=multi_pod)
                counts[rec["status"]] = counts.get(rec["status"], 0) + 1
                assert rec["status"] in ("ok", "skipped"), rec.get("traceback")
    assert counts["ok"] + counts["skipped"] == len(ARCH_IDS) * len(SHAPES) * 2
    rec = dryrun.run_cell("qwen2.5-3b", "train_4k", multi_pod=True,
                          pod_reduce="int8_ef")
    r = rec["roofline"]
    assert rec["status"] == "ok" and r["collective_s"] > 0
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")


def test_mesh_module_is_import_pure():
    """Importing the mesh module starts no process group; the production
    mesh refuses to run without one; both mesh kinds read alike."""
    import importlib

    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    importlib.reload(tmesh)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    m = tmesh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert tmesh.mesh_axes(m) == {"pod": 2, "data": 16, "model": 16}
    assert m.size == 512 and list(m) == ["pod", "data", "model"]


@pytest.mark.parametrize("n", [1, 5, 16, 24, 33])
@pytest.mark.parametrize("k", [1, 2, 16])
def test_local_slices_cut_as_torch_chunk(n, k):
    """A dim split over one axis: shards of ceil(n / k), the last short or
    empty, as torch.chunk (DTensor's Shard) and GSPMD cut it; over two
    axes, the first major."""
    from repro_torch.sharding.placement import local_slices

    x = torch.arange(n)
    chunks = list(x.chunk(k)) + [x[:0]] * k
    for i in range(k):
        (sl,) = local_slices((n,), P("model"), {"model": k}, {"model": i})
        assert torch.equal(x[sl], chunks[i])
    axes = {"pod": 2, "data": k}
    got = torch.cat([x[local_slices((n,), P(("pod", "data")), axes,
                                    {"pod": p, "data": d})[0]]
                     for p in range(2) for d in range(k)])
    assert torch.equal(got, x)
