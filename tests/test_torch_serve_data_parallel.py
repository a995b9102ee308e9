"""Serving over data-parallel ranks (``pod`` × ``data`` > 1) on gloo ranks
(CPU), against the one-process port engine and the JAX ``ServeEngine``.

Ranks are ``torch.multiprocessing`` processes joined through a ``file://``
store under a temporary directory (no port), one thread each; one spawn a
world size runs every job: 2 ranks on (data 2, model 1), 4 on (data 2,
model 2).  The SMOKE configs of qwen2.5-3b (dense; at model 2 a cache over
KV heads), deepseek-v2-236b (MoE and MLA: the latent cache over the
sequence at model 2) and zamba2-7b (hybrid: ``h`` and ``conv_x`` over SSM
heads, the shared cache over KV heads), with the port's weights from seed
0 (the JAX engine serves the same values as its parameter tree), under
two plans: the SMOKE decode plan (the caches' batch over ``data``,
weights whole over ``data``) and ``fsdp``, the train plan's parameter
specs (every matrix sharded over ``data`` too) with the decode plan's
caches.

Held (float32): every rank's greedy tokens equal, and equal to the
one-process port engine's and the JAX engine's; each rank's caches hold
``max_batch / 2`` rows (every row where 2 does not divide ``max_batch``);
under ``fsdp`` a rank holds its ``data`` shard of each such leaf between
steps and gathers the whole of one layer's leaves while it runs.  A
planted router sends every row's choices to two experts, so the batch's
capacity drops copies: the data ranks' decode logits (the engine's and
the decode cell's ``serve_step`` on the rank's rows) are within 1e-5 of
one process's, and differ once the token group is left out.  A bfloat16
decode over a cache split over the sequence rounds once: its output is
the float64 attention rounded once to bfloat16, except where that value
lies within 1e-5 of a rounding boundary.
"""

import contextlib
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_arch as j_get_arch
from repro.serve.engine import ServeEngine as JServeEngine

B, MAXLEN, NEW_TOKENS = 4, 32, 6
PROMPTS = ([5, 3, 9, 1, 7], list(range(20, 31)), [2, 4, 6],
           list(range(40, 57)))
TOL = 1e-5
ARCHS = ("qwen2.5-3b", "deepseek-v2-236b", "zamba2-7b")
SHAPES = {2: (2, 1), 4: (2, 2)}
WHICH = ("decode", "fsdp")
# the planted router: max_batch, the offset planted on the embedding's
# first OFF dims, the two experts' router weight on them
ROUTE_B, OFF, OFF_VALUE, ROUTE_W = 8, 8, 4.0, 2.0
# the single-rounding check: (B, H, KV, dh, whole cache length)
MERGE = (6, 8, 2, 16, 48)


def _label(*args) -> str:
    return "-".join(str(a).replace(" ", "") for a in args)


def _np_params(arch: str) -> dict:
    """The port's SMOKE weights from seed 0 as the JAX package's parameter
    tree (numpy; ``blocks/...`` stacked over the layers): both engines
    serve the same values, and drawing them takes no JAX compile."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.train.train_loop import _master_tree

    tree = _master_tree(init_params(get_arch(arch).smoke, 0, "cpu"))
    return jax.tree.map(lambda t: t.numpy(), tree)


def _planted(params: dict) -> dict:
    """deepseek's SMOKE weights with every embedding row offset on its
    first ``OFF`` dims and each layer's router reading them for experts 0
    and 1: every row's two choices go to those two experts."""
    p = jax.tree.map(np.copy, params)
    p["embed"][:, :OFF] += OFF_VALUE
    router = p["blocks"]["moe"]["router"]              # (L, D, E)
    router[:, :OFF, 0] = ROUTE_W
    router[:, :OFF, 1] = ROUTE_W * 0.9
    return p


def _plan(mesh, arch: str, which: str, batch: int = B):
    """The SMOKE decode plan of ``arch`` on ``mesh`` for ``batch`` cache
    rows; ``fsdp``: with the train plan's parameter specs (sharded over
    ``data``)."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.sharding.planner import plan_for

    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model=spec.smoke)
    plan = plan_for(spec, mesh, mode="decode",
                    cell=ShapeCell("dp", "decode", MAXLEN, batch),
                    cache_batch=batch, cache_len=MAXLEN)
    if which == "fsdp":
        train = plan_for(spec, mesh, mode="train",
                         cell=ShapeCell("dp", "train", 16, 4))
        plan = dataclasses.replace(plan, param_specs=train.param_specs)
    return plan


def _serve(cfg, model, prompts, batch, **kw):
    """The engine's tokens and each decode step's logits (all rows)."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, model, max_batch=batch, max_len=MAXLEN,
                      device="cpu", **kw)
    steps = []
    sample = eng._sample

    def spy(logits):
        if logits.shape[0] == batch:
            steps.append(logits.clone())
        return sample(logits)

    eng._sample = spy
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    toks = [r.tokens for r in eng.run_to_completion()]
    return eng, toks, steps


# ------------------------------------------------------------------- jobs
def _engine_job(rank: int, tmp: str, arch: str, shape, which: str):
    """The engine on a plan over data ranks: tokens, cache and parameter
    shapes, the FSDP gathers."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import _leaves, params_from_reference
    from repro_torch.sharding import tp
    from repro_torch.sharding.tp import data_split, model_split

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    cfg = get_arch(arch).smoke
    plan = _plan(mesh, arch, which)
    split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
    data = data_split(cfg, plan, mesh)
    params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                        weights_only=False)
    model = params_from_reference(params, cfg, "cpu", split, data)
    whole = params_from_reference(params, cfg, "cpu", split)
    gathers = []
    real = tp.DataSplit.gather

    def spy(self, t, path):
        out = real(self, t, path)
        gathers.append((path, tuple(t.shape), tuple(out.shape)))
        return out

    tp.DataSplit.gather = spy
    try:
        eng, toks, _ = _serve(cfg, model, PROMPTS, B, mesh=mesh, plan=plan)
    finally:
        tp.DataSplit.gather = real
    try:                    # FSDP's in-place leaves are a serving layout
        model.forward_train(np.array([[1, 2, 3]]))
        refused = False
    except NotImplementedError:
        refused = True
    held = {p: [tuple(t.shape) for t in ts] for p, ts in _leaves(model).items()}
    shard = {p: [tuple(t.shape) for t in ts] for p, ts in _leaves(whole).items()}
    out = dict(tokens=toks, caches={k: tuple(v.shape) for k, v in eng.caches.items()},
               rows=eng.rows, fsdp=dict(data.fsdp), held=held, shard=shard,
               in_place=sorted(p for p in data.fsdp if data.held(p)),
               gathers=gathers, split_cache=None if split is None else split.cache,
               train_refused=refused,
               bytes=sum(t.numel() for t in model.parameters()),
               shard_bytes=sum(t.numel() for t in whole.parameters()))
    torch.save(out, os.path.join(tmp, f"eng_{_label(arch, shape, which)}_{rank}.pt"))


def _whole_job(rank: int, tmp: str, shape):
    """qwen2.5-3b with a ``max_batch`` (3) that 2 data ranks do not divide:
    the plan keeps the batch whole on every rank."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import params_from_reference
    from repro_torch.sharding.tp import data_split, model_split

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    cfg = get_arch("qwen2.5-3b").smoke
    plan = _plan(mesh, "qwen2.5-3b", "decode", batch=3)
    split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
    params = torch.load(os.path.join(tmp, "params_qwen2.5-3b.pt"),
                        weights_only=False)
    eng, toks, _ = _serve(cfg, params_from_reference(params, cfg, "cpu", split),
                          PROMPTS[:3], 3, mesh=mesh, plan=plan)
    out = dict(tokens=toks, data=data_split(cfg, plan, mesh),
               caches={k: tuple(v.shape) for k, v in eng.caches.items()})
    torch.save(out, os.path.join(tmp, f"whole_{_label(shape)}_{rank}.pt"))


def _route_job(rank: int, tmp: str, shape):
    """deepseek-v2 with the planted router at ``ROUTE_B`` rows: the
    engine's decode logits with the token group and without it, under the
    ``fsdp`` plan (the experts on their data shard: the group's buffer
    summed), and the decode cell's ``serve_step`` on the rank's rows."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import init_cache, params_from_reference
    from repro_torch.serve import engine as eng_mod
    from repro_torch.sharding.tp import data_split, gather_from_model, model_split

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    arch = "deepseek-v2-236b"
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model=spec.smoke)
    cfg = spec.model
    params = torch.load(os.path.join(tmp, "params_planted.pt"),
                        weights_only=False)
    prompts = [[(7 * i + j) % 250 + 1 for j in range(5 + i)]
               for i in range(ROUTE_B)]
    prog = build_cell(spec, ShapeCell("dp", "decode", MAXLEN, ROUTE_B), mesh)
    split, data = prog.split(mesh), prog.data(mesh)
    model = params_from_reference(params, cfg, "cpu", split, data)
    _, toks, steps = _serve(cfg, model, prompts, ROUTE_B, mesh=mesh,
                            plan=prog.plan)
    real = eng_mod.use_token_group
    eng_mod.use_token_group = lambda group: contextlib.nullcontext()
    try:
        _, toks_alone, steps_alone = _serve(cfg, model, prompts, ROUTE_B,
                                            mesh=mesh, plan=prog.plan)
    finally:
        eng_mod.use_token_group = real
    fplan = _plan(mesh, arch, "fsdp", batch=ROUTE_B)
    fmodel = params_from_reference(
        params, cfg, "cpu", model_split(cfg, fplan.param_specs, mesh,
                                        fplan.cache_specs),
        data_split(cfg, fplan, mesh))
    _, toks_fsdp, steps_fsdp = _serve(cfg, fmodel, prompts, ROUTE_B, mesh=mesh,
                                      plan=fplan)
    # the decode cell on the rank's rows: one step at positions 0..B-1
    r0, r1 = data.rows(ROUTE_B)
    token = np.arange(1, ROUTE_B + 1, dtype=np.int32) * 11
    pos = np.arange(ROUTE_B, dtype=np.int32)
    caches = init_cache(cfg, ROUTE_B, MAXLEN, device="cpu", split=split,
                        data=data)
    logits, _ = prog.fn(model, token[r0:r1], caches, pos[r0:r1])
    if split is not None and split.vocab_out is not None:
        logits = gather_from_model(logits, -1, split)
    cell = data.gather_rows(logits)
    out = dict(tokens=toks, steps=steps, tokens_alone=toks_alone,
               steps_alone=steps_alone, tokens_fsdp=toks_fsdp,
               steps_fsdp=steps_fsdp, cell=cell, token=token, pos=pos)
    torch.save(out, os.path.join(tmp, f"route_{_label(shape)}_{rank}.pt"))


def _merge_job(rank: int, tmp: str):
    """A bfloat16 ``gqa_decode`` over a cache split over the sequence on
    2 ranks: one-hot inputs (q, k and v rows of the weights, exactly) and
    ``wo`` the identity (the output is the attention's, rounded by the
    decode path alone); every rank's output."""
    import torch.distributed as dist

    from repro_torch.models.attention import gqa_decode
    from repro_torch.sharding.tp import ModelSplit

    Bm, H, KV, dh, S = MERGE
    D = H * dh
    g = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    p = {"wq": torch.randn((D, H, dh), generator=g).to(bf),
         "wk": torch.randn((D, KV, dh), generator=g).to(bf),
         "wv": torch.randn((D, KV, dh), generator=g).to(bf),
         "wo": torch.eye(D).reshape(H, dh, D).to(bf)}
    x = torch.zeros((Bm, 1, D), dtype=bf)
    x[torch.arange(Bm), 0, 3 * torch.arange(Bm) + 1] = 1.0
    k = torch.randn((Bm, S, KV, dh), generator=g).to(bf)
    v = torch.randn((Bm, S, KV, dh), generator=g).to(bf)
    pos = torch.tensor([0, 5, S // 2 - 1, S // 2, S // 2 + 7, S - 1])
    split = ModelSplit(m=2, r=rank, group=dist.group.WORLD, specs={},
                       heads=None, kv=None, ffn=None, vocab_in=None,
                       vocab_out=None, cache="seq")
    Sl = S // 2
    kc, vc = (t[:, rank * Sl:(rank + 1) * Sl].clone() for t in (k, v))
    cos = torch.ones((Bm, 1, dh // 2))
    sin = torch.zeros((Bm, 1, dh // 2))
    out, _ = gqa_decode(p, x, kc, vc, pos, cos, sin, split=split)
    if rank == 0:
        torch.save(dict(p=p, x=x, k=k, v=v, pos=pos),
                   os.path.join(tmp, "merge_in.pt"))
    torch.save(out, os.path.join(tmp, f"merge_{rank}.pt"))


def _worker(rank: int, world: int, store: str, tmp: str, jobs) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    init_group("cpu", init_method=f"file://{store}", world_size=world,
               rank=rank)
    try:
        for name, *args in jobs:
            {"engine": _engine_job, "whole": _whole_job, "route": _route_job,
             "merge": _merge_job}[name](rank, tmp, *args)
    finally:
        dist.destroy_process_group()


def _jax_tokens(arch: str, params: dict) -> list[list[int]]:
    cfg_j = j_get_arch(arch).smoke
    eng = JServeEngine(cfg_j, jax.tree.map(jnp.asarray, params), max_batch=B,
                       max_len=MAXLEN)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    return [list(map(int, r.tokens)) for r in eng.run_to_completion()]


def _one_process(tmp: str) -> dict:
    """The one-process port engine's tokens (and decode logits) of every
    case the ranks serve."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import params_from_reference

    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch).smoke
        params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                            weights_only=False)
        out[arch] = _serve(cfg, params_from_reference(params, cfg, "cpu"),
                           PROMPTS, B)[1]
        if arch == "qwen2.5-3b":
            out["whole"] = _serve(cfg, params_from_reference(params, cfg, "cpu"),
                                  PROMPTS[:3], 3)[1]
    return out


@pytest.fixture(scope="module")
def runs():
    """Every job, once: {"tmp": the ranks' results, "jax": the JAX
    engine's tokens by arch, "one": the one-process port engine's}."""
    with tempfile.TemporaryDirectory(prefix="dp-") as tmp:
        params = {arch: _np_params(arch) for arch in ARCHS}
        for arch, p in params.items():
            torch.save(p, os.path.join(tmp, f"params_{arch}.pt"))
        torch.save(_planted(params["deepseek-v2-236b"]),
                   os.path.join(tmp, "params_planted.pt"))
        spawned = []
        for world, shape in SHAPES.items():   # both worlds at once
            jobs = ([("engine", a, shape, w) for a in ARCHS for w in WHICH]
                    + [("whole", shape), ("route", shape)]
                    + ([("merge",)] if world == 2 else []))
            spawned.append(mp.spawn(_worker, args=(world, os.path.join(
                tmp, f"store{world}"), tmp, jobs), nprocs=world, join=False))
        # the references while the ranks run
        torch.set_num_threads(2)
        jax_tokens = {a: _jax_tokens(a, p) for a, p in params.items()}
        one = _one_process(tmp)
        for ranks in spawned:
            while not ranks.join():
                pass
        yield {"tmp": tmp, "jax": jax_tokens, "one": one}


def _load(runs, name: str, rank: int):
    return torch.load(os.path.join(runs["tmp"], f"{name}_{rank}.pt"),
                      weights_only=False)


def _close(got: torch.Tensor, want: torch.Tensor, label: str) -> None:
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), (label, err)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("world,arch,which",
                         [(w, a, x) for w in SHAPES for a in ARCHS for x in WHICH],
                         ids=lambda v: str(v))
def test_data_ranks_serve_the_one_process_tokens(runs, world, arch, which):
    shape = SHAPES[world]
    one = runs["one"][arch]
    assert len(one) == len(PROMPTS) and all(len(t) == NEW_TOKENS for t in one)
    assert one == runs["jax"][arch]
    for r in range(world):
        got = _load(runs, f"eng_{_label(arch, shape, which)}", r)
        assert got["tokens"] == one, r
        d = r // shape[1]                      # the rank's data index
        assert got["rows"] == (d * B // 2, (d + 1) * B // 2)
        for key, cshape in got["caches"].items():
            assert cshape[1] == B // 2, (key, cshape)


@pytest.mark.parametrize("world,arch", [(w, a) for w in SHAPES for a in ARCHS],
                         ids=lambda v: str(v))
def test_fsdp_rank_holds_its_data_shard_between_layers(runs, world, arch):
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(arch).smoke
    shape = SHAPES[world]
    for r in range(world):
        got = _load(runs, f"eng_{_label(arch, shape, 'fsdp')}", r)
        fsdp = got["fsdp"]
        assert fsdp and "embed" in fsdp
        for path, shapes in got["held"].items():
            for held, shard in zip(shapes, got["shard"][path]):
                want = list(shard)
                if path in fsdp:
                    want[fsdp[path]] //= 2
                assert held == tuple(want), (path, held, shard)
        # every gather makes a leaf's model shard whole along data, and
        # each forward (a prefill or a decode step) gathers every FSDP leaf
        # of each layer it runs once (the shared block at each
        # application), but for the leaves computed on their shard in
        # place (the embedding, the head, the experts, wo): never
        wo = "shared_attn/attn/wo" if cfg.family == "hybrid" else "blocks/attn/wo"
        experts = (("blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down")
                   if cfg.family == "moe" else ())
        assert set(got["in_place"]) == {"embed", "lm_head", wo, *experts}
        whole = {p: s[0] for p, s in got["shard"].items()}
        assert all(out == whole[p] for p, _, out in got["gathers"])
        count = {p: sum(g[0] == p for g in got["gathers"]) for p in fsdp}
        assert all(count[p] == 0 for p in got["in_place"])
        gathered = [p for p in fsdp if p not in got["in_place"]]
        uses = {"blocks/": cfg.n_mamba_layers or cfg.n_layers,
                "shared_attn/": cfg.hybrid_groups}
        per_run = {p: next(u for pre, u in uses.items() if p.startswith(pre))
                   for p in gathered}
        runs_ = {count[p] // per_run[p] for p in gathered}
        assert len(runs_) == 1 and all(count[p] % per_run[p] == 0
                                       for p in gathered), count
        assert runs_.pop() >= len(PROMPTS) + NEW_TOKENS - 1
        assert got["bytes"] < 0.6 * got["shard_bytes"]
        assert got["train_refused"]
        assert got["tokens"] == runs["one"][arch]


@pytest.mark.parametrize("world", list(SHAPES), ids=lambda v: str(v))
def test_batch_data_does_not_divide_stays_whole(runs, world):
    for r in range(world):
        got = _load(runs, f"whole_{_label(SHAPES[world])}", r)
        assert got["data"] is None
        assert all(s[1] == 3 for s in got["caches"].values())
        assert got["tokens"] == runs["one"]["whole"]


@pytest.mark.parametrize("world", list(SHAPES), ids=lambda v: str(v))
def test_moe_decode_routes_over_the_whole_batch(runs, world):
    """The planted router drops copies at the batch's capacity: the data
    ranks' decode logits are one process's, and another function without
    the token group."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import params_from_reference

    cfg = get_arch("deepseek-v2-236b").smoke
    params = torch.load(os.path.join(runs["tmp"], "params_planted.pt"),
                        weights_only=False)
    model = params_from_reference(params, cfg, "cpu")
    x = _load(runs, f"route_{_label(SHAPES[world])}", 0)
    prompts = [[(7 * i + j) % 250 + 1 for j in range(5 + i)]
               for i in range(ROUTE_B)]
    _, toks, steps = _serve(cfg, model, prompts, ROUTE_B)
    from repro_torch.models.transformer import init_cache
    cell_want, _ = model.forward_decode(x["token"], init_cache(
        cfg, ROUTE_B, MAXLEN, device="cpu"), x["pos"])
    for r in range(world):
        got = _load(runs, f"route_{_label(SHAPES[world])}", r)
        for key in ("", "_fsdp"):
            assert got["tokens" + key] == toks, (r, key)
            assert len(got["steps" + key]) == len(steps)
            for i, (a, b) in enumerate(zip(got["steps" + key], steps)):
                _close(a, b, f"rank {r}{key} step {i}")
        _close(got["cell"], cell_want, f"rank {r} serve_step")
        alone = max(float((a - b).abs().max())
                    for a, b in zip(got["steps_alone"], steps))
        assert alone > 1e3 * TOL * float(steps[0].abs().max()), alone


def test_sequence_split_bf16_decode_rounds_once(runs):
    """The merged output is the float64 attention over the whole cache
    rounded once to bfloat16 (ties: the value within 1e-5 of a rounding
    boundary)."""
    x = torch.load(os.path.join(runs["tmp"], "merge_in.pt"))
    outs = [torch.load(os.path.join(runs["tmp"], f"merge_{r}.pt"))
            for r in range(2)]
    assert torch.equal(outs[0], outs[1])
    Bm, H, KV, dh, S = MERGE
    p, pos, D = x["p"], x["pos"], H * dh
    dd = lambda t: t.double()                     # noqa: E731
    idx = x["x"][:, 0].float().argmax(-1)         # one-hot: the weights' rows
    q, k_new, v_new = p["wq"][idx], p["wk"][idx], p["wv"][idx]
    k, v = x["k"].clone(), x["v"].clone()
    rows = torch.arange(Bm)
    k[rows, pos], v[rows, pos] = k_new, v_new
    G = H // KV
    s = torch.einsum("bkgd,bskd->bkgs", dd(q).reshape(Bm, KV, G, dh),
                     dd(k)) * dh ** -0.5
    valid = torch.arange(S)[None, :] <= pos[:, None]
    s = s.masked_fill(~valid[:, None, None, :], -torch.inf)
    exact = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1),
                         dd(v)).reshape(Bm, D)
    got = outs[0].reshape(Bm, D)
    want = exact.to(torch.bfloat16)
    tie = ((exact * (1 + 1e-5)).to(torch.bfloat16)
           != (exact * (1 - 1e-5)).to(torch.bfloat16))
    bad = (got != want) & ~tie
    assert not bool(bad.any()), (int(bad.sum()), int(tie.sum()), got.numel())
