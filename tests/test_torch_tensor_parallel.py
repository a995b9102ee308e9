"""The dense LMs split over the mesh's ``model`` axis (Megatron's scheme,
``repro_torch/sharding/tp.py``) on gloo ranks (CPU), against the
one-process port and the JAX reference.

Ranks are ``torch.multiprocessing`` processes joined through a ``file://``
store under a temporary directory (no port), one thread each; one spawn a
world size runs every job: 2 ranks on (data 1, model 2), 4 ranks on (data
1, model 4), (data 2, model 2) and, with the int8 cross-pod reduce,
(pod 2, data 1, model 2).  The SMOKE configs of qwen2.5-3b
(replicated ``wk``/``wv``, ``bk``/``bv`` sharded at model 2 and replicated
at 4, a cache split over the sequence at 4), codeqwen1.5-7b (MHA, QKV
biases), musicgen-medium and internvl2-26b (a vision prefix; a
sequence-split cache at 4), with the JAX package's weights
(``params_from_reference``; the QKV biases random).

Limits (float32; a sum split over ranks only reorders adds): logits
within 1e-5 of the largest logit of the one-process forward (and of the
JAX reference's ``forward_full``); the first update's moments (the first
gradients) within 1e-5 of each leaf's largest magnitude; grad norms rtol
1e-5, losses rtol 1e-4; masters are not compared element by element after
AdamW (its first update is lr·sign(g) wherever |g| >> eps); the engine's
greedy tokens equal.  A checkpoint restores bitwise on any layout.
"""

import dataclasses
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt

B, S, MAXLEN, NP = 2, 12, 32, 8
TOL = 1e-5
LIMITS = dict(loss=1e-4, grad_norm=1e-5, first=1e-5)
PROMPTS = ([5, 3, 9, 1, 7], list(range(20, 31)), [2, 4, 6])
NEW_TOKENS = 6
FORWARD = {2: (("qwen2.5-3b", (1, 2)), ("codeqwen1.5-7b", (1, 2)),
               ("musicgen-medium", (1, 2)), ("internvl2-26b", (1, 2))),
           4: (("qwen2.5-3b", (1, 4)), ("internvl2-26b", (1, 4)),
               ("musicgen-medium", (1, 4)))}
TRAIN = {2: (("qwen2.5-3b", (1, 2)), ("codeqwen1.5-7b", (1, 2))),
         4: (("qwen2.5-3b", (1, 4)), ("qwen2.5-3b", (2, 2)))}
ENGINE = {2: (("qwen2.5-3b", (1, 2)), ("codeqwen1.5-7b", (1, 2))),
          4: (("qwen2.5-3b", (1, 4)),)}
ARCHS = ("qwen2.5-3b", "codeqwen1.5-7b", "musicgen-medium", "internvl2-26b")


def _label(arch: str, shape) -> str:
    return f"{arch}-data{shape[0]}model{shape[1]}"


def _np_params(arch: str) -> dict:
    cfg = j_get_arch(arch).smoke
    tree = jax.tree.map(np.array, jt.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(1)
    for b in ("bq", "bk", "bv"):
        if b in tree["blocks"]["attn"]:
            a = tree["blocks"]["attn"][b]
            tree["blocks"]["attn"][b] = (0.1 * rng.standard_normal(a.shape)
                                         ).astype(a.dtype)
    return tree


def _inputs(cfg) -> tuple[np.ndarray, np.ndarray | None]:
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = (rng.standard_normal((B, NP, cfg.d_model)).astype(np.float32)
              if cfg.modality == "vision_prefix" else None)
    return tokens, prefix


def _spec(arch: str):
    from repro_torch.configs.registry import get_arch
    spec = get_arch(arch)
    return dataclasses.replace(spec, model=spec.smoke)


# ------------------------------------------------------------------- jobs
def _forward_job(rank: int, tmp: str, arch: str, shape):
    """Forward (logits gathered over model), one decode step against the
    rank's caches, the local shapes; rank 0 also the one-process port."""
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import (_leaves, init_cache,
                                                params_from_reference)
    from repro_torch.sharding.planner import plan_for
    from repro_torch.sharding.spec import shard_shape
    from repro_torch.sharding.tp import gather_from_model, model_split

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    spec = _spec(arch)
    cfg = spec.model
    plan = plan_for(spec, mesh, mode="decode",
                    cell=ShapeCell("tp", "decode", MAXLEN, B), cache_batch=B,
                    cache_len=MAXLEN)
    split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
    params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                        weights_only=False)
    tokens, prefix = _inputs(cfg)
    pre = None if prefix is None else torch.from_numpy(prefix)

    def run(model, sp):
        logits, caches, _ = model.forward_full(tokens, prefix_embeds=pre,
                                               return_cache=True)
        c = init_cache(cfg, B, MAXLEN, device="cpu", split=sp)
        n = caches["k"].shape[2]
        for key in c:
            if sp is not None and sp.cache == "seq":
                Sl = c[key].shape[2]
                c0 = sp.r * Sl
                k = max(0, min(n - c0, Sl))
                c[key][:, :, :k] = caches[key][:, :, c0:c0 + k]
            else:
                c[key][:, :, :n] = caches[key]
        step, _ = model.forward_decode(np.array([3, 4]), c, np.array([n, n]))
        return (gather_from_model(logits, -1, sp),
                gather_from_model(step, -1, sp))

    model = params_from_reference(params, cfg, "cpu", split)
    logits, step = run(model, split)
    axes = {"pod": 1, "data": 1, "model": shape[1]}
    flat = {p: s for p, s in _flat_specs(plan.param_specs).items()}
    shapes = {}
    for path, ts in _leaves(model).items():
        whole = _whole(params, path)
        spec1 = flat[path][1:] if path.startswith("blocks/") else flat[path]
        shapes[path] = (tuple(ts[0].shape), shard_shape(whole, spec1, axes),
                        "model" in str(spec1))
    out = dict(logits=logits, step=step, shapes=shapes,
               cache=split.cache, heads=split.heads, kv=split.kv)
    if rank == 0:
        one = params_from_reference(params, cfg, "cpu")
        out["one_logits"], out["one_step"] = run(one, None)
    torch.save(out, os.path.join(tmp, f"fwd_{_label(arch, shape)}_{rank}.pt"))


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _whole(params: dict, path: str) -> tuple:
    node = params
    for key in path.split("/"):
        node = node[key]
    shape = tuple(np.shape(node))
    return shape[1:] if path.startswith("blocks/") else shape


def _engine_job(rank: int, tmp: str, arch: str, shape):
    """The engine on a plan; rank 0 also the one-process engine."""
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import params_from_reference
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.planner import plan_for
    from repro_torch.sharding.tp import model_split

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    spec = _spec(arch)
    cfg = spec.model
    plan = plan_for(spec, mesh, mode="decode",
                    cell=ShapeCell("tp", "decode", MAXLEN, B), cache_batch=B,
                    cache_len=MAXLEN)
    split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
    params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                        weights_only=False)

    def serve(model, **kw):
        eng = ServeEngine(cfg, model, max_batch=B, max_len=MAXLEN,
                          device="cpu", **kw)
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=NEW_TOKENS)
        return [r.tokens for r in eng.run_to_completion()]

    out = {"tokens": serve(params_from_reference(params, cfg, "cpu", split),
                           mesh=mesh, plan=plan), "cache": split.cache}
    if rank == 0:
        out["one"] = serve(params_from_reference(params, cfg, "cpu"))
    torch.save(out, os.path.join(tmp, f"eng_{_label(arch, shape)}_{rank}.pt"))


def _train_job(rank: int, tmp: str, arch: str, shape):
    """2 steps through ``build_cell``'s step, the gathers on its path
    recorded; rank 0 also the one-process step."""
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.data.tokens import PipelineState, TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import _flatten
    from repro_torch.sharding.placement import local_rows, spec_of
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    spec = _spec(arch)
    cell = ShapeCell("tp", "train", 16, 4)
    cfg = spec.cell_config(cell)
    oc = OptConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                        weights_only=False)
    split = build_cell(spec, cell, mesh).split(mesh)
    model, state = tloop.init_state(cfg, 0, device="cpu", params=params,
                                    split=split)
    prog = build_cell(spec, cell, mesh, microbatch_override=1, oc=oc,
                      model=model)
    state = tloop.shard_state(state, prog.in_shardings[0], mesh)
    gathers = []
    real = tloop.gather_full

    def spy(x, over=None):
        out = real(x, over=over)
        gathers.append(("model" in str(spec_of(x)), out.numel(), x.numel()))
        return out

    tloop.gather_full = spy
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq_len=16)
    batches, ps = [], PipelineState()
    for _ in range(2):
        b, ps = pipe.batch_at(ps)
        batches.append({k: torch.as_tensor(v) for k, v in b.items()})
    metrics, first = [], None
    try:
        for b in batches:
            state, m = prog.fn(state, local_rows(
                b, prog.in_shardings[1]["tokens"], mesh))
            metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
            if first is None:
                tloop.gather_full = real
                one = tloop.gather_state(state)
                first = {p: {k: x.clone() for k, x in
                             _flatten(getattr(one, p)).items()}
                         for p in ("m", "v")}
                tloop.gather_full = spy
    finally:
        tloop.gather_full = real
    out = dict(metrics=metrics, first=first, gathers=gathers,
               partial=sorted(split.partial))
    if rank == 0:
        model2, st = tloop.init_state(cfg, 0, device="cpu", params=params)
        step = tloop.make_train_step(model2, oc, n_microbatches=shape[0])
        ref, ref_first = [], None
        for b in batches:
            st, m = step(st, b)
            ref.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
            if ref_first is None:
                ref_first = {p: {k: x.clone() for k, x in
                                 _flatten(getattr(st, p)).items()}
                             for p in ("m", "v")}
        out.update(ref=ref, ref_first=ref_first)
    torch.save(out, os.path.join(tmp, f"train_{_label(arch, shape)}_{rank}.pt"))


def _ckpt_job(rank: int, tmp: str):
    """A state trained a step at (data 1, model 2), saved; restored at
    (data 2, model 1) and by rank 0 alone: bitwise."""
    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeCell
    from repro_torch.data.tokens import PipelineState, TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import _flatten
    from repro_torch.sharding.placement import local_rows
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    spec = _spec("qwen2.5-3b")
    cell = ShapeCell("tp", "train", 16, 4)
    cfg = spec.cell_config(cell)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    split = build_cell(spec, cell, mesh).split(mesh)
    model, state = tloop.init_state(cfg, 0, device="cpu", split=split)
    prog = build_cell(spec, cell, mesh, microbatch_override=1,
                      oc=OptConfig(lr=5e-3, warmup_steps=1, total_steps=10),
                      model=model)
    state = tloop.shard_state(state, prog.in_shardings[0], mesh)
    b, _ = TokenPipeline(vocab_size=cfg.vocab_size, batch=4,
                         seq_len=16).batch_at(PipelineState())
    b = {k: torch.as_tensor(v) for k, v in b.items()}
    state, _ = prog.fn(state, local_rows(b, prog.in_shardings[1]["tokens"],
                                         mesh))
    d = os.path.join(tmp, "ckpt")
    ckpt.save(d, 1, state)
    want = tloop.gather_state(state)
    flat = lambda st: {f"{p}/{k}": x for p in ("params", "m", "v")
                       for k, x in _flatten(getattr(st, p)).items()}
    want = flat(want)
    _, fresh = tloop.init_state(cfg, 7, device="cpu")
    mesh21 = make_mesh((2, 1), ("data", "model"), "cpu")
    prog21 = build_cell(spec, cell, mesh21)
    target = tloop.shard_state(fresh, prog21.in_shardings[0], mesh21)
    got, _ = ckpt.restore(d, target)
    got = flat(tloop.gather_state(got))
    same = {"data2model1": all(torch.equal(got[k], want[k]) for k in want)}
    dist.barrier()
    if rank == 0:
        got, _ = ckpt.restore(d, fresh)
        same["one"] = all(torch.equal(flat(got)[k], want[k]) for k in want)
    torch.save(same, os.path.join(tmp, f"ckpt_{rank}.pt"))


def _int8_job(rank: int, tmp: str):
    """int8_ef at (pod 2, data 1, model 2): ``compressed_mean`` of each
    rank's model shard on the whole leaf's scale (two steps of EF), and
    the train step's losses and grad norms; rank 0 also the one-process
    gradients of each pod's rows and the EF math on the host."""
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.data.tokens import PipelineState, TokenPipeline
    from repro_torch.launch.mesh import axis_group, make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import _flatten, _nest
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.placement import local_rows
    from repro_torch.sharding.tp import gather_from_model
    from repro_torch.train import compression as tcomp
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig, adamw_update, global_norm

    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    pod, m = rank // 2, rank % 2
    group = axis_group(mesh, ("model",))
    whole = lambda p, step: torch.from_numpy((np.random.default_rng(
        10 * step + p).standard_normal((6, 8))
        * (1.0 + 9.0 * (np.arange(8) >= 4))).astype(np.float32))  # larger on rank 1
    ef = torch.zeros((6, 4))
    shards = []
    with use_mesh(mesh):
        for step in range(2):
            g = whole(pod, step)[:, 4 * m:4 * m + 4]
            mean, ef = tcomp.compressed_mean({"a": g}, {"a": ef}, "pod",
                                             {"a": group})
            ef = ef["a"]
            split = type("S", (), {"group": group, "m": 2, "r": m})
            shards.append((gather_from_model(mean["a"], 1, split),
                           gather_from_model(ef, 1, split)))
    host, efs = [], [torch.zeros((6, 8)) for _ in range(2)]
    for step in range(2):
        deqs = []
        for p in range(2):
            c = whole(p, step) + efs[p]
            deq = tcomp.dequantize_int8(*tcomp.quantize_int8(c))
            efs[p] = c - deq
            deqs.append(deq)
        host.append((tcomp.divide(deqs[0] + deqs[1], 2), efs[pod]))
    same = all(torch.equal(a, b) for got, want in zip(shards, host)
               for a, b in zip(got, want))

    spec = _spec("qwen2.5-3b")
    cell = ShapeCell("tp", "train", 16, 4)
    cfg = spec.cell_config(cell)
    oc = OptConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    split = build_cell(spec, cell, mesh, pod_reduce="int8_ef").split(mesh)
    model, state = tloop.init_state(cfg, 0, device="cpu", ef=True, split=split)
    prog = build_cell(spec, cell, mesh, pod_reduce="int8_ef",
                      microbatch_override=1, oc=oc, model=model)
    state = tloop.shard_state(state, prog.in_shardings[0], mesh)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq_len=16)
    batches, ps = [], PipelineState()
    for _ in range(2):
        b, ps = pipe.batch_at(ps)
        batches.append({k: torch.as_tensor(v) for k, v in b.items()})
    metrics = []
    for b in batches:
        state, mt = prog.fn(state, local_rows(
            b, prog.in_shardings[1]["tokens"], mesh))
        metrics.append([float(mt[k]) for k in ("loss", "grad_norm", "lr")])
    out = dict(same=same, metrics=metrics)
    if rank == 0:                     # each pod's rows, the EF math
        model2, st = tloop.init_state(cfg, 0, device="cpu")
        accumulate = tloop._accumulator(model2, 1, False)
        efs, ref = [tcomp.ef_init(st.params) for _ in range(2)], []
        for b in batches:
            deqs, losses = [], []
            for p in range(2):
                acc, loss = accumulate({k: v[2 * p:2 * p + 2]
                                        for k, v in b.items()})
                flat_ef = _flatten(efs[p])
                c = {k: a + flat_ef[k] for k, a in acc.items()}
                deq = {k: tcomp.dequantize_int8(*tcomp.quantize_int8(x))
                       for k, x in c.items()}
                efs[p] = _nest({k: c[k] - deq[k] for k in c})
                deqs.append(deq)
                losses.append(loss)
            mean = _nest({k: tcomp.divide(deqs[0][k] + deqs[1][k], 2)
                          for k in deqs[0]})
            gnorm = global_norm(mean)
            _, _, _, mt = adamw_update(st.params, mean, st.m, st.v, st.step,
                                       oc, gnorm=gnorm)
            st = tloop.TrainState(st.params, st.m, st.v, st.step + 1, None)
            tloop.load_masters(model2, st.params)
            ref.append([float(tcomp.divide(losses[0] + losses[1], 2)),
                        float(gnorm), float(mt["lr"])])
        out["ref"] = ref
    torch.save(out, os.path.join(tmp, f"int8_{rank}.pt"))


def _worker(rank: int, world: int, store: str, tmp: str, jobs) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    init_group("cpu", init_method=f"file://{store}", world_size=world,
               rank=rank)
    try:
        for name, *args in jobs:
            {"forward": _forward_job, "engine": _engine_job,
             "train": _train_job, "ckpt": _ckpt_job,
             "int8": _int8_job}[name](rank, tmp, *args)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs():
    """Every job, once: {"tmp": the directory of the ranks' results,
    "jax": the reference's logits by arch}."""
    with tempfile.TemporaryDirectory(prefix="tp-") as tmp:
        jax_logits = {}
        for arch in ARCHS:
            params = _np_params(arch)
            torch.save(params, os.path.join(tmp, f"params_{arch}.pt"))
            cfg_j = j_get_arch(arch).smoke
            tokens, prefix = _inputs(cfg_j)
            logits, _, _ = jt.forward_full(
                jax.tree.map(jax.numpy.asarray, params), cfg_j,
                jax.numpy.asarray(tokens),
                prefix_embeds=None if prefix is None else jax.numpy.asarray(prefix))
            jax_logits[arch] = np.asarray(logits)
        for world in (2, 4):
            jobs = ([("forward", a, s) for a, s in FORWARD[world]]
                    + [("engine", a, s) for a, s in ENGINE[world]]
                    + [("train", a, s) for a, s in TRAIN[world]]
                    + ([("ckpt",)] if world == 2 else [("int8",)]))
            mp.spawn(_worker, args=(world, os.path.join(tmp, f"store{world}"),
                                    tmp, jobs), nprocs=world, join=True)
        yield {"tmp": tmp, "jax": jax_logits}


def _load(runs, name: str, rank: int) -> dict:
    return torch.load(os.path.join(runs["tmp"], f"{name}_{rank}.pt"),
                      weights_only=False)


def _cases(table):
    return [(world, a, s) for world, rows in table.items() for a, s in rows]


def _close(got: torch.Tensor, want, label: str) -> None:
    want = torch.as_tensor(np.array(want))
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), (label, err)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("world,arch,shape", _cases(FORWARD),
                         ids=lambda v: str(v))
def test_forward_and_decode_match_one_process_and_reference(runs, world, arch,
                                                            shape):
    one = _load(runs, f"fwd_{_label(arch, shape)}", 0)
    for r in range(world):
        got = _load(runs, f"fwd_{_label(arch, shape)}", r)
        _close(got["logits"], one["one_logits"], f"{arch} rank {r} forward")
        _close(got["logits"], runs["jax"][arch], f"{arch} rank {r} vs JAX")
        _close(got["step"], one["one_step"], f"{arch} rank {r} decode")
    # the plan's layouts: qwen's KV heads do not divide model = 4
    assert one["cache"] == ("seq" if arch in ("qwen2.5-3b", "internvl2-26b")
                            and shape[1] == 4 else "heads")


@pytest.mark.parametrize("world,arch,shape", _cases(FORWARD),
                         ids=lambda v: str(v))
def test_each_rank_holds_its_shards(runs, world, arch, shape):
    for r in range(world):
        shapes = _load(runs, f"fwd_{_label(arch, shape)}", r)["shapes"]
        sharded = [p for p, (_, _, on) in shapes.items() if on]
        assert {"blocks/attn/wq", "blocks/attn/wo", "blocks/mlp/w_gate",
                "embed", "lm_head"} <= set(sharded)
        for path, (local, want, _) in shapes.items():
            assert local == want, (path, local, want)


@pytest.mark.parametrize("world,arch,shape", _cases(TRAIN),
                         ids=lambda v: str(v))
def test_train_step_within_limits(runs, world, arch, shape):
    ref = _load(runs, f"train_{_label(arch, shape)}", 0)
    for r in range(world):
        got = _load(runs, f"train_{_label(arch, shape)}", r)
        for a, b in zip(got["metrics"], ref["ref"], strict=True):
            np.testing.assert_allclose(a[0], b[0], rtol=LIMITS["loss"])
            np.testing.assert_allclose(a[1], b[1], rtol=LIMITS["grad_norm"])
            assert a[2] == b[2]
        for part in ("m", "v"):
            for path, want in ref["ref_first"][part].items():
                err = float((got["first"][part][path] - want).abs().max())
                assert err <= LIMITS["first"] * float(want.abs().max()), (
                    r, part, path, err)
        # no model-sharded leaf is gathered whole on the step's path
        assert got["gathers"] and all(out < whole for on, out, whole in
                                      got["gathers"] if on), r
    if arch == "qwen2.5-3b":   # wk/wv replicated beside split heads
        assert {"blocks/attn/wk", "blocks/attn/wv"} <= set(ref["partial"])


@pytest.mark.parametrize("world,arch,shape", _cases(ENGINE),
                         ids=lambda v: str(v))
def test_engine_on_a_plan_gives_one_process_tokens(runs, world, arch, shape):
    one = _load(runs, f"eng_{_label(arch, shape)}", 0)["one"]
    assert len(one) == len(PROMPTS) and all(len(t) == NEW_TOKENS for t in one)
    for r in range(world):
        got = _load(runs, f"eng_{_label(arch, shape)}", r)
        assert got["tokens"] == one, r
    assert got["cache"] == ("seq" if shape[1] == 4 else "heads")


def test_int8_ef_quantizes_a_split_leaf_on_its_whole_scale(runs):
    """At (pod 2, data 1, model 2) each rank's shard of a leaf quantizes on
    the whole leaf's scale: ``compressed_mean`` gathered over ``model``
    equals the unsplit EF math bitwise (two steps), and the train step
    holds its losses and grad norms within the limits of one process with
    the EF math on the host."""
    ref = _load(runs, "int8", 0)["ref"]
    for r in range(4):
        got = _load(runs, "int8", r)
        assert got["same"], r
        for a, b in zip(got["metrics"], ref, strict=True):
            np.testing.assert_allclose(a[0], b[0], rtol=LIMITS["loss"])
            np.testing.assert_allclose(a[1], b[1], rtol=LIMITS["grad_norm"])
            assert a[2] == b[2]


def test_checkpoint_of_model2_restores_bitwise_elsewhere(runs):
    for r in range(2):
        assert _load(runs, "ckpt", r)["data2model1"], r
    assert _load(runs, "ckpt", 0)["one"]


@pytest.mark.parametrize("empty", [False, True])
def test_decode_lse_merge_matches_unsplit_attention(empty):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models.attention import merge_by_lse

    rng = np.random.default_rng(5)
    Bq, H, KV, dh, Sk, m = 3, 8, 2, 16, 40, 4
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((Bq, H, dh), (Bq, Sk, KV, dh), (Bq, Sk, KV, dh)))
    lens = torch.tensor([9, 25, 1 if empty else 37])
    Sl = Sk // m
    outs, lses = [], []
    for r in range(m):
        piece = slice(r * Sl, (r + 1) * Sl)
        o, lse = decode_attention(q, k[:, piece].contiguous(),
                                  v[:, piece].contiguous(),
                                  (lens - r * Sl).clamp(0, Sl), round_p=False,
                                  return_lse=True)
        outs.append(o)
        lses.append(lse)
    # a piece with no keys: zeros and -inf
    assert torch.all(lses[-1][0] == -torch.inf) and torch.all(outs[-1][0] == 0)
    got = merge_by_lse(torch.stack(outs), torch.stack(lses))
    want = decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    _, lse = decode_attention_ref(q, k, v, lens, return_lse=True)
    torch.testing.assert_close(torch.logsumexp(torch.stack(lses), 0), lse,
                               rtol=1e-6, atol=1e-5)


class _Mesh:
    """A mesh's axes and this rank's coordinate, no process group."""

    def __init__(self, shape, names=("data", "model")):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def get_coordinate(self):
        return [0] * len(self.shape)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_other_families_refuse_a_split_and_run_at_model_1(arch, monkeypatch):
    """The ``ssm`` and ``hybrid`` families take the plan's split at model 2
    (``model_split`` and ``Transformer(split=)``: each rank's SSM heads),
    model 1 gives no split, and a plan that splits ``w_x`` but keeps
    ``w_z`` whole, or the reverse, is refused."""
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.sharding import tp
    from repro_torch.sharding.planner import plan_for
    from repro_torch.sharding.spec import P
    from repro_torch.sharding.tp import model_split, plan_split

    spec = _spec(arch)
    cfg = spec.model
    plan = plan_for(spec, _Mesh((1, 2)), mode="train")
    monkeypatch.setattr(tp, "axis_group", lambda mesh, axes: "model group")
    split = model_split(cfg, plan.param_specs, _Mesh((1, 2)))
    assert split.group == "model group"
    assert split.ssm == (0, cfg.ssm_heads // 2)
    assert split.inner == (0, cfg.d_inner // 2)
    model = Transformer(cfg, "meta", split)
    assert tuple(model.blocks[0].ssm["w_x"].shape) == (cfg.d_model,
                                                       cfg.d_inner // 2)
    plan1 = plan_for(spec, _Mesh((2, 1)), mode="train")
    assert model_split(cfg, plan1.param_specs, _Mesh((2, 1))) is None
    col = P(None, None, "model")
    for split_one, whole in (("w_x", "w_z"), ("w_z", "w_x")):
        specs = {"blocks": {"ssm": {split_one: col, whole: P()}}}
        with pytest.raises(NotImplementedError, match="w_"):
            plan_split(cfg, specs, 2, 0)
    logits, _, _ = init_params(cfg, 0, "cpu").forward_full(
        np.zeros((1, 4), np.int32))
    assert torch.isfinite(logits).all()


def test_dryrun_counts_the_split_by_hand():
    """qwen2.5's SMOKE train cell (S 16, batch 4, one microbatch) on (data
    2, model 2), counted by hand from the plan's split."""
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell
    from repro_torch.sharding.spec import MeshShape

    spec = _spec("qwen2.5-3b")
    cell = ShapeCell("tp", "train", 16, 4)
    axes = {"data": 2, "model": 2}
    prog = build_cell(spec, cell, MeshShape((2, 2), ("data", "model")),
                      microbatch_override=1)
    # T = 2 rows x 16 tokens a rank, D 64, 2 layers, float32 activations;
    # ring all-reduce over 2 ranks sends 2 (2 - 1) / 2 = 1 x the bytes
    T, D, L = 32, 64, 2
    fwd = L * 2 * T * D * 4            # heads and FFN columns: fp32 partials
    embed = T * D * 4                  # vocab-parallel embedding
    # remat: the recompute stops at the block's last saved tensor, before
    # the FFN's all-reduce
    recompute = L * T * D * 4
    bwd = L * 2 * T * D * 4            # the split inputs' gradients
    # the head's input gradient; the loss over 2 rows x 15 targets
    head = T * D * 4 + 3 * (T - 2) * 4
    assert dryrun.split_collective_bytes(prog, axes) == (
        fwd + embed + recompute + bwd + head)
    # the gradients' all-reduce over data (1 x the bytes of the rank's
    # model shards), over data and model (1.5 x) for wk and wv, which stay
    # whole beside split heads: elements of the rank's shards by hand
    shards = (128 * 64 + 64 * 128 + 64 + 2 * 64 * 2       # embed, head, norms
              + 2 * (2 * 64 * 4 * 8)                       # wq, wo
              + 2 * 4 * 8 + 2 * 2 * 1 * 8                  # bq, bk + bv
              + 3 * (2 * 64 * 64))                         # the FFN
    partial = 2 * (2 * 64 * 2 * 8)                         # wk, wv
    grads = 4 * shards + 1.5 * 4 * partial
    # the masters' all-gather over data (FSDP): one shard of each leaf a
    # rank sends, its dims divided by data and model
    gathers = 4 * (2 * 128 * 32 + 2 * 4 * 8 * 32 * 2 + 2 * 2 * 32 * 2 * 8
                   + 3 * 2 * 32 * 64)
    # the loss's sum over data, the clipping norm's squares over model
    scalars = 4 + 4
    assert dryrun._train_collective_bytes(prog, axes, "fp32") == (
        grads + gathers + scalars + fwd + embed + recompute + bwd + head)
