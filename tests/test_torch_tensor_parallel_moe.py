"""The MoE family split over the mesh's ``model`` axis (experts, the
router's columns, the shared experts' columns, MLA's heads and latent
cache over the sequence; ``repro_torch/sharding/tp.py``,
``repro_torch/models/moe.py``) and routed over the data-parallel ranks'
whole microbatch, on gloo ranks (CPU), against the one-process port and
the JAX reference.

Ranks are ``torch.multiprocessing`` processes joined through a ``file://``
store under a temporary directory, one thread each; one spawn a world size
runs every job: 2 ranks on (data 1, model 2) and (data 2, model 1), 4 on
(data 1, model 4) and (data 2, model 2).  The SMOKE configs of olmoe-1b-7b
(GQA, 8 experts top-2) and deepseek-v2-236b (MLA, 2 shared + 8 routed
experts top-2) with the JAX package's weights, under two sets of specs:
the SMOKE plan's own (``smoke``: heads and the router's columns split, the
experts whole) and the specs ``plan_for`` gives the full config on the
same mesh (``full``: the experts, MLA's heads and the shared experts'
columns split, the router whole), applied at SMOKE widths.

Limits (float32; a sum split over ranks only reorders adds): logits
within 1e-5 of the largest logit of the one-process forward and of the
JAX reference's; the first update's moments within 1e-5 of each leaf's
largest magnitude; grad norms rtol 1e-5, losses rtol 1e-4; the engine's
greedy tokens equal.  At (data 2, model 1) each MoE layer's output over
both ranks' rows is the JAX ``moe_ffn``'s on the whole microbatch (within
1e-5 of its largest), its aux loss too (rtol 1e-5), at the SMOKE
capacity, where copies drop.
"""

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
from repro.models import moe as jmoe
from repro.models import transformer as jt

B, S, MAXLEN = 2, 12, 32
TB, TS = 4, 16                       # the train batch: rows, tokens
TOL = 1e-5
LIMITS = dict(loss=1e-4, grad_norm=1e-5, first=1e-5)
PROMPTS = ([5, 3, 9, 1, 7], list(range(20, 31)), [2, 4, 6])
NEW_TOKENS = 6
ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b")
SPECS = ("smoke", "full")
FORWARD = {2: [(a, (1, 2), w) for a in ARCHS for w in SPECS],
           4: [(a, (1, 4), w) for a in ARCHS for w in SPECS]}
# (arch, mesh, specs, microbatches a rank)
TRAIN = {2: [(a, (1, 2), w, 1) for a in ARCHS for w in SPECS]
         + [("deepseek-v2-236b", (1, 2), "both", 1)],
         4: [(a, (1, 4), "full", 1) for a in ARCHS]
         + [(a, (2, 2), w, 1) for a in ARCHS for w in SPECS]
         + [("olmoe-1b-7b", (2, 2), "full", 2)]}
ENGINE = {2: [(a, (1, 2), w) for a in ARCHS for w in SPECS],
          4: [(a, (1, 4), "full") for a in ARCHS]}
ROUTE_ARCH = "olmoe-1b-7b"


def _label(*args) -> str:
    return "-".join(str(a).replace(" ", "") for a in args)


def _np_params(arch: str) -> dict:
    cfg = j_get_arch(arch).smoke
    return jax.tree.map(np.array, jt.init_params(cfg, jax.random.key(0)))


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)


def _train_batches(vocab: int) -> list[dict]:
    from repro_torch.data.tokens import PipelineState, TokenPipeline

    pipe = TokenPipeline(vocab_size=vocab, batch=TB, seq_len=TS)
    out, ps = [], PipelineState()
    for _ in range(2):
        b, ps = pipe.batch_at(ps)
        out.append({k: torch.as_tensor(v) for k, v in b.items()})
    return out


def _plan(mesh, arch: str, which: str, mode: str):
    """The plan of ``arch`` on ``mesh``: of its SMOKE config, or (``full``)
    of the full config, whose specs the SMOKE model then runs under, or
    (``both``) the SMOKE plan with the experts split beside the router's
    columns, as the planner lays out deepseek-v2 at widths 256 to 2,048
    (the router's gathered logits then carry partial gradients)."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.sharding.planner import plan_for
    from repro_torch.sharding.spec import P

    spec = get_arch(arch)
    if which != "full":
        spec = dataclasses.replace(spec, model=spec.smoke)
    if mode == "train":
        plan = plan_for(spec, mesh, mode="train",
                        cell=ShapeCell("tp", "train", TS, TB))
    else:
        plan = plan_for(spec, mesh, mode="decode",
                        cell=ShapeCell("tp", "decode", MAXLEN, B),
                        cache_batch=B, cache_len=MAXLEN)
    if which == "both":
        moe = plan.param_specs["blocks"]["moe"]
        for name in ("w_gate", "w_up", "w_down"):
            moe[name] = P(None, "model", *tuple(moe[name])[2:])
    return plan


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


# ------------------------------------------------------------------- jobs
def _forward_job(rank: int, tmp: str, arch: str, shape, which: str):
    """Forward (logits gathered over model, aux), one decode step against
    the rank's caches, the local shapes; rank 0 also the one-process port."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import (_leaves, init_cache,
                                                params_from_reference)
    from repro_torch.sharding.spec import shard_shape
    from repro_torch.sharding.tp import gather_from_model, model_split

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    cfg = get_arch(arch).smoke
    plan = _plan(mesh, arch, which, "decode")
    split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
    params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                        weights_only=False)
    tokens = _tokens(cfg)

    def run(model, sp):
        logits, caches, aux = model.forward_full(tokens, return_cache=True)
        c = init_cache(cfg, B, MAXLEN, device="cpu", split=sp)
        for key in c:
            if sp is not None and sp.cache == "seq":
                Sl = c[key].shape[2]
                c0 = sp.r * Sl
                k = max(0, min(S - c0, Sl))
                c[key][:, :, :k] = caches[key][:, :, c0:c0 + k]
            else:
                c[key][:, :, :S] = caches[key]
        step, _ = model.forward_decode(np.array([3, 4]), c, np.array([S, S]))
        gather = (lambda t: gather_from_model(t, -1, sp)) if (
            sp is not None and sp.vocab_out is not None) else (lambda t: t)
        return gather(logits), gather(step), float(aux)

    model = params_from_reference(params, cfg, "cpu", split)
    logits, step, aux = run(model, split)
    axes = {"pod": 1, "data": 1, "model": shape[1]}
    flat = _flat_specs(plan.param_specs)
    shapes = {}
    for path, ts in _leaves(model).items():
        whole = _whole(params, path)
        spec1 = flat[path][1:] if path.startswith("blocks/") else flat[path]
        shapes[path] = (tuple(ts[0].shape), shard_shape(whole, spec1, axes),
                        "model" in str(spec1))
    out = dict(logits=logits, step=step, aux=aux, shapes=shapes,
               cache=split.cache, heads=split.heads, experts=split.experts,
               router=split.router, shared=split.shared,
               partial=sorted(split.partial))
    if rank == 0:
        one = params_from_reference(params, cfg, "cpu")
        out["one_logits"], out["one_step"], out["one_aux"] = run(one, None)
    torch.save(out, os.path.join(tmp, f"fwd_{_label(arch, shape, which)}_{rank}.pt"))


def _engine_job(rank: int, tmp: str, arch: str, shape, which: str):
    """The engine on a plan; rank 0 also the one-process engine."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import params_from_reference
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.tp import model_split

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    cfg = get_arch(arch).smoke
    plan = _plan(mesh, arch, which, "decode")
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
    torch.save(out, os.path.join(tmp, f"eng_{_label(arch, shape, which)}_{rank}.pt"))


def _train_job(rank: int, tmp: str, arch: str, shape, which: str, micro: int):
    """2 steps of the mesh's train step, the gathers on its path recorded;
    rank 0 also the one-process step at the same microbatches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import _flatten
    from repro_torch.sharding.placement import local_rows, spec_of
    from repro_torch.sharding.tp import model_split
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    cfg = get_arch(arch).smoke
    oc = OptConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                        weights_only=False)
    plan = _plan(mesh, arch, which, "train")
    split = model_split(cfg, plan.param_specs, mesh)
    model, state = tloop.init_state(cfg, 0, device="cpu", params=params,
                                    split=split)
    step = tloop.make_train_step(model, oc, n_microbatches=micro, mesh=mesh,
                                 grad_specs=plan.param_specs)
    state = tloop.shard_state(state, tloop.state_specs(plan), mesh)
    gathers = []
    real = tloop.gather_full

    def spy(x, over=None):
        out = real(x, over=over)
        gathers.append(("model" in str(spec_of(x)), out.numel(), x.numel()))
        return out

    tloop.gather_full = spy
    metrics, first = [], None
    try:
        for b in _train_batches(cfg.vocab_size):
            state, m = step(state, local_rows(b, plan.batch_spec(TB), mesh))
            metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
            if first is None:
                tloop.gather_full = real
                one = tloop.gather_state(state)
                first = {k: x.clone() for k, x in _flatten(one.m).items()}
                tloop.gather_full = spy
    finally:
        tloop.gather_full = real
    out = dict(metrics=metrics, first=first, gathers=gathers,
               partial=sorted(split.partial) if split else [])
    if rank == 0:
        model2, st = tloop.init_state(cfg, 0, device="cpu", params=params)
        step2 = tloop.make_train_step(model2, oc, n_microbatches=micro)
        ref, ref_first = [], None
        for b in _train_batches(cfg.vocab_size):
            st, m = step2(st, b)
            ref.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
            if ref_first is None:
                ref_first = {k: x.clone() for k, x in _flatten(st.m).items()}
        out.update(ref=ref, ref_first=ref_first)
    torch.save(out, os.path.join(
        tmp, f"train_{_label(arch, shape, which, micro)}_{rank}.pt"))


def _route_job(rank: int, tmp: str):
    """olmoe's SMOKE train step at (data 2, model 1), one microbatch of
    the whole batch: each MoE layer's input, output and aux loss on this
    rank (a spy on the layer), and the first step's loss and grad norm."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.sharding.placement import local_rows
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    cfg = get_arch(ROUTE_ARCH).smoke
    params = torch.load(os.path.join(tmp, f"params_{ROUTE_ARCH}.pt"),
                        weights_only=False)
    plan = _plan(mesh, ROUTE_ARCH, "smoke", "train")
    model, state = tloop.init_state(cfg, 0, device="cpu", params=params)
    step = tloop.make_train_step(model, OptConfig(), n_microbatches=1,
                                 mesh=mesh, grad_specs=plan.param_specs)
    state = tloop.shard_state(state, tloop.state_specs(plan), mesh)
    layers = []
    real = transformer.moe_ffn

    def spy(p, x, **kw):
        out, aux = real(p, x, **kw)
        layers.append((x.detach().clone(), out.detach().clone(),
                       float(aux)))
        return out, aux

    transformer.moe_ffn = spy
    try:
        b = _train_batches(cfg.vocab_size)[0]
        _, m = step(state, local_rows(b, plan.batch_spec(TB), mesh))
    finally:
        transformer.moe_ffn = real
    torch.save(dict(layers=layers[:cfg.n_layers], loss=float(m["loss"]),
                    grad_norm=float(m["grad_norm"])),
               os.path.join(tmp, f"route_{rank}.pt"))


def _worker(rank: int, world: int, store: str, tmp: str, jobs) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    init_group("cpu", init_method=f"file://{store}", world_size=world,
               rank=rank)
    try:
        for name, *args in jobs:
            {"forward": _forward_job, "engine": _engine_job,
             "train": _train_job, "route": _route_job}[name](rank, tmp, *args)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs():
    """Every job, once: {"tmp": the directory of the ranks' results,
    "jax": the reference's logits by arch}."""
    with tempfile.TemporaryDirectory(prefix="tp-moe-") as tmp:
        jax_logits = {}
        for arch in ARCHS:
            params = _np_params(arch)
            torch.save(params, os.path.join(tmp, f"params_{arch}.pt"))
            cfg_j = j_get_arch(arch).smoke
            logits, _, _ = jt.forward_full(jax.tree.map(jnp.asarray, params),
                                           cfg_j, jnp.asarray(_tokens(cfg_j)))
            jax_logits[arch] = np.asarray(logits)
        for world in (2, 4):
            jobs = ([("forward", *c) for c in FORWARD[world]]
                    + [("engine", *c) for c in ENGINE[world]]
                    + [("train", *c) for c in TRAIN[world]]
                    + ([("route",)] if world == 2 else []))
            mp.spawn(_worker, args=(world, os.path.join(tmp, f"store{world}"),
                                    tmp, jobs), nprocs=world, join=True)
        yield {"tmp": tmp, "jax": jax_logits}


def _load(runs, name: str, rank: int) -> dict:
    return torch.load(os.path.join(runs["tmp"], f"{name}_{rank}.pt"),
                      weights_only=False)


def _cases(table):
    return [(world, *c) for world, rows in table.items() for c in rows]


def _close(got: torch.Tensor, want, label: str) -> None:
    want = torch.as_tensor(np.array(want))
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), (label, err)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("world,arch,shape,which", _cases(FORWARD),
                         ids=lambda v: str(v))
def test_forward_and_decode_match_one_process_and_reference(runs, world, arch,
                                                            shape, which):
    name = f"fwd_{_label(arch, shape, which)}"
    one = _load(runs, name, 0)
    for r in range(world):
        got = _load(runs, name, r)
        _close(got["logits"], one["one_logits"], f"{arch} rank {r} forward")
        _close(got["logits"], runs["jax"][arch], f"{arch} rank {r} vs JAX")
        _close(got["step"], one["one_step"], f"{arch} rank {r} decode")
        np.testing.assert_allclose(got["aux"], one["one_aux"], rtol=1e-5)
    mla = arch == "deepseek-v2-236b"
    assert one["cache"] == ("seq" if mla else "heads")
    # the layouts: the SMOKE plan splits the router, the full one the experts
    assert (one["experts"] is None) == (which == "smoke")
    assert (one["router"] is None) == (which == "full")
    assert (one["shared"] is not None) == (mla and which == "full")
    if which == "full":
        assert "blocks/moe/router" in one["partial"]
    if mla:
        assert {"blocks/attn/w_dkv", "blocks/attn/w_kr", "blocks/attn/norm_kv",
                "blocks/attn/w_dq", "blocks/attn/norm_q"} <= set(one["partial"])


@pytest.mark.parametrize("world,arch,shape,which", _cases(FORWARD),
                         ids=lambda v: str(v))
def test_each_rank_holds_its_shards(runs, world, arch, shape, which):
    m = shape[1]
    for r in range(world):
        shapes = _load(runs, f"fwd_{_label(arch, shape, which)}", r)["shapes"]
        sharded = {p for p, (_, _, on) in shapes.items() if on}
        heads = ({"blocks/attn/w_uq", "blocks/attn/w_uk", "blocks/attn/w_uv",
                  "blocks/attn/wo"} if arch == "deepseek-v2-236b"
                 else {"blocks/attn/wq", "blocks/attn/wo"})
        moe = ({"blocks/moe/router"} if which == "smoke" else
               {"blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down"})
        assert heads | moe <= sharded, sharded
        for path, (local, want, _) in shapes.items():
            assert local == want, (path, local, want)
        if which == "full":       # E / m experts a rank
            assert shapes["blocks/moe/w_gate"][0][0] == 8 // m


@pytest.mark.parametrize("world,arch,shape,which,micro", _cases(TRAIN),
                         ids=lambda v: str(v))
def test_train_step_within_limits(runs, world, arch, shape, which, micro):
    name = f"train_{_label(arch, shape, which, micro)}"
    ref = _load(runs, name, 0)
    for r in range(world):
        got = _load(runs, name, r)
        for a, b in zip(got["metrics"], ref["ref"], strict=True):
            np.testing.assert_allclose(a[0], b[0], rtol=LIMITS["loss"])
            np.testing.assert_allclose(a[1], b[1], rtol=LIMITS["grad_norm"])
            assert a[2] == b[2]
        for path, want in ref["ref_first"].items():
            err = float((got["first"][path] - want).abs().max())
            assert err <= LIMITS["first"] * float(want.abs().max()), (
                r, path, err)
        # no model-sharded leaf is gathered whole on the step's path
        assert got["gathers"] and all(out < whole for on, out, whole in
                                      got["gathers"] if on), r


@pytest.mark.parametrize("world,arch,shape,which", _cases(ENGINE),
                         ids=lambda v: str(v))
def test_engine_on_a_plan_gives_one_process_tokens(runs, world, arch, shape,
                                                    which):
    name = f"eng_{_label(arch, shape, which)}"
    one = _load(runs, name, 0)["one"]
    assert len(one) == len(PROMPTS) and all(len(t) == NEW_TOKENS for t in one)
    for r in range(world):
        assert _load(runs, name, r)["tokens"] == one, r


def _ref_capacity_and_drops(pj: dict, x: np.ndarray, k: int, cf: float):
    """The reference's capacity and dropped copies for ``x`` (T, D): the
    lines of ``repro.models.moe.moe_ffn`` that assign slots."""
    T = x.shape[0]
    E = pj["router"].shape[-1]
    cap = max(k, int(T * k * cf / E))
    cap = -(-cap // 4) * 4
    gates = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(pj["router"]), axis=-1)
    _, top_i = jax.lax.top_k(gates, k)
    counts, dropped = jnp.zeros((E,), jnp.int32), 0
    for j in range(k):
        onehot = jax.nn.one_hot(top_i[:, j], E, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(onehot, 0) - onehot) * onehot, -1) + counts[
            top_i[:, j]]
        dropped += int(jnp.sum(pos >= cap))
        counts = counts + jnp.sum(onehot, 0)
    return cap, dropped


def test_data_ranks_route_over_the_whole_microbatch(runs):
    """At (data 2, model 1) the MoE layers route over both ranks' rows as
    the reference routes the global microbatch: each layer's output within
    1e-5 of the JAX ``moe_ffn``'s on the whole microbatch, its aux loss
    rtol 1e-5, at the SMOKE capacity where copies drop; the step's loss and
    grad norm against the JAX ``lm_loss`` and its gradient's norm."""
    cfg_j = j_get_arch(ROUTE_ARCH).smoke
    params = _np_params(ROUTE_ARCH)
    ranks = [_load(runs, "route", r) for r in range(2)]
    for layer in range(cfg_j.n_layers):
        x = torch.cat([rk["layers"][layer][0] for rk in ranks]).numpy()
        got = torch.cat([rk["layers"][layer][1] for rk in ranks])
        pj = jax.tree.map(lambda a, i=layer: jnp.asarray(a[i]),
                          params["blocks"]["moe"])
        want, aux = jmoe.moe_ffn(pj, jnp.asarray(x), k=cfg_j.experts_per_token,
                                 capacity_factor=cfg_j.capacity_factor)
        cap, dropped = _ref_capacity_and_drops(
            pj, x.reshape(-1, x.shape[-1]), cfg_j.experts_per_token,
            cfg_j.capacity_factor)
        assert cap == 20 and dropped > 0, (cap, dropped)  # T 64 over 2 ranks
        _close(got, want, f"layer {layer} output")
        for rk in ranks:
            np.testing.assert_allclose(rk["layers"][layer][2], float(aux),
                                       rtol=1e-5)
    tokens = jnp.asarray(_train_batches(cfg_j.vocab_size)[0]["tokens"].numpy())
    loss, grads = jax.value_and_grad(jt.lm_loss)(
        jax.tree.map(jnp.asarray, params), cfg_j, tokens)
    gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                               for g in jax.tree.leaves(grads))))
    for rk in ranks:
        np.testing.assert_allclose(rk["loss"], float(loss), rtol=LIMITS["loss"])
        np.testing.assert_allclose(rk["grad_norm"], gnorm,
                                   rtol=LIMITS["grad_norm"])


def test_absorbed_decode_merges_pieces_by_lse():
    """MLA's absorbed decode over four pieces of the latent cache (one
    empty: zeros and -inf) merged by ``merge_by_lse`` against the unsplit
    softmax over the whole cache."""
    from repro_torch.models.attention import latent_piece, merge_by_lse

    rng = np.random.default_rng(6)
    Bq, H, r, dr, Sk, m = 3, 8, 32, 8, 40, 4
    q_lat, qr, ckv, kr = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((Bq, H, r), (Bq, H, dr), (Bq, Sk, r),
                               (Bq, Sk, dr)))
    lens = torch.tensor([9, 25, 17])
    scale = (16 + dr) ** -0.5
    Sl = Sk // m
    pieces = [latent_piece(q_lat, qr, ckv[:, i * Sl:(i + 1) * Sl],
                           kr[:, i * Sl:(i + 1) * Sl],
                           (lens - i * Sl).clamp(0, Sl), scale)
              for i in range(m)]
    assert torch.all(pieces[-1][1] == -torch.inf)
    assert torch.all(pieces[-1][0] == 0)
    got = merge_by_lse(torch.stack([p[0] for p in pieces]),
                       torch.stack([p[1] for p in pieces]))
    s = (q_lat @ ckv.transpose(1, 2) + qr @ kr.transpose(1, 2)) * scale
    s = s.masked_fill(~(torch.arange(Sk)[None, :] < lens[:, None])[:, None],
                      -1e30)
    want = torch.softmax(s, -1) @ ckv
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


class _Mesh:
    """A mesh's axes and this rank's coordinate, no process group."""

    def __init__(self, shape, names=("data", "model")):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def get_coordinate(self):
        return [0] * len(self.shape)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_split_takes_the_moe_family(arch, m):
    """``plan_split`` and ``Transformer(split=)`` run the MoE family at
    model 2 and 4 under both spec sets; a dim that does not divide the axis
    is split in GSPMD's pieces, as the dense split's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.spec import P
    from repro_torch.sharding.tp import plan_split

    cfg = get_arch(arch).smoke
    for which in SPECS:
        for mode in ("train", "decode"):
            plan = _plan(_Mesh((1, m)), arch, which, mode)
            for r in range(m):
                sp = plan_split(cfg, plan.param_specs, m, r, plan.cache_specs)
                assert sp.heads == (r * 4 // m, (r + 1) * 4 // m)
                if which == "full":
                    assert sp.experts == (r * 8 // m, (r + 1) * 8 // m)
                else:
                    assert sp.router == (r * 8 // m, (r + 1) * 8 // m)
                model = Transformer(cfg, "meta", sp)
                assert tuple(model.blocks[0].moe["router"].shape) == (
                    64, 8 // m if which == "smoke" else 8)
    # 8 experts over 3 ranks: pieces of 3, 3 and 2
    specs = {"blocks": {"moe": {"w_gate": P(None, "model", None, None)}}}
    assert [plan_split(cfg, specs, 3, r).experts for r in range(3)] == [
        (0, 3), (3, 6), (6, 8)]


def test_plan_split_refuses_shared_experts_split_alone():
    """The shared experts' column partials ride on the routed experts'
    all-reduce: a plan that splits the shared experts and keeps the routed
    ones whole raises."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.sharding.spec import P
    from repro_torch.sharding.tp import plan_split

    cfg = get_arch("deepseek-v2-236b").smoke
    col, row = P(None, None, "model"), P(None, "model", None)
    specs = {"blocks": {"moe": {"shared": {"w_gate": col, "w_up": col,
                                           "w_down": row}}}}
    with pytest.raises(NotImplementedError, match="shared experts"):
        plan_split(cfg, specs, 2, 0)
    specs["blocks"]["moe"].update(w_gate=P(None, "model", None, None),
                                  w_up=P(None, "model", None, None),
                                  w_down=P(None, "model", None, None))
    assert plan_split(cfg, specs, 2, 1).shared is not None


def test_dryrun_counts_a_moe_cell_by_hand():
    """deepseek-v2's SMOKE train cell (S 16, batch 4, one microbatch) on
    (data 2, model 2) under the full config's specs, counted by hand."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell
    from repro_torch.sharding.spec import MeshShape

    spec = get_arch("deepseek-v2-236b")
    cell = ShapeCell("tp", "train", TS, TB)
    mesh = MeshShape((2, 2), ("data", "model"))
    prog = build_cell(spec, cell, mesh, microbatch_override=1)
    prog.cfg = spec.smoke                  # the full plan on SMOKE widths
    axes = {"data": 2, "model": 2}
    # T = 2 rows x 16 tokens a rank, D 64, 2 layers, float32; a ring
    # all-reduce over 2 ranks sends 1 x the bytes
    T, D, L, E, k = 32, 64, 2, 8, 2
    fwd = L * 2 * T * D * 4          # MLA's wo and the experts' combine
    embed = T * D * 4
    bwd = L * 2 * T * D * 4          # the attention's and the MoE's input
    head = T * D * 4 + 3 * (T - 2) * 4  # the loss: 2 rows x 15 targets
    assert dryrun.split_collective_bytes(prog, axes) == (
        fwd + embed + fwd + bwd + head)
    # over the 2 data ranks a layer: the (k, E) int64 counts gathered, f's
    # and p's sums all-reduced, in the forward and the recompute, and the
    # sums once more in the backward
    route = L * (2 * (k * E * 8 + 2 * E * 4) + 2 * E * 4)
    assert dryrun.routing_collective_bytes(prog, axes, "fp32") == route
    # one data rank routes alone: nothing is sent
    assert dryrun.routing_collective_bytes(prog, {"data": 1, "model": 2},
                                           "fp32") == 0
