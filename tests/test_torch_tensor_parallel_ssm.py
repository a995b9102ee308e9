"""The ``ssm`` and ``hybrid`` families split over the mesh's ``model`` axis
(Mamba2's SSM heads, conv channels and state, zamba2's shared attention
block; ``repro_torch/sharding/tp.py``, ``repro_torch/models/mamba2.py``)
on gloo ranks (CPU), against the one-process port and the JAX reference.

Ranks are ``torch.multiprocessing`` processes joined through a ``file://``
store under a temporary directory, one thread each; one spawn a world size
runs every job: 2 ranks on (data 1, model 2), 4 on (data 1, model 4) and
(data 2, model 2).  The SMOKE configs of mamba2-1.3b (2 Mamba2 layers, 8
SSM heads of 8) and zamba2-7b (7 layers: a shared block of 4 heads at 2 ×
d_model after every 2 Mamba2 layers) with the JAX package's weights, under
two sets of specs: the SMOKE plan's own (``smoke``: the Mamba2 leaves
split, the shared block's weights whole; its serving cache over KV heads,
so the block runs on the cache's heads with its weights sliced) and the
specs ``plan_for`` gives the full config on the same mesh (``full``: the
shared block's heads and FFN columns split too), applied at SMOKE widths.

Limits (float32; a sum split over ranks only reorders adds): logits
within 1e-5 of the largest logit of the one-process forward and of the
JAX reference's; the first update's moments within 1e-5 of each leaf's
largest magnitude; grad norms rtol 1e-5, losses rtol 1e-4 (the train
step against the one-process port and against the JAX reference's
``make_train_step`` on the same weights and batches); the engine's greedy
tokens equal to the one-process engine's and to the JAX ``ServeEngine``'s.
The gated norm alone: its gradients within 1e-5 of one process's, and off
by far more without the backward all-reduce.
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
from repro.models import transformer as jt
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import optim as joptim
from repro.train import train_loop as jloop

B, S, MAXLEN = 2, 12, 32
TB, TS = 4, 16                       # the train batch: rows, tokens
TOL = 1e-5
LIMITS = dict(loss=1e-4, grad_norm=1e-5, first=1e-5)
PROMPTS = ([5, 3, 9, 1, 7], list(range(20, 31)), [2, 4, 6])
NEW_TOKENS = 6
ARCHS = ("mamba2-1.3b", "zamba2-7b")
SPECS = ("smoke", "full")
FORWARD = {2: [(a, (1, 2), w) for a in ARCHS for w in SPECS],
           4: [(a, s, w) for a in ARCHS for w in SPECS
               for s in ((1, 4), (2, 2))]}
# (arch, mesh, specs, microbatches a rank)
TRAIN = {2: [(a, (1, 2), w, 1) for a in ARCHS for w in SPECS]
         + [("zamba2-7b", (1, 2), "full", 2)],
         4: [(a, s, w, 1) for a in ARCHS for w in SPECS
             for s in ((1, 4), (2, 2))]}
# the JAX reference's train runs: (arch, microbatches)
JAX_TRAIN = sorted({(a, micro) for rows in TRAIN.values()
                    for a, _, _, micro in rows})
ENGINE = {2: [(a, (1, 2), w) for a in ARCHS for w in SPECS],
          4: [(a, (1, 4), w) for a in ARCHS for w in SPECS]}
# the gated norm alone: (rows, tokens, d_inner)
NORM_SHAPE = (2, 5, 64)


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


def _jax_train(arch: str, micro: int) -> dict:
    """The JAX reference's train step from the same weights (its
    ``init_state`` at key 0 draws ``_np_params``'s) on the same batches:
    [loss, grad norm] a step and the first update's moments by leaf."""
    cfg_j = j_get_arch(arch).smoke
    state = jloop.init_state(cfg_j, jax.random.key(0))
    step = jax.jit(jloop.make_train_step(
        cfg_j, joptim.OptConfig(lr=5e-3, warmup_steps=1, total_steps=10),
        n_microbatches=micro))
    metrics, first = [], None
    for b in _train_batches(cfg_j.vocab_size):
        state, m = step(state, {k: jnp.asarray(v.numpy())
                                for k, v in b.items()})
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
        if first is None:
            first = {k: np.asarray(v) for k, v in _flat_specs(state.m).items()}
    return {"metrics": metrics, "first": first}


def _jax_tokens(arch: str, params: dict) -> list[list[int]]:
    """The JAX ``ServeEngine``'s greedy tokens for ``PROMPTS``."""
    cfg_j = j_get_arch(arch).smoke
    eng = JServeEngine(cfg_j, jax.tree.map(jnp.asarray, params), max_batch=B,
                       max_len=MAXLEN)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    return [list(map(int, r.tokens)) for r in eng.run_to_completion()]


def _plan(mesh, arch: str, which: str, mode: str):
    """The plan of ``arch`` on ``mesh``: of its SMOKE config, or (``full``)
    of the full config, whose specs the SMOKE model then runs under."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.sharding.planner import plan_for

    spec = get_arch(arch)
    if which == "smoke":
        spec = dataclasses.replace(spec, model=spec.smoke)
    if mode == "train":
        return plan_for(spec, mesh, mode="train",
                        cell=ShapeCell("tp", "train", TS, TB))
    return plan_for(spec, mesh, mode="decode",
                    cell=ShapeCell("tp", "decode", MAXLEN, B),
                    cache_batch=B, cache_len=MAXLEN)


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


def _block(split) -> tuple | None:
    b = split.block
    return None if b is None else (b.heads, b.kv, b.ffn, b.cache)


# ------------------------------------------------------------------- jobs
def _forward_job(rank: int, tmp: str, arch: str, shape, which: str):
    """Forward (logits gathered over model), one decode step against the
    rank's caches, the local shapes; rank 0 also the one-process port."""
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
        logits, caches, _ = model.forward_full(tokens, return_cache=True)
        c = init_cache(cfg, B, MAXLEN, device="cpu", split=sp)
        cache_shapes = {k: tuple(t.shape) for k, t in c.items()}
        for key in c:
            if key in ("k", "v"):
                c[key][:, :, :S] = caches[key]
            else:
                c[key].copy_(caches[key])
        step, _ = model.forward_decode(np.array([3, 4]), c, np.array([S, S]))
        gather = (lambda t: gather_from_model(t, -1, sp)) if (
            sp is not None and sp.vocab_out is not None) else (lambda t: t)
        return gather(logits), gather(step), cache_shapes

    model = params_from_reference(params, cfg, "cpu", split)
    logits, step, cache_shapes = run(model, split)
    axes = {"pod": 1, "data": 1, "model": shape[1]}
    flat = _flat_specs(plan.param_specs)
    shapes = {}
    for path, ts in _leaves(model).items():
        whole = _whole(params, path)
        spec1 = flat[path][1:] if path.startswith("blocks/") else flat[path]
        shapes[path] = (tuple(ts[0].shape), shard_shape(whole, spec1, axes),
                        "model" in str(spec1))
    out = dict(logits=logits, step=step, shapes=shapes,
               cache_shapes=cache_shapes, cache=split.cache, ssm=split.ssm,
               inner=split.inner, block=_block(split),
               partial=sorted(split.partial))
    if rank == 0:
        one = params_from_reference(params, cfg, "cpu")
        out["one_logits"], out["one_step"], _ = run(one, None)
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
               partial=sorted(split.partial), block=_block(split))
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


def _norm_job(rank: int, tmp: str):
    """The gated norm alone over this rank's half of the channels, with
    ``tp.sum_over_model`` and with ``tp.reduce_from_model`` (no all-reduce
    in the backward) in its place: the output and the gradients of the
    input and of ``norm`` against a fixed cotangent; rank 0 also one
    process's."""
    from repro_torch.models import mamba2
    from repro_torch.sharding import tp

    rng = np.random.default_rng(7)
    Bn, Sn, E = NORM_SHAPE
    u, w, g = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((Bn, Sn, E)), 1 + 0.3 * rng.standard_normal(E),
        rng.standard_normal((Bn, Sn, E))))
    split = tp.ModelSplit(2, rank, None, {}, None, None, None, None, None)
    c0, c1 = rank * E // 2, (rank + 1) * E // 2

    def grads(sp, lo, hi):
        ul = u[..., lo:hi].clone().requires_grad_(True)
        wl = w[lo:hi].clone().requires_grad_(True)
        out = mamba2.gated_rms_norm(ul, wl, sp)
        (out * g[..., lo:hi]).sum().backward()
        return out.detach(), ul.grad, wl.grad

    res = {"split": grads(split, c0, c1)}
    real = tp.sum_over_model
    tp.sum_over_model = tp.reduce_from_model
    try:
        res["no_bwd_reduce"] = grads(split, c0, c1)
    finally:
        tp.sum_over_model = real
    if rank == 0:
        res["one"] = grads(None, 0, E)
    torch.save(res, os.path.join(tmp, f"norm_{rank}.pt"))


def _worker(rank: int, world: int, store: str, tmp: str, jobs) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    init_group("cpu", init_method=f"file://{store}", world_size=world,
               rank=rank)
    try:
        for name, *args in jobs:
            {"forward": _forward_job, "engine": _engine_job,
             "train": _train_job, "norm": _norm_job}[name](rank, tmp, *args)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs():
    """Every job, once: {"tmp": the directory of the ranks' results,
    "jax": the reference's logits by arch, "jax_train": its train runs by
    (arch, microbatches), "jax_tokens": its engine's tokens by arch}."""
    with tempfile.TemporaryDirectory(prefix="tp-ssm-") as tmp:
        params = {arch: _np_params(arch) for arch in ARCHS}
        for arch, p in params.items():
            torch.save(p, os.path.join(tmp, f"params_{arch}.pt"))
        jax_logits, jax_tokens, jax_train = {}, {}, {}
        for world in (2, 4):
            jobs = ([("forward", *c) for c in FORWARD[world]]
                    + [("engine", *c) for c in ENGINE[world]]
                    + [("train", *c) for c in TRAIN[world]]
                    + ([("norm",)] if world == 2 else []))
            ranks = mp.spawn(_worker, args=(world, os.path.join(
                tmp, f"store{world}"), tmp, jobs), nprocs=world, join=False)
            if world == 2:          # the JAX reference while the ranks run
                for arch, p in params.items():
                    cfg_j = j_get_arch(arch).smoke
                    logits, _, _ = jt.forward_full(
                        jax.tree.map(jnp.asarray, p), cfg_j,
                        jnp.asarray(_tokens(cfg_j)))
                    jax_logits[arch] = np.asarray(logits)
                    jax_tokens[arch] = _jax_tokens(arch, p)
                jax_train = {c: _jax_train(*c) for c in JAX_TRAIN}
            while not ranks.join():
                pass
        yield {"tmp": tmp, "jax": jax_logits, "jax_train": jax_train,
               "jax_tokens": jax_tokens}


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
    m = shape[1]
    assert one["cache"] == "heads"
    assert one["ssm"] == (0, 8 // m) and one["inner"] == (0, 64 // m)
    assert {"blocks/ssm/w_b", "blocks/ssm/w_dt", "blocks/ssm/A_log",
            "blocks/ssm/norm", "blocks/ssm/conv_c_w"} <= set(one["partial"])
    if arch == "mamba2-1.3b":
        assert one["block"] is None
    else:                   # 4 shared heads, G 1; FFN columns under "full"
        ffn = (0, 64 // m) if which == "full" else None
        assert one["block"] == ((0, 4 // m), (0, 4 // m), ffn, "heads")
        # under the SMOKE plan the block's weights stay whole, read in part
        assert ("shared_attn/attn/wq" in one["partial"]) == (which == "smoke")


@pytest.mark.parametrize("world,arch,shape,which", _cases(FORWARD),
                         ids=lambda v: str(v))
def test_each_rank_holds_its_shards(runs, world, arch, shape, which):
    m = shape[1]
    for r in range(world):
        got = _load(runs, f"fwd_{_label(arch, shape, which)}", r)
        shapes = got["shapes"]
        sharded = {p for p, (_, _, on) in shapes.items() if on}
        ssm = {f"blocks/ssm/{n}" for n in ("w_z", "w_x", "conv_x_w",
                                           "conv_x_b", "out_proj")}
        shared = ({f"shared_attn/attn/{n}" for n in ("wq", "wk", "wv", "wo")}
                  | {f"shared_attn/mlp/{n}" for n in ("w_gate", "w_up",
                                                      "w_down")})
        assert ssm <= sharded, sharded
        assert (shared <= sharded) == (arch == "zamba2-7b" and which == "full")
        for path, (local, want, _) in shapes.items():
            assert local == want, (path, local, want)
        assert shapes["blocks/ssm/w_x"][0] == (32, 64 // m)
        cs = got["cache_shapes"]
        assert cs["h"][2] == 8 // m and cs["conv_x"][3] == 64 // m
        assert cs["conv_b"][3] == 8             # whole on every rank
        if arch == "zamba2-7b":
            assert cs["k"][3] == 4 // m


@pytest.mark.parametrize("world,arch,shape,which,micro", _cases(TRAIN),
                         ids=lambda v: str(v))
def test_train_step_within_limits(runs, world, arch, shape, which, micro):
    name = f"train_{_label(arch, shape, which, micro)}"
    ref = _load(runs, name, 0)
    jref = runs["jax_train"][arch, micro]
    assert (ref["block"] is not None) == (arch == "zamba2-7b"
                                          and which == "full")
    for r in range(world):
        got = _load(runs, name, r)
        for label, want_metrics, want_first in (
                ("one process", ref["ref"], ref["ref_first"]),
                ("JAX", jref["metrics"], jref["first"])):
            for a, b in zip(got["metrics"], want_metrics, strict=True):
                np.testing.assert_allclose(a[0], b[0], rtol=LIMITS["loss"],
                                           err_msg=f"{label} rank {r} loss")
                np.testing.assert_allclose(a[1], b[1],
                                           rtol=LIMITS["grad_norm"],
                                           err_msg=f"{label} rank {r} norm")
            assert set(got["first"]) == set(want_first), label
            for path, want in want_first.items():
                want = torch.as_tensor(np.array(want))
                err = float((got["first"][path] - want).abs().max())
                assert err <= LIMITS["first"] * float(want.abs().max()), (
                    label, r, path, err)
        assert all(a[2] == b[2] for a, b in zip(got["metrics"], ref["ref"]))
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
    assert one == runs["jax_tokens"][arch]
    for r in range(world):
        got = _load(runs, name, r)
        assert got["cache"] == "heads"
        assert got["tokens"] == one, r


def test_gated_norm_needs_the_backward_all_reduce(runs):
    """The gated RMSNorm over two ranks' halves of the channels: output and
    the gradients of its input and of ``norm`` within 1e-5 of one process;
    with ``reduce_from_model`` (identity backward) in place of
    ``sum_over_model`` the forward is the same and the input's gradient is
    off by far more than the limit."""
    ranks = [_load(runs, "norm", r) for r in range(2)]
    one = ranks[0]["one"]
    E = NORM_SHAPE[-1]
    halves = [slice(0, E // 2), slice(E // 2, E)]
    for r, rk in enumerate(ranks):
        want_out, want_du, want_dw = (t[..., halves[r]] for t in one)
        got_out, got_du, got_dw = rk["split"]
        _close(got_out, want_out, f"rank {r} output")
        _close(got_du, want_du, f"rank {r} input gradient")
        _close(got_dw, want_dw, f"rank {r} norm gradient")
        bad_out, bad_du, _ = rk["no_bwd_reduce"]
        _close(bad_out, want_out, f"rank {r} output without the reduce")
        err = float((bad_du - want_du).abs().max())
        assert err > 100 * TOL * float(want_du.abs().max()), (r, err)


class _Mesh:
    """A mesh's axes and this rank's coordinate, no process group."""

    def __init__(self, shape, names=("data", "model")):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def get_coordinate(self):
        return [0] * len(self.shape)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_split_takes_the_ssm_families(arch, m):
    """``plan_split`` and ``Transformer(split=)`` take both families at
    model 2 and 4 under both spec sets, and the full configs on their own
    plans: every rank's SSM heads, channels and the shared block's
    ranges."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.tp import plan_split

    for cfg, sets in ((get_arch(arch).smoke, SPECS),
                      (get_arch(arch).model, ("full",))):
        Hs, E = cfg.ssm_heads, cfg.d_inner
        for which in sets:
            for mode in ("train", "decode"):
                plan = _plan(_Mesh((1, m)), arch, which, mode)
                cache = plan.cache_specs if mode == "decode" else None
                for r in range(m):
                    sp = plan_split(cfg, plan.param_specs, m, r, cache)
                    assert sp.ssm == (r * Hs // m, (r + 1) * Hs // m)
                    assert sp.inner == (r * E // m, (r + 1) * E // m)
                    assert sp.cache == ("heads" if cache else None)
                    model = Transformer(cfg, "meta", sp)
                    assert tuple(model.blocks[0].ssm["w_z"].shape) == (
                        cfg.d_model, E // m)
                    if arch == "zamba2-7b" and (which == "full"
                                                or cache is not None):
                        H = cfg.n_heads
                        assert sp.block.heads == (r * H // m, (r + 1) * H // m)
                        assert sp.block.ffn == (None if which == "smoke" else (
                            r * cfg.d_ff // m, (r + 1) * cfg.d_ff // m))
                    else:
                        assert sp.block is None


def test_plan_split_refuses_what_the_ssm_split_cannot_run():
    """Channels that are not whole SSM heads a rank, ``conv_x`` whole beside
    a split ``w_x``, a state cache off the weights' range, and a shared
    cache over the sequence raise; ``out_proj`` whole beside split heads is
    sliced at use and partial."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.sharding.spec import P
    from repro_torch.sharding.tp import plan_split

    cfg = get_arch("zamba2-7b").smoke      # d_inner 64: 8 heads of 8
    col, row = P(None, None, "model"), P(None, "model", None)
    ssm = {"w_x": col, "w_z": col, "conv_x_w": col,
           "conv_x_b": P(None, "model"), "out_proj": row}
    specs = {"blocks": {"ssm": dict(ssm)}}
    with pytest.raises(NotImplementedError, match="not whole heads"):
        plan_split(cfg, specs, 16, 0)           # 4 channels a rank
    specs = {"blocks": {"ssm": dict(ssm, conv_x_w=P())}}
    with pytest.raises(NotImplementedError, match="conv_x_w whole"):
        plan_split(cfg, specs, 2, 0)
    specs = {"blocks": {"ssm": dict(ssm, out_proj=P())}}
    sp = plan_split(cfg, specs, 2, 1)
    assert sp.ssm == (4, 8) and "blocks/ssm/out_proj" in sp.partial
    specs = {"blocks": {"ssm": dict(ssm)}}
    whole4, whole5 = P(None, None, None, None), P(None, None, None, None, None)
    cache = {"h": P(None, None, "model", None, None),
             "conv_x": P(None, None, None, "model"), "conv_b": whole4,
             "conv_c": whole4, "k": whole5, "v": whole5}
    assert plan_split(cfg, specs, 2, 1, cache).cache == "heads"
    with pytest.raises(NotImplementedError, match="cache h"):
        plan_split(cfg, specs, 2, 1, dict(cache, h=whole5))
    with pytest.raises(NotImplementedError, match="cache conv_b"):
        plan_split(cfg, specs, 2, 1, dict(cache, conv_b=P(None, None, None,
                                                          "model")))
    seq = P(None, None, "model", None, None)
    with pytest.raises(NotImplementedError, match="sequence-split shared"):
        plan_split(cfg, specs, 2, 1, dict(cache, k=seq, v=seq))


def test_dryrun_counts_an_ssm_cell_by_hand():
    """mamba2's and zamba2's SMOKE train cells (S 16, batch 4, one
    microbatch) on (data 2, model 2) under the full configs' specs, and
    zamba2's decode cell, counted term by term."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell
    from repro_torch.sharding.spec import MeshShape

    axes = {"data": 2, "model": 2}
    mesh = MeshShape((2, 2), ("data", "model"))
    # a ring all-reduce over 2 ranks sends 1 x the bytes; T = 2 rows x 16
    # tokens a rank, D 32, float32 activations (4 bytes)
    T, D, a = 32, 32, 4
    embed = T * D * 4                       # the vocab-parallel embedding
    # the head's input gradient, the loss over 2 rows x 15 targets
    head = T * D * a + 3 * (T - 2) * 4
    mamba = T * D * 4 + T * 4               # out_proj's partials, the squares
    mamba_bwd = T * D * a + T * 4           # the input's gradient, the squares'
    for arch, M, G in (("mamba2-1.3b", 2, 0), ("zamba2-7b", 5, 2)):
        spec = get_arch(arch)
        prog = build_cell(spec, ShapeCell("tp", "train", TS, TB), mesh,
                          microbatch_override=1)
        prog.cfg = spec.smoke               # the full plan on SMOKE widths
        shared = 2 * T * 2 * D * 4          # heads and FFN at 2 x d_model
        shared_bwd = 2 * T * 2 * D * a      # the split inputs' gradients
        fwd = M * mamba + G * shared
        bwd = M * mamba_bwd + G * shared_bwd
        # the recompute stops before out_proj's all-reduce, a Mamba2
        # layer's last op
        recompute = fwd - M * T * D * 4
        assert dryrun.split_collective_bytes(prog, axes) == (
            fwd + embed + recompute + bwd + head), arch
    # zamba2 decode (batch 2 on one data rank, one token a row): the
    # forward alone
    spec = get_arch("zamba2-7b")
    prog = build_cell(spec, ShapeCell("tp", "decode", MAXLEN, B), mesh)
    prog.cfg = spec.smoke
    Td = dryrun._rows(prog)
    want = 5 * (Td * D * 4 + Td * 4) + 2 * (2 * Td * 2 * D * 4) + Td * D * 4
    assert dryrun.split_collective_bytes(prog, axes) == want
