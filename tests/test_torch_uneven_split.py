"""Uneven splits over the mesh's ``model`` axis (the planner's
``allow_uneven``: GSPMD's pieces, ``ceil(n / m)`` a rank, the last short,
trailing ranks' empty) for the dense and MoE families, on 3 gloo ranks
(CPU), against the one-process port and the JAX reference.

Ranks are ``torch.multiprocessing`` processes joined through a ``file://``
store under a temporary directory, one thread each; one spawn runs every
job at (data 1, model 3) while this process runs the references.  The
SMOKE configs of qwen2.5-3b and granite-8b (8 query heads, 2 KV heads: 3,
3 and 2 heads a rank, rank 1's heads 3-5 crossing from KV head 0 into 1;
qwen keeps ``wk``/``wv`` whole, granite splits them, so K and V are
gathered), olmoe-1b-7b and deepseek-v2-236b (4 heads: 2, 2 and none; 8
experts: 3, 3, 2; deepseek's shared columns 22, 22, 20), with the port's
weights from seed 0 (the JAX reference runs the same values as its
parameter tree), under two sets of specs: the SMOKE plan's own (``smoke``:
at model 3 only the caches, over the sequence: 11, 11 and 10 of 32
slots) and the full config's plan on the same mesh (``full``), applied at
SMOKE widths (the vocabulary 86, 86, 84, the FFN 43, 43, 42).

Limits (float32; a sum split over ranks only reorders adds): logits and a
decode step within 1e-5 of the largest logit of the one-process forward
and of the JAX reference's; the first update's moments within 1e-5 of
each leaf's largest magnitude, grad norms rtol 1e-5, losses rtol 1e-4;
served greedy tokens equal to the one-process engine's and the JAX
engine's; a 3-rank checkpoint restored in one process bitwise.  A planted
fault, the attention's head offset dropped (local head h reading KV head
h // G), must fail the logits' limit; another, K and V's gradient not
summed over model, the first moments'.  The kernels with an offset are held
against their plain versions on the card in ``tests/test_torch_kernel_cuda.py``
(``-m cuda``; that file imports no JAX).
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
from repro.kernels import ref as jref
from repro.models import attention as jatt
from repro.models import transformer as jt
from repro.serve.engine import ServeEngine as JServeEngine

M = 3
B, S, MAXLEN = 2, 12, 32
TB, TS = 2, 16                       # the train batch: rows, tokens
TOL = 1e-5
LIMITS = dict(loss=1e-4, grad_norm=1e-5, first=1e-5)
PROMPTS = ([5, 3, 9, 1, 7], list(range(20, 31)), [2, 4, 6])
NEW_TOKENS = 6
ARCHS = ("qwen2.5-3b", "granite-8b", "olmoe-1b-7b", "deepseek-v2-236b")
SPECS = ("smoke", "full")
CASES = [(a, w) for a in ARCHS for w in SPECS]
CKPT_ARCH, FAULT_ARCH = "granite-8b", "qwen2.5-3b"
# under the full config's specs its K and V are gathered over model (wk's
# 2 KV heads in pieces 1, 1, 0 against the heads' reads [0, 1), [0, 2),
# [1, 2))
TRAIN_FAULT_ARCH = "granite-8b"
# the full configs of the dense and MoE families, and the model axes that
# do not divide their heads, KV heads, FFN, experts or vocabulary
DENSE_MOE = ("qwen2.5-3b", "granite-8b", "command-r-35b", "codeqwen1.5-7b",
             "musicgen-medium", "internvl2-26b", "olmoe-1b-7b",
             "deepseek-v2-236b")
UNEVEN_AXES = (3, 5, 6, 7)
# plain attention with an offset: (H, KV, dh) split over m ranks
HEADS = ((8, 2, 16), (32, 8, 16), (16, 2, 8), (12, 12, 8))


def _label(*args) -> str:
    return "-".join(str(a).replace(" ", "") for a in args)


def _np_params(arch: str) -> dict:
    """The port's SMOKE weights from seed 0 as the JAX package's parameter
    tree (numpy; ``blocks/...`` stacked over the layers)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.train.train_loop import _master_tree

    tree = _master_tree(init_params(get_arch(arch).smoke, 0, "cpu"))
    return jax.tree.map(lambda t: t.numpy(), tree)


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
    """The uneven plan (``allow_uneven``) of ``arch`` on ``mesh``: of its
    SMOKE config, or (``full``) of the full config, whose specs the SMOKE
    model then runs under."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.sharding.planner import plan_for

    spec = get_arch(arch)
    if which != "full":
        spec = dataclasses.replace(spec, model=spec.smoke)
    if mode == "train":
        return plan_for(spec, mesh, mode="train", allow_uneven=True,
                        cell=ShapeCell("uneven", "train", TS, TB))
    return plan_for(spec, mesh, mode="decode", allow_uneven=True,
                    cell=ShapeCell("uneven", "decode", MAXLEN, B),
                    cache_batch=B, cache_len=MAXLEN)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _forward(model, cfg, split):
    """Logits (gathered over ``model``) of :func:`_tokens`, and of one
    decode step against the rank's caches (filled from the forward's)."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.sharding.tp import gather_from_model

    tokens = _tokens(cfg)
    logits, caches, _ = model.forward_full(tokens, return_cache=True)
    c = init_cache(cfg, B, MAXLEN, device="cpu", split=split)
    for key in c:
        if split is not None and split.cache == "seq":
            Sl = c[key].shape[2]
            c0 = split.r * Sl
            n = max(0, min(S - c0, Sl))
            c[key][:, :, :n] = caches[key][:, :, c0:c0 + n]
        else:
            c[key][:, :, :S] = caches[key]
    step, _ = model.forward_decode(np.array([3, 4]), c, np.array([S, S]))
    if split is None or split.vocab_out is None:
        return logits, step
    return (gather_from_model(logits, -1, split, of="vocab_out"),
            gather_from_model(step, -1, split, of="vocab_out"))


def _serve(cfg, model, **kw) -> list[list[int]]:
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, model, max_batch=B, max_len=MAXLEN, device="cpu",
                      **kw)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    return [r.tokens for r in eng.run_to_completion()]


def _dropped_offset(real):
    """The planted fault: the plain attention with the heads' offset
    dropped, so local head h reads KV head h // G."""
    def fn(q, k, v, *, group=None, head_offset=0, **kw):
        if group is None:
            return real(q, k, v, **kw)
        kv = -(-q.shape[2] // group)
        return real(q, k[:, :, :kv], v[:, :, :kv], group=group, **kw)
    return fn


# ------------------------------------------------------------------- jobs
def _forward_job(rank: int, tmp: str, arch: str, which: str,
                 fault: bool = False):
    """Logits and a decode step gathered over model, each leaf's local
    shape against the plan's shard shape, the split's ranges."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import _leaves, params_from_reference
    from repro_torch.sharding.placement import local_slices
    from repro_torch.sharding.spec import shard_shape
    from repro_torch.sharding.tp import model_split

    mesh = make_mesh((1, M), ("data", "model"), "cpu")
    cfg = get_arch(arch).smoke
    plan = _plan(mesh, arch, which, "decode")
    split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
    params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                        weights_only=False)
    model = params_from_reference(params, cfg, "cpu", split)
    real = fa.flash_attention_ref
    if fault:
        fa.flash_attention_ref = _dropped_offset(real)
    try:
        logits, step = _forward(model, cfg, split)
    finally:
        fa.flash_attention_ref = real
    axes = {"pod": 1, "data": 1, "model": M}
    flat = _flat(plan.param_specs)
    shapes = {}
    for path, ts in _leaves(model).items():
        whole = tuple(np.shape(_flat(params)[path]))
        spec = flat[path]
        if path.startswith("blocks/"):
            whole, spec = whole[1:], tuple(spec)[1:]
        piece = local_slices(whole, spec, axes, {"pod": 0, "data": 0,
                                                 "model": rank})
        shapes[path] = (tuple(ts[0].shape), shard_shape(whole, spec, axes),
                        tuple(sl.stop - sl.start for sl in piece))
    out = dict(logits=logits, step=step, shapes=shapes, layout=None)
    if split is not None:
        out["layout"] = {k: getattr(split, k) for k in (
            "heads", "kv", "ffn", "vocab_out", "experts", "shared", "cache",
            "kv_gather")}
        out["layout"]["offset"] = split.head_offset()
    name = "fault" if fault else "fwd"
    torch.save(out, os.path.join(tmp, f"{name}_{_label(arch, which)}_{rank}.pt"))


def _engine_job(rank: int, tmp: str, arch: str, which: str):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import params_from_reference
    from repro_torch.sharding.tp import model_split

    mesh = make_mesh((1, M), ("data", "model"), "cpu")
    cfg = get_arch(arch).smoke
    plan = _plan(mesh, arch, which, "decode")
    split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
    params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                        weights_only=False)
    toks = _serve(cfg, params_from_reference(params, cfg, "cpu", split),
                  mesh=mesh, plan=plan)
    torch.save(toks, os.path.join(tmp, f"eng_{_label(arch, which)}_{rank}.pt"))


def _unsummed_kv(real):
    """The planted training fault: K and V gathered over model with their
    gradient not summed over the ranks first, so a KV head that two ranks'
    query heads read keeps one rank's share of its gradient."""
    def fn(x, dim, split, grad_sum=False, of=None):
        return real(x, dim, split, grad_sum=grad_sum and of != "kv", of=of)
    return fn


def _train_job(rank: int, tmp: str, arch: str, fault: bool = False):
    """Two steps of the mesh's train step under the full config's specs;
    the first moments gathered whole; for ``CKPT_ARCH`` a checkpoint of
    the state after them and the state gathered.  ``fault``: the steps
    under :func:`_unsummed_kv`, no checkpoint."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention
    from repro_torch.models.transformer import _flatten
    from repro_torch.sharding.placement import local_rows
    from repro_torch.sharding.tp import model_split
    from repro_torch.train import checkpoint
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    mesh = make_mesh((1, M), ("data", "model"), "cpu")
    cfg = get_arch(arch).smoke
    params = torch.load(os.path.join(tmp, f"params_{arch}.pt"),
                        weights_only=False)
    plan = _plan(mesh, arch, "full", "train")
    split = model_split(cfg, plan.param_specs, mesh)
    model, state = tloop.init_state(cfg, 0, device="cpu", params=params,
                                    split=split)
    step = tloop.make_train_step(model, OptConfig(lr=5e-3, warmup_steps=1,
                                                  total_steps=10),
                                 n_microbatches=1, mesh=mesh,
                                 grad_specs=plan.param_specs)
    state = tloop.shard_state(state, tloop.state_specs(plan), mesh)
    metrics, first = [], None
    real = attention.gather_from_model
    if fault:
        attention.gather_from_model = _unsummed_kv(real)
    try:
        for b in _train_batches(cfg.vocab_size):
            state, m = step(state, local_rows(b, plan.batch_spec(TB), mesh))
            metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
            if first is None:
                first = {k: x.clone() for k, x in
                         _flatten(tloop.gather_state(state).m).items()}
    finally:
        attention.gather_from_model = real
    out = dict(metrics=metrics, first=first)
    if fault:
        torch.save(out, os.path.join(tmp, f"train_fault_{arch}_{rank}.pt"))
        return
    if arch == CKPT_ARCH:
        tree = {"params": state.params, "m": state.m, "v": state.v}
        checkpoint.save(os.path.join(tmp, "ckpt"), 2, tree)
        whole = tloop.gather_state(state)
        out["state"] = {part: _flatten(getattr(whole, part))
                        for part in ("params", "m", "v")}
    torch.save(out, os.path.join(tmp, f"train_{arch}_{rank}.pt"))


def _gather_job(rank: int, tmp: str):
    """The padded gather over model against ``torch.chunk``: every rank's
    piece of dims of 1 to 8 over 3 ranks (short and empty pieces), forward
    and backward (with and without the gradient summed first)."""
    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.sharding.tp import ModelSplit, gather_from_model, local_range

    out = []
    for n in (1, 2, 4, 7, 8):
        x = torch.arange(n * 5, dtype=torch.float32).reshape(5, n)
        pieces = torch.chunk(x, M, dim=1)
        a, b = local_range(n, ("model",), M, rank)
        mine = pieces[rank] if rank < len(pieces) else x[:, n:]
        sp = ModelSplit(m=M, r=rank, group=None, specs={}, heads=None,
                        kv=None, ffn=None, vocab_in=None, vocab_out=None,
                        sizes={"heads": n})
        for grad_sum in (False, True):
            piece = x[:, a:b].clone().requires_grad_(True)
            whole = gather_from_model(piece, 1, sp, grad_sum=grad_sum,
                                      of="heads")
            w = torch.arange(whole.numel(), dtype=torch.float32).reshape(
                whole.shape) * (rank + 1)
            (whole * w).sum().backward()
            out.append(dict(n=n, grad_sum=grad_sum, same_piece=torch.equal(
                x[:, a:b], mine), whole=whole.detach(), grad=piece.grad,
                w=w, range=(a, b)))
    # the vocab-parallel loss over 4 columns (3 of them real) in pieces of
    # 2, 2 and none, targets on every piece, and its gradient
    logits = torch.randn((2, 5, 4), generator=torch.Generator().manual_seed(7))
    targets = torch.tensor([[0, 1, 2, 2, 1], [2, 0, 0, 1, 2]])
    a, b = local_range(4, ("model",), M, rank)
    sp = ModelSplit(m=M, r=rank, group=None, specs={}, heads=None, kv=None,
                    ffn=None, vocab_in=None, vocab_out=(a, b),
                    sizes={"vocab_out": 4})
    piece = logits[..., a:b].clone().requires_grad_(True)
    loss = cross_entropy_loss(piece, targets, vocab_size=3, split=sp)
    loss.backward()
    torch.save(dict(gathers=out, loss=loss.detach(), grad=piece.grad,
                    range=(a, b)), os.path.join(tmp, f"gather_{rank}.pt"))


def _worker(rank: int, world: int, store: str, tmp: str, jobs) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    init_group("cpu", init_method=f"file://{store}", world_size=world,
               rank=rank)
    try:
        for name, *args in jobs:
            {"forward": _forward_job, "engine": _engine_job,
             "train": _train_job, "gather": _gather_job}[name](rank, tmp, *args)
    finally:
        dist.destroy_process_group()


def _references(tmp: str, params: dict) -> dict:
    """This process's references while the ranks run: the JAX forward's
    logits and the JAX engine's tokens, and the one-process port's logits,
    decode step, tokens and train steps."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import _flatten, params_from_reference
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    out: dict = {"jax": {}, "jax_tokens": {}, "one": {}, "one_tokens": {},
                 "train": {}}
    for arch in ARCHS:
        cfg_j, cfg = j_get_arch(arch).smoke, get_arch(arch).smoke
        jp = jax.tree.map(jnp.asarray, params[arch])
        logits, _, _ = jt.forward_full(jp, cfg_j, jnp.asarray(_tokens(cfg_j)))
        out["jax"][arch] = np.asarray(logits)
        eng = JServeEngine(cfg_j, jp, max_batch=B, max_len=MAXLEN)
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=NEW_TOKENS)
        out["jax_tokens"][arch] = [list(map(int, r.tokens))
                                   for r in eng.run_to_completion()]
        model = params_from_reference(params[arch], cfg, "cpu")
        out["one"][arch] = _forward(model, cfg, None)
        out["one_tokens"][arch] = _serve(cfg, model)
        model, st = tloop.init_state(cfg, 0, device="cpu", params=params[arch])
        step = tloop.make_train_step(model, OptConfig(
            lr=5e-3, warmup_steps=1, total_steps=10), n_microbatches=1)
        steps, first = [], None
        for b in _train_batches(cfg.vocab_size):
            st, m = step(st, b)
            steps.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
            if first is None:
                first = {k: x.clone() for k, x in _flatten(st.m).items()}
        out["train"][arch] = dict(metrics=steps, first=first)
    return out


@pytest.fixture(scope="module")
def runs():
    """Every job, once: {"tmp": the ranks' results, and the references of
    :func:`_references`}."""
    with tempfile.TemporaryDirectory(prefix="uneven-") as tmp:
        params = {arch: _np_params(arch) for arch in ARCHS}
        for arch, p in params.items():
            torch.save(p, os.path.join(tmp, f"params_{arch}.pt"))
        jobs = ([("forward", a, w) for a, w in CASES]
                + [("forward", FAULT_ARCH, "full", True)]
                + [("engine", a, w) for a, w in CASES]
                + [("train", a) for a in ARCHS]
                + [("train", TRAIN_FAULT_ARCH, True), ("gather",)])
        ranks = mp.spawn(_worker, args=(M, os.path.join(tmp, "store"), tmp,
                                        jobs), nprocs=M, join=False)
        torch.set_num_threads(2)
        refs = _references(tmp, params)
        while not ranks.join():
            pass
        yield dict(tmp=tmp, params=params, **refs)


def _load(runs, name: str, rank: int):
    return torch.load(os.path.join(runs["tmp"], f"{name}_{rank}.pt"),
                      weights_only=False)


def _err(got: torch.Tensor, want) -> float:
    """The largest error relative to ``want``'s largest magnitude."""
    want = torch.as_tensor(np.array(want))
    return float((got - want).abs().max()) / float(want.abs().max())


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("arch,which", CASES, ids=lambda v: str(v))
def test_forward_and_decode_match_one_process_and_reference(runs, arch,
                                                            which):
    one_logits, one_step = runs["one"][arch]
    assert _err(one_logits, runs["jax"][arch]) <= TOL
    for r in range(M):
        got = _load(runs, f"fwd_{_label(arch, which)}", r)
        assert _err(got["logits"], one_logits) <= TOL, r
        assert _err(got["logits"], runs["jax"][arch]) <= TOL, r
        assert _err(got["step"], one_step) <= TOL, r


@pytest.mark.parametrize("arch,which", CASES, ids=lambda v: str(v))
def test_each_rank_holds_its_gspmd_pieces(runs, arch, which):
    """Every leaf as the rank's GSPMD piece: the reference plan's shard
    shape (``ceil(n / m)``) on rank 0, the short or empty rest on the
    last; and the layouts the module docstring states."""
    lay = [_load(runs, f"fwd_{_label(arch, which)}", r)["layout"]
           for r in range(M)]
    for r in range(M):
        for path, (local, want, piece) in _load(
                runs, f"fwd_{_label(arch, which)}", r)["shapes"].items():
            assert local == piece, (r, path, local, piece)
            assert r > 0 or local == want, (path, local, want)
    assert all(x["cache"] == "seq" for x in lay)
    if which == "smoke":
        assert all(x["heads"] is None for x in lay)
        return
    assert [x["vocab_out"] for x in lay] == [(0, 86), (86, 172), (172, 256)]
    if arch in ("qwen2.5-3b", "granite-8b"):
        assert [x["heads"] for x in lay] == [(0, 3), (3, 6), (6, 8)]
        assert [x["kv"] for x in lay] == [(0, 1), (0, 2), (1, 2)]
        assert [x["offset"] for x in lay] == [0, 3, 2]
        assert [x["ffn"] for x in lay] == [(0, 43), (43, 86), (86, 128)]
        assert all(x["kv_gather"] == (arch == "granite-8b") for x in lay)
    else:
        assert [x["heads"] for x in lay] == [(0, 2), (2, 4), (4, 4)]
        assert [x["experts"] for x in lay] == [(0, 3), (3, 6), (6, 8)]
        want = ([(0, 22), (22, 44), (44, 64)] if arch == "deepseek-v2-236b"
                else [None] * M)
        assert [x["shared"] for x in lay] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_within_limits(runs, arch):
    ref = runs["train"][arch]
    for r in range(M):
        got = _load(runs, f"train_{arch}", r)
        for a, b in zip(got["metrics"], ref["metrics"], strict=True):
            np.testing.assert_allclose(a[0], b[0], rtol=LIMITS["loss"])
            np.testing.assert_allclose(a[1], b[1], rtol=LIMITS["grad_norm"])
            assert a[2] == b[2]
        for path, want in ref["first"].items():
            assert _err(got["first"][path], want) <= LIMITS["first"], (r, path)


@pytest.mark.parametrize("arch,which", CASES, ids=lambda v: str(v))
def test_engine_serves_one_process_and_jax_tokens(runs, arch, which):
    one = runs["one_tokens"][arch]
    assert len(one) == len(PROMPTS) and all(len(t) == NEW_TOKENS for t in one)
    assert one == runs["jax_tokens"][arch]
    for r in range(M):
        assert _load(runs, f"eng_{_label(arch, which)}", r) == one, r


def test_three_rank_checkpoint_resumes_in_one_process_bitwise(runs):
    """granite-8b's state after two steps on 3 ranks (heads, KV heads,
    FFN and vocabulary in uneven pieces), written by the ranks and read
    back into one process's state: every leaf bitwise the ranks' gathered
    state."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import _flatten
    from repro_torch.train import checkpoint
    from repro_torch.train import train_loop as tloop

    cfg = get_arch(CKPT_ARCH).smoke
    _, st = tloop.init_state(cfg, 0, device="cpu")
    target = {"params": st.params, "m": st.m, "v": st.v}
    tree, _ = checkpoint.restore(os.path.join(runs["tmp"], "ckpt"), target)
    want = _load(runs, f"train_{CKPT_ARCH}", 0)["state"]
    for part in ("params", "m", "v"):
        got = _flatten(tree[part])
        assert set(got) == set(want[part])
        for path, x in want[part].items():
            assert torch.equal(got[path], x), (part, path)


def test_padded_gather_matches_chunk(runs):
    """Each rank's piece is ``torch.chunk``'s (empty past its chunks); the
    gather gives the whole dim on every rank; its backward gives the rank
    its own range of the gradient, or of the gradient summed over ranks
    with ``grad_sum``."""
    ranks = [_load(runs, "gather", r)["gathers"] for r in range(M)]
    for i, case in enumerate(ranks[0]):
        n = case["n"]
        x = torch.arange(n * 5, dtype=torch.float32).reshape(5, n)
        total = sum(rk[i]["w"] for rk in ranks)
        for r, rk in enumerate(ranks):
            c = rk[i]
            assert c["same_piece"], (n, r)
            assert torch.equal(c["whole"], x), (n, r)
            a, b = c["range"]
            want = (total if c["grad_sum"] else c["w"])[:, a:b]
            assert torch.equal(c["grad"], want), (n, r, c["grad_sum"])


def test_vocab_parallel_loss_on_an_empty_piece(runs):
    """The loss over vocabulary pieces of 2, 2 and none (4 padded columns,
    3 real): every rank the one-process loss, finite, and each rank's
    gradient its columns of the one-process gradient (none on the empty
    piece)."""
    from repro_torch.models.layers import cross_entropy_loss

    logits = torch.randn((2, 5, 4), generator=torch.Generator().manual_seed(7))
    targets = torch.tensor([[0, 1, 2, 2, 1], [2, 0, 0, 1, 2]])
    whole = logits.clone().requires_grad_(True)
    want = cross_entropy_loss(whole, targets, vocab_size=3)
    want.backward()
    for r in range(M):
        got = _load(runs, "gather", r)
        a, b = got["range"]
        assert torch.isfinite(got["loss"]) and b - a == (0 if r == M - 1 else 2)
        torch.testing.assert_close(got["loss"], want.detach(), rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(got["grad"], whole.grad[..., a:b],
                                   rtol=1e-6, atol=1e-7)


def test_planted_offset_fault_fails_the_limits(runs):
    """With the heads' offset dropped (local head h reading KV head h //
    G) the split forward misses the one-process logits by far more than
    the limit on the ranks whose heads do not start a group; the sound run
    holds it."""
    one_logits, _ = runs["one"][FAULT_ARCH]
    errs = [_err(_load(runs, f"fault_{_label(FAULT_ARCH, 'full')}", r)
                 ["logits"], one_logits) for r in range(M)]
    assert min(errs) > 100 * TOL, errs


def test_planted_kv_sum_fault_fails_the_first_moments(runs):
    """With K and V's gradient not summed over model (each KV head keeps
    the share of the ranks' query heads on the rank that holds it) the
    forward is the sound one (the first loss within its limit), and the
    first moments of wk and wv (and of what lies before them, through
    the input's gradient) miss the one-process step's by far more than
    their limit."""
    ref = runs["train"][TRAIN_FAULT_ARCH]
    errs = {}
    for r in range(M):
        got = _load(runs, f"train_fault_{TRAIN_FAULT_ARCH}", r)
        np.testing.assert_allclose(got["metrics"][0][0], ref["metrics"][0][0],
                                   rtol=LIMITS["loss"])
        for path, want in ref["first"].items():
            errs[path] = max(errs.get(path, 0.0),
                             _err(got["first"][path], want))
    off = {p for p, e in errs.items() if e > 100 * LIMITS["first"]}
    assert {"blocks/attn/wk", "blocks/attn/wv"} <= off, errs


def _slices(H: int, KV: int, m: int):
    """Each rank's (query heads, KV heads they read, offset) over m."""
    from repro_torch.sharding.tp import local_range

    G = H // KV
    for r in range(m):
        h0, h1 = local_range(H, ("model",), m, r)
        kv = (h0 // G, (h1 - 1) // G + 1) if h1 > h0 else (h0 // G,) * 2
        yield (h0, h1), kv, h0 - kv[0] * G


@pytest.mark.parametrize("H,KV,dh", HEADS)
@pytest.mark.parametrize("m", UNEVEN_AXES)
def test_plain_attention_with_offset_matches_reference(H, KV, dh, m):
    """Each rank's query heads against the KV heads they read, with their
    offset: the flash plain version and its gradient against
    ``repro.models.attention.plain_attention`` sliced to the heads (dk and
    dv summed over the ranks), the decode plain version against
    ``repro.kernels.ref.decode_attention_ref``'s, within 1e-5; with the
    offset dropped a rank whose heads cross from one KV group into the
    next misses."""
    from repro_torch.kernels.ref import (decode_attention_ref,
                                         flash_attention_bwd_ref,
                                         flash_attention_ref)

    rng = np.random.default_rng(H * 100 + m)
    Bq, Sq = 2, 9
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (Bq, Sq, H, dh), (Bq, Sq, KV, dh), (Bq, Sq, KV, dh), (Bq, Sq, H, dh)))
    out_j, vjp = jax.vjp(lambda a, b, c: jatt.plain_attention(a, b, c),
                         *(jnp.asarray(t) for t in (q, k, v)))
    dq_j, dk_j, dv_j = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    qd, kd = q[:, -1], k                      # decode: the last token's query
    lens = np.array([Sq, 4], np.int32)
    dec_j = np.asarray(jref.decode_attention_ref(*(jnp.asarray(t) for t in (
        qd, kd, v, lens))))
    G = H // KV
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    faults = 0
    for (h0, h1), (k0, k1), off in _slices(H, KV, m):
        t = lambda a, lo, hi: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
            a[:, :, lo:hi]))
        qs, ks, vs, gs = t(q, h0, h1), t(k, k0, k1), t(v, k0, k1), t(g, h0, h1)
        kw = dict(group=G, head_offset=off)
        out = flash_attention_ref(qs, ks, vs, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j)[:, :, h0:h1],
                                   rtol=TOL, atol=TOL)
        dq_, dk_, dv_, _ = flash_attention_bwd_ref(qs, ks, vs, gs, **kw)
        np.testing.assert_allclose(dq_.numpy(), dq_j[:, :, h0:h1], rtol=TOL,
                                   atol=TOL)
        dk[:, :, k0:k1] += dk_.numpy()
        dv[:, :, k0:k1] += dv_.numpy()
        dec = decode_attention_ref(torch.from_numpy(qd[:, h0:h1].copy()), ks,
                                   vs, torch.from_numpy(lens), **kw)
        np.testing.assert_allclose(dec.numpy(), dec_j[:, h0:h1], rtol=TOL,
                                   atol=TOL)
        if off:
            bad = _dropped_offset(flash_attention_ref)(qs, ks, vs, **kw)
            faults += float(np.abs(bad.numpy() - np.asarray(out_j)[:, :, h0:h1]
                                   ).max()) > 1e3 * TOL
    np.testing.assert_allclose(dk, dk_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dv, dv_j, rtol=TOL, atol=TOL)
    assert faults == sum(off > 0 and off + h1 - h0 > G
                         for (h0, h1), _, off in _slices(H, KV, m))


class _Mesh:
    def __init__(self, shape, names=("data", "model")):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def get_coordinate(self):
        return [0] * len(self.shape)


@pytest.mark.parametrize("m", UNEVEN_AXES)
def test_plan_split_runs_every_uneven_dense_and_moe_plan(m):
    """Every plan ``plan_for(..., allow_uneven=True)`` makes for the full
    configs of the dense and MoE archs at model m (train and decode) is a
    split every rank runs (the first and the last rank's models built on
    meta); the ssm and hybrid families refuse uneven pieces, citing the
    ROADMAP item that ports them."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.planner import plan_for
    from repro_torch.sharding.tp import plan_split

    mesh = _Mesh((1, m))
    for arch in DENSE_MOE + ("mamba2-1.3b", "zamba2-7b"):
        spec = get_arch(arch)
        for mode in ("train", "decode"):
            kw = (dict(cache_batch=8, cache_len=4096) if mode == "decode"
                  else {})
            plan = plan_for(spec, mesh, mode=mode, allow_uneven=True,
                            cell=ShapeCell("u", mode, 4096, 8), **kw)
            if arch not in DENSE_MOE:
                with pytest.raises(NotImplementedError,
                                   match="Queue A item 12"):
                    plan_split(spec.model, plan.param_specs, m, 0,
                               plan.cache_specs)
                continue
            for r in range(m):
                sp = plan_split(spec.model, plan.param_specs, m, r,
                                plan.cache_specs)
                if r in (0, m - 1):
                    Transformer(spec.model, "meta", sp)


def test_dryrun_counts_musicgen_uneven_cells():
    """musicgen-medium's 24 heads over 16: its 6 cells (3 shapes x 2
    production meshes) counted, rank 0 named as the rank counted, no other
    rank doing more (its heads are whole KV heads); rank 15 (no heads)
    counts less; the closed forms refuse to count the cells' collectives.
    Where a rank's heads cross KV groups (granite-8b at model 3) the
    record names the rank that reads more KV heads than rank 0; where that
    happens on a production mesh (musicgen-medium's 24 heads on 8 KV heads,
    G 3, over 16: rank 1's heads [2, 4) read 2 KV heads, rank 0's 1) the
    cell is that rank's count, the step's longest roofline."""
    from repro_torch.configs.registry import SHAPES, ShapeCell, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION_SHAPES
    from repro_torch.launch.steps import build_cell
    from repro_torch.sharding.spec import MeshShape

    for multi in (False, True):
        for shape in SHAPES:
            rec = dryrun.run_cell("musicgen-medium", shape, multi_pod=multi,
                                  allow_uneven=True, count=True)
            if rec["status"] == "skipped":
                assert shape == "long_500k"
                continue
            assert rec["status"] == "ok", rec.get("error")
            assert rec["counted_rank"]["rank"] == 0 and rec["flops"] > 0
            assert rec["counted_rank"]["others_do_no_more"]     # G 1
            closed = dryrun.run_cell("musicgen-medium", shape,
                                     multi_pod=multi, allow_uneven=True)
            assert closed["roofline"]["collective_s"] is None
            assert "uneven pieces" in closed["roofline"]["sources"][
                "collective_bytes"]
    spec, cell = get_arch("musicgen-medium"), SHAPES["decode_32k"]
    shape, names = PRODUCTION_SHAPES[False]
    counts = [dryrun.count_cell(spec, cell, shape, names, rank=r,
                                allow_uneven=True)[1] for r in (0, 15)]
    # rank 15 holds no heads, but on a cache over the sequence every rank
    # attends every head against its piece
    assert counts[1].flops < counts[0].flops
    assert counts[1].kernels == counts[0].kernels
    prog = build_cell(get_arch("granite-8b"), ShapeCell("u", "train", 4096, 8),
                      MeshShape((1, M), ("data", "model")), allow_uneven=True)
    rec = dryrun.counted_rank(prog, {"data": 1, "model": M})
    assert not rec["others_do_no_more"]
    assert rec["more"] == ["rank 1's kv 4 against rank 0's 3"]
    assert rec["ranks"] == [0, 1]
    over = {"n_kv_heads": 8}
    rec = dryrun.run_cell("musicgen-medium", "prefill_32k", multi_pod=False,
                          allow_uneven=True, count=True, cfg_overrides=over)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["counted_rank"]["ranks"] == [0, 1]
    assert rec["counted_rank"]["rank"] == 1
    steps = rec["counted_rank"]["steps_s"]
    assert rec["roofline"]["ideal_step_s"] == steps[1] > steps[0]
    one = dryrun.count_cell(spec, SHAPES["prefill_32k"], shape, names, rank=1,
                            allow_uneven=True, cfg_overrides=over)[1]
    assert (rec["flops"], rec["bytes"]) == (one.flops, one.bytes)
