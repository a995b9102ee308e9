"""Sliding-window decode on a full-length cache, against the JAX package's,
on the CPU.

The reference's ``gqa_decode`` with ``window`` W on a full-length cache
masks the keys at or below ``pos − W`` (``repro/models/attention.py``); a
dense or MoE config with ``attn_window`` decodes so in every layer.  The
port attends keys ``[max(0, pos + 1 − W), pos + 1)``: each row's start is
made on the card from ``pos`` and handed to the decode kernel
(``cache_start``; on CPU tensors its plain version).  Held here, with
inputs from numpy seeds and the port's seed-0 weights handed to JAX as its
tree (no JAX ``init_params`` compile):

* ``gqa_decode(window=8)`` against JAX's, at positions below, at and above
  W (float32 ``rtol = atol = 1e-5``: the same fp32 terms summed in another
  order), and the written caches (RoPE's fp32 rounding apart);
* the SMOKE qwen2.5-3b and olmoe-1b-7b with ``attn_window = 8``: the port's
  ``ServeEngine`` gives the JAX engine's greedy tokens (prompts longer than
  W, so prefill and decode both cut windows);
* gloo ranks (one spawn of 4, one thread each) serving qwen2.5-3b's SMOKE
  with the window at (data 1, model 4), where the plan puts the cache over
  the sequence (each rank's starts local, ``clamp(start − r·Sl, 0, Sl)``,
  a piece wholly below its start merged as lse −inf), and at (data 2,
  model 2), each data rank on its own rows' starts: tokens equal and every
  decode step's logits within 1e-5 of the largest against one process.
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
from repro.models import attention as jatt
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.registry import get_arch
from repro_torch.models import attention as tatt
from repro_torch.models.transformer import init_params, params_from_reference
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.train_loop import _master_tree

W = 8
TOL = dict(rtol=1e-5, atol=1e-5)
MAXLEN, NEW_TOKENS, BATCH = 32, 6, 4
PROMPTS = ([5, 3, 9, 1, 7], list(range(20, 31)), [2, 4, 6, 8, 10, 12, 14, 16, 18],
           list(range(40, 53)))
SHAPES = ((1, 4), (2, 2))


def _cfg(arch: str):
    return dataclasses.replace(get_arch(arch).smoke, attn_window=W)


def _jcfg(arch: str):
    return dataclasses.replace(j_get_arch(arch).smoke, attn_window=W)


# ---------------------------------------------------------------- the layer
@pytest.mark.parametrize("pos", [[0, 3, 6], [7, 8, 8], [9, 17, 23]],
                         ids=["below", "at", "above"])
def test_gqa_decode_window_matches_reference(pos):
    B, S, D, H, KV, dh = 3, 24, 32, 4, 2, 8
    rng = np.random.default_rng(sum(pos))
    p = {"wq": (D, H, dh), "wk": (D, KV, dh), "wv": (D, KV, dh),
         "wo": (H, dh, D)}
    p = {n: (rng.standard_normal(s) * D ** -0.5).astype(np.float32)
         for n, s in p.items()}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, KV, dh)).astype(np.float32)
              for _ in range(2))
    ang = np.asarray(pos, np.float32)[:, None] * (
        1e4 ** -(np.arange(dh // 2, dtype=np.float32) / (dh // 2)))[None]
    cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]
    pj = np.asarray(pos, np.int32)
    yj, (kj, vj) = jatt.gqa_decode({n: jnp.asarray(a) for n, a in p.items()},
                                   jnp.asarray(x), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pj),
                                   jnp.asarray(cos), jnp.asarray(sin),
                                   window=W)
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    yt, _ = tatt.gqa_decode({n: torch.from_numpy(a) for n, a in p.items()},
                            torch.from_numpy(x), kt, vt, torch.from_numpy(pj),
                            torch.from_numpy(cos), torch.from_numpy(sin),
                            window=W)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
    # the window matters at these positions: the whole cache differs
    full, _ = tatt.gqa_decode({n: torch.from_numpy(a) for n, a in p.items()},
                              torch.from_numpy(x), kt.clone(), vt.clone(),
                              torch.from_numpy(pj), torch.from_numpy(cos),
                              torch.from_numpy(sin))
    assert (max(pos) >= W) == (not torch.allclose(full, yt, **TOL))


# --------------------------------------------------------------- the engine
def _np_params(cfg) -> dict:
    """The port's seed-0 weights as the JAX package's tree (numpy)."""
    return jax.tree.map(lambda t: t.numpy(),
                        _master_tree(init_params(cfg, 0, "cpu")))


def _serve(cfg, model, **kw):
    """The engine's tokens and each decode step's logits (all rows)."""
    eng = ServeEngine(cfg, model, max_batch=BATCH, max_len=MAXLEN,
                      device="cpu", **kw)
    steps = []
    sample = eng._sample

    def spy(logits):
        if logits.shape[0] == BATCH:
            steps.append(logits.clone())
        return sample(logits)

    eng._sample = spy
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    return [r.tokens for r in eng.run_to_completion()], steps


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b"])
def test_engine_tokens_equal_the_jax_engine_with_a_window(arch):
    cfg = _cfg(arch)
    params = _np_params(cfg)
    ref = JServeEngine(_jcfg(arch), jax.tree.map(jnp.asarray, params),
                       max_batch=BATCH, max_len=MAXLEN)
    for p in PROMPTS:
        ref.submit(p, max_new_tokens=NEW_TOKENS)
    want = [list(map(int, r.tokens)) for r in ref.run_to_completion()]
    got, _ = _serve(cfg, params_from_reference(params, cfg, "cpu"))
    assert got == want
    assert all(len(t) == NEW_TOKENS for t in got)


# ---------------------------------------------------------------- the ranks
def _worker(rank: int, world: int, store: str, tmp: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch.mesh import init_group, make_mesh
    from repro_torch.sharding.planner import plan_for
    from repro_torch.sharding.tp import (data_split, gather_from_model,
                                         model_split)

    init_group("cpu", init_method=f"file://{store}", world_size=world,
               rank=rank)
    try:
        cfg = _cfg("qwen2.5-3b")
        spec = dataclasses.replace(get_arch("qwen2.5-3b"), model=cfg)
        params = torch.load(os.path.join(tmp, "params.pt"), weights_only=False)
        for shape in SHAPES:
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            plan = plan_for(spec, mesh, mode="decode",
                            cell=ShapeCell("win", "decode", MAXLEN, BATCH),
                            cache_batch=BATCH, cache_len=MAXLEN)
            split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
            data = data_split(cfg, plan, mesh)
            model = params_from_reference(params, cfg, "cpu", split, data)
            toks, steps = _serve(cfg, model, mesh=mesh, plan=plan)
            if split is not None and split.vocab_out is not None:
                steps = [gather_from_model(t, -1, split) for t in steps]
            torch.save(dict(tokens=toks, steps=steps,
                            cache=None if split is None else split.cache,
                            rows=None if data is None else data.rows(BATCH)),
                       os.path.join(tmp, f"rank_{shape[0]}x{shape[1]}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory(prefix="win-") as tmp:
        cfg = _cfg("qwen2.5-3b")
        params = _np_params(cfg)
        torch.save(params, os.path.join(tmp, "params.pt"))
        procs = mp.spawn(_worker, args=(4, os.path.join(tmp, "store"), tmp),
                         nprocs=4, join=False)
        one = _serve(cfg, params_from_reference(params, cfg, "cpu"))
        while not procs.join():
            pass
        yield {shape: [torch.load(os.path.join(
            tmp, f"rank_{shape[0]}x{shape[1]}_{r}.pt"), weights_only=False)
            for r in range(4)] for shape in SHAPES}, one


@pytest.mark.parametrize("shape", SHAPES, ids=["model4-seq", "data2-model2"])
def test_window_decode_over_ranks_equals_one_process(ranks, shape):
    got, (tokens, steps) = ranks
    assert len(steps) >= NEW_TOKENS - 1
    for r, out in enumerate(got[shape]):
        assert out["tokens"] == tokens, r
        if shape == (1, 4):
            assert out["cache"] == "seq"     # the pieces of the sequence
        else:
            assert out["rows"] is not None and out["rows"][1] - out["rows"][0] < BATCH
        assert len(out["steps"]) == len(steps)
        for a, b in zip(out["steps"], steps):
            top = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-5 * top, r
