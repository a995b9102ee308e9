"""The port's token ``ServeEngine`` on the CPU: against the JAX engine, and
the fast cases of ``tests/test_serve.py``.

qwen2.5's ``SMOKE`` config with the JAX weights carried across (the QKV
biases set to random values first): the two engines give identical greedy
tokens for the same prompts, and every served token is the argmax of the
port's own teacher-forced ``forward_full`` over the prompt and the tokens
before it.  Inputs come from numpy seeds.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models.transformer import init_params, params_from_reference
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduling import QueueFull

SMOKE = get_arch("qwen2.5-3b").smoke
RNG = np.random.default_rng(0)


def _reference_tree(seed=0):
    tree = jax.tree.map(np.array, jt.init_params(j_get_arch("qwen2.5-3b").smoke,
                                                 jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for b in ("bq", "bk", "bv"):
        a = tree["blocks"]["attn"][b]
        tree["blocks"]["attn"][b] = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return tree


_MODEL = init_params(SMOKE, 0, "cpu")


def _engine(**kw):
    return ServeEngine(SMOKE, _MODEL, device="cpu", **kw)


def _teacher_forced(model, prompt, tokens):
    full = np.asarray(list(prompt) + tokens, np.int32)[None, :]
    logits, _, _ = model.forward_full(full)
    lf = logits[0].clone()
    lf[:, SMOKE.vocab_size:] = -torch.inf
    return [int(lf[len(prompt) - 1 + i].argmax()) for i in range(len(tokens))]


def test_greedy_tokens_equal_the_jax_engine():
    tree = _reference_tree()
    model = params_from_reference(tree, SMOKE, "cpu")
    prompts = [list(RNG.integers(1, SMOKE.vocab_size, size=n)) for n in (5, 9, 13, 20)]
    ref = JServeEngine(j_get_arch("qwen2.5-3b").smoke,
                       jax.tree.map(jax.numpy.asarray, tree), max_batch=3,
                       max_len=64)
    eng = ServeEngine(SMOKE, model, max_batch=3, max_len=64, device="cpu")
    for p in prompts:
        ref.submit(p, max_new_tokens=6)
        eng.submit(p, max_new_tokens=6)
    want = [r.tokens for r in ref.run_to_completion()]
    got = eng.run_to_completion()
    assert [r.tokens for r in got] == want
    for r in got:
        assert r.tokens == _teacher_forced(model, r.prompt, r.tokens)


def test_generation_matches_teacher_forcing():
    eng = _engine(max_batch=3, max_len=64)
    for n in (5, 9, 13, 30):
        eng.submit(list(RNG.integers(1, SMOKE.vocab_size, size=n)), max_new_tokens=5)
    for r in eng.run_to_completion():
        assert r.tokens == _teacher_forced(_MODEL, r.prompt, r.tokens)


def test_max_new_tokens_1_retires_without_spinning():
    eng = _engine(max_batch=2, max_len=64)
    rids = [eng.submit([1 + i, 2, 3], max_new_tokens=1) for i in range(3)]
    done = eng.run_to_completion(max_steps=6)
    assert sorted(r.rid for r in done) == rids
    assert all(len(r.tokens) == 1 for r in done)
    assert not eng._slots and not eng.active.any()


def test_max_new_tokens_1_mixed_with_longer_requests():
    eng = _engine(max_batch=2, max_len=64)
    short = eng.submit([5, 6], max_new_tokens=1)
    long = eng.submit([7, 8, 9], max_new_tokens=4)
    by_rid = {r.rid: r for r in eng.run_to_completion(max_steps=10)}
    assert len(by_rid[short].tokens) == 1
    assert len(by_rid[long].tokens) == 4


def test_submit_validates_inputs():
    eng = _engine(max_batch=1, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(1, 17)))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2], max_new_tokens=0)
    assert not eng._queue


def test_more_requests_than_slots():
    eng = _engine(max_batch=2, max_len=64)
    rids = [eng.submit([1 + i, 2, 3], max_new_tokens=4) for i in range(5)]
    done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == rids
    assert all(len(r.tokens) == 4 for r in done)


def test_slot_reuse_does_not_leak_state():
    """A reused slot gives what a fresh engine gives: the stale cache
    beyond ``pos`` is masked."""
    eng = _engine(max_batch=1, max_len=64)
    p1 = list(RNG.integers(1, SMOKE.vocab_size, size=20))
    p2 = list(RNG.integers(1, SMOKE.vocab_size, size=6))
    eng.submit(p1, max_new_tokens=4)
    eng.submit(p2, max_new_tokens=4)
    done = eng.run_to_completion()
    fresh = _engine(max_batch=1, max_len=64)
    fresh.submit(p2, max_new_tokens=4)
    (ref,) = fresh.run_to_completion()
    assert done[1].tokens == ref.tokens


def test_interleaved_batch_isolation():
    """Requests decoded together do not influence one another."""
    eng = _engine(max_batch=4, max_len=64)
    prompts = [list(RNG.integers(1, SMOKE.vocab_size, size=n)) for n in (4, 7, 11, 5)]
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    for r in eng.run_to_completion():
        solo = _engine(max_batch=1, max_len=64)
        solo.submit(r.prompt, max_new_tokens=6)
        (ref,) = solo.run_to_completion()
        assert r.tokens == ref.tokens, f"request {r.rid} affected by batchmates"


def test_token_engine_reports_shared_metrics():
    eng = _engine(max_batch=2, max_len=64)
    rids = [eng.submit([1 + i, 2, 3], max_new_tokens=3) for i in range(4)]
    done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == rids
    snap = eng.metrics.snapshot()
    assert snap["served"] == 8                  # 4 requests × 2 decoded tokens
    assert snap["batches"] == 4
    assert snap["batch_occupancy"] == 2.0
    assert snap["p50_ms"] > 0 and snap["p99_ms"] >= snap["p50_ms"]
    assert snap["device_s"] > 0 and snap["rps"] > 0
    assert len(eng.metrics._latencies) == 4
    eng.metrics.reset()
    assert eng.metrics.snapshot()["served"] == 0


def test_token_engine_slo_classes():
    eng = _engine(max_batch=2, max_len=64, prefill_slo_s=30.0, decode_slo_s=30.0)
    rids = [eng.submit([1 + i, 2, 3], max_new_tokens=3) for i in range(4)]
    assert all(r.deadline is not None for r in eng._queue._items)
    done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == rids
    assert len(eng.metrics_prefill._latencies) == 4
    assert len(eng.metrics_decode._latencies) == 4
    assert eng.metrics_prefill.snapshot()["slo_misses"] == 0
    assert eng.metrics_decode.snapshot()["slo_misses"] == 0
    for r in done:
        assert r.ttft_s is not None
        assert r.t_first_token <= eng.metrics_decode.t_last
    assert len(eng.metrics._latencies) == 4


def test_token_engine_slo_misses_and_backpressure():
    eng = _engine(max_batch=1, max_len=64, prefill_slo_s=0.0, decode_slo_s=0.0,
                  queue_limit=2)
    eng.submit([1, 2, 3], max_new_tokens=2)
    eng.submit([4, 5, 6], max_new_tokens=2)
    with pytest.raises(QueueFull):
        eng.submit([7, 8, 9], max_new_tokens=2)
    assert eng._queue.rejected == 1
    assert len(eng.run_to_completion()) == 2
    assert eng.metrics_prefill.snapshot()["slo_misses"] == 2
    assert eng.metrics_decode.snapshot()["slo_misses"] == 2
    assert eng.metrics.snapshot()["slo_misses"] == 0


def test_sampling_draws_from_a_seeded_generator():
    def run(seed):
        eng = _engine(max_batch=2, max_len=64, greedy=False, seed=seed)
        for p in ([3, 4, 5], [9, 8]):
            eng.submit(p, max_new_tokens=8)
        return [r.tokens for r in eng.run_to_completion()]

    a = run(0)
    assert a == run(0)
    assert all(0 <= t < SMOKE.vocab_size for toks in a for t in toks)


def test_engine_refuses_what_is_not_ported_or_misplaced():
    with pytest.raises(ValueError, match="both mesh and plan"):
        ServeEngine(SMOKE, _MODEL, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="another ModelConfig"):
        ServeEngine(dataclasses.replace(SMOKE, name="x"), _MODEL, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(SMOKE, _MODEL)


def test_launcher_serves_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device",
                              "cpu", "--requests", "3", "--max-new", "4",
                              "--max-batch", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "3 requests, 12 tokens" in out
