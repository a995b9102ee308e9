"""zamba2-7b's SMOKE config against the JAX package, on the CPU: the
slowest cases of ``tests/test_torch_hybrid.py``, in a file of their own so
that two workers share them (``--dist loadfile`` gives each file one).

* ``forward_full``/``forward_decode`` without a window, in float32 and
  bfloat16 (the tolerances of ``tests/test_torch_hybrid.py``);
* the port's engine against the JAX engine's greedy tokens (exact-length
  prefills; with a window of 8 the prompts are longer than the ring, whose
  slots take the prefill's last 8 positions at ``idx % 8``), and the ring's
  slots after one prefill.
"""

import numpy as np
import pytest
import torch

from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.serve.engine import ServeEngine
from test_torch_hybrid import _models, forward_and_decode


@pytest.mark.parametrize("dtype,window", [("float32", 0), ("bfloat16", 0)])
def test_forward_full_and_decode_match_reference(dtype, window):
    """Without a window the shared cache has one slot a position."""
    forward_and_decode(dtype, window)


@pytest.mark.parametrize("window", [0, 8])
def test_engine_greedy_tokens_equal_the_jax_engine(window):
    """Exact-length prefills; with a window of 8 the prompts of 13 and 17
    tokens are longer than the ring, whose slots take the prefill's last 8
    positions at ``idx % 8``."""
    cfg_j, pj, cfg, model = _models(attn_window=window)
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (1, 5, 13, 17)]
    ref = JServeEngine(cfg_j, pj, max_batch=3, max_len=48)
    eng = ServeEngine(cfg, model, max_batch=3, max_len=48, device="cpu")
    for p in prompts:
        ref.submit(p, max_new_tokens=7)
        eng.submit(p, max_new_tokens=7)
    want = [r.tokens for r in ref.run_to_completion()]
    assert [r.tokens for r in eng.run_to_completion()] == want


def test_engine_writes_a_ring_by_position_modulo_its_width():
    """One 13-token prompt into a ring of 8: slot s holds the prefill's
    position in [5, 13) that is s modulo 8; the state caches take the
    slot whole."""
    _, _, cfg, model = _models(attn_window=8)
    eng = ServeEngine(cfg, model, max_batch=2, max_len=32, device="cpu")
    prompt = list(range(3, 16))
    eng.submit(prompt, max_new_tokens=1)
    eng._insert(eng._queue.take(1)[0], 1)
    _, pc, _ = model.forward_full(np.asarray(prompt)[None], return_cache=True)
    assert eng.caches["k"].shape[2] == 8
    for s in range(8):
        p = next(i for i in range(5, 13) if i % 8 == s)
        assert torch.equal(eng.caches["k"][:, 1, s], pc["k"][:, 0, p])
        assert torch.equal(eng.caches["v"][:, 1, s], pc["v"][:, 0, p])
    assert torch.equal(eng.caches["h"][:, 1], pc["h"][:, 0])
    assert not eng.caches["k"][:, 0].any() and not eng.caches["h"][:, 0].any()
