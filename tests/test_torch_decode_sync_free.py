"""Decode attention's lengths on the card, and the wider shapes, on the CPU.

A decode step makes ``cache_len`` once, from the one device copy of the
positions, and hands that one tensor to every layer; the wrapper reads
lengths given on the card never back (no synchronisation, capturable in a
CUDA graph), and still checks lengths given on the host.  ``plan_decode``
takes G > 64 by a grid axis over groups of at most 64 query rows and dh up
to 512 by more 16-byte segments per lane, where the shared memory allows.
The kernel's order of work at those shapes is emulated by
``tests/test_torch_decode_plan.py``'s ``kernel_plan`` (its ``CASES`` hold
a G = 128, dh = 320 case); the card's kernel is run by
``tests/test_torch_kernel_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.models import attention as tatt
from repro_torch.models.transformer import init_cache, init_params

torch.set_num_threads(1)

SMS = 132
SMOKE = get_arch("qwen2.5-3b").smoke


def test_one_decode_step_passes_one_cache_len_to_every_layer(monkeypatch):
    """qwen2.5's SMOKE config: the positions are checked on the host and
    turned into one ``cache_len`` tensor, the same object for every layer,
    equal to pos + 1."""
    model = init_params(SMOKE, seed=0, device="cpu")
    cache = init_cache(SMOKE, 2, 16, device="cpu")
    seen = []
    real = tatt.decode_attention

    def spy(q, k, v, cache_len, **kw):
        seen.append(cache_len)
        return real(q, k, v, cache_len, **kw)

    monkeypatch.setattr(tatt, "decode_attention", spy)
    pos = np.array([3, 7], np.int32)
    logits, _ = model.forward_decode(np.array([1, 2]), cache, pos)
    assert logits.shape == (2, SMOKE.padded_vocab)
    assert len(seen) == SMOKE.n_layers > 1
    assert all(t is seen[0] for t in seen)
    assert torch.is_tensor(seen[0]) and seen[0].tolist() == [4, 8]


def test_host_lengths_are_checked_and_card_lengths_never_read(monkeypatch):
    """Lengths on the host are range-checked; the check is skipped for any
    tensor that is not on the host (so a card tensor is not read back)."""
    for bad in ([0, 3], [3, 11]):
        with pytest.raises(ValueError, match="cache_len"):
            da._lengths(bad, 2, 10)
    lens = da._lengths(torch.tensor([3, 10], dtype=torch.int64), 2, 10)
    assert lens.dtype == torch.int32 and lens.tolist() == [3, 10]

    class OnCard(torch.Tensor):
        """A CPU tensor that says it lies on the card and fails if read."""

        @property
        def device(self):
            return torch.device("cuda", 0)

        def any(self, *a, **k):
            raise AssertionError("lengths on the card were read back")

    bad = torch.tensor([0, 99], dtype=torch.int32).as_subclass(OnCard)
    assert da._lengths(bad, 2, 10) is not None


def test_plan_takes_wide_groups_and_heads():
    """G = 128 and dh = 320 give plans: two groups of 64 rows in 16 warps of
    4, and the dh <= 256 plans are the served ones."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = da.plan_decode(8, 1, 128, 2048, 320, dtype, SMS)
        assert (plan.groups, plan.warps, plan.rows) == (2, 16, 4)
        assert plan.group_rows(128) == 64
        assert da.plan_decode(8, 2, 8, 2048, 128, dtype, SMS) == da.DecodePlan(
            32, 64, 4, 2, 1)
    plan = da.plan_decode(2, 1, 100, 64, 64, torch.float32, SMS)
    assert (plan.groups, plan.group_rows(100), plan.warps, plan.rows) == (2, 50, 13, 4)
    assert da.plan_decode(2, 1, 8, 64, 448, torch.float32, SMS).groups == 1
    for dh, dtype in ((460, torch.float32), (513, torch.bfloat16)):
        with pytest.raises(ValueError, match="dh"):
            da.plan_decode(2, 1, 8, 64, dh, dtype, SMS)
