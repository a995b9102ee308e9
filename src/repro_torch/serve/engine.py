"""Batched token serving: slot-based continuous batching over a fixed cache.

The port of the JAX package's ``serve/engine.py``, for every family.  The
engine owns the caches (GQA's ``k``/``v``, MLA's latent ``ckv``/``kr``, the
Mamba2 layers' states, the hybrid's shared ``k``/``v``) for ``max_batch``
sequence *slots* of ``max_len`` tokens plus per-slot cursors.  Requests are
prefilled one at a time (prompt lengths bucketed to powers of two from 8 for
the attention families; exact lengths for ``ssm``/``hybrid``, whose state
integrates every position and must not see padding) and inserted into a
free slot: a cache with a sequence axis (``_SEQ_KEYS``) takes the prompt's
positions, a ring of width W its last W at ``idx % W``, a state cache the
whole of the slot;
``step()`` then decodes one token for *every* slot in a single batched
``forward_decode`` (idle slots too, as the reference does: MoE rows share
the experts' capacity, so only the same rows give the same function).
Prefill attention runs on the flash-attention kernel and GQA decode
attention on the decode-attention kernel; the caches are updated in place.

The engine reports through the shared :class:`~repro_torch.serve.metrics.
ServeMetrics`: one ``record_batch`` per batched decode (active slots,
host-clock seconds around the forward and the sampling, which waits for the
card) and one ``record_request`` per retirement.  Admission runs through the
shared :class:`~repro_torch.serve.scheduling.AdmissionQueue`: ``queue_limit``
turns overflow into ``QueueFull``, and two SLO classes report separately —
prefill (time to first token) via ``metrics_prefill`` and decode (full
completion) via ``metrics_decode``.

Sampling is greedy by default; ``greedy=False`` draws from the softmax of
the logits with a ``torch.Generator`` on the engine's device seeded by
``seed``.  ``device=None`` means the card.

On a ``mesh`` (a ``DeviceMesh``) with a ``plan`` (the reference's
distributed serving), every rank runs this host loop on the same requests
(SPMD): the model is the rank's (built with the plan's
:class:`~repro_torch.sharding.tp.ModelSplit`: every family; olmoe's and
deepseek-v2's experts, mamba2's and zamba2's SSM heads split), the caches
are the plan's local caches (its KV heads, or its piece of the sequence:
MLA's latents always; a Mamba2 layer's ``h`` over its SSM heads and
``conv_x`` over its channels, each slot written whole at the exact-length
prefill; zamba2's shared ``k``/``v`` over its KV heads),
the logits are gathered over ``model`` before sampling, and the
generators are seeded alike, so that every rank emits the same tokens.

Where ``pod`` × ``data`` exceeds one rank (a :class:`~repro_torch.sharding.
tp.DataSplit`) the data ranks split the slots as the plan splits the
caches' batch: a rank holds rows ``[d·B/D, (d+1)·B/D)`` of the ``max_batch``
slots (D the data-parallel ranks, pod-major, d this rank's index; every
row where the plan leaves the batch whole), and the ``model`` split runs
unchanged inside each data rank.  Every rank keeps the same queue, slot
pool, positions and last tokens over all the slots, so every scheduling
decision is the same without a collective.  A prefill runs on every rank
(one request, B = 1, routed alone through the MoE layers; under FSDP its
layers gather their weights over ``data``, a collective every data rank
joins), so every rank samples the same first token, and only the slot's
owner writes it into its cache.  A decode step runs each rank's rows
through ``forward_decode``, the MoE layers routing over the whole batch
(the data ranks installed as the token group: the capacity of all B rows,
and positions after the earlier ranks' copies, as the reference's GSPMD
routes); the logits (the rank's vocabulary columns of its rows) are
gathered over the data ranks in row order, then over ``model``, and every
rank samples the whole batch.  The model must
carry the plan's data split (:func:`~repro_torch.sharding.tp.data_split`:
FSDP's shards of the weights).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import ModelConfig, Transformer, init_cache
from repro_torch.sharding.ctx import use_plan, use_token_group
from repro_torch.sharding.tp import data_split, gather_from_model, model_split
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduling import AdmissionQueue, SlotPool, bucket_for

__all__ = ["ServeEngine", "Request"]

_SEQ_KEYS = ("k", "v", "ckv", "kr")       # cache leaves with a sequence axis


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    t_submit: float = 0.0
    # prefill-class SLO deadline (absolute monotonic seconds): the instant
    # by which the first token must be sampled.
    deadline: float | None = None
    t_first_token: float | None = None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    @property
    def ttft_s(self) -> float | None:
        """Submit → first-token latency (the prefill-class SLO unit)."""
        return (None if self.t_first_token is None
                else self.t_first_token - self.t_submit)


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        model: Transformer,
        *,
        max_batch: int = 8,
        max_len: int = 512,
        greedy: bool = True,
        seed: int = 0,
        mesh: Any | None = None,
        plan: Any | None = None,
        prefill_slo_s: float | None = None,
        decode_slo_s: float | None = None,
        queue_limit: int | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        """``model`` (a :class:`Transformer` of ``cfg``) must lie on
        ``device`` (None: the card).  ``prefill_slo_s``/``decode_slo_s`` are
        the two SLO classes; ``queue_limit`` bounds admission.  ``mesh``
        and ``plan`` come together; the plan's caches must hold
        ``max_batch`` sequences of ``max_len``, and ``model`` must carry
        the plan's split (:func:`~repro_torch.sharding.tp.model_split`) and
        its data split (:func:`~repro_torch.sharding.tp.data_split`)."""
        if (mesh is None) != (plan is None):
            raise ValueError("serving on a plan needs both mesh and plan")
        split = data = None
        if mesh is not None:
            split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
            if (split is None) != (model.split is None) or (
                    split is not None and (split.specs, split.cache) !=
                    (model.split.specs, model.split.cache)):
                raise ValueError("the model was not built with the plan's "
                                 "split (sharding.tp.model_split)")
            data = data_split(cfg, plan, mesh)
            if getattr(model, "data", None) != data:
                raise ValueError("the model was not built with the plan's "
                                 "data split (sharding.tp.data_split)")
        self.mesh, self.plan, self.split, self.data = mesh, plan, split, data
        # this rank's slots [r0, r1): its rows of the caches' batch
        rows = data.rows(max_batch) if data is not None else None
        self.rows = rows or (0, max_batch)
        self._tokens = data.group if rows is not None else None
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"runs on {self.device}")
        if model.cfg != cfg:
            raise ValueError("the model was built for another ModelConfig")
        self.cfg = cfg
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.greedy = greedy
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.caches = init_cache(cfg, max_batch, max_len, device=self.device,
                                 split=split, data=data)
        self.pos = np.zeros(max_batch, np.int32)
        # slot occupancy lives in the shared SlotPool; ``active`` aliases
        # its flags array so the decode mask and the pool stay one state
        self.slots = SlotPool(max_batch)
        self.active = self.slots.flags
        self.last_token = np.zeros(max_batch, np.int32)
        self._slots: dict[int, Request] = {}
        self._next_rid = 0
        self._queue = AdmissionQueue(queue_limit)
        self._finished: list[Request] = []
        self._exact_prefill = cfg.family in ("ssm", "hybrid")
        self.prefill_slo_s = prefill_slo_s
        self.decode_slo_s = decode_slo_s
        self.metrics = ServeMetrics()
        self.metrics_prefill = ServeMetrics()
        self.metrics_decode = ServeMetrics()

    # --------------------------------------------------------- bookkeeping
    def submit(self, prompt: list[int], max_new_tokens: int = 16) -> int:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= engine max_len {self.max_len}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        now = time.monotonic()
        req = Request(self._next_rid, prompt, max_new_tokens, t_submit=now,
                      deadline=(None if self.prefill_slo_s is None
                                else now + self.prefill_slo_s))
        self._queue.push(req)      # QueueFull propagates as backpressure
        self._next_rid += 1
        return req.rid

    def _bucket(self, n: int) -> int:
        if self._exact_prefill:
            return n
        return bucket_for(n, self.max_len, floor=8)

    def _sample(self, logits: torch.Tensor) -> list[int]:
        """One token per row of ``logits`` (N, Vp; on a plan the rank's
        columns, gathered over ``model`` first), the vocabulary padding
        masked: the argmax, or a draw from the softmax."""
        if self.split is not None and self.split.vocab_out is not None:
            logits = gather_from_model(logits, -1, self.split, of="vocab_out")
        lf = logits.float().clone()
        lf[:, self.cfg.vocab_size:] = -torch.inf
        if self.greedy:
            return lf.argmax(dim=-1).tolist()
        probs = torch.softmax(lf, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].tolist()

    # -------------------------------------------------------------- prefill
    def _insert(self, req: Request, slot: int) -> None:
        plen = len(req.prompt)
        if plen >= self.max_len:  # submit() validates; keep a -O-proof guard
            raise ValueError(
                f"prompt length {plen} >= engine max_len {self.max_len}")
        sp = self._bucket(plen)
        padded = np.zeros((1, sp), np.int32)
        padded[0, :plen] = req.prompt
        with use_plan(self.mesh, getattr(self.plan, "act_specs", None)):
            logits, pcache, _ = self.model.forward_full(padded,
                                                        return_cache=True)
        (first,) = self._sample(logits[0, plen - 1:plen])
        r0, r1 = self.rows
        for key, leaf in (self.caches.items() if r0 <= slot < r1 else ()):
            new = pcache[key][:, 0]
            if key not in _SEQ_KEYS:
                leaf[:, slot - r0] = new
                continue
            if self.split is not None and self.split.cache == "seq":
                # this rank's positions [r·Sl, (r + 1)·Sl) of the prompt
                Sl = leaf.shape[2]
                c0 = self.split.r * Sl
                n = max(0, min(new.shape[1] - c0, Sl))
                leaf[:, slot - r0, :n] = new[:, c0:c0 + n]
                continue
            S, win = new.shape[1], leaf.shape[2]
            if S <= win:
                leaf[:, slot - r0, :S] = new
            else:                     # a ring: the last ``win`` positions
                idx = torch.arange(S - win, S, device=leaf.device)
                leaf[:, slot - r0, idx % win] = new[:, idx]
        self.pos[slot] = plen
        self.slots.acquire(slot)
        self.last_token[slot] = first
        req.slot = slot
        req.tokens.append(first)
        self._slots[slot] = req
        req.t_first_token = time.monotonic()
        self.metrics_prefill.record_request(
            req.ttft_s, t_submit=req.t_submit, t_done=req.t_first_token,
            missed_slo=(req.deadline is not None
                        and req.t_first_token > req.deadline))

    def _retire(self, slot: int, req: Request) -> None:
        now = time.monotonic()
        self.slots.release(slot)
        self._finished.append(req)
        del self._slots[slot]
        latency = now - req.t_submit
        self.metrics.record_request(latency, t_submit=req.t_submit, t_done=now)
        self.metrics_decode.record_request(
            latency, t_submit=req.t_submit, t_done=now,
            missed_slo=(self.decode_slo_s is not None
                        and latency > self.decode_slo_s))

    # ----------------------------------------------------------------- step
    def step(self) -> dict[int, int]:
        """Admit queued requests into free slots, then decode one token for
        every active slot.  Returns {request id: new token}."""
        for slot in self.slots.free():
            if not self._queue:
                break
            (req,) = self._queue.take(1)
            self._insert(req, slot)
        # retire requests their prefill token already satisfied
        # (max_new_tokens=1) before decoding
        for slot, req in list(self._slots.items()):
            if req.done:
                self._retire(slot, req)
        if not self.slots.any_active:
            return {}

        n_active = len(self._slots)
        t0 = time.perf_counter()
        r0, r1 = self.rows
        with use_plan(self.mesh, getattr(self.plan, "act_specs", None)), \
                use_token_group(self._tokens):
            logits, self.caches = self.model.forward_decode(
                self.last_token[r0:r1], self.caches, self.pos[r0:r1])
        if self._tokens is not None:             # every rank's rows, in order
            logits = self.data.gather_rows(logits)
        toks = self._sample(logits)              # waits for the card
        self.metrics.record_batch(n_active, time.perf_counter() - t0)
        out: dict[int, int] = {}
        for slot, req in list(self._slots.items()):
            tok = toks[slot]
            req.tokens.append(tok)
            out[req.rid] = tok
            self.last_token[slot] = tok
            self.pos[slot] += 1
            if req.done or self.pos[slot] >= self.max_len - 1:
                self._retire(slot, req)
        return out

    # ---------------------------------------------------------- run loop
    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self._queue or self._slots) and steps < max_steps:
            self.step()
            steps += 1
        return sorted(self._finished, key=lambda r: r.rid)
