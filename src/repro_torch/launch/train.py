"""Training launcher: LM training steps on one device, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        [--smoke] [--layers N] [--act-dtype float32] [--steps 50] \
        [--ckpt-dir DIR --ckpt-every 20] [--device cpu]

The port of the JAX package's ``launch/train.py`` on one device: no mesh
and no sharding plan (ROADMAP.md, Queue A item 9).  It builds the train
step (:func:`repro_torch.train.train_loop.make_train_step`), the
deterministic synthetic token pipeline, periodic and preemption-triggered
checkpoints, and straggler tracking.  The weights are random, float32
masters drawn from ``--seed``.  ``--layers`` cuts the depth and keeps every
width; ``--act-dtype`` overrides the activation dtype.  Without
``--device`` it runs on the card (and raises without one).  On a restart
with the same ``--ckpt-dir`` it resumes exactly, the data cursor included.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.device import resolve_device
from repro_torch.data.tokens import PipelineState, TokenPipeline
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import PreemptionHandler, StragglerPolicy
from repro_torch.train.optim import OptConfig
from repro_torch.train.train_loop import (init_state, load_masters,
                                          make_train_step)

__all__ = ["main", "run_training"]


def run_training(arch: str, *, smoke: bool, steps: int, batch: int,
                 seq_len: int, ckpt_dir: str | None, ckpt_every: int,
                 microbatches: int, lr: float, log_every: int = 10,
                 device: torch.device | str | None = None,
                 layers: int | None = None, act_dtype: str | None = None,
                 seed: int = 0) -> dict:
    """Train ``steps`` steps (resuming from ``ckpt_dir`` when it holds a
    checkpoint); returns {"final": the last logged metrics, "history": the
    logged metrics, "state": the final :class:`TrainState`}."""
    spec = get_arch(arch)
    cfg = spec.smoke if smoke else spec.model
    if layers is not None:
        if not 1 <= layers <= cfg.n_layers:
            raise ValueError(f"layers {layers}: {cfg.name} has {cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if act_dtype is not None:
        cfg = dataclasses.replace(cfg, act_dtype=act_dtype)
    dev = resolve_device(device)
    oc = OptConfig(lr=lr, warmup_steps=max(2, steps // 10), total_steps=steps)

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq_len)
    pstate = PipelineState()
    start_step = 0
    model, state = init_state(cfg, seed, device=dev)
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, meta = ckpt.restore(ckpt_dir, state)
        load_masters(model, state.params)
        pstate = PipelineState.from_json(meta["pipeline"])
        start_step = int(meta["step"])
        print(f"resumed from step {start_step}")
    step_fn = make_train_step(model, oc, n_microbatches=microbatches)

    preempt = PreemptionHandler()
    straggler = StragglerPolicy()
    metrics_hist = []
    try:
        for i in range(start_step, steps):
            np_batch, pstate = pipe.batch_at(pstate)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, np_batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            if straggler.observe(dt):
                print(f"[straggler] step {i} took {dt:.2f}s "
                      f"(deadline {straggler.factor}×median); backup-dispatch hook")
            if (i + 1) % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                metrics_hist.append({"step": i + 1, **m, "sec": dt})
                print(f"step {i+1:5d} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} ({dt:.2f}s)")
            want_save = ckpt_dir and ((i + 1) % ckpt_every == 0 or i == steps - 1)
            if want_save or (ckpt_dir and preempt.should_save):
                ckpt.save(ckpt_dir, i + 1, state,
                          metadata={"pipeline": pstate.to_json(), "step": i + 1,
                                    "arch": arch})
                if preempt.should_save:
                    print(f"[preemption] checkpoint saved at step {i+1}; exiting")
                    break
    finally:
        preempt.restore()
    return {"final": metrics_hist[-1] if metrics_hist else {},
            "history": metrics_hist, "state": state}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--act-dtype", default=None, choices=("float32", "bfloat16"),
                    help="the activation dtype (default: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    out = run_training(
        args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, microbatches=args.microbatches, lr=args.lr,
        device=args.device, layers=args.layers, act_dtype=args.act_dtype,
        seed=args.seed,
    )
    print("final:", out["final"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
