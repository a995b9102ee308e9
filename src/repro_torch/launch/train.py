"""Training launcher: LM training steps on a mesh of ranks, on the cards.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        [--smoke] [--layers N] [--act-dtype float32] [--steps 50] \
        [--ckpt-dir DIR --ckpt-every 20] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2.5-3b --smoke --device cpu

The port of the JAX package's ``launch/train.py``: the mesh that fits the
process group's ranks (:func:`build_mesh_for_devices`, elastic:
``elastic_mesh_shape(world, prefer_model=min(16, world))``), the MAFIA
plan (:func:`repro_torch.sharding.planner.plan_for`), the train state
placed on the plan and the train step on the mesh
(:mod:`repro_torch.train.train_loop`; every family's layers
split over ``model`` as the plan says, :mod:`repro_torch.sharding.tp`), the deterministic synthetic token
pipeline (every rank reads the global batch and keeps its rows),
periodic and preemption-triggered checkpoints (gathered, written by rank
0), and straggler tracking.  Under ``torchrun`` the ranks come from its
variables; alone it starts a group of one rank (NCCL on the card, gloo
with ``--device cpu``).  The weights are random, float32 masters drawn
from ``--seed``.  ``--layers`` cuts the depth and keeps every width;
``--act-dtype`` overrides the activation dtype.  Without ``--device`` it
runs on the card (and raises without one).  On a restart with the same
``--ckpt-dir`` it resumes exactly, the data cursor included, on any
number of ranks (reshard on restore).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.core.device import resolve_device
from repro_torch.data.tokens import PipelineState, TokenPipeline
from repro_torch.launch.mesh import init_group, make_mesh
from repro_torch.sharding.ctx import use_activation_sharding
from repro_torch.sharding.placement import local_rows
from repro_torch.sharding.planner import plan_for
from repro_torch.sharding.tp import model_split
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (PreemptionHandler,
                                               StragglerPolicy,
                                               elastic_mesh_shape)
from repro_torch.train.optim import OptConfig
from repro_torch.train.train_loop import (gather_state, init_state,
                                          make_train_step, shard_state,
                                          state_specs)

__all__ = ["main", "run_training", "build_mesh_for_devices"]


def build_mesh_for_devices(device: torch.device | str | None = None):
    """The mesh over the process group's ranks (a one-rank group is started
    when none runs and ``torchrun``'s variables are unset): the elastic
    (pod, data, model) grid of the world size."""
    dev = resolve_device(device)
    init_group(dev)
    world = dist.get_world_size()
    axes, used = elastic_mesh_shape(world, prefer_model=min(16, world))
    if used != world:
        raise ValueError(f"{world} ranks: the elastic mesh {axes} uses {used}")
    return make_mesh(tuple(axes.values()), tuple(axes), dev)


def run_training(arch: str, *, smoke: bool, steps: int, batch: int,
                 seq_len: int, ckpt_dir: str | None, ckpt_every: int,
                 microbatches: int, lr: float, log_every: int = 10,
                 device: torch.device | str | None = None,
                 layers: int | None = None, act_dtype: str | None = None,
                 seed: int = 0) -> dict:
    """Train ``steps`` steps (resuming from ``ckpt_dir`` when it holds a
    checkpoint) on the mesh of the process group's ranks (every rank calls
    it); returns {"final": the last logged metrics, "history": the logged
    metrics, "state": the final :class:`TrainState` gathered whole}.  A
    process group it starts, it ends."""
    spec = get_arch(arch)
    cfg = spec.smoke if smoke else spec.model
    if layers is not None:
        if not 1 <= layers <= cfg.n_layers:
            raise ValueError(f"layers {layers}: {cfg.name} has {cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if act_dtype is not None:
        cfg = dataclasses.replace(cfg, act_dtype=act_dtype)
    dev = resolve_device(device)
    own_group = not dist.is_initialized()
    mesh = build_mesh_for_devices(dev)
    preempt = PreemptionHandler()
    try:
        cell = ShapeCell("cli", "train", seq_len, batch)
        plan = plan_for(dataclasses.replace(spec, model=cfg), mesh,
                        mode="train", cell=cell)
        oc = OptConfig(lr=lr, warmup_steps=max(2, steps // 10),
                       total_steps=steps)

        pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=batch,
                             seq_len=seq_len)
        log = print if dist.get_rank() == 0 else (lambda *a, **k: None)
        pstate = PipelineState()
        start_step = 0
        # the rank's model: its shards of what the plan splits over `model`
        model, state = init_state(cfg, seed, device=dev,
                                  split=model_split(cfg, plan.param_specs, mesh))
        state = shard_state(state, state_specs(plan), mesh)
        if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
            state, meta = ckpt.restore(ckpt_dir, state)
            pstate = PipelineState.from_json(meta["pipeline"])
            start_step = int(meta["step"])
            log(f"resumed from step {start_step}")
        step_fn = make_train_step(model, oc, n_microbatches=microbatches,
                                  mesh=mesh, grad_specs=plan.param_specs)
        batch_spec = plan.batch_spec(batch)

        straggler = StragglerPolicy()
        metrics_hist = []
        for i in range(start_step, steps):
            np_batch, pstate = pipe.batch_at(pstate)
            rows = local_rows({k: torch.as_tensor(v)
                               for k, v in np_batch.items()}, batch_spec, mesh)
            t0 = time.perf_counter()
            with use_activation_sharding(plan.act_specs):
                state, metrics = step_fn(state, rows)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            if straggler.observe(dt):
                log(f"[straggler] step {i} took {dt:.2f}s "
                      f"(deadline {straggler.factor}×median); backup-dispatch hook")
            if (i + 1) % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                metrics_hist.append({"step": i + 1, **m, "sec": dt})
                log(f"step {i+1:5d} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} ({dt:.2f}s)")
            want_save = ckpt_dir and ((i + 1) % ckpt_every == 0 or i == steps - 1)
            if want_save or (ckpt_dir and preempt.should_save):
                ckpt.save(ckpt_dir, i + 1, state,
                          metadata={"pipeline": pstate.to_json(), "step": i + 1,
                                    "arch": arch})
                if preempt.should_save:
                    log(f"[preemption] checkpoint saved at step {i+1}; exiting")
                    break
        return {"final": metrics_hist[-1] if metrics_hist else {},
                "history": metrics_hist, "state": gather_state(state)}
    finally:
        preempt.restore()
        if own_group:
            dist.destroy_process_group()


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
