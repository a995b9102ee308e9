"""Serving launcher: batched generation with the slot engine, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        [--smoke] [--layers N] [--requests 6] [--max-new 12] [--device cpu]

``--arch`` is any of the reference's ten architectures: qwen2.5-3b,
granite-8b, codeqwen1.5-7b, command-r-35b, musicgen-medium, internvl2-26b
(served from its tokens: no vision prefix), olmoe-1b-7b, deepseek-v2-236b,
mamba2-1.3b or zamba2-7b.  The weights are random,
made on the device from ``--seed``.  ``--layers`` cuts the depth and keeps
every width (deepseek-v2-236b's 60 layers do not fit on one card: ``--layers
2``); the cut is printed.  Without ``--device`` the engine runs on the card
(and raises without one).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import ServeEngine

__all__ = ["main"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.n_layers:
            ap.error(f"--layers {args.layers}: {cfg.name} has {cfg.n_layers}")
        print(f"{cfg.name}: depth cut to {args.layers} of {cfg.n_layers} "
              "layers, every width kept")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(args.device)
    model = init_params(cfg, args.seed, dev)
    engine = ServeEngine(cfg, model, max_batch=args.max_batch,
                         max_len=args.max_len, device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        engine.submit(list(rng.integers(1, cfg.vocab_size, size=plen)),
                      max_new_tokens=args.max_new)
    done = engine.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.tokens) for r in done)
    for r in done:
        print(f"req {r.rid}: {len(r.prompt)} prompt → {r.tokens}")
    print(f"{len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s on {dev}, kernel builds included)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
