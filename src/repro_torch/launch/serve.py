"""Serving launcher: batched generation with the slot engine, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        [--smoke] [--requests 6] [--max-new 12] [--device cpu]

The weights are random, made on the device from ``--seed``.  Without
``--device`` the engine runs on the card (and raises without one).
"""

from __future__ import annotations

import argparse
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
