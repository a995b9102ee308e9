"""Phase tp-ssm's first moments against a float64 step: how far the
one-process float32 step and the split's ranks each lie from the exact
first update, on one card.

    python3 tools/tp_ssm_first.py
    python3 tools/tp_ssm_first.py --train qwen2.5-3b 4 --train granite-8b 2 \
        --model 3 --uneven           # phase tp-uneven's train runs

The options run other train runs of ``chip_smoke``'s train job the same
way: ``--train ARCH LAYERS`` (repeated; default ``TPS_TRAIN``), ``--model``
ranks (default 2), ``--uneven`` for the planner's ``allow_uneven`` plan
(phase tp-uneven's, one step).

For each model of ``chip_smoke.TPS_TRAIN`` (mamba2-1.3b x4, zamba2-7b x6 at
every width, phase tp-ssm's cell: S ``TP_S``, batch ``TP_BATCH`` in
``TP_MB`` microbatches):

* the one-process float32 train reference (``chip_smoke.tp_train_ref``)
  and its first moments, each (data 1, model 2) rank's slices;
* the same first step in float64: the model's weights in float64, every
  float32 cast of the model code and every float32 tensor it makes kept
  at float64 (``Tensor.float`` is the identity on a float64 tensor while
  it runs), the attention's plain version; the first moments are
  ``(1 - beta1) * min(1, clip / |g|) * g`` of its mean gradient ``g``, as
  the step's AdamW makes them;
* phase tp-ssm's two ranks at (data 1, model 2), whose first moments are
  held against the float64 ones in place of the float32 reference's.

Prints, for each model, each leaf's relative distance from the float64
moments (of the leaf's largest magnitude) for the float32 one-process step
and for each rank, the furthest leaves first (phase tp-ssm holds the
distance between those two to ``TPS_FIRST_REL``); writes it all to
``chiprun_out/tp_ssm_first.json``.
"""

import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def float64_model_code():
    """The model code's float32 casts and float32 tensors it makes (the
    SSM scan's initial state, the rope tables) kept at float64."""
    import torch

    real_float = torch.Tensor.float
    made = ("zeros", "ones", "full", "empty", "arange")
    real = {name: getattr(torch, name) for name in made}

    def keep(self, *args, **kw):
        return self if self.dtype == torch.float64 else real_float(self, *args,
                                                                   **kw)

    def wide(fn):
        def make(*args, **kw):
            if kw.get("dtype") is torch.float32:
                kw["dtype"] = torch.float64
            return fn(*args, **kw)
        return make

    torch.Tensor.float = keep
    for name, fn in real.items():
        setattr(torch, name, wide(fn))
    try:
        yield
    finally:
        torch.Tensor.float = real_float
        for name, fn in real.items():
            setattr(torch, name, fn)


def first_float64(dev, arch: str, layers: int) -> dict:
    """The float64 first moments of phase tp-ssm's first step (leaf path
    → tensor, ``blocks/`` stacked), on the card."""
    import torch

    from repro_torch.models.transformer import _leaves, lm_loss
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    _, _, cfg = cs._tp_train_cfg(arch, layers)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    model, _ = tloop.init_state(cfg, 0, device=dev)
    model.double()
    leaves = _leaves(model)
    weights = [t for ts in leaves.values() for t in ts]
    tokens = cs._tp_data(cfg.vocab_size)[0]["tokens"]
    mb = tokens.shape[0] // cs.TP_MB
    acc = [torch.zeros_like(w) for w in weights]
    with float64_model_code():
        for i in range(cs.TP_MB):
            loss = lm_loss(model, tokens[i * mb:(i + 1) * mb],
                           plain_attention=True)
            for a, g in zip(acc, torch.autograd.grad(loss, weights)):
                a.add_(g)
            del loss
    g = [a / cs.TP_MB for a in acc]
    norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
    scale = (1 - oc.beta1) * torch.clamp_max(oc.clip_norm / norm, 1.0)
    out, it = {}, iter(g)
    for path, ts in leaves.items():
        xs = [next(it) * scale for _ in ts]
        out[path] = torch.stack(xs) if path.startswith("blocks/") else xs[0]
    del model, acc, g
    return out


def distance(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| over want's largest magnitude."""
    return {p: float((got[p].double() - w.double()).abs().max())
            / max(float(w.abs().max()), 1e-300) for p, w in want.items()}


def child(rank: int, world: int, tmp: str, device: str, jobs) -> None:
    """One rank: the train jobs."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    cs.tp_child(rank, world, tmp, jobs, device)


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch
    import torch.multiprocessing as mp

    from repro_torch.kernels import build
    from repro_torch.launch.steps import build_cell
    from repro_torch.sharding.spec import MeshShape

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--train", nargs=2, action="append",
                    metavar=("ARCH", "LAYERS"))
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--uneven", action="store_true")
    args = ap.parse_args(argv)
    runs = ([(a, int(n)) for a, n in args.train] if args.train
            else list(cs.TPS_TRAIN))
    m, uneven = args.model, args.uneven
    steps = cs.TPU_STEPS if uneven else cs.TP_STEPS
    jobs = [("train", (1, m), a, n) + ((True, steps) if uneven else ())
            for a, n in runs]
    if not torch.cuda.is_available():
        print("CUDA is not available; this run needs a GPU", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = cs.card_line()
    print(card, flush=True)
    build.build(("flash_attention", "decode_attention", "gemv"))
    dev = torch.device("cuda", 0)
    out = {"card": card, "limit": cs.TPS_FIRST_REL, "model": m,
           "uneven": uneven, "models": {}}
    with tempfile.TemporaryDirectory(prefix="mafia-tps-first-") as tmp:
        for arch, layers in runs:
            cs.tp_train_ref(dev, tmp, arch, layers, m, uneven, steps)
            f32 = [torch.load(os.path.join(tmp, f"tp_ref_first_{arch}_{r}.pt"))
                   for r in range(m)]
            m64 = first_float64(dev, arch, layers)
            spec, cell, cfg = cs._tp_train_cfg(arch, layers)
            plan = build_cell(spec, cell, MeshShape((1, m), ("data", "model")),
                              allow_uneven=uneven).plan
            cs.tp_save_first(tmp, arch, cfg, plan, m64, m)  # the ranks' reference
            f64 = [torch.load(os.path.join(tmp, f"tp_ref_first_{arch}_{r}.pt"))
                   for r in range(m)]
            out["models"][arch] = {"layers": layers, "f32_one_process":
                                   [distance(f32[r], f64[r]) for r in range(m)]}
            del m64
            torch.cuda.empty_cache()
        mp.spawn(child, args=(m, tmp, str(dev), jobs), nprocs=m, join=True)
        for job in jobs:
            arch, layers = job[2], job[3]
            rec = out["models"][arch]
            rec["ranks"] = [torch.load(os.path.join(
                tmp, f"tp_{job[0]}_{'_'.join(map(str, job[1:]))}_{r}.pt"),
                weights_only=False)["first_err"] for r in range(m)]
            print(f"{arch} x{layers}: first moments against the float64 step "
                  "(of each leaf's largest), furthest leaves first", flush=True)
            for r in range(m):
                one, rank = rec["f32_one_process"][r], rec["ranks"][r]
                worst = sorted(one, key=lambda p: -max(one[p], rank[p]))[:6]
                for p in worst:
                    print(f"  rank {r}'s slice of {p}: float32 one process "
                          f"{one[p]:.3g}, the rank {rank[p]:.3g}", flush=True)
                print(f"  rank {r}: largest, float32 one process "
                      f"{max(one.values()):.3g}, the rank {max(rank.values()):.3g}"
                      f" (phase tp-ssm holds the two within "
                      f"{cs.TPS_FIRST_REL} of each other)", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tp_ssm_first.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
