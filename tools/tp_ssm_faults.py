"""Planted faults in ``chip_smoke.py``'s phase tp-ssm: what its train
limits read when the split over ``model`` is wrong, on one card.

    python3 tools/tp_ssm_faults.py

Builds the attention kernels, runs phase tp-ssm's one-process float32
train references (``chip_smoke.TPS_TRAIN``: mamba2-1.3b x4, zamba2-7b x6 at
every width), then, for each fault, two ranks on the card train both
models at (data 1, model 2) as the phase does, with the fault planted in
each rank's process:

* ``w_b not partial``: ``blocks/ssm/w_b`` left out of the split's partial
  leaves, so its gradient (from the rank's heads only) is not summed over
  ``model``;
* ``norm backward``: the gated norm's sum of squares through
  ``tp.reduce_from_model`` (an all-reduce in the forward only) in place of
  ``tp.sum_over_model``.

Prints each rank's readings (losses, grad norms, the furthest leaf's first
moments, the forward logits) against the phase's limits, writes them to
``chiprun_out/tp_ssm_faults.json`` and exits 0 only if every fault fails
the limits on every rank.
"""

import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

FAULTS = ("w_b not partial", "norm backward")


def plant(fault: str) -> None:
    """Plant ``fault`` in this process's ``repro_torch.sharding.tp``."""
    from repro_torch.sharding import tp

    if fault == "w_b not partial":
        real = tp.plan_split

        def plan_split(*args, **kw):
            sp = real(*args, **kw)
            return sp if sp is None else dataclasses.replace(
                sp, partial=sp.partial - {tp.SSM + "w_b"})

        tp.plan_split = plan_split
    elif fault == "norm backward":
        tp.sum_over_model = tp.reduce_from_model
    else:
        raise ValueError(fault)


def child(rank: int, world: int, tmp: str, fault: str, device: str) -> None:
    """One rank: ``fault`` planted, then phase tp-ssm's train jobs."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    plant(fault)
    cs.tp_child(rank, world, tmp, [("train", (1, 2), a, n)
                                   for a, n in cs.TPS_TRAIN], device)


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.kernels import build

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
    limits = dict(loss=cs.TP_LOSS_RTOL, grad_norm=cs.TP_GNORM_RTOL,
                  first=cs.TPS_FIRST_REL, logits=cs.TP_LOGIT_REL)
    out = {"card": card, "limits": limits, "faults": {}}
    caught = True
    with tempfile.TemporaryDirectory(prefix="mafia-tps-faults-") as tmp:
        refs = {a: cs.tp_train_ref(dev, tmp, a, n) for a, n in cs.TPS_TRAIN}
        for i, fault in enumerate(FAULTS):
            sub = os.path.join(tmp, f"fault{i}")       # a store of its own
            os.makedirs(sub)
            for name in os.listdir(tmp):
                if name.startswith("tp_ref_"):
                    os.symlink(os.path.join(tmp, name), os.path.join(sub, name))
            mp.spawn(child, args=(2, sub, fault, str(dev)), nprocs=2,
                     join=True)
            rows = out["faults"][fault] = []
            for arch, layers in cs.TPS_TRAIN:
                for r in range(2):
                    got = torch.load(os.path.join(
                        sub, f"tp_train_{(1, 2)}_{arch}_{layers}_{r}.pt"),
                        weights_only=False)
                    rd = cs.tp_train_reading(got, refs[arch])
                    over = [k for k in limits if (rd[k][1] if k == "first"
                                                  else rd[k]) > limits[k]]
                    caught &= bool(over)
                    rows.append(dict(arch=arch, layers=layers, rank=r,
                                     **rd, over=over))
                    print(f"  {fault}: {arch} x{layers} rank {r}: losses "
                          f"{rd['loss']:.3g} off (limit {limits['loss']}), "
                          f"grad norms {rd['grad_norm']:.3g} (limit "
                          f"{limits['grad_norm']}), first moments "
                          f"{rd['first'][1]:.3g} at {rd['first'][0]} (limit "
                          f"{limits['first']}), logits {rd['logits']:.3g} "
                          f"(limit {limits['logits']}); over the limit: "
                          f"{over or 'none'}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tp_ssm_faults.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"every fault caught: {caught} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
