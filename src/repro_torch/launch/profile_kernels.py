"""Time the two split kernels on the card under other plans than their own.

    PYTHONPATH=src python -m repro_torch.launch.profile_kernels

Decode attention at qwen2.5-3b's decode shape (B 8, S 2048, H 16, KV 2,
dh 128), float32 and bfloat16, at the lengths of ``chip_smoke.py``'s last
served decode step, at full caches and with every length 1, for chunks of
32 to 2048 keys (``plan_decode`` picks 32); spmv on bonsai/curet-m's Zx
(24 × 610) and on a 4096² weight keeping 10 % of its 128² tiles, batch 64,
for every split count up to the tile slots (``plan_spmv`` picks by its
wave rule).  Each line gives the device time of each kernel of a call,
from a ``torch.profiler`` trace of 50 calls, per call.  Needs a card; it
exits with 1 without one.
"""

from __future__ import annotations

import subprocess
import sys
from unittest import mock

import numpy as np
import torch

SERVED_LENS = [905, 689, 562, 319, 357, 88, 122, 63]
CHUNKS = (32, 64, 128, 256, 2048)


def device_parts(fn, reps: int = 50) -> dict[str, float]:
    """Device ms per call of each kernel (and copy) ``fn`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts: dict[str, float] = {}
    for e in p.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0].split("<")[0].replace("void ", "")
            parts[name] = parts.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return parts


def _fmt(parts: dict[str, float]) -> str:
    return ", ".join(f"{k} {v:.5f}" for k, v in parts.items()) + \
        f"; total {sum(parts.values()):.5f} ms"


def profile_decode(dev: torch.device) -> None:
    from repro_torch.kernels import decode_attention as da

    planned = da.plan_decode
    for dt in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
                   for s in ((8, 16, 128), (8, 2048, 2, 128), (8, 2048, 2, 128)))
        for name, lens in (("served", SERVED_LENS), ("full", [2048] * 8),
                           ("every length 1", [1] * 8)):
            for chunk in CHUNKS:
                def plan(B, KV, G, S, dh, dtype, sms=132, chunk=chunk):
                    p = planned(B, KV, G, S, dh, dtype, sms)
                    return da.DecodePlan(chunk, -(-S // chunk), p.warps, p.rows)
                with mock.patch.object(da, "plan_decode", plan):
                    parts = device_parts(
                        lambda: da.decode_attention(q, k, v, lens, round_p=False))
                print(f"decode_attention {str(dt)[6:]} {name} lens, chunk "
                      f"{chunk}: {_fmt(parts)}", flush=True)


def profile_spmv(dev: torch.device) -> None:
    from repro_torch.configs.classical import build
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmv as sp

    zx = next(np.asarray(n.params["matrix"], np.float32)
              for n in build("bonsai/curet-m")[0].nodes.values() if n.id == "Zx")
    g = torch.Generator(device=dev).manual_seed(6)
    w = torch.randn((4096, 4096), generator=g, device=dev)
    keep = torch.rand((32, 32), generator=g, device=dev) < 0.1
    w = (w * keep.repeat_interleave(128, 0).repeat_interleave(128, 1)).cpu().numpy()
    planned = sp.plan_spmv
    for label, wn in (("Zx (24, 610)", zx), ("(4096, 4096) at 10 %", w)):
        packed = ops.pack_bcsr(wn, device=dev)
        x = torch.randn((64, wn.shape[1]), generator=g, device=dev)
        own = planned(64, packed.m, packed.bm, packed.j_max)
        for splits in range(1, packed.j_max + 1):
            def plan(B, m, bm, j_max, sms=132, splits=splits):
                p = planned(B, m, bm, j_max, sms)
                return sp.SpmvPlan(p.batch_tiles, p.slices, splits)
            with mock.patch.object(sp, "plan_spmv", plan):
                parts = device_parts(lambda: ops.spmv(packed, x))
            mark = " (the plan's)" if splits == own.splits else ""
            print(f"spmv {label} B=64, {splits} splits{mark}: {_fmt(parts)}",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    profile_decode(dev)
    profile_spmv(dev)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
