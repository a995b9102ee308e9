"""Planted faults in the rounded-p flash backward's argmax share: what
``chip_smoke.py``'s phase 10 reads when a kernel loses it, on one card.

    python3 tools/rounded_bwd_faults.py

Builds ``csrc/flash_attention.cu`` as it is and with each fault planted
(``profile_kernels._patched_build``), all three at once:

* ``dk share``: the dkdv kernels leave out each row's argmax share, as
  they would where their S^T = k.q^T is not bitwise the dq kernel's
  S = q.k^T at the row's max;
* ``detached max``: the dq kernel leaves it out too (the gradient of a
  row max held constant).

With each build, at qwen2.5-3b's heads (``fbt_dkdv_kernel``) and MLA's
(``fbt_dkdv2_kernel``), bfloat16, S ``FLASH_BWD_S``, the backward with p
rounded to bfloat16 on the tensor cores, on phase 10's inputs: the max
abs error of dq, dk and dv against the plain version in bf16 ulps of each
one's largest (phase 10's limit is ``FLASH_BWD_BF16_ULPS``) and each
gradient's share of the way towards each fault (``FLASH_BWD_FAULT_SHARE``);
and on one-hot attention (``profile_kernels.argmax_inputs``) dq and dk
against the shares' size (``FLASH_BWD_ARGMAX_REL``).  Prints them, writes
them to ``chiprun_out/rounded_bwd_faults.json`` and exits 0 only if the
build as it is passes both checks and each fault fails both.
"""

import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

# csrc/flash_attention.cu's lines that add the share, and what each fault
# puts in their place
_DKDV = (("            if (sc[i] == L) d += Ds[2 * FBT_RM + col];\n", ""),
         ("(p < 0.0f ? Ds[2 * RS + col] : 0.0f)", "0.0f"))
FAULTS = {"dk share": _DKDV,
          "detached max": _DKDV + (("        if (sc[i] == mr[h]) d += share[h];\n",
                                    ""),)}
HEADS = ((16, 2, 128), (128, 128, 192))


def readings(dev) -> list[dict]:
    """The checks of the library installed now, at each of ``HEADS``."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    from repro_torch.launch.profile_kernels import (argmax_inputs, fault_shares,
                                                    rounded_bwd_faults)

    bf, S, out = torch.bfloat16, cs.FLASH_BWD_S, []
    for H, KV, dh in HEADS:
        g = torch.Generator(device=dev).manual_seed(H * 1000 + dh + 7)  # phase 10's
        q, go = (torch.randn((1, S, H, dh), generator=g, device=dev).to(bf)
                 for _ in range(2))
        k, v = (torch.randn((1, S, KV, dh), generator=g, device=dev).to(bf)
                for _ in range(2))
        if dh == 192:
            v[..., 128:] = 0
            go[..., 128:] = 0
        want = flash_attention_bwd_ref(q, k, v, go, round_p=bf)
        rounded, faults = rounded_bwd_faults(q, k, v, go)
        got = fa.flash_attention_bwd(q, k, v, go, round_p=bf)
        ulps = {n: float((a.float() - b.float()).abs().max())
                / 2.0 ** (math.floor(math.log2(float(b.float().abs().max()))) - 7)
                for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        shares = fault_shares(got[:3], rounded, faults)
        nearer = any(x and x[1] <= cs.FLASH_BWD_FAULT_NOISE
                     and x[0] > cs.FLASH_BWD_FAULT_SHARE
                     for s in shares.values() for x in s.values())
        del q, k, v, go, want, rounded, faults, got
        q, k, v, go = argmax_inputs(S, H, KV, dh, bf, dev, seed=H + dh,
                                    dhv=128 if dh == 192 else None)
        size = [float(t.abs().max()) for t in
                rounded_bwd_faults(q, k, v, go)[1]["detached max"][:2]]
        got = fa.flash_attention_bwd(q, k, v, go, round_p=bf)
        onehot = [float(a.float().abs().max()) / z for a, z in zip(got[:2], size)]
        out.append(dict(heads=[H, KV, dh], ulps=ulps, shares=shares,
                        nearer_a_fault=nearer, one_hot=onehot,
                        one_hot_off=max(onehot) > cs.FLASH_BWD_ARGMAX_REL))
        del q, k, v, go, got
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.profile_kernels import _patched_build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(FAULTS) + 1) as pool:
        built = pool.submit(build.build, ("flash_attention",))
        planted = {f: pool.submit(_patched_build, "flash_attention", patches,
                                  f.replace(" ", "_"))
                   for f, patches in FAULTS.items()}
        built.result()
        libs = {f: p.result() for f, p in planted.items()}
    print(f"built as it is and with {len(FAULTS)} faults in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rec, ok = {}, True
    for name in ("as built",) + tuple(FAULTS):
        build._LIBS.pop("flash_attention", None)
        if name != "as built":
            fa._declare(libs[name])
            build._LIBS["flash_attention"] = libs[name]
        rec[name] = readings(dev)
        for r in rec[name]:
            caught = r["nearer_a_fault"] and r["one_hot_off"]
            ok = ok and (caught if name in FAULTS else
                         not (r["nearer_a_fault"] or r["one_hot_off"]))
            print(f"  {name}, heads {r['heads']}: max abs err in bf16 ulps of "
                  f"each largest " + ", ".join(f"{n} {x:.2f}" for n, x in
                                              r["ulps"].items())
                  + f" (limit {cs.FLASH_BWD_BF16_ULPS}); towards each fault "
                  + "; ".join(f"{f} " + ", ".join(
                      f"{n} {x[0]:.4f}" for n, x in s.items() if x)
                      for f, s in r["shares"].items())
                  + f" (limit {cs.FLASH_BWD_FAULT_SHARE}); one-hot dq, dk "
                  + ", ".join(f"{x:.3g}" for x in r["one_hot"])
                  + f" of the shares' largest (limit {cs.FLASH_BWD_ARGMAX_REL})"
                  + ("" if name == "as built" else
                     "; caught" if caught else "; NOT CAUGHT"), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rounded_bwd_faults.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"ok": ok, "seconds": time.perf_counter() - t0}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
