"""The float32 backward with p rounded to bfloat16, as the tensor cores
would compute it, emulated with exact sums on ``chip_smoke.py``'s phase 10
inputs, against the plain version: how far fp16-term products whose only
difference from the plain version is their order and precision lie from
it, on one card.

    python3 tools/rounded_f32_emulation.py

The float32 route on the tensor cores splits each operand into two fp16
terms scaled by a power of two (``csrc/flash_attention.cu`` point 2).
Here, at qwen2.5-3b's, MLA's and zamba2-7b's heads, float32, S
``FLASH_BWD_S``, causal, on phase 10's inputs (its seeds, v rounded to
bfloat16, MLA's v and g zero past 128), the rounded-p gradient (point 6:
the row's raw max m, l, dp~ = r(dP / l), D and the argmax share from the
rounding residuals, ds = p (dp~ - D / l) + the share) with every product
taken as the sum of its terms' pairs hi.hi + hi.mid + mid.hi summed
exactly in float64 and rounded once to float32, a head at a time; beside
it ``flash_attention_bwd`` on ``fb_*``, whose sums follow the plain
version's order.  Prints each one's max abs error of dq, dk and dv of
each one's largest against the plain version (phase 10 holds float32 at
``FLASH_BWD_ROUNDED_REL``) and writes them to
``chiprun_out/rounded_f32_emulation.json``.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def pow2(m):
    """2^s bringing the largest magnitude ``m`` into [2^13, 2^14), as the
    float32 route's split scales its terms."""
    import torch

    m = m.to(torch.float32)
    e = ((m.view(torch.int32) >> 23) & 0xFF) - 127
    return torch.ldexp(torch.ones_like(m), torch.clamp(13 - e, max=126))


def terms(x, c):
    """Two fp16 terms of ``c x`` (what the first left), divided by ``c``."""
    import torch

    out, y = [], x * c
    for _ in range(2):
        t = y.to(torch.float16).float()
        out.append(t / c)
        y = y - t
    return out


def emulate(q, k, v, g):
    """dq, dk, dv of one group of heads (k and v expanded over G)."""
    import torch

    dev, bf = q.device, torch.bfloat16
    S, d = q.shape[1], q.shape[3]
    scale = torch.tensor(d ** -0.5, dtype=torch.float32, device=dev)
    sl2 = scale * torch.tensor(1.4426950408889634, dtype=torch.float32, device=dev)
    qh, gh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, g, k, v))

    def prod(a, b, bt=True):
        ta = terms(a, pow2(a.abs().amax(-1, keepdim=True) if not bt else a.abs().max()))
        tb = terms(b, pow2(b.abs().max()))
        return sum(ta[i].double() @ (tb[j].double().transpose(-1, -2) if bt
                                     else tb[j].double())
                   for i in range(2) for j in range(2) if i + j < 2).float()

    hid = torch.arange(S, device=dev)[None, :] > torch.arange(S, device=dev)[:, None]
    s = prod(qh, kh).masked_fill(hid, -1e30)
    m = s.amax(-1, keepdim=True)
    p = (s.double() * sl2.double() - (m * sl2).double()).float().exp2()
    p = p.masked_fill(hid, 0.0)
    l = p.sum(-1, keepdim=True)
    x = prod(gh, vh) * (1.0 / l)
    rp, rx = p.to(bf).float(), x.to(bf).float()
    tie = (s == m) & ~hid
    D = (rp * x).masked_fill(hid, 0.0).sum(-1, keepdim=True)
    e = ((rp - p) * x + p * (x - rx)).masked_fill(hid, 0.0).sum(-1, keepdim=True)
    ds = (p * (rx - D / l)).masked_fill(hid, 0.0) + tie * (e / tie.sum(-1, keepdim=True))
    dq = (prod(ds, kh, bt=False) * scale).permute(0, 2, 1, 3)
    dk = (prod(ds.transpose(-1, -2), qh, bt=False) * scale).permute(0, 2, 1, 3)
    dv = prod((rp / l).transpose(-1, -2), gh, bt=False).permute(0, 2, 1, 3)
    return dq, dk, dv


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
        return 1
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf, S, rec = torch.device("cuda"), torch.bfloat16, cs.FLASH_BWD_S, []
    for H, KV, dh in cs.ROUNDED_HEADS:
        g = torch.Generator(device=dev).manual_seed(H * 1000 + dh + 7)  # phase 10's
        q, go = (torch.randn((1, S, H, dh), generator=g, device=dev) for _ in range(2))
        k, v = (torch.randn((1, S, KV, dh), generator=g, device=dev) for _ in range(2))
        v = v.to(bf).float()
        if dh == 192:
            v[..., 128:] = 0
            go[..., 128:] = 0
        want = flash_attention_bwd_ref(q, k, v, go, round_p=bf)[:3]
        G = H // KV
        kx, vx = (t.repeat_interleave(G, dim=2) for t in (k, v))
        parts = [emulate(q[:, :, h:h + 8], kx[:, :, h:h + 8], vx[:, :, h:h + 8],
                         go[:, :, h:h + 8]) for h in range(0, H, 8)]
        emu = [torch.cat([x[i] for x in parts], 2) for i in range(3)]
        emu[1:] = [t.reshape(1, S, KV, G, dh).sum(3) for t in emu[1:]]
        row = dict(heads=[H, KV, dh])
        for name, got in (("emulated tensor cores", emu),
                          ("fb_*", flash_attention_bwd(q, k, v, go, round_p=bf)[:3])):
            row[name] = {n: float((a - b).abs().max() / b.abs().max())
                         for n, a, b in zip(("dq", "dk", "dv"), got, want)}
            print(f"  float32 S={S} H={H} KV={KV} dh={dh} p rounded to bfloat16, "
                  f"{name}: max abs err " + ", ".join(
                      f"{n} {x:.3g}" for n, x in row[name].items())
                  + f" of each largest (phase 10's limit "
                  f"{cs.FLASH_BWD_ROUNDED_REL})", flush=True)
        rec.append(row)
        del q, k, v, go, want, kx, vx, parts, emu
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rounded_f32_emulation.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
