"""Phase lm-train's ``attn_probs_bf16`` twin: how far the rounded-p
gradient's two float32 evaluations, the kernels and the plain version, lie
from each other and from the same function in float64, on one card.

    python3 tools/probs_bf16_f64.py

The cell is phase lm-train's float32 twin (``chip_smoke.LM_TRAIN_LAYERS``
layers of qwen2.5-3b at every width, S ``chip_smoke.LM_TRAIN_S``, batch 2,
seed 0) with ``attn_probs_bf16`` on:

* every leaf's first gradient with the attention's kernels against the
  same with its plain version, each leaf's largest distance as a share of
  its largest magnitude, the furthest leaves first (the twin holds these
  within ``chip_smoke.FLASH_BWD_BF16_ULPS`` bf16 ulps of the largest);
* the inputs and output gradient of each layer's attention in the kernels'
  run, and on them the rounded-p backward on the kernels
  (``flash_attention_bwd(..., round_p=torch.bfloat16)``), the plain
  version's (``kernels.ref.flash_attention_bwd_ref``) and the function in
  float64 (scores, p, l and P·V in float64, p and the cotangent of P·V's p
  rounded to bfloat16 as the function defines them, autograd), each pair's
  distance as a share of the float64 gradient's largest magnitude.

Prints both; writes them to ``chiprun_out/probs_bf16_f64.json``.
"""

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def rounded_float64(q, k, v, g):
    """dq, dk, dv of causal attention whose P·V takes p = e^(s - m)
    rounded to bfloat16 (m the row max), all in float64 but the two
    roundings the function makes: p, and the cotangent of the rounded p."""
    import torch

    B, S, H, dh = q.shape
    KV = k.shape[2]
    qq, kk, vv = (t.double().requires_grad_(True) for t in (q, k, v))
    qg = (qq * dh ** -0.5).reshape(B, S, KV, H // KV, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kk)
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = (torch.einsum("bkgqs,bskd->bkgqd", p.to(torch.bfloat16).double(), vv)
           / p.sum(-1, keepdim=True))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh)
    return torch.autograd.grad(out, (qq, kk, vv), g.double())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a card (torch.cuda.is_available() is False)")
        return 1
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import PipelineState, TokenPipeline
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    from repro_torch.models import attention as ma
    from repro_torch.models.transformer import _leaves, lm_loss
    from repro_torch.train.train_loop import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    kb.build(("flash_attention",))
    dev, bf = torch.device("cuda"), torch.bfloat16
    print(cs.card_line(), flush=True)
    L, S = cs.LM_TRAIN_LAYERS, cs.LM_TRAIN_S
    cfg = dataclasses.replace(get_arch(cs.LM_ARCH).model, n_layers=L,
                              act_dtype="float32", attn_probs_bf16=True)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=S)
    tokens = pipe.batch_at(PipelineState(step=0))[0]["tokens"]
    model, _ = init_state(cfg, 0, device=dev)
    weights = [t for ts in _leaves(model).values() for t in ts]

    calls = []
    train = ma.flash_attention_train

    def spy(q, k, v, **kw):
        out = train(q, k, v, **kw)
        rec = dict(q=q.detach().clone(), k=k.detach().clone(),
                   v=v.detach().clone())
        out.register_hook(lambda g, rec=rec: rec.__setitem__("g", g.detach().clone()))
        calls.append(rec)
        return out

    ma.flash_attention_train = spy
    try:
        kernels = torch.autograd.grad(lm_loss(model, tokens), weights)
    finally:
        ma.flash_attention_train = train
    plain = torch.autograd.grad(lm_loss(model, tokens, plain_attention=True),
                                weights)
    leaves, i = [], 0
    for path, ts in _leaves(model).items():
        a = torch.stack(kernels[i:i + len(ts)]).float()
        b = torch.stack(plain[i:i + len(ts)]).float()
        i += len(ts)
        top = float(b.abs().max())
        leaves.append(dict(leaf=path, share=float((a - b).abs().max()) / top,
                           largest=top))
    leaves.sort(key=lambda r: -r["share"])
    for r in leaves:
        print(f"  leaf {r['leaf']}: kernels against plain {r['share']:.3g} of "
              f"{r['largest']:.3g}", flush=True)
    rows = []
    for n, rec in enumerate(c for c in calls if "g" in c):
        q, k, v, g = rec["q"], rec["k"], rec["v"], rec["g"]
        kern = flash_attention_bwd(q, k, v, g, round_p=bf)[:3]
        ref = flash_attention_bwd_ref(q, k, v, g, round_p=bf)[:3]
        f64 = rounded_float64(q, k, v, g)
        torch.cuda.synchronize()
        for name, x, y, z in zip(("dq", "dk", "dv"), kern, ref, f64):
            top = float(z.abs().max())
            row = dict(layer=n, grad=name, largest=top,
                       kernels_plain=float((x - y).abs().max()) / top,
                       kernels_f64=float((x.double() - z).abs().max()) / top,
                       plain_f64=float((y.double() - z).abs().max()) / top)
            rows.append(row)
            print(f"  layer {n} {name}: kernels against plain "
                  f"{row['kernels_plain']:.3g}, kernels against float64 "
                  f"{row['kernels_f64']:.3g}, plain against float64 "
                  f"{row['plain_f64']:.3g} (of {top:.3g})", flush=True)
        del kern, ref, f64
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probs_bf16_f64.json"), "w") as f:
        json.dump(dict(card=cs.card_line(), leaves=leaves, calls=rows), f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
