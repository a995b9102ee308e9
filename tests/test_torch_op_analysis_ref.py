"""The port's count of a SMOKE step against the reference's: one step of
each SMOKE cell through ``repro.launch.steps.build_cell`` on a one-device
CPU mesh, compiled, into ``repro.launch.hlo_analysis.analyze_hlo``, beside
the port's count of the same step on meta tensors
(``test_torch_op_analysis.port_cost``).

The reference's jnp attention scores every (query, key) pair and masks
after; the port's flash kernels' work leaves the masked pairs out.  So the
reference's flops are compared after its products over the masked pairs
are taken out in closed form: q·kᵀ and p·v over them, in a train step once
in the forward, once in the remat recompute and four products in the
backward.  What is left apart is the two programs' own arithmetic: the
elementwise work around the attention (the reference's masks and softmax
run on every pair), the backward kernel's recompute of the scores (2·dh a
kept pair the reference reads from its recompute), the MLA kernel's
products over v padded to q's width, the decode caches' one-hot rewrite
(the reference's, elementwise over the whole cache) against the port's
indexed write, the SSD scan's two formulations.  Measured here (SMOKE, B
4, S 16, 4 microbatches): the port's flops 0.8245–1.0107 of the
reference's adjusted flops (the lowest mamba2's train step, then zamba2's
decode 0.8566 and train 0.8863; the dense, MoE and MLA cells
0.9190–1.0107, deepseek-v2's train step the one above 1).  Held at
``REF_WINDOW``: the port within 20 % under and 5 % over the adjusted
reference.  Bytes are printed side by side, not held: eager ops and XLA
fusions are different programs.
"""

import dataclasses

import jax
import pytest

from repro.configs.registry import ShapeCell as JShapeCell
from repro.configs.registry import get_arch as j_get_arch
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.steps import build_cell as j_build_cell
from repro_torch.kernels.flash_attention import kept_pairs
from test_torch_op_analysis import B, MICRO, S, _cfg, port_cost

REF_WINDOW = (0.80, 1.05)
ARCHS = ("qwen2.5-3b", "olmoe-1b-7b", "deepseek-v2-236b", "mamba2-1.3b",
         "zamba2-7b", "internvl2-26b")


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def ref_cost(arch: str, kind: str, mesh):
    spec = j_get_arch(arch)
    spec = dataclasses.replace(spec, model=spec.smoke)
    prog = j_build_cell(spec, JShapeCell("count", kind, S, B), mesh,
                        microbatch_override=MICRO)
    return analyze_hlo(prog.lower(mesh).compile().as_text())


def masked_flops(arch: str, kind: str) -> float:
    """The reference's products over the pairs the causal mask drops: q·kᵀ
    over q's width and p·v over v's, per (row, head, attention layer); a
    train step: the forward, the remat recompute and the backward's four
    (dS·K and dSᵀ·Q over q's width, Pᵀ·dO and dO·Vᵀ over v's)."""
    cfg = _cfg(arch, kind)
    if kind == "decode" or not cfg.uses_attention:
        return 0.0
    if cfg.family == "hybrid":
        layers, H = cfg.hybrid_groups, cfg.n_heads
        dq = dv = 2 * cfg.d_model // cfg.n_heads
    else:
        layers, H = cfg.n_layers, cfg.n_heads_eff
        dq = cfg.d_head + (cfg.d_rope if cfg.use_mla else 0)
        dv = cfg.d_head
    masked = S * S - kept_pairs(S, S)
    per_pair = 2 * dq + 2 * dv
    if kind == "train":
        per_pair = 2 * per_pair + 4 * dq + 4 * dv
    return float(layers * B * H * masked * per_pair)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_against_reference(arch, kind, mesh):
    ref = ref_cost(arch, kind, mesh)
    port = port_cost(arch, kind)
    adjusted = ref.flops - masked_flops(arch, kind)
    ratio = port.flops / adjusted
    print(f"{arch} {kind}: flops port {port.flops:.6g}, reference "
          f"{ref.flops:.6g} ({adjusted:.6g} without the masked pairs), "
          f"ratio {ratio:.4f}; bytes port {port.bytes:.6g}, reference "
          f"{ref.bytes:.6g}; transcendentals {port.transcendentals:.6g} / "
          f"{ref.transcendentals:.6g}")
    assert REF_WINDOW[0] <= ratio <= REF_WINDOW[1]
    assert port.products <= port.flops
