"""Plan interpreter — runs a static :class:`ExecutionPlan` with PyTorch.

:mod:`repro_torch.core.lowering` runs the compile-time pass pipeline once and
emits the plan; :func:`build_callable` is a thin interpreter over it, in one
of three lanes:

* ``"interpret"`` — walk the step list, one template call per step (the
  oracle the other lanes are held against); a plan lowered with
  ``use_pallas=True`` carries fused §IV-G stage chains
  (:class:`~repro_torch.core.lowering.ChainStep`), each one launch of the
  CUDA chain kernel (:mod:`repro_torch.kernels.linear_pipeline`, float or
  fixed-point variant) — for the whole bucket on the batched lane;
* ``"megakernel"`` — run the linearize pass's
  :class:`~repro_torch.kernels.megakernel.MegakernelProgram`: each segment
  is one launch of the CUDA megakernel per sample; steps without an ISA
  encoding run as interpreted islands;
* ``"megakernel_grid"`` — same stream, but the batched lane puts the whole
  bucket on the kernel's grid: one launch per segment per bucket.

:func:`execute` stays the *unplanned* numeric oracle: a direct per-node walk
with the float templates.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import node_types
from repro_torch.core.device import as_tensor, resolve_device
from repro_torch.core.dfg import DFG
from repro_torch.core.lowering import (
    ChainStep,
    ExecutionPlan,
    NodeStep,
    _resolve,
    lower,
)
from repro_torch.kernels.linear_pipeline import Chain, run_chain

__all__ = ["build_callable", "execute"]


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is contiguous, else a contiguous copy."""
    return t if t.is_contiguous() else t.contiguous()


def build_callable(
    dfg: DFG,
    *,
    fused_clusters: list[list[str]] | None = None,
    use_pallas: bool = False,
    batch: bool = False,
    precision: str = "float32",
    qplan: Any | None = None,
    plan: ExecutionPlan | None = None,
    mode: str = "interpret",
    device: torch.device | str | None = None,
) -> Callable[..., dict[str, Any]]:
    """Compile the DFG into ``f(**graph_inputs) -> {output: tensor}``.

    Without a pre-built ``plan`` the lowering pipeline runs here.  With
    ``batch`` every graph input (and output) carries a leading batch axis.
    ``precision="int8"``/``"int16"`` runs the DFG in fixed point from a
    ``qplan``; the interface stays float in / float out.  ``mode`` selects
    the lane (see the module docstring).  ``device`` is where the values
    live; None means the card.
    """
    if plan is None:
        plan = lower(dfg, fused_clusters=fused_clusters, use_pallas=use_pallas,
                     precision=precision, qplan=qplan)
    return _interpret(plan, batch=batch, mode=mode, device=device)


def _interpret(
    plan: ExecutionPlan, *, batch: bool = False, mode: str = "interpret",
    device: torch.device | str | None = None,
) -> Callable[..., dict[str, Any]]:
    """Thin interpreter over a static plan (per-sample or batched lane)."""
    if mode not in ("interpret", "megakernel", "megakernel_grid"):
        raise ValueError(f"unknown execution mode {mode!r}")
    dev = resolve_device(device)
    mk = mode in ("megakernel", "megakernel_grid")
    grid = mode == "megakernel_grid" and batch
    quantized = plan.precision != "float32"
    if quantized:
        from repro_torch.core import quantize as quantize_mod
    if mk:
        if plan.megakernel is None:
            raise ValueError(
                "plan has no megakernel program — it predates the linearize "
                "pass; re-lower the DFG (lower()/MafiaCompiler.compile())")
        from repro_torch.kernels.megakernel import run_segment, run_segment_grid
    allowed = set(plan.dfg.graph_inputs)
    bits = plan.bits or 8
    out_refs = {out: _resolve(plan.alias, out) for out in plan.outputs}
    # one Chain per ChainStep: its static operands reach the device once
    # per program, not once per call
    chains = {id(s): Chain(s.stages, s.vecs, s.quantized, bits)
              for s in plan.steps if isinstance(s, ChainStep)}

    def exec_step(step: NodeStep | ChainStep, env: dict[str, Any],
                  bdim: int | None) -> None:
        """Execute one plan step into ``env`` (the interpret walk and the
        megakernel lanes' interpreted islands)."""
        if isinstance(step, ChainStep):
            # one chain launch: the whole bucket on the batched lane, one
            # row per sample; only the terminal is materialized
            val = run_chain(chains[id(step)], _dense(env[step.stream]),
                            [_dense(env[r]) for r in step.extras])
            for nid in step.dead:
                env[nid] = None
            env[step.terminal] = val
            return
        args = [env[r] for r in step.inputs]
        if batch and not step.inputs:
            # zero-input node (const): one value, broadcast over the bucket
            val = step.fn().to(dev)
            env[step.nid] = (val if bdim is None
                             else val.expand((bdim,) + tuple(val.shape)))
        elif batch:
            env[step.nid] = torch.func.vmap(step.fn)(*args)
        else:
            out = step.fn(*args)
            env[step.nid] = out.to(dev) if not args else out

    def exec_segment(seg: Any, env: dict[str, Any], bdim: int | None) -> None:
        """Run one megakernel segment and publish its stored refs."""
        args = [env[r].contiguous() for r in seg.in_refs]
        if batch and args:
            if grid:
                # the bucket rides the kernel's grid: one launch per bucket
                outs = run_segment_grid(seg, args)
            else:
                # per-sample launches (the same kernel at nb = 1), stacked
                per = [run_segment(seg, [a[i] for a in args])
                       for i in range(bdim)]
                outs = [torch.stack([p[j] for p in per])
                        for j in range(len(seg.out_refs))]
            for i, r in enumerate(seg.out_refs):
                env[r] = outs[i].reshape((bdim,) + tuple(seg.out_shapes[i]))
        else:
            outs = run_segment(seg, args, device=dev)
            for i, r in enumerate(seg.out_refs):
                val = outs[i].reshape(tuple(seg.out_shapes[i]))
                if batch and bdim is not None:
                    val = val.expand((bdim,) + tuple(val.shape))
                env[r] = val

    def run(**inputs: Any) -> dict[str, Any]:
        unknown = set(inputs) - allowed
        if unknown:
            raise TypeError(f"unknown graph inputs: {sorted(unknown)}")
        missing = allowed - set(inputs)
        if missing:
            raise TypeError(f"missing graph inputs: {sorted(missing)}")
        env: dict[str, Any] = {k: as_tensor(v, dev) for k, v in inputs.items()}
        if quantized:
            env = {k: quantize_mod.quantize_t(v.to(torch.float32),
                                              plan.input_exps[k], bits)
                   for k, v in env.items()}
        bdim = next((int(v.shape[0]) for v in env.values()), None) if batch else None

        with torch.no_grad():
            if mk:
                for kind, payload in plan.megakernel.items:
                    if kind == "seg":
                        exec_segment(payload, env, bdim)
                    else:   # interpreted island: a step with no ISA encoding
                        exec_step(plan.steps[payload], env, bdim)
            else:
                for step in plan.steps:
                    exec_step(step, env, bdim)

        if quantized:
            return {
                out: env[ref] if plan.output_exps[out] is None
                else quantize_mod.dequantize(env[ref], plan.output_exps[out])
                for out, ref in out_refs.items()
            }
        return {out: env[ref] for out, ref in out_refs.items()}

    return run


def execute(dfg: DFG, *, device: torch.device | str | None = None,
            **inputs: Any) -> dict[str, Any]:
    """One-shot reference execution — the *unplanned* numeric oracle: a
    direct per-node walk with the float templates (no lowering, no fusion)."""
    dfg.validate()
    missing = set(dfg.graph_inputs) - set(inputs)
    if missing:
        raise TypeError(f"missing graph inputs: {sorted(missing)}")
    dev = resolve_device(device)
    env: dict[str, Any] = {k: as_tensor(v, dev) for k, v in inputs.items()}
    with torch.no_grad():
        for nid in dfg.topo_order():
            node = dfg.nodes[nid]
            spec = node_types.get(node.op)
            env[nid] = spec.fn([env[s] for s in node.inputs], node.params,
                               node.dims).to(dev)
    return {out: env[out] for out in dfg.outputs}
