"""Public entry points of the port's kernel library.

The same names as the JAX package's ``kernels.ops``: ``spmv``, ``gemv``,
``matmul``, ``linear_chain``, ``linear_chain_q`` and the host packer
``pack_bcsr``.  Each runs its hand-written CUDA kernel on CUDA tensors and
its plain version (:mod:`repro_torch.kernels.ref`) on CPU tensors.

The bridge from MAFIA's §IV-G pipelining decision to the chain kernels is
compile-time analysis in the lowering pipeline (the chain-decompose pass):
its :class:`~repro_torch.core.lowering.ChainStep` programs run through
:func:`linear_chain` / :func:`linear_chain_q`, one launch per chain.
"""

from __future__ import annotations

from repro_torch.kernels import gemv as _gemv_mod
from repro_torch.kernels import spmv as _spmv_mod
from repro_torch.kernels.linear_pipeline import (fused_linear_chain,
                                                 fused_linear_chain_q)

__all__ = [
    "spmv", "gemv", "matmul", "linear_chain", "linear_chain_q", "pack_bcsr",
]

pack_bcsr = _spmv_mod.pack_bcsr
spmv = _spmv_mod.spmv
gemv = _gemv_mod.gemv
matmul = _gemv_mod.matmul
linear_chain = fused_linear_chain
linear_chain_q = fused_linear_chain_q
