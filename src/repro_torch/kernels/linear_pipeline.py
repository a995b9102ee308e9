"""Fused linear-time pipeline — tile budget only.

The reference runs compile-time stage chains (paper §IV-G) through a fused
Pallas kernel.  That kernel is not ported yet: the port's main path runs
every chain member inside the megakernel instead, and
``MafiaCompiler(use_pallas=True)`` raises.  What the compile side still
needs is the kernel's *budget*: :func:`chain_vmem_bytes` prices a chain's
resident footprint for the cost-guided chain splitter
(:func:`repro_torch.core.cost_model.chain_live_bytes`), so the port splits
chains exactly where the reference does.
"""

from __future__ import annotations

__all__ = ["DEFAULT_BB", "DEFAULT_BN", "chain_vmem_bytes", "set_tuned_tiles",
           "tuned_tiles"]

DEFAULT_BB = 256   # batch tile
DEFAULT_BN = 512   # feature tile

# Process-wide tile override (the reference's autotuner installs one);
# tiling never changes per-element arithmetic.
_TUNED: dict[str, int] = {}


def set_tuned_tiles(bb: int | None = None, bn: int | None = None) -> None:
    """Install (or with both None, clear) the process-wide tuned tile sizes
    used when a chain call does not pass ``bb``/``bn`` explicitly."""
    _TUNED.clear()
    if bb is not None:
        _TUNED["bb"] = int(bb)
    if bn is not None:
        _TUNED["bn"] = int(bn)


def tuned_tiles() -> tuple[int, int]:
    """The effective default ``(bb, bn)`` — tuned override or the builtins."""
    return _TUNED.get("bb", DEFAULT_BB), _TUNED.get("bn", DEFAULT_BN)


def chain_vmem_bytes(n: int, n_vec: int, n_arr: int, *,
                     bb: int | None = None, bn: int | None = None,
                     itemsize: int = 4) -> int:
    """Peak bytes one fused-chain launch keeps resident: the stream tile,
    the output tile and one ``(bb, bn)`` tile per ``*_arr`` extra, plus one
    ``(1, bn)`` row per ``*_vec`` operand — the unit of the chain splitter's
    ``chain_split_bytes`` budget."""
    tb, tn = tuned_tiles()
    bb = tb if bb is None else bb
    bn = tn if bn is None else bn
    bn_eff = min(bn, max(128, 1 << max(0, int(n) - 1).bit_length()))
    return (2 + n_arr) * bb * bn_eff * itemsize + n_vec * bn_eff * itemsize
