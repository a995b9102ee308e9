"""Target-FPGA resource model — the paper's evaluation board (§V-A).

Xilinx Arty (Artix-7 XC7A35T): 20,800 LUTs, 90 DSP slices, 225 KB on-chip
memory, clocked at 10 MHz.  Memory (BRAM/FF/LUTRAM) is *not* modelled as a
constraint: the paper finds buffering fits comfortably in distributed RAM for
KB-sized models (§IV-B), so — like the paper — we track and report memory but
only *constrain* compute resources (LUT, DSP).
"""

from __future__ import annotations

import dataclasses

__all__ = ["FpgaBudget", "ARTY_A7", "UNO_MCU_CLOCK_HZ"]


@dataclasses.dataclass(frozen=True)
class FpgaBudget:
    name: str
    luts: int
    dsps: int
    onchip_mem_bytes: int
    clock_hz: float

    def cycles_to_us(self, cycles: float) -> float:
        return cycles / self.clock_hz * 1e6


ARTY_A7 = FpgaBudget(
    name="xilinx-arty-a7",
    luts=20_800,
    dsps=90,
    onchip_mem_bytes=225 * 1024,
    clock_hz=10e6,
)

# Arduino Uno (ATmega328P @16 MHz) — the microcontroller baseline of Table I.
UNO_MCU_CLOCK_HZ = 16e6
