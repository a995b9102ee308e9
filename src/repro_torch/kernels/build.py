"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled for ``sm_90a`` with ``nvcc`` into a
shared library with a plain C interface under ``build/kernels/``, named by
the digest of its source and of the headers in ``csrc/`` (so an edited
source or header never reuses a stale build), and loaded with ``ctypes``.
No fast math: the kernels use ``expf``/``tanhf`` and round as the plain
versions do.  Builds start only when a kernel is first launched on a card
(or when :func:`build` is called); importing this module builds nothing.

``LAUNCHES`` counts each kernel's launches by name, where its wrapper
launches it and nowhere else.  :func:`note_kernel` hands the work of a
kernel call (:class:`Work`, a function of its shapes) to every analysis
that listens (:mod:`repro_torch.launch.op_analysis`): a wrapper calls it
where it launches its kernel, and on meta tensors where it returns the
kernel's empty outputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterable

import torch

__all__ = ["SOURCES", "LAUNCHES", "BUILD_LOG", "BUILD_SECONDS", "BUILD_DIR",
           "STAGE_CODES", "UNARY_CODES", "DTYPE_CODES", "build", "load",
           "segment_cache", "check_launch", "Work", "note_kernel",
           "LISTENERS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("megakernel", "linear_chain", "spmv", "gemv", "flash_attention",
           "decode_attention")

LAUNCHES: dict[str, int] = {"megakernel": 0, "linear_chain": 0,
                            "linear_chain_q": 0, "spmv": 0, "matmul": 0,
                            "matmul_wgmma": 0, "flash_attention": 0,
                            "flash_attention_wgmma": 0,
                            "flash_attention_bwd": 0,
                            "flash_attention_bwd_wgmma": 0,
                            "decode_attention": 0}
BUILD_LOG: list[str] = []             # nvcc's -Xptxas -v report of each build
BUILD_SECONDS: dict[str, float] = {}  # wall seconds of each build this process

# The codes of csrc/fixed_point.cuh, shared by the packed tables of the
# megakernel and of the chain kernels.
STAGE_CODES = {"scalar_mul": 0, "add_vec": 1, "sub_vec": 2, "hadamard_vec": 3,
               "tanh": 4, "sigmoid": 5, "relu": 6, "exp": 7, "add_arr": 8,
               "sub_arr": 9, "hadamard_arr": 10, "q_scalar_mul": 16,
               "q_add_vec": 17, "q_sub_vec": 18, "q_hadamard_vec": 19,
               "q_add_arr": 20, "q_sub_arr": 21, "q_hadamard_arr": 22,
               "q_unary": 23}
UNARY_CODES = {"tanh": 0, "sigmoid": 1, "relu": 2, "exp": 3}
DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.int8: 2, torch.int16: 3}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"libmafia_{name}_{h.hexdigest()[:16]}.so"


def _nvcc(name: str, out: Path) -> None:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: the CUDA kernel {name!r} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu ({res.returncode}):\n{res.stderr}")
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG.append(f"{name}.cu:\n{res.stderr.strip()}")
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> dict[str, Path]:
    """Build the named sources that have no library yet, one ``nvcc`` per
    source, all started together.  Returns each library's path."""
    paths = {n: _library_path(n) for n in names}
    todo = [n for n, p in paths.items() if not p.exists()]
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            for f in [pool.submit(_nvcc, n, paths[n]) for n in todo]:
                f.result()
    return paths


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed and loaded once;
    ``declare`` sets its functions' ``argtypes``/``restype``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            declare(lib)
            _LIBS[name] = lib
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise on the ``cudaGetLastError()`` a launch function returned;
    count the launch otherwise."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


@dataclass(frozen=True)
class Work:
    """What one kernel call computes and moves: ``flops`` of its products,
    ``bytes`` of its operands read and its results written once each,
    ``transcendentals`` (its exponentials)."""

    flops: float
    bytes: float
    transcendentals: float = 0.0


# the analyses listening for kernel calls (op_analysis.analyze), innermost
# last; empty outside an analysis, so a wrapper pays one test of a list
LISTENERS: list[Callable[[str, Work], None]] = []


def note_kernel(name: str, work: Callable[..., Work], *args: Any) -> None:
    """Hand ``work(*args)``, one call of kernel ``name`` (its ``LAUNCHES``
    key), to every listening analysis; nothing (not even the work) where
    none listens."""
    if LISTENERS:
        w = work(*args)
        for listen in LISTENERS:
            listen(name, w)


_CACHE: dict[tuple[str, int, Any], Any] = {}


def segment_cache(kind: str, owner: Any, device: torch.device,
                  make: Callable[[], Any]) -> Any:
    """``make()`` once per (``kind``, ``owner``, device), kept until
    ``owner`` is collected: the one lifetime rule for device data derived
    from a compiled object (a segment's or a chain's pack, the plain
    version's pools)."""
    key = (kind, id(owner), device)
    hit = _CACHE.get(key)
    if hit is None:
        hit = _CACHE[key] = make()
        oid = id(owner)
        weakref.finalize(owner, lambda: [_CACHE.pop(k, None)
                                         for k in list(_CACHE) if k[1] == oid])
    return hit
