"""The port stands alone: it imports neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT_FILES = sorted((SRC / "repro_torch").rglob("*.py"))
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(SRC)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    hits = [m.group(0).strip() for m in _IMPORT.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(SRC)} imports {hits}"


_BLOCKED = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    from repro_torch.serve.classical_engine import ClassicalServeEngine

    eng = ClassicalServeEngine("protonn/usps-b", exec_mode="megakernel_grid",
                               max_batch=4, device="cpu")
    x = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    eng.submit(x)
    (req,) = eng.run_to_completion()
    assert 0 <= int(req.pred) < 10
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
                   for m in sys.modules)
    print("served", int(req.pred))
""")


def test_serves_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("served")
