"""The port stands alone: it imports neither JAX nor the JAX package.

Every module of ``repro_torch`` is scanned for such imports, and a fresh
interpreter with ``jax``, ``jaxlib`` and ``repro`` blocked serves on the CPU
through the classical engine, the LM engine and the LM launcher, plans a
dry-run cell, trains a step through the launcher on a one-rank gloo mesh,
and loads a program from an artifact store and serves it: the payload
pickles no class of the JAX package."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# the port and the script that runs it on the card
PORT_FILES = (sorted((SRC / "repro_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py"])
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)


def _id(path: Path) -> str:
    return str(path.relative_to(SRC if path.is_relative_to(SRC) else ROOT))


@pytest.mark.parametrize("path", PORT_FILES, ids=[_id(p) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    hits = [m.group(0).strip() for m in _IMPORT.finditer(path.read_text())]
    assert not hits, f"{_id(path)} imports {hits}"


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

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch("qwen2.5-3b").smoke
    lm = ServeEngine(cfg, init_params(cfg, 0, "cpu"), max_batch=2, max_len=32,
                     device="cpu")
    lm.submit([3, 1, 4, 1, 5], max_new_tokens=3)
    (gen,) = lm.run_to_completion()
    assert len(gen.tokens) == 3
    assert launch_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device",
                              "cpu", "--requests", "2", "--max-new", "2"]) == 0

    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train

    rec = dryrun.run_cell("deepseek-v2-236b", "train_4k", multi_pod=True)
    assert rec["status"] == "ok" and rec["arg_bytes_per_device"] > 0, rec
    out = launch_train.run_training(
        "qwen2.5-3b", smoke=True, steps=1, batch=2, seq_len=8, ckpt_dir=None,
        ckpt_every=1, microbatches=1, lr=1e-3, log_every=1, device="cpu",
        layers=1)
    assert out["history"][0]["step"] == 1
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
                   for m in sys.modules)
    print("served", int(req.pred))
""")


_BLOCKED_STORE = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.serve.classical_engine import ClassicalServeEngine

    store = ArtifactStore(sys.argv[1])
    (key,) = store.keys()
    prog = store.load(key, "cpu")
    assert prog is not None and prog.pf_source == "artifact", store
    eng = ClassicalServeEngine(prog, max_batch=4)
    X = np.load(sys.argv[2])
    for x in X:
        eng.submit(x)
    preds = [int(r.pred) for r in eng.run_to_completion()]
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
                   for m in sys.modules)
    print("preds", *preds)
""")


def test_store_loads_and_serves_with_jax_and_reference_blocked(tmp_path):
    """An artifact the port wrote loads and serves in an interpreter that
    cannot import JAX or the JAX package, with the predictions of the
    program that wrote it."""
    import numpy as np

    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.serve.classical_engine import get_program

    store = ArtifactStore(tmp_path / "store")
    prog = get_program("bonsai/usps-b", use_pallas=True, precision="int8",
                       device="cpu", artifact_store=store)
    X = np.random.default_rng(0).standard_normal((6, 256)).astype(np.float32)
    np.save(tmp_path / "x.npy", X)
    want = prog.batch(4)(x=X)["Pred"].reshape(-1).tolist()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _BLOCKED_STORE,
                          str(store.root), str(tmp_path / "x.npy")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[1:] == [str(p) for p in want]


def test_serves_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[-1].startswith("served")
    assert any("2 requests, 4 tokens" in line for line in lines)
