"""Bonsai and ProtoNN in the port against the JAX package's models.

``init_params`` reproduces the reference's numpy draws exactly;
``params_from_reference`` carries the reference's parameters (random or
trained) across with name, shape and dtype checks; both packages build the
same DFG from the same arrays; ``predict`` agrees to float32 tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.classical import training_split
from repro.data.datasets import get_spec
from repro.models import bonsai as jbonsai
from repro.models import protonn as jprotonn
from repro_torch.core.dfg import DFG
from repro_torch.models import bonsai as tbonsai
from repro_torch.models import protonn as tprotonn

torch.set_num_threads(1)

MODELS = {"bonsai": (jbonsai, tbonsai), "protonn": (jprotonn, tprotonn)}
DATASETS = ["usps-b", "letter-m", "cr-m"]


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("ds", DATASETS)
@pytest.mark.parametrize("algo", sorted(MODELS))
def test_init_build_predict_match(algo, ds):
    jm, tm = MODELS[algo]
    spec = get_spec(ds)
    jcfg, tcfg = jm.from_spec(spec), tm.from_spec(spec)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, tp = jm.init_params(jcfg, seed=3), tm.init_params(tcfg, seed=3)
    assert jp.keys() == tp.keys()
    for k in jp:
        assert np.asarray(jp[k]).dtype == tp[k].dtype
        np.testing.assert_array_equal(tp[k], np.asarray(jp[k]))
    carried = tm.params_from_reference(_np(jp), tcfg)
    jg, tg = jm.build_dfg(jp, jcfg), tm.build_dfg(carried, tcfg)
    assert isinstance(tg, DFG)
    assert tg.structural_hash() == jg.structural_hash()
    X = np.random.default_rng(0).standard_normal((5, spec.n_features))
    X = X.astype(np.float32)
    want = np.asarray(jm.predict(jp, jcfg, jnp.asarray(X)))
    got = tm.predict(carried, tcfg, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_protonn_data_init_matches():
    Xtr, ytr = training_split("protonn/usps-b")
    cfg = jprotonn.from_spec(get_spec("usps-b"))
    jp = jprotonn.init_params(cfg, seed=1, X=Xtr, y=ytr)
    tp = tprotonn.init_params(tprotonn.from_spec(get_spec("usps-b")), seed=1,
                              X=Xtr, y=ytr)
    for k in jp:
        np.testing.assert_array_equal(tp[k], np.asarray(jp[k]))


def test_trained_reference_weights_carry_across():
    """Weights trained by the JAX package serve unchanged in the port."""
    Xtr, ytr = training_split("protonn/usps-b")
    jcfg = jprotonn.from_spec(get_spec("usps-b"))
    jp = _np(jprotonn.train(jcfg, Xtr[:128], ytr[:128], steps=3))
    tcfg = tprotonn.from_spec(get_spec("usps-b"))
    tp = tprotonn.params_from_reference(jp, tcfg)
    assert (tprotonn.build_dfg(tp, tcfg).structural_hash()
            == jprotonn.build_dfg(jp, jcfg).structural_hash())
    want = np.asarray(jprotonn.predict(jp, jcfg, jnp.asarray(Xtr[:16])))
    got = tprotonn.predict(tp, tcfg, torch.from_numpy(Xtr[:16])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("algo", sorted(MODELS))
def test_params_from_reference_checks(algo):
    jm, tm = MODELS[algo]
    cfg = tm.from_spec(get_spec("usps-b"))
    good = _np(jm.init_params(jm.from_spec(get_spec("usps-b"))))
    assert tm.params_from_reference(good).keys() == good.keys()
    missing = dict(good)
    missing.pop(next(iter(missing)))
    bad_dtype = {k: v.astype(np.float64) for k, v in good.items()}
    bad_shape = {k: (v[:-1] if v.ndim else v) for k, v in good.items()}
    for params in (missing, bad_dtype, bad_shape):
        with pytest.raises(ValueError):
            tm.params_from_reference(params, cfg)


@pytest.mark.parametrize("algo", sorted(MODELS))
def test_train_waits_for_training_slice(algo):
    """Training is ported (``tests/test_torch_train.py`` holds it against
    the reference): it runs where asked and, asked nowhere, on the card —
    with no card it raises rather than fall back to the CPU."""
    _, tm = MODELS[algo]
    cfg = tm.from_spec(get_spec("usps-b"))
    X = np.random.default_rng(0).standard_normal((64, cfg.n_features))
    y = np.arange(64) % cfg.n_classes     # ProtoNN seeds 40 prototypes
    out = tm.train(cfg, X.astype(np.float32), y, steps=2, device="cpu")
    assert set(out) == set(tm.param_shapes(cfg))
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in out.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.train(cfg, X.astype(np.float32), y, steps=1)
