"""The port's Bonsai and ProtoNN trainers against the JAX package's, on the
CPU.

Both fit by plain full-batch gradient descent from the same
``init_params`` (numpy, from ``seed``): the port through
``torch.autograd`` over its ``predict``, the reference through
``jax.grad``.  Tolerances: the loss at every one of 20 steps within
``rtol = 1e-5`` (float32 sums in another order) and the parameters after
them within ``atol = 1e-5``; at the reference's 120 steps the test accuracy
within one sample, and the int8 calibration exponents of the port's trained
program equal to those of the JAX-trained parameters carried across with
``params_from_reference``.  Sparsity masks hold exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import classical as jclassical
from repro.models import bonsai as jbonsai
from repro.models import protonn as jprotonn
from repro_torch.configs import classical as tclassical
from repro_torch.core.compiler import MafiaCompiler
from repro_torch.core.device import default_device, resolve_device
from repro_torch.data.datasets import get_spec, make_dataset
from repro_torch.models import bonsai as tbonsai
from repro_torch.models import protonn as tprotonn

torch.set_num_threads(1)

PROGRAMS = ["bonsai/usps-b", "protonn/usps-b"]
MODS = {"bonsai": (jbonsai, tbonsai), "protonn": (jprotonn, tprotonn)}
STEPS, LR = 20, {"bonsai": 0.3, "protonn": 0.5}


def _setup(bench, n_train=256):
    algo, ds = bench.split("/")
    jmod, tmod = MODS[algo]
    spec = get_spec(ds)
    Xtr, ytr, Xte, yte = make_dataset(spec, n_train=n_train, seed=0)
    return algo, jmod, tmod, tmod.from_spec(spec), Xtr, ytr, Xte, yte


def _jax_losses(algo, jmod, cfg, X, y, steps):
    """The reference's training loop step by step (``jmod.train``'s own
    update), recording the loss before each step."""
    import jax.numpy as jnp

    init = (jmod.init_params(cfg, 0) if algo == "bonsai"
            else jmod.init_params(cfg, 0, X, y))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    mask_key = "Z" if algo == "bonsai" else "W"
    mask = (np.asarray(params[mask_key]) != 0).astype(np.float32)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    vg = jax.jit(jax.value_and_grad(lambda p: jmod.loss_fn(p, cfg, Xj, yj)))
    scale = {"gamma": 0.01} if algo == "protonn" else {}
    losses = []
    for _ in range(steps):
        loss, g = vg(params)
        losses.append(float(loss))
        params = {k: params[k] - LR[algo] * scale.get(k, 1.0) * g[k]
                  for k in params}
        params[mask_key] = params[mask_key] * mask
    return losses, {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("bench", PROGRAMS)
def test_loss_trajectory_matches_jax(bench):
    algo, jmod, tmod, cfg, X, y, _, _ = _setup(bench)
    jlosses, jparams = _jax_losses(algo, jmod, cfg, X, y, STEPS)
    # the loop above is the reference's train, bit for bit
    ref = jmod.train(cfg, X, y, steps=STEPS, seed=0)
    for k in ref:
        np.testing.assert_array_equal(jparams[k], ref[k])
    tlosses: list[float] = []
    tparams = tmod.train(cfg, X, y, steps=STEPS, seed=0, device="cpu",
                         history=tlosses)
    assert len(tlosses) == STEPS
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    assert tlosses[-1] < tlosses[0]
    assert set(tparams) == set(ref)
    for k in ref:
        assert tparams[k].dtype == np.float32 and tparams[k].shape == ref[k].shape
        np.testing.assert_allclose(tparams[k], ref[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("bench", PROGRAMS)
def test_sparsity_mask_holds(bench):
    algo, _, tmod, cfg, X, y, _, _ = _setup(bench, n_train=128)
    init = (tmod.init_params(cfg, 3) if algo == "bonsai"
            else tmod.init_params(cfg, 3, X, y))
    key = "Z" if algo == "bonsai" else "W"
    out = tmod.train(cfg, X, y, steps=5, seed=3, device="cpu")
    zero = init[key] == 0
    assert zero.any() and (out[key][zero] == 0).all()
    assert (out[key][~zero] != init[key][~zero]).any()


def test_trained_build_matches_jax_at_120_steps():
    """``build(trained=True)`` on the CPU (inside ``default_device``): the
    reference's 1,024 rows and 120 steps.  Test accuracy within one sample
    of the JAX-trained model's, and int8 calibration exponents equal to
    those of the JAX-trained parameters carried across."""
    bench = "bonsai/usps-b"
    with default_device("cpu"):
        tdfg, tparams, tcfg = tclassical.build(bench, trained=True)
    _, jparams, jcfg = jclassical.build(bench, trained=True)
    jparams = {k: np.asarray(v) for k, v in jparams.items()}
    _, _, Xte, yte = make_dataset(get_spec("usps-b"),
                                  n_train=tclassical.TRAIN_SPLIT, seed=0)
    acc_t = tbonsai.accuracy(tparams, tcfg, Xte, yte)
    acc_j = jbonsai.accuracy(jparams, jcfg, Xte, yte)
    assert abs(acc_t - acc_j) * len(yte) <= 1
    assert acc_t > 0.5

    Xtr, _ = tclassical.training_split(bench)
    carried = tbonsai.params_from_reference(jparams, tcfg)
    qplans = []
    for dfg in (tdfg, tbonsai.build_dfg(carried, tcfg, name="bonsai_usps-b")):
        prog = MafiaCompiler(precision="int8", device="cpu").compile(
            dfg, calib=Xtr[:256])
        qplans.append(prog.qplan)
    a, b = qplans
    assert a.input_exps == b.input_exps
    assert set(a.nodes) == set(b.nodes)
    for nid, nq in a.nodes.items():
        other = b.nodes[nid]
        assert (nq.in_exps, nq.out_exp) == (other.in_exps, other.out_exp), nid
        assert set(nq.param_exps) == set(other.param_exps), nid
        for k, e in nq.param_exps.items():
            np.testing.assert_array_equal(e, other.param_exps[k])


def test_train_runs_on_the_card_unless_asked():
    """No device means the card: without one, training raises rather than
    quietly running on the CPU; ``default_device`` scopes the choice."""
    _, _, tmod, cfg, X, y, _, _ = _setup("protonn/usps-b", n_train=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmod.train(cfg, X, y, steps=1)
    with default_device("cpu"):
        assert resolve_device() == torch.device("cpu")
        out = tmod.train(cfg, X, y, steps=1)
    assert set(out) == {"W", "B", "Zs", "gamma"}
    assert out["gamma"].shape == () and out["gamma"].dtype == np.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
