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

LM training (``repro_torch.train``, ``models.transformer.lm_loss``), against
``repro.train`` and ``repro.models.transformer`` on the same numpy inputs:
``lr_at``, ``global_norm`` and ``adamw_update`` (``rtol = 1e-6``: the same
float32 operations in the same order); ``cross_entropy_loss`` with a padded
vocabulary and a mask; ``lm_loss`` and every parameter's gradient against
``jax.value_and_grad`` on qwen2.5's SMOKE with the JAX weights (float32
``rtol = atol = 1e-5`` of each leaf's largest magnitude; bfloat16 within
twice the reference's own bf16-vs-float32 gap of each leaf, measured at
most 1.15 times it); ``make_train_step`` against the JAX step over 5 steps
of ``TokenPipeline`` batches at 2 microbatches (loss ``rtol = 1e-5``, as
the Bonsai loop); 1, 2 and 4 microbatches alike (the reference's
``rtol = 2e-4, atol = 2e-5`` on the parameters); the reference's 20-step
loss drop of 0.3; ``quantize_int8`` bitwise; a checkpoint written by either
package restored by the other and resumed to the same losses; the atomic
publish; ``launch.train`` on the CPU, resumed bitwise.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import classical as jclassical
from repro.configs import get_arch as j_get_arch
from repro.data.tokens import PipelineState, TokenPipeline
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optim as joptim
from repro.train import train_loop as jloop
from repro.models import bonsai as jbonsai
from repro.models import protonn as jprotonn
from repro_torch.configs import classical as tclassical
from repro_torch.core.compiler import MafiaCompiler
from repro_torch.core.device import default_device, resolve_device
from repro_torch.data.datasets import get_spec, make_dataset
from repro_torch.models import bonsai as tbonsai
from repro_torch.models import protonn as tprotonn
from repro_torch.configs.registry import get_arch
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import optim as toptim
from repro_torch.train import train_loop as tloop

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


# ======================================================= LM training
LM = "qwen2.5-3b"
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
J_VG = jax.jit(jax.value_and_grad(jt.lm_loss), static_argnums=1)


def _np_tree(seed: int = 0):
    return jax.tree.map(np.array, jt.init_params(j_get_arch(LM).smoke,
                                                 jax.random.key(seed)))


def _t(tree):
    """A numpy tree as torch tensors (nested dicts)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _grads(model):
    return {path: (np.stack([t.grad.float().numpy() for t in ts])
                   if path.startswith("blocks/") else ts[0].grad.float().numpy())
            for path, ts in tt._leaves(model).items()}


@pytest.mark.parametrize("step", [0, 1, 2, 5, 9, 10, 14])
def test_lr_at_matches_reference(step):
    oc = dict(lr=1e-3, warmup_steps=3, total_steps=10, min_lr_ratio=0.1)
    want = float(joptim.lr_at(jnp.asarray(step, jnp.int32), joptim.OptConfig(**oc)))
    got = float(toptim.lr_at(torch.tensor(step, dtype=torch.int32),
                             toptim.OptConfig(**oc)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_and_global_norm_match_reference(clip):
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (2, 3, 2)}}

    def draw(scale):
        return jax.tree.map(lambda s: (scale * rng.standard_normal(s))
                            .astype(np.float32), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))

    params = draw(1.0)
    jp = jax.tree.map(jnp.asarray, params)
    jm, jv = joptim.adamw_init(jp)
    tp = _t(params)
    tm, tv = toptim.adamw_init(tp)
    oc = dict(lr=1e-2, warmup_steps=1, total_steps=6, clip_norm=clip)
    for step in range(4):
        grads = draw(3.0)
        np.testing.assert_allclose(float(toptim.global_norm(_t(grads))),
                                   float(joptim.global_norm(grads)), rtol=1e-6)
        jp, jm, jv, jmet = joptim.adamw_update(
            jp, jax.tree.map(jnp.asarray, grads), jm, jv,
            jnp.asarray(step, jnp.int32), joptim.OptConfig(**oc))
        tp, tm, tv, tmet = toptim.adamw_update(
            tp, _t(grads), tm, tv, torch.tensor(step, dtype=torch.int32),
            toptim.OptConfig(**oc))
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-6)
        for a, b in zip(toptim.tree_leaves({"p": tp, "m": tm, "v": tv}),
                        jax.tree.leaves({"p": jp, "m": jm, "v": jv})):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    V, Vp = 250, 256
    logits = (4 * rng.standard_normal((2, 6, Vp))).astype(np.float32)
    tgt = rng.integers(0, V, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.7).astype(np.float32)
    for m in (None, mask):
        def jf(x):
            return jl.cross_entropy_loss(x, jnp.asarray(tgt), vocab_size=V,
                                         mask=None if m is None else jnp.asarray(m))
        want, jg = jax.value_and_grad(jf)(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        got = tl.cross_entropy_loss(x, torch.from_numpy(tgt), vocab_size=V,
                                    mask=None if m is None else torch.from_numpy(m))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)
        assert not x.grad[..., V:].any()


def test_lm_loss_and_every_gradient_match_reference():
    cfg_j, cfg = j_get_arch(LM).smoke, get_arch(LM).smoke
    tree = _np_tree()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, jg = J_VG(jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(toks))
    model = tt.params_from_reference(tree, cfg, "cpu")
    loss = tt.lm_loss(model, toks)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    flat = tt._flatten(jax.tree.map(np.asarray, jg))
    got = _grads(model)
    assert set(got) == set(flat)
    for path, g in got.items():
        top = float(np.abs(flat[path]).max())
        np.testing.assert_allclose(g, flat[path], rtol=1e-5, atol=1e-5 * top,
                                   err_msg=path)


# The port's bf16 loss and gradients against the reference's bf16 ones, as
# fractions of the reference's own bf16-vs-f32 gap.  Rounding at the same
# casting points errs alike, so the port lands well inside that gap (loss
# 0.11 of it, gradients 0.65 over all leaves in the L2 norm, on this seed);
# a port that computed in float32 lands at 1.0, and one that rounded at other
# points near sqrt(2).  The control in the test holds the limits below 1.
BF16_LOSS_GAP, BF16_GRAD_GAP = 0.5, 0.8


def test_lm_loss_bf16_gradients_within_the_reference_bf16_gap():
    cfg_j, cfg = j_get_arch(LM).smoke, get_arch(LM).smoke
    tree = _np_tree()
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    p = jax.tree.map(jnp.asarray, tree)
    l32, g32 = J_VG(p, cfg_j, toks)
    l16, g16 = J_VG(p, dataclasses.replace(cfg_j, act_dtype="bfloat16"), toks)
    f32 = tt._flatten(jax.tree.map(np.asarray, g32))
    f16 = tt._flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), g16))
    loss_gap = abs(float(l16) - float(l32))

    def port(act_dtype):
        """(the loss's and the gradients' distance from the reference's
        bf16 ones, each a fraction of the reference's bf16-vs-f32 gap)"""
        model = tt.params_from_reference(
            tree, dataclasses.replace(cfg, act_dtype=act_dtype), "cpu")
        loss = tt.lm_loss(model, np.asarray(toks))
        loss.backward()
        grads = _grads(model)
        for path, g in grads.items():
            ref_gap = np.abs(f16[path] - f32[path]).max()
            assert np.abs(g - f16[path]).max() <= 2 * ref_gap, path
        off = sum(float(np.sum((g - f16[path]) ** 2)) for path, g in grads.items())
        gap = sum(float(np.sum((f32[path] - f16[path]) ** 2)) for path in grads)
        return (abs(float(loss.detach()) - float(l16)) / loss_gap,
                (off / gap) ** 0.5)

    loss_frac, grad_frac = port("bfloat16")
    assert loss_frac <= BF16_LOSS_GAP, loss_frac
    assert grad_frac <= BF16_GRAD_GAP, grad_frac
    # control: the same model computed in float32 fails both limits
    loss_frac, grad_frac = port("float32")
    assert loss_frac > BF16_LOSS_GAP and grad_frac > BF16_GRAD_GAP


def _jax_steps(state, step, pipe, ps, n):
    losses = []
    for _ in range(n):
        b, ps = pipe.batch_at(ps)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return state, ps, losses


def _port_steps(state, step, pipe, ps, n):
    losses = []
    for _ in range(n):
        b, ps = pipe.batch_at(ps)
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, ps, losses


def test_train_step_matches_reference_over_5_steps():
    cfg_j, cfg = j_get_arch(LM).smoke, get_arch(LM).smoke
    jstate = jloop.init_state(cfg_j, jax.random.key(0))
    jstep = jax.jit(jloop.make_train_step(cfg_j, joptim.OptConfig(**OPT),
                                          n_microbatches=2))
    model, tstate = tloop.init_state(
        cfg, params=jax.tree.map(np.array, jstate.params), device="cpu")
    tstep = tloop.make_train_step(model, toptim.OptConfig(**OPT),
                                  n_microbatches=2)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq_len=32)
    _, _, want = _jax_steps(jstate, jstep, pipe, PipelineState(), 5)
    tstate, _, got = _port_steps(tstate, tstep, pipe, PipelineState(), 5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(tstate.step) == 5
    # the model holds the masters' casts
    flat = tt._flatten(tstate.params)
    for path, ts in tt._leaves(model).items():
        src = flat[path] if path.startswith("blocks/") else flat[path][None]
        assert all(torch.equal(t, s.to(t.dtype)) for t, s in zip(ts, src))


def test_microbatch_count_invariance():
    cfg = get_arch(LM).smoke
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=8, seq_len=16)
    batch, _ = pipe.batch_at(PipelineState())
    oc = toptim.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    outs = []
    for n_mb in (1, 2, 4):
        model, state = tloop.init_state(cfg, 0, device="cpu")
        state, m = tloop.make_train_step(model, oc, n_microbatches=n_mb)(state, batch)
        outs.append((float(m["loss"]), toptim.tree_leaves(state.params)))
    for loss, leaves in outs[1:]:
        np.testing.assert_allclose(loss, outs[0][0], rtol=1e-5)
        for a, b in zip(outs[0][1], leaves):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-5)


def test_loss_decreases_smoke():
    cfg = get_arch(LM).smoke
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=8, seq_len=32)
    model, state = tloop.init_state(cfg, 0, device="cpu")
    step = tloop.make_train_step(model, toptim.OptConfig(
        lr=1e-2, warmup_steps=3, total_steps=40), n_microbatches=2)
    _, _, losses = _port_steps(state, step, pipe, PipelineState(), 20)
    assert losses[-1] < losses[0] - 0.3


def test_int8_ef_pod_reduce_raises():
    """int8_ef without a pod axis raises, as in the reference; on a one-rank
    gloo group the cross-pod reduce is the plain EF math of one pod."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group, make_mesh
    from repro_torch.sharding.ctx import use_mesh

    model, _ = tloop.init_state(get_arch(LM).smoke, 0, device="cpu")
    with pytest.raises(ValueError, match="pod"):
        tloop.make_train_step(model, toptim.OptConfig(), pod_reduce="int8_ef")
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
         "b": {"c": torch.from_numpy(rng.standard_normal(9).astype(np.float32))}}
    ef = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)
                                * 1e-2), "b": {"c": torch.zeros(9)}}
    init_group("cpu")
    try:
        with use_mesh(make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")):
            got, got_ef = tcomp.compressed_mean(g, ef, "pod")
    finally:
        dist.destroy_process_group()
    for want_g, want_e, mean, e in (
            (g["a"], ef["a"], got["a"], got_ef["a"]),
            (g["b"]["c"], ef["b"]["c"], got["b"]["c"], got_ef["b"]["c"])):
        c = want_g + want_e
        q, scale = tcomp.quantize_int8(c)
        deq = tcomp.dequantize_int8(q, scale)
        assert torch.equal(mean, deq) and torch.equal(e, c - deq)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_bitwise(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((33, 17)) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]            # ties after scaling
    qj, sj = jcomp.quantize_int8(jnp.asarray(x))
    qt, st = tcomp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tcomp.dequantize_int8(qt, st).numpy(),
                                  np.asarray(jcomp.dequantize_int8(qj, sj)))
    ef = tcomp.ef_init({"w": torch.from_numpy(x).to(torch.bfloat16)})
    assert ef["w"].dtype == torch.float32 and not ef["w"].any()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages_and_resumes(writer, tmp_path):
    """A checkpoint of either package restores into the other, and both
    resume from it to the same losses."""
    cfg_j, cfg = j_get_arch(LM).smoke, get_arch(LM).smoke
    oc = dict(lr=5e-3, warmup_steps=1, total_steps=10)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq_len=16)
    jstep = jax.jit(jloop.make_train_step(cfg_j, joptim.OptConfig(**oc)))
    jstate = jloop.init_state(cfg_j, jax.random.key(0))
    jstate, ps, _ = _jax_steps(jstate, jstep, pipe, PipelineState(), 2)
    model, tstate = tloop.init_state(
        cfg, params=jax.tree.map(np.array, jstate.params), device="cpu")
    tstep = tloop.make_train_step(model, toptim.OptConfig(**oc))
    if writer == "jax":
        jckpt.save(str(tmp_path), 2, jstate, metadata={"pipeline": ps.to_json()})
        tstate, meta = tckpt.restore(str(tmp_path), tstate)
        tloop.load_masters(model, tstate.params)
    else:
        tstate = dataclasses.replace(
            tstate, m=_t(jax.tree.map(np.array, jstate.m)),
            v=_t(jax.tree.map(np.array, jstate.v)),
            step=torch.tensor(2, dtype=torch.int32))
        tckpt.save(str(tmp_path), 2, tstate, metadata={"pipeline": ps.to_json()})
        jstate, meta = jckpt.restore(str(tmp_path), jstate)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["paths"][-1] == ".step" and ".params/embed" in manifest["paths"]
    assert int(tstate.step) == 2 and int(jstate.step) == 2
    ps = PipelineState.from_json(meta["pipeline"])
    _, _, want = _jax_steps(jstate, jstep, pipe, ps, 3)
    _, _, got = _port_steps(tstate, tstep, pipe, ps, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_checkpoint_publish_is_atomic(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "n": torch.tensor(3)}
    os.makedirs(os.path.join(d, ".tmp_step_00000005"))    # a crashed save
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, tree)
    path = tckpt.save(d, 5, tree, metadata={"k": 1})
    assert os.path.basename(path) == "step_00000005"
    assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
    tckpt.save(d, 9, {"w": tree["w"] + 1, "n": tree["n"]})
    assert tckpt.available_steps(d) == [5, 9] and tckpt.latest_step(d) == 9
    back, meta = tckpt.restore(d, tree, step=5)
    assert meta == {"k": 1} and torch.equal(back["w"], tree["w"])
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(d, {"w": torch.zeros(3, 2), "n": tree["n"]})
    with pytest.raises(ValueError, match="missing"):
        tckpt.restore(d, {"w": tree["w"], "other": tree["n"]})


def _final_params(d: str, step: int) -> dict:
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        paths = json.load(f)["paths"]
    return {p: np.load(os.path.join(d, f"step_{step:08d}", f"arr_{i}.npy"))
            for i, p in enumerate(paths)}


def test_launcher_trains_on_the_cpu_and_resumes_exactly(tmp_path, capsys):
    kw = dict(smoke=True, batch=4, seq_len=16, ckpt_every=2, microbatches=2,
              lr=3e-3, log_every=1, device="cpu")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    launch_train.run_training(LM, steps=4, ckpt_dir=a, **kw)
    launch_train.run_training(LM, steps=2, ckpt_dir=b, **kw)
    out = launch_train.run_training(LM, steps=4, ckpt_dir=b, **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    assert [h["step"] for h in out["history"]] == [3, 4]
    want, got = _final_params(a, 4), _final_params(b, 4)
    assert set(want) == set(got)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert launch_train.main(["--arch", LM, "--smoke", "--device", "cpu",
                              "--steps", "1", "--batch", "2", "--seq-len", "8",
                              "--layers", "1"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_train.run_training(LM, steps=1, ckpt_dir=None,
                                      **{**kw, "device": None})
