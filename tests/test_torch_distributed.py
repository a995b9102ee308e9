"""The train step on a mesh of gloo ranks (CPU) against the one-process
step, the int8 cross-pod reduce against the reference's, and the launcher
resharding a checkpoint across rank counts.

Ranks are ``torch.multiprocessing`` processes joined through a
``file://`` store under ``tmp_path`` (no port, so parallel test workers
never meet); each runs one thread, and the one-process references run in
rank 0's process, so that every comparison is between the same kernels
and is bitwise where no sum splits over ``model``.  Where the plan splits a
layer over ``model`` (Megatron's scheme, ``sharding/tp.py``) the sums over
ranks reorder adds, and the comparison holds the split step within float32
rounding of the one-process step (:data:`LIMITS`).  Three spawns in all:

* 2 ranks: qwen2.5's SMOKE on (data 2, model 1) and (pod 2, data 1,
  model 1), 2 steps through ``launch.steps.build_cell``, against the
  one-process step on the whole batch with twice the microbatches; the
  int8_ef step at 2 pods against the EF math on the host; and
  ``compressed_mean`` at 2 pods (and one EF carry-over) against the
  reference's under ``jax.vmap(..., axis_name="pod")``;
* 4 ranks: (data 2, model 2) within :data:`LIMITS`, shards of uneven
  dims against DTensor's own, and the launcher's straight run and
  checkpoint at 4 ranks (its mesh: data 1, model 4), resumed there at 4
  ranks bitwise;
* 2 ranks: the launcher resumes that checkpoint at 2 ranks (model 2),
  then rank 0 alone at 1, each within :data:`LIMITS` of the straight run.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

LM = "qwen2.5-3b"
B, S = 4, 16
OC = dict(lr=5e-3, warmup_steps=1, total_steps=10)
LAUNCH = dict(smoke=True, batch=B, seq_len=S, microbatches=1, lr=3e-3,
              log_every=1, device="cpu")
# a split over `model` only reorders float32 adds: losses rtol 1e-4, grad
# norms rtol 1e-5, the first update's moments (the first gradients) within
# 1e-5 of each leaf's largest magnitude.  Masters are not compared element
# by element after AdamW: its first update is lr·sign(g) wherever |g| >>
# eps, so a rounding-level difference on a near-zero gradient moves a
# master by up to 2·lr.
LIMITS = dict(loss=1e-4, grad_norm=1e-5, first=1e-5)


def _grads(pod: int, step: int) -> dict:
    rng = np.random.default_rng(100 * step + pod)
    scale = 10.0 ** rng.uniform(-2, 2)
    return {"a": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(9) * scale).astype(np.float32)}}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _steps_job(rank: int, tmp: str, tag: str, shape, names, pod_reduce: str):
    """2 steps on a mesh; rank 0 also runs the one-process reference."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.data.tokens import PipelineState, TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import _flatten, _nest
    from repro_torch.sharding.placement import local_rows
    from repro_torch.train import compression as tcomp
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig, adamw_update, global_norm

    mesh = make_mesh(shape, names, "cpu")
    spec = get_arch(LM)
    spec = dataclasses.replace(spec, model=spec.smoke)
    cell = ShapeCell("dist", "train", S, B)
    cfg = spec.cell_config(cell)
    oc = OptConfig(**OC)
    ef = pod_reduce == "int8_ef"
    split = build_cell(spec, cell, mesh, pod_reduce=pod_reduce).split(mesh)
    model, state = tloop.init_state(cfg, 0, device="cpu", ef=ef, split=split)
    prog = build_cell(spec, cell, mesh, pod_reduce=pod_reduce,
                      microbatch_override=1, oc=oc, model=model)
    dp = prog.plan.dp_size
    assert prog.meta["n_microbatches"] == 1 and dp == 2
    state = tloop.shard_state(state, prog.in_shardings[0], mesh)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=B, seq_len=S)
    batches, ps = [], PipelineState()
    for _ in range(2):
        b, ps = pipe.batch_at(ps)
        batches.append({k: torch.as_tensor(v) for k, v in b.items()})
    metrics, first = [], None
    for b in batches:
        state, m = prog.fn(state, local_rows(b, prog.in_shardings[1]["tokens"],
                                             mesh))
        metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        if first is None:
            one = tloop.gather_state(state)
            first = {part: {k: x.clone() for k, x in
                            _flatten(getattr(one, part)).items()}
                     for part in ("m", "v")}     # the state updates in place
    full = tloop.gather_state(state)
    out = {"metrics": metrics, "first": first,
           "split": split is not None,
           **{part: _flatten(getattr(full, part))
              for part in ("params", "m", "v")}}
    if ef:
        out["ef"] = _flatten(full.ef)
    torch.save(out, os.path.join(tmp, f"{tag}_{rank}.pt"))
    if rank != 0:
        return
    # the one-process reference: the whole batch in twice the microbatches,
    # or for int8_ef each pod's rows, then the EF math on the host
    model2, st = tloop.init_state(cfg, 0, device="cpu")
    ref, ref_first = [], None
    if not ef:
        step = tloop.make_train_step(model2, oc, n_microbatches=dp)
        for b in batches:
            st, m = step(st, b)
            ref.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
            if ref_first is None:
                ref_first = {part: {k: x.clone() for k, x in
                                    _flatten(getattr(st, part)).items()}
                             for part in ("m", "v")}
    else:
        accumulate = tloop._accumulator(model2, 1, False)
        efs = [tcomp.ef_init(st.params) for _ in range(dp)]
        rows = B // dp
        for b in batches:
            deqs, losses, cs = [], [], []
            for p in range(dp):
                acc, loss = accumulate({k: v[p * rows:(p + 1) * rows]
                                        for k, v in b.items()})
                flat_ef = _flatten(efs[p])
                c = {k: a.mul_(1.0) + flat_ef[k] for k, a in acc.items()}
                deq = {k: tcomp.dequantize_int8(*tcomp.quantize_int8(x))
                       for k, x in c.items()}
                efs[p] = _nest({k: c[k] - deq[k] for k in c})
                deqs.append(deq)
                losses.append(loss * 1.0)
            mean = _nest({k: (deqs[0][k] + deqs[1][k]) / dp for k in deqs[0]})
            gnorm = global_norm(mean)
            _, _, _, m = adamw_update(st.params, mean, st.m, st.v, st.step, oc,
                                      gnorm=gnorm)
            st = tloop.TrainState(st.params, st.m, st.v, st.step + 1, None)
            tloop.load_masters(model2, st.params)
            ref.append([float((losses[0] + losses[1]) / dp), float(gnorm),
                        float(m["lr"])])
        out_ef = [_flatten(e) for e in efs]
    ref_out = {"metrics": ref, "first": ref_first,
               **{part: _flatten(getattr(st, part))
                  for part in ("params", "m", "v")}}
    if ef:
        ref_out["ef"] = out_ef
    torch.save(ref_out, os.path.join(tmp, f"{tag}_ref.pt"))


def _compressed_job(rank: int, tmp: str):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.train import compression as tcomp

    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
    ef = tcomp.ef_init(_tensors(_grads(rank, 0)))
    outs = []
    with use_mesh(mesh):
        for step in range(2):
            mean, ef = tcomp.compressed_mean(_tensors(_grads(rank, step)), ef,
                                             "pod")
            outs.append((mean, ef))
    torch.save(outs, os.path.join(tmp, f"compressed_{rank}.pt"))


def _uneven_job(rank: int, tmp: str):
    """Uneven shards (the planner's allow_uneven): this rank's slice is
    DTensor's own, and the gather gives the whole tensor back."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.placement import gather_full, shard_tensor
    from repro_torch.sharding.spec import P

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    x = torch.arange(5 * 3 * 7, dtype=torch.float32).reshape(5, 3, 7)
    for spec in (P("model", None, "data"), P(("data", "model")),
                 P(None, "model")):
        d = shard_tensor(x, spec, mesh)
        assert torch.equal(d.full_tensor(), x), spec
        assert torch.equal(gather_full(d), x), spec
    torch.save(True, os.path.join(tmp, f"uneven_{rank}.pt"))


def _launch_job(rank: int, tmp: str, runs):
    """Each run: (ranks, steps, checkpoint dir, every[, a checkpoint dir
    it starts from, copied]); rank 0 keeps each run's logged metrics."""
    import torch.distributed as dist

    from repro_torch.launch.train import run_training

    for ranks, steps, ckpt, every, *src in runs:
        if ranks < dist.get_world_size():
            dist.destroy_process_group()
            if rank >= ranks:
                return
        if src:
            if rank == 0:
                shutil.copytree(os.path.join(tmp, src[0]),
                                os.path.join(tmp, ckpt))
            if dist.is_initialized():
                dist.barrier()
        out = run_training(LM, steps=steps, ckpt_dir=os.path.join(tmp, ckpt),
                           ckpt_every=every, **LAUNCH)
        if rank == 0:
            torch.save(out["history"], os.path.join(tmp, f"{ckpt}_hist.pt"))


def _worker(rank: int, world: int, store: str, tmp: str, jobs) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    init_group("cpu", init_method=f"file://{store}", world_size=world,
               rank=rank)
    try:
        for name, *args in jobs:
            {"steps": _steps_job, "compressed": _compressed_job,
             "launch": _launch_job, "uneven": _uneven_job}[name](rank, tmp,
                                                                 *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(tmp_path, world: int, jobs, name: str) -> None:
    mp.spawn(_worker, args=(world, str(tmp_path / f"store_{name}"),
                            str(tmp_path), jobs), nprocs=world, join=True)


def _assert_same(got: dict, want: dict, label: str) -> None:
    assert set(got) == set(want), label
    for path in want:
        assert torch.equal(got[path], want[path]), f"{label}: {path}"


def _close_metrics(got: list, want: list, label: str) -> None:
    """[loss, grad_norm, lr] rows within :data:`LIMITS`, lr equal."""
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a[0], b[0], rtol=LIMITS["loss"],
                                   err_msg=f"{label}: loss")
        np.testing.assert_allclose(a[1], b[1], rtol=LIMITS["grad_norm"],
                                   err_msg=f"{label}: grad norm")
        assert a[2] == b[2], label


def _check_steps(tmp_path, tag: str, world: int) -> None:
    ranks = [torch.load(tmp_path / f"{tag}_{r}.pt") for r in range(world)]
    ref = torch.load(tmp_path / f"{tag}_ref.pt")
    for r, got in enumerate(ranks):
        if got.get("split"):            # sums split over `model`: LIMITS
            _close_metrics(got["metrics"], ref["metrics"], f"{tag} rank {r}")
            for part in ("m", "v"):
                for path, want in ref["first"][part].items():
                    g = got["first"][part][path]
                    tol = LIMITS["first"] * float(want.abs().max())
                    assert float((g - want).abs().max()) <= tol, (
                        f"{tag} rank {r} first {part} {path}")
            assert all(torch.isfinite(x).all() for x in got["params"].values())
            continue
        assert got["metrics"] == ref["metrics"], (tag, r)
        for part in ("params", "m", "v"):
            _assert_same(got[part], ref[part], f"{tag} rank {r} {part}")
    if "ef" in ref:                     # each pod keeps its own residual
        for r, got in enumerate(ranks):
            _assert_same(got["ef"], ref["ef"][r], f"{tag} rank {r} ef")
    assert all(np.isfinite(x) for m in ref["metrics"] for x in m)


def test_two_ranks_data_pod_and_int8_reduce(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.train import compression as jcomp

    _spawn(tmp_path, 2, [
        ("steps", "data2", (2, 1), ("data", "model"), "fp32"),
        ("steps", "pod2", (2, 1, 1), ("pod", "data", "model"), "fp32"),
        ("steps", "pod2_int8", (2, 1, 1), ("pod", "data", "model"), "int8_ef"),
        ("compressed",)], "a")
    for tag in ("data2", "pod2", "pod2_int8"):
        _check_steps(tmp_path, tag, 2)

    # compressed_mean against the reference's under vmap over "pod"
    fn = jax.vmap(lambda g, e: jcomp.compressed_mean(g, e, "pod"),
                  axis_name="pod")
    ranks = [torch.load(tmp_path / f"compressed_{r}.pt") for r in range(2)]
    stack = lambda trees: jax.tree.map(lambda *x: jnp.stack(x), *trees)
    ef = stack([jax.tree.map(np.zeros_like, _grads(p, 0)) for p in range(2)])
    for step in range(2):
        mean, ef = fn(stack([_grads(p, step) for p in range(2)]), ef)
        for r in range(2):
            got_mean, got_ef = ranks[r][step]
            for want, got in ((mean, got_mean), (ef, got_ef)):
                for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w)[r])


def test_four_ranks_data_model_and_launcher_reshards(tmp_path):
    _spawn(tmp_path, 4, [
        ("steps", "data2model2", (2, 2), ("data", "model"), "fp32"),
        ("uneven",),
        ("launch", [(4, 4, "straight", 4), (4, 2, "resume", 2),
                    (4, 4, "r4", 2, "resume")])], "b")
    _check_steps(tmp_path, "data2model2", 4)
    assert torch.load(tmp_path / "data2model2_0.pt")["split"]
    assert all(torch.load(tmp_path / f"uneven_{r}.pt") for r in range(4))
    for d in ("r2", "r1"):
        shutil.copytree(tmp_path / "resume", tmp_path / d)
    _spawn(tmp_path, 2, [("launch", [(2, 4, "r2", 2), (1, 4, "r1", 2)])], "c")

    def final(d: str) -> dict:
        import json
        step = tmp_path / d / "step_00000004"
        paths = json.loads((step / "manifest.json").read_text())["paths"]
        return {p: np.load(step / f"arr_{i}.npy") for i, p in enumerate(paths)}

    # resumed on the same layout (data 1, model 4): bitwise; at 2 ranks
    # (model 2) and 1 the split differs: the logged metrics within LIMITS
    want = final("straight")
    assert any(p.startswith(".params/") for p in want)
    got = final("r4")
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    hist = lambda d: [[h["loss"], h["grad_norm"], h["lr"]] for h in
                      torch.load(tmp_path / f"{d}_hist.pt")]
    for d in ("r2", "r1"):
        assert set(final(d)) == set(want), d
        _close_metrics(hist(d), hist("straight")[2:], d)
