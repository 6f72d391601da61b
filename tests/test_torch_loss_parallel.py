"""The port's vocab-parallel cross entropy (``repro_torch.models.lm``'s
``masked_nll`` on DTensor logits, ``_VocabNLL``) against the JAX
package's loss arithmetic on the CPU.

Seeded numpy logits and targets go through JAX's ``lm.loss_fn`` and
``encdec.loss_fn`` with their ``forward_train`` replaced by one that
returns the logits (so the loss is JAX's own lines, the text slice
included), under ``jax.value_and_grad``; and through the port's on
gloo worlds, the logits placed as the head's product leaves them on a
mesh: rows ``Shard`` over the data axes where they divide the batch,
the vocab ``Shard`` over ``model`` where it divides the vocab
(replicated otherwise, as the rule tables do). The loss within 1e-5
relative of JAX's, the logits' gradient within 1e-5 relative L2.

Two 4-rank worlds from a ``FileStore`` under ``tmp_path``, started
together and joined by one ``JOIN_S`` deadline: plain gloo on ``(2, 2)``,
``(4, 1)`` and ``(2, 2, 1)`` over ``("pod", "data", "model")``; and
``distributed/gloo_cuda.py``'s collectives registered for the CPU (the
card's path) on ``(1, 4)`` and ``(2, 1, 2)``. Cases: targets on the
first and last column of every vocab shard; masked targets (-100); a
data rank whose rows are all masked; every row masked (the count clamped
to 1); an odd vocab (replicated over ``model``); a vocab ``model``
shards unevenly; a batch ``data`` does not divide; qwen2-vl's text
slice through ``lm.loss_fn``; seamless's ``encdec.loss_fn``. Each
rank also counts the loss's collectives with the dry run's
``StepCounter``: no all-gather, three all-reduces over ``model`` where
the vocab is sharded, one over each data axis that splits the rows. And
the models' own ``forward_train`` (reduced qwen2-1.5b, also at a vocab
of 255 that the rule tables replicate, qwen2-vl-7b, seamless-m4t-medium)
leaves the logits vocab-sharded on each mesh, its loss and gradients
within 1e-5 of the meshless port's.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import encdec as j_encdec
from repro.models import lm as j_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
# One deadline for every process a fixture starts, counted from the
# fixture's start, and the ranks' gloo timeout: over 3x the slowest
# world fixture seen (276 s, the gloo test modules run together on 6
# xdist workers over 8 cores).
JOIN_S = 900
MASKED = -100
FRONT = 3                       # qwen2-vl's patch rows ahead of the text

# mesh name -> (shape, axes, the world that runs it)
MESHES = {"2x2": ((2, 2), ("data", "model"), "gloo"),
          "4x1": ((4, 1), ("data", "model"), "gloo"),
          "pod_2x2x1": ((2, 2, 1), ("pod", "data", "model"), "gloo"),
          "1x4": ((1, 4), ("data", "model"), "gloo_cuda"),
          "pod_2x1x2": ((2, 1, 2), ("pod", "data", "model"), "gloo_cuda")}


def _cases():
    """name -> (logits (B, S, V) f32, targets (B, S) int32, kind,
    sharded): ``kind`` the loss function the case goes through, and
    ``sharded`` whether the vocab goes ``Shard`` over ``model`` even
    where ``model`` does not divide it."""
    rng = np.random.default_rng(23)

    def logits(b, s, v):
        return (3 * rng.standard_normal((b, s, v))).astype(np.float32)

    def targets(b, s, v):
        return rng.integers(0, v, (b, s)).astype(np.int32)

    out = {}
    # every first and last column of a 16-, 32- or 64-column shard
    edges = np.array([0, 15, 16, 31, 32, 47, 48, 63], np.int32)
    out["shard_edges"] = (logits(4, 8, 64),
                          np.tile(edges, (4, 1)), "nll", False)
    t = targets(4, 8, 64)
    t[rng.random(t.shape) < 0.3] = MASKED
    out["masked"] = (logits(4, 8, 64), t, "nll", False)
    t = targets(4, 8, 64)
    t[:2] = MASKED              # data rank 0's rows at data = 2, and 4
    out["rank_all_masked"] = (logits(4, 8, 64), t, "nll", False)
    out["all_masked"] = (logits(4, 8, 64),
                         np.full((4, 8), MASKED, np.int32), "nll", False)
    out["odd_vocab"] = (logits(4, 8, 67), targets(4, 8, 67), "nll", False)
    out["uneven_vocab_shard"] = (logits(4, 8, 66), targets(4, 8, 66),
                                 "nll", True)
    out["uneven_batch"] = (logits(3, 8, 64), targets(3, 8, 64), "nll",
                           False)
    t = targets(4, 8, 64)
    t[1, :3] = MASKED
    out["text_slice"] = (logits(4, FRONT + 8, 64), t, "lm", False)
    t = targets(4, 6, 64)
    t[3, 4:] = MASKED
    out["encdec"] = (logits(4, 6, 64), t, "encdec", False)
    return out


CASES = _cases()


def _models():
    """arch -> a seeded batch for the reduced config (vocab 256, d 64,
    8 frontend rows)."""
    rng = np.random.default_rng(29)

    def ids(*shape):
        return rng.integers(0, 256, shape).astype(np.int32)

    t = ids(4, 8)
    t[0, :5] = MASKED
    return {"qwen2-1.5b": {"tokens": ids(4, 8), "targets": t},
            # a vocab no model size here divides: the rule tables
            # replicate the head, the loss splits its rows
            "qwen2-1.5b@255": {"tokens": ids(4, 8), "targets": ids(4, 8)},
            "qwen2-vl-7b": {"tokens": ids(4, 8), "targets": ids(4, 8),
                            "embeds": rng.standard_normal((4, 8, 64))
                            .astype(np.float32)},
            "seamless-m4t-medium": {
                "tokens": ids(4, 8), "targets": ids(4, 8),
                "enc_embeds": rng.standard_normal((4, 8, 64))
                .astype(np.float32)}}


MODELS = _models()


def _jax_loss_and_grad(x, t, kind):
    """JAX's loss and its gradient in the logits, from the package's own
    ``loss_fn`` with ``forward_train`` giving back ``x``."""
    cfg = types.SimpleNamespace(moe=None)
    b = x.shape[0]
    if kind == "encdec":
        mod, batch = j_encdec, {"enc_embeds": jnp.zeros((b, 2, 1)),
                                "tokens": jnp.zeros(t.shape, jnp.int32),
                                "targets": jnp.asarray(t)}
    else:
        mod, batch = j_lm, {"tokens": jnp.zeros(t.shape, jnp.int32),
                            "targets": jnp.asarray(t)}
        if kind == "lm":
            batch["embeds"] = jnp.zeros((b, FRONT, 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "forward_train",
                   lambda logits, cfg, *a, **k: (
                       logits if mod is j_encdec else (logits, {})))
        loss, grad = jax.value_and_grad(
            lambda lg: mod.loss_fn(lg, cfg, batch)[0])(jnp.asarray(x))
    return float(loss), np.asarray(grad, np.float64)


RANK = textwrap.dedent("""
    import dataclasses, pickle, sys, types
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    torch.set_num_threads(1)
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models import encdec, lm
    from repro_torch.models.tree import tree_flatten_with_path, tree_unflatten

    rank, store, inp, out, world = (int(sys.argv[1]), sys.argv[2],
                                     sys.argv[3], sys.argv[4], sys.argv[5])
    with open(inp, "rb") as f:
        d = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4,
                            timeout=timedelta(seconds=JOIN_S))
    if world == "gloo_cuda":
        from repro_torch.distributed import gloo_cuda
        gloo_cuda.install("CPU")
    cfg = types.SimpleNamespace(moe=None)

    def placed(x, mesh, sharded):
        # rows over the data axes that divide them, the vocab over
        # model where it divides (or ``sharded``), as the head's product
        B, V = x.shape[0], x.shape[-1]
        b = sharding._fit(mesh, sharding.dp_axes(mesh), B)
        v = "model" if (sharded or V % mesh.size(
            sharding.mesh_dim(mesh, "model")) == 0) else None
        pl = sharding.placements(mesh, sharding.Spec(b, None, v))
        rows = sharding.placements(mesh, sharding.Spec(b))
        return pl, rows

    def local_of(t, mesh, pl):
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(
            mesh, pl).to_local().contiguous()

    LM_FORWARD, ED_FORWARD = lm.forward_train, encdec.forward_train

    def model_loss(arch, mesh):
        # the model's own forward_train: the logits' placements, the
        # loss and the gradients on the mesh and without it
        name, _, vocab = arch.partition("@")
        cfg = reduced(get_config(name))
        if vocab:
            cfg = dataclasses.replace(cfg, vocab_size=int(vocab))
        p0 = steps.init_params(torch.Generator().manual_seed(0), cfg)
        batch = {k: torch.from_numpy(v).clamp(max=cfg.vocab_size - 1)
                 for k, v in d["models"][arch].items()}
        p = sharding.distribute(p0, mesh, sharding.param_specs(p0, mesh))
        specs = sharding.batch_specs(cfg, mesh, "train",
                                     batch["tokens"].shape[0])
        mb = sharding.distribute(batch, mesh, {k: specs[k] for k in batch})
        if cfg.is_encdec:
            logits = encdec.forward_train(p, cfg, mb["enc_embeds"],
                                          mb["tokens"])
            fn = encdec.loss_fn
        else:
            logits, _ = lm.forward_train(p, cfg, mb["tokens"],
                                         mb.get("embeds"))
            fn = lm.loss_fn
        loss, _, grads = steps._value_and_grad(p, cfg, mb)
        loss0, _, grads0 = steps._value_and_grad(p0, cfg, batch)
        flat = lambda g: torch.cat([t.reshape(-1).double() for _, t in
                                    tree_flatten_with_path(g)])
        full = tree_unflatten(grads, [t.full_tensor() for _, t in
                                      tree_flatten_with_path(grads)])
        return {"placements": tuple(logits.placements),
                "loss": float(loss.full_tensor()), "plain": float(loss0),
                "grad_rel": float((flat(full) - flat(grads0)).norm()
                                  / flat(grads0).norm())}

    res = {}
    try:
        for name, (shape, axes) in d["meshes"].items():
            mesh = tmesh.make_mesh(shape, axes, device_type="cpu")
            for arch in d["models"]:
                res[(name, arch)] = model_loss(arch, mesh)
            for case, (x, t, kind, sharded) in d["cases"].items():
                pl, rows = placed(x, mesh, sharded)
                xl = local_of(torch.from_numpy(x), mesh, pl)
                xl.requires_grad_()
                logits = sharding.from_local(xl, mesh, pl, x.shape)
                targets = DTensor.from_local(
                    local_of(torch.from_numpy(t), mesh, rows), mesh, rows,
                    run_check=False)
                b = x.shape[0]
                with dryrun.StepCounter(mesh) as c:
                    if kind == "encdec":
                        encdec.forward_train = lambda p, *a: p
                        loss, _ = encdec.loss_fn(
                            logits, cfg, {"enc_embeds": None, "tokens": None,
                                          "targets": targets})
                    elif kind == "lm":
                        lm.forward_train = lambda p, *a: (p, {})
                        loss, _ = lm.loss_fn(
                            logits, cfg, {"tokens": None, "targets": targets,
                                          "embeds": torch.zeros(
                                              b, d["front"], 1)})
                    else:
                        loss = lm.masked_nll(logits, targets)
                    loss.backward()
                lm.forward_train = LM_FORWARD
                encdec.forward_train = ED_FORWARD
                grad = sharding.from_local(xl.grad, mesh, pl,
                                           x.shape).full_tensor()
                res[(name, case)] = {
                    "loss": float(loss.full_tensor()),
                    "loss_placements": tuple(loss.placements),
                    "grad": grad.double().numpy(),
                    "vocab_sharded": any(p == Shard(2) for p in pl),
                    "row_axes": [a for a, p in zip(axes, rows)
                                 if p == Shard(0) and mesh.size(
                                     axes.index(a)) > 1],
                    "collectives": c.by_axis}
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
""").replace("JOIN_S", str(JOIN_S))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(mesh, case): [each rank's result]} from the two worlds, run
    together."""
    start = time.monotonic()
    tmp = tmp_path_factory.mktemp("loss_parallel")
    (tmp / "rank.py").write_text(RANK)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = []
    for world in ("gloo", "gloo_cuda"):
        d = {"cases": CASES, "front": FRONT, "models": MODELS,
             "meshes": {n: (s, a) for n, (s, a, w) in MESHES.items()
                        if w == world}}
        (tmp / f"in_{world}.pkl").write_bytes(pickle.dumps(d))
        procs += [(f"{world} rank {r}", subprocess.Popen(
            [sys.executable, str(tmp / "rank.py"), str(r),
             str(tmp / f"store_{world}"), str(tmp / f"in_{world}.pkl"),
             str(tmp / f"out_{world}_{r}.pkl"), world], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
            for r in range(4)]
    try:
        for name, p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(start + JOIN_S - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name} did not end {JOIN_S} s after "
                                     f"the fixture began")
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = {}
    for world in ("gloo", "gloo_cuda"):
        for r in range(4):
            got = pickle.loads((tmp / f"out_{world}_{r}.pkl").read_bytes())
            for k, v in got.items():
                out.setdefault(k, []).append(v)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    return {c: _jax_loss_and_grad(x, t, kind)
            for c, (x, t, kind, _) in CASES.items()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_vocab_parallel_loss_and_grad_equal_jax(ranks, jax_ref, mesh, case):
    """Every rank reads JAX's loss within 1e-5 relative, replicated; the
    logits' gradient assembled from the ranks' pieces within 1e-5
    relative L2 of ``jax.grad``'s (exactly zero where every row is
    masked)."""
    want_loss, want_grad = jax_ref[case]
    for r in ranks[(mesh, case)]:
        np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-5)
        assert all(type(p).__name__ == "Replicate"
                   for p in r["loss_placements"])
        if case == "all_masked":
            assert want_loss == 0.0 and not np.any(want_grad)
            np.testing.assert_array_equal(r["grad"], 0.0)
        else:
            assert _rel_l2(r["grad"], want_grad) <= 1e-5


@pytest.mark.parametrize("arch", list(MODELS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_train_keeps_the_vocab_sharded(ranks, mesh, arch):
    """The models' own ``forward_train`` on the mesh (reduced qwen2-1.5b,
    also at a vocab of 255, qwen2-vl-7b with its frontend rows,
    seamless-m4t-medium, from seeded parameters): the logits keep the
    vocab ``Shard`` over ``model`` (where the rule tables replicate the
    head, as at 255, the loss splits its rows) and the rows over the data
    axes that divide the batch; ``loss_fn`` on the mesh is the meshless
    port's within 1e-5 relative, its gradients within 1e-5 relative L2."""
    from torch.distributed.tensor import Replicate, Shard
    shape, axes, _ = MESHES[mesh]
    for r in ranks[(mesh, arch)]:
        # a mesh dim of one rank holds the whole either way
        want = [Replicate() if n == 1 else
                Shard(2) if a == "model" else Shard(0)
                for a, n in zip(axes, shape)]
        got = [Replicate() if n == 1 else p
               for p, n in zip(r["placements"], shape)]
        assert got == want, (r["placements"], want)
        np.testing.assert_allclose(r["loss"], r["plain"], rtol=1e-5)
        assert r["grad_rel"] <= 1e-5, r["grad_rel"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_loss_gathers_nothing(ranks, mesh):
    """The loss's collectives on every rank, forward and backward: no
    all-gather, no all-to-all; three all-reduces over ``model`` (the
    row max, the sum of exponentials, the gold logit) where the vocab is
    sharded over several ranks of it, none where it is replicated or
    ``model`` has one rank; one over each data
    axis that splits the rows (the masked sum and the count). The
    backward adds none."""
    shape, axes, _ = MESHES[mesh]
    for case in CASES:
        for r in ranks[(mesh, case)]:
            by_axis = r["collectives"]
            for per in by_axis.values():
                assert per["all-gather"] == 0 and per["all-to-all"] == 0
            b = CASES[case][0].shape[0]
            model = by_axis.get("model", {}).get("all-reduce", 0)
            if r["vocab_sharded"] and shape[axes.index("model")] > 1:
                # three f32 pieces of the rank's rows and positions
                rows = b // np.prod([shape[axes.index(a)]
                                     for a in r["row_axes"]])
                s = CASES[case][1].shape[1]
                assert model == 3 * rows * s * 4, (case, by_axis)
            else:
                assert model == 0, (case, by_axis)
            for a in ("pod", "data"):
                got = by_axis.get(a, {}).get("all-reduce", 0)
                assert got == (8 if a in r["row_axes"] else 0), (case, a)
