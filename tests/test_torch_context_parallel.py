"""The port's streaming attention layout (``cfg.attn_block_k``,
``cfg.act_dp``, ``cfg.act_sp``: the JAX package's ``_pin_dp`` and
``flash_attention_xla``) on a 4-rank gloo world, against the JAX package
run meshless with the same ``attn_block_k``, and against the meshless
port.

Reduced qwen2-1.5b (2 layers, d 64, vocab 256, QKV bias) at two head
counts: 4 query heads over 1 kv head (the ``model`` axis of 2 divides the
query heads, so the pin overrides the port's head-sharded layout) and 3
over 1 (it divides neither). Parameters from JAX's ``init_params``
carried by ``repro_torch.convert``; batches of 4 × 64 tokens from a numpy
seed. On ``(2, 2)`` over ``("data", "model")`` with ``act_dp=("data",)``,
``act_sp="model"`` and ``attn_block_k=16``:

* the loss and its gradients on the mesh against JAX's ``loss_fn`` under
  ``jax.value_and_grad`` (loss and gradient norm 1e-5 relative, every
  leaf 1e-5 relative L2);
* three AdamW steps (``make_train_step(mesh=)``) against the meshless
  port's: losses and gradient norms 1e-5, parameters 1e-4 relative L2;
* each rank's flash call saw the ``S/2`` query rows of its ``model``
  coordinate, at ``q_offset = r·S/2``, against all ``S`` keys;
* the prefill bundle's logits against JAX's ``prefill`` within 1e-4
  (f32), ``attend_prefill``'s caches in the decode step's placements
  (``_kv_placements``), the bundle's in ``cache_specs_tree``'s, and one
  decode step from them against JAX's;
* at ``S = 24`` (16 does not divide it) the sequence stays whole, as in
  JAX, and the loss is JAX's;
* the int8 cross-pod step on ``(2, 1, 2)`` over ``("pod", "data",
  "model")`` with ``act_dp=("pod", "data")``: each pod's step runs on its
  submesh with ``"pod"`` dropped from ``act_dp`` (which the submesh would
  refuse), its loss the meshless port's.

The world runs ``distributed/gloo_cuda.py``'s collectives registered for
the CPU (the card's path), from a ``FileStore`` under ``tmp_path``,
joined by one ``JOIN_S`` deadline from the fixture's start.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.launch import steps as j_steps
from repro.models import lm as j_lm
from repro_torch import convert
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.launch import steps
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.optim import adamw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCH = "qwen2-1.5b"
# One deadline for every process a fixture starts, counted from the
# fixture's start, and the ranks' gloo timeout: over 3x the slowest
# world fixture seen (276 s, the gloo test modules run together on 6
# xdist workers over 8 cores).
JOIN_S = 900
B, S, S_ODD, STEPS, LR = 4, 64, 24, 3, 1e-3
BLOCK = 16
HEADS = {"heads4": {}, "heads3": {"n_heads": 3, "n_kv_heads": 1,
                                  "head_dim": 16}}
STREAMING = dict(attn_block_k=BLOCK, act_dp=("data",), act_sp="model")


def _jax_cfg(name):
    return dataclasses.replace(j_reduced(j_get_config(ARCH)),
                               attn_block_k=BLOCK, **HEADS[name])


def _port_cfg(name):
    return dataclasses.replace(reduced(get_config(ARCH)), attn_block_k=BLOCK,
                               **HEADS[name])


def _inputs():
    rng = np.random.default_rng(31)
    out = {}
    for seq in (S, S_ODD):
        out[seq] = {k: rng.integers(0, 256, (B, seq)).astype(np.int32)
                    for k in ("tokens", "targets")}
    out["next"] = rng.integers(0, 256, (B,)).astype(np.int32)
    return out


INPUTS = _inputs()
PARAMS = {n: jax.tree_util.tree_map(
    np.asarray, j_steps.init_params(jax.random.PRNGKey(0), _jax_cfg(n)))
    for n in HEADS}


RANK = textwrap.dedent("""
    import dataclasses, pickle, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import gloo_cuda, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models import attention, blocks, lm
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim import adamw

    rank, store, inp, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4])
    with open(inp, "rb") as f:
        d = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4,
                            timeout=timedelta(seconds=JOIN_S))
    gloo_cuda.install("CPU")
    seen = []
    flash = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw.get("q_offset"),
                     kw.get("block_k")))
        return flash(q, k, v, **kw)

    ops.flash_attention = spy

    def cfg_of(name, **layout):
        layout = dict({"attn_block_k": d["block"]}, **layout)
        return dataclasses.replace(reduced(get_config(d["arch"])),
                                   **d["heads"][name], **layout)

    def full(tree):
        return [t.full_tensor().double().numpy()
                for _, t in tree_flatten_with_path(tree)]

    def placed(p0, batch, cfg, mesh):
        p = sharding.distribute(p0, mesh, sharding.param_specs(p0, mesh))
        specs = sharding.batch_specs(cfg, mesh, "train",
                                     batch["tokens"].shape[0])
        return p, sharding.distribute(batch, mesh,
                                      {k: specs[k] for k in batch})

    res = {}
    try:
        mesh = tmesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        res["model_rank"] = mesh.get_local_rank("model")
        for name in d["heads"]:
            cfg = cfg_of(name, **d["layout"])
            p0 = convert.lm_params(d["params"][name], cfg, "cpu")
            for seq in (d["S"], d["S_odd"]):
                batch = {k: torch.from_numpy(v)
                         for k, v in d["inputs"][seq].items()}
                p, mb = placed(p0, batch, cfg, mesh)
                seen.clear()
                loss, _, grads = steps._value_and_grad(p, cfg, mb)
                res[(name, seq, "loss")] = float(loss.full_tensor())
                res[(name, seq, "grads")] = full(grads)
                res[(name, seq, "seen")] = list(seen)

            # AdamW steps on the mesh
            ocfg = adamw.AdamWConfig(lr=d["lr"], warmup_steps=0)
            step = steps.make_train_step(cfg, ocfg, mesh=mesh)
            batch = {k: torch.from_numpy(v)
                     for k, v in d["inputs"][d["S"]].items()}
            p = sharding.distribute(p0, mesh, sharding.param_specs(p0, mesh))
            s = adamw.adamw_init(p, ocfg)
            hist = []
            for _ in range(d["steps"]):
                p, s, m = step(p, s, batch)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            res[(name, "train")] = hist
            res[(name, "train_params")] = full(p)

            # prefill and one decode step through the bundles; the
            # attention layer's own caches
            C = d["S"] + 1
            pb = steps.build_step_bundle(
                cfg, ShapeSpec("p", d["S"], d["B"], "prefill"), mesh,
                cache_len=C)
            db = steps.build_step_bundle(
                cfg, ShapeSpec("d", C, d["B"], "decode"), mesh)
            pp = pb.place(p0)[0]
            tok = sharding.distribute(batch["tokens"], mesh, pb.in_specs[1])
            seen.clear()
            logits, caches = pb.fn(pp, tok)
            res[(name, "prefill_seen")] = list(seen)
            res[(name, "prefill")] = logits.full_tensor().double().numpy()
            res[(name, "cache_placed")] = all(
                tuple(t.placements) == sharding.placements(mesh, sp)
                for (_, t), sp in zip(tree_flatten_with_path(caches),
                                      sharding.spec_leaves(db.in_specs[1])))
            token, pos = (sharding.distribute(
                torch.as_tensor(x, dtype=torch.int32), mesh, sp)
                for x, sp in ((d["inputs"]["next"], db.in_specs[2]),
                              (np.full(d["B"], d["S"]), db.in_specs[3])))
            logits, _ = db.fn(pp, caches, token, pos)
            res[(name, "decode")] = logits.full_tensor().double().numpy()
            h = sharding.pin_dp(sharding.distribute(
                torch.randn(d["B"], d["S"], cfg.d_model,
                            generator=torch.Generator().manual_seed(1)),
                mesh, sharding.Spec(None)))
            positions = sharding.like(torch.arange(d["S"], dtype=torch.int32)
                                      .expand(d["B"], d["S"]).contiguous(), h)
            layer = blocks._layer(pp["blocks"], 0, h)
            layer = layer[0] if isinstance(layer, tuple) else layer
            _, cache = attention.attend_prefill(layer["attn"], h, cfg,
                                                positions, C)
            lay = sharding.head_layout(mesh, cfg.n_heads, cfg.n_kv_heads)
            res[(name, "layer_cache_placed")] = all(
                tuple(t.placements) == attention._kv_placements(h, lay)
                for t in cache.values())

        # the int8 cross-pod step: "pod" dropped from act_dp on the submesh
        pmesh = tmesh.make_mesh((2, 1, 2), ("pod", "data", "model"),
                                device_type="cpu")
        cfg = cfg_of("heads4", act_dp=("pod", "data"), act_sp="model")
        p0 = convert.lm_params(d["params"]["heads4"], cfg, "cpu")
        ocfg = adamw.AdamWConfig(lr=d["lr"], warmup_steps=0)
        step = steps.make_train_step(cfg, ocfg, mesh=pmesh,
                                     compress_crosspod=True)
        p = sharding.distribute(p0, pmesh, sharding.param_specs(p0, pmesh))
        s = adamw.adamw_init(p, ocfg)
        seen.clear()
        _, _, m = step(p, s, {k: torch.from_numpy(v)
                              for k, v in d["inputs"][d["S"]].items()})
        res["pod_loss"] = float(m["loss"])
        res["pod_seen"] = list(seen)
        try:
            sharding.act_specs(pmesh["data", "model"], ("pod", "data"),
                               "model", 2, d["S"])
            res["pod_refused"] = False
        except ValueError:
            res["pod_refused"] = True
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
""").replace("JOIN_S", str(JOIN_S))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results from the 4-rank world."""
    start = time.monotonic()
    tmp = tmp_path_factory.mktemp("context_parallel")
    (tmp / "rank.py").write_text(RANK)
    d = {"arch": ARCH, "block": BLOCK, "heads": HEADS, "layout": STREAMING,
         "params": PARAMS, "inputs": INPUTS, "S": S, "S_odd": S_ODD,
         "B": B, "steps": STEPS, "lr": LR}
    (tmp / "in.pkl").write_bytes(pickle.dumps(d))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "rank.py"), str(r), str(tmp / "store"),
         str(tmp / "in.pkl"), str(tmp / f"out_{r}.pkl")], env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(4)]
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(start + JOIN_S - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} did not end {JOIN_S} s "
                                     f"after the fixture began")
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [pickle.loads((tmp / f"out_{r}.pkl").read_bytes())
            for r in range(4)]


@pytest.fixture(scope="module")
def jax_ref():
    """JAX meshless at the same ``attn_block_k``: the loss and gradients
    at both lengths, the prefill logits and one decode step's."""
    out = {}
    for name in HEADS:
        cfg, params = _jax_cfg(name), PARAMS[name]
        for seq in (S, S_ODD):
            batch = {k: jnp.asarray(v) for k, v in INPUTS[seq].items()}
            (loss, _), grads = jax.value_and_grad(
                j_lm.loss_fn, has_aux=True)(params, cfg, batch)
            out[(name, seq)] = (float(loss), [
                np.asarray(g, np.float64)
                for _, g in tree_flatten_with_path(
                    jax.tree_util.tree_map(np.asarray, grads))])
        logits, caches = j_lm.prefill(params, cfg,
                                      jnp.asarray(INPUTS[S]["tokens"]), S + 1)
        step, _ = j_lm.decode_step(params, cfg, caches,
                                   jnp.asarray(INPUTS["next"]),
                                   jnp.full((B,), S, jnp.int32))
        out[(name, "prefill")] = np.asarray(logits, np.float64)
        out[(name, "decode")] = np.asarray(step, np.float64)
    return out


@pytest.fixture(scope="module")
def meshless():
    """The meshless port (the CPU's streaming plain version): AdamW steps'
    losses, gradient norms and final parameters, per head count; the
    loss of the step the pod world takes."""
    out = {}
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=0)
    batch = {k: torch.from_numpy(v) for k, v in INPUTS[S].items()}
    for name in HEADS:
        cfg = _port_cfg(name)
        p = convert.lm_params(PARAMS[name], cfg, "cpu")
        s = adamw.adamw_init(p, ocfg)
        step = steps.make_train_step(cfg, ocfg)
        hist = []
        for _ in range(STEPS):
            p, s, m = step(p, s, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        out[name] = (hist, [t.double().numpy()
                            for _, t in tree_flatten_with_path(p)])
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


def _rel_l2(got, want):
    g = np.concatenate([x.ravel() for x in got])
    w = np.concatenate([x.ravel() for x in want])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("seq", [S, S_ODD])
@pytest.mark.parametrize("name", list(HEADS))
def test_loss_and_gradients_equal_jax(ranks, jax_ref, name, seq):
    """Every rank reads JAX's loss within 1e-5 relative; the gradients,
    assembled from the ranks' pieces, have JAX's global norm within 1e-5
    relative and each leaf within 1e-5 relative L2."""
    want_loss, want = jax_ref[(name, seq)]
    want_norm = np.sqrt(sum(float((g ** 2).sum()) for g in want))
    for r in ranks:
        got = r[(name, seq, "grads")]
        assert _rel(r[(name, seq, "loss")], want_loss) <= 1e-5
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in got))
        assert _rel(norm, want_norm) <= 1e-5
        for g, w in zip(got, want):
            assert _rel_l2([g], [w]) <= 1e-5


@pytest.mark.parametrize("name", list(HEADS))
def test_each_rank_attends_its_half_of_the_rows(ranks, name):
    """With ``act_sp`` and 16 | S, every flash call of a rank took the
    ``S/2`` query rows of its ``model`` coordinate at ``q_offset =
    r·S/2`` against all S keys, with ``block_k`` passed on: in training
    two a layer (the forward and ``remat='dots'``'s recompute), in the
    prefill one; at S = 24 the sequence stayed whole (default offset)."""
    for r in ranks:
        c = S // 2
        want = (c, S, r["model_rank"] * c, BLOCK)
        assert r[(name, S, "seen")] == [want] * 4, r[(name, S, "seen")]
        assert r[(name, S_ODD, "seen")] == [(S_ODD, S_ODD, None, BLOCK)] * 4
        assert r[(name, "prefill_seen")] == [want] * 2


@pytest.mark.parametrize("name", list(HEADS))
def test_train_steps_equal_the_meshless_port(ranks, meshless, name):
    """Three AdamW steps on the mesh against the meshless port's: losses
    and gradient norms within 1e-5 relative, the parameters after the
    steps within 1e-4 relative L2, on every rank."""
    hist, params = meshless[name]
    for r in ranks:
        for (lg, ng), (lw, nw) in zip(r[(name, "train")], hist):
            assert _rel(lg, lw) <= 1e-5 and _rel(ng, nw) <= 1e-5
        assert _rel_l2(r[(name, "train_params")], params) <= 1e-4


@pytest.mark.parametrize("name", list(HEADS))
def test_prefill_and_decode_equal_jax_and_keep_the_decode_layout(
        ranks, jax_ref, name):
    """The prefill's last-position logits within 1e-4 of JAX's (f32); the
    attention layer leaves its caches in the placements the decode step
    takes, the bundle in ``cache_specs_tree``'s; a decode step from them
    within 1e-4 of JAX's."""
    for r in ranks:
        for what in ("prefill", "decode"):
            got, want = r[(name, what)], jax_ref[(name, what)]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert r[(name, "cache_placed")] and r[(name, "layer_cache_placed")]


def test_crosspod_step_drops_pod_from_act_dp(ranks, meshless):
    """The int8 cross-pod step on (2, 1, 2): each pod's gradients run on
    its (data, model) submesh, which refuses an ``act_dp`` naming
    ``"pod"``; the step drops it, the rows still split over ``model``,
    and its loss (before the update) is the meshless port's."""
    hist, _ = meshless["heads4"]
    for r in ranks:
        assert r["pod_refused"]
        assert _rel(r["pod_loss"], hist[0][0]) <= 1e-5
        assert [(q, k) for q, k, _, _ in r["pod_seen"]] == [(S // 2, S)] * 4
