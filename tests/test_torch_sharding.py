"""The port's sharding rules (``repro_torch.distributed.sharding``), its
wide-mesh execution (``launch.steps`` on DTensors, ``launch.train
.TrainLoop(mesh=)``), ``checkpoint/reshard.py`` and the step bundles,
against the JAX package's on the CPU.

* Rule tables, with no ranks: for every registered arch on abstract
  ``(16, 16)`` and ``(2, 16, 16)`` meshes, ``param_specs``, ``opt_specs``
  and, for each ``SHAPES`` cell, ``batch_specs`` and ``cache_specs_tree``
  equal JAX's on its ``make_abstract_mesh`` (as tuples); the
  divisibility fallback, the rule against using an axis twice,
  ``placements``, ``input_specs`` on ``meta``, ``leaf_slice_bytes``,
  ``save_unsharded_spec``, the local-heads rule and the refusals.
* Gloo worlds: one 4-rank world per mesh shape, ``(2, 2)``, ``(4, 1)``
  and ``(1, 4)`` over ``("data", "model")``, on reduced qwen2-1.5b (f32;
  4 q heads and 1 kv head of 16): ranks joined by a ``FileStore`` under
  ``tmp_path``, started together with JAX's reference subprocess, all
  joined by one ``JOIN_S`` deadline from the fixture's start, every
  result in one pickle per rank. 3
  train steps from JAX's parameters against JAX's meshless step and the
  port's: losses within 1e-5 relative, the parameters within 1e-4
  relative L2 (the whole parameter vector); the placements of every
  carried leaf after every step; the activations' placements after each
  block; the local head counts the kernel saw; ``TrainLoop(mesh=)`` bit
  for bit ``make_train_step``; a checkpoint saved on ``(2, 2)`` restored
  onto ``(4, 1)`` and then onto no mesh, bit for bit; the decode
  bundle's greedy tokens equal to ``ModelServer``'s; every registered
  arch building a train step and a decode bundle, reduced seamless
  training a step. The ``(2, 2)`` world also runs a ``(2, 2, 1)`` mesh over
  ``("pod", "data", "model")``: the pod axis composes with ``data`` for
  the batch (against JAX's meshless step), and the int8 pod reduce
  against JAX's compressed step on four host devices (the tolerance of
  ``tests/test_torch_distributed.py``: int8 codes can flip at a rounding
  boundary). The ``(1, 4)`` world registers ``distributed/gloo_cuda.py``'s
  collectives for the CPU, so its cases run through the implementations
  the card's gloo worlds use, and holds each op to its definition.
"""
import functools
import os
import pickle
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.checkpoint import reshard as j_reshard
from repro.compat import make_abstract_mesh
from repro.configs import base as j_base
from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config, list_archs
from repro.distributed import sharding as js
from repro.launch import steps as j_steps
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import reshard
from repro_torch.configs import base as t_base
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as ts
from repro_torch.launch import steps
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.optim import adamw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs()
ARCH = "qwen2-1.5b"
LR = 1e-3
STEPS = 3
# One deadline for every process a fixture starts, counted from the
# fixture's start, and the ranks' gloo timeout: over 3x the slowest
# world fixture seen (276 s, the gloo test modules run together on 6
# xdist workers over 8 cores).
JOIN_S = 900
WORLDS = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
# batches (2, 2) does not split into even rows per data rank, or at all
UNEVEN = (1, 3, 6, 10)


def _is_p(x):
    return isinstance(x, P)


def _jax_leaves(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(tree, is_leaf=_is_p)]


def _port_leaves(tree):
    return [tuple(s) for s in ts.spec_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _structs(arch):
    """(JAX params struct, port params struct) of the full-size arch."""
    return (j_steps.params_struct(j_get_config(arch)),
            steps.params_struct(get_config(arch)))


def _meshes(name):
    shape, axes = MESHES[name]
    return make_abstract_mesh(shape, axes), ts.AbstractMesh(shape, axes)


# ---------------------------------------------------------------------------
# rule tables against JAX, no ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jp, tp = _structs(arch)
    assert all(t.device.type == "meta" for _, t in tree_flatten_with_path(tp))
    assert ([p for p, _ in tree_flatten_with_path(tp)]
            == [tuple(getattr(k, "key", getattr(k, "idx", None))
                      for k in p)
                for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]])
    assert _port_leaves(ts.param_specs(tp, tm)) == _jax_leaves(
        js.param_specs(jp, jm))
    jo = jax.eval_shape(lambda p: j_adamw.adamw_init(
        p, j_adamw.AdamWConfig()), jp)
    to = adamw.adamw_init(tp, adamw.AdamWConfig())
    assert _port_leaves(ts.opt_specs(to, tm)) == _jax_leaves(
        js.opt_specs(jo, jm))


@pytest.mark.parametrize("cell", list(j_base.SHAPES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, mesh, cell):
    jm, tm = _meshes(mesh)
    jc, tc = j_get_config(arch), get_config(arch)
    ss = t_base.SHAPES[cell]
    jb = js.batch_specs(jc, jm, ss.kind, ss.global_batch)
    tb = ts.batch_specs(tc, tm, ss.kind, ss.global_batch)
    assert {k: tuple(v) for k, v in tb.items()} == {
        k: tuple(v) for k, v in jb.items()}
    if ss.kind == "train":
        return
    jcs = j_steps.cache_struct(jc, ss.global_batch, ss.seq_len)
    tcs = steps.cache_struct(tc, ss.global_batch, ss.seq_len)
    assert [tuple(t.shape) for _, t in tree_flatten_with_path(tcs)] == [
        tuple(a.shape) for a in jax.tree_util.tree_leaves(jcs)]
    assert _port_leaves(ts.cache_specs_tree(
        tcs, tc, tm, ss.global_batch)) == _jax_leaves(
        js.cache_specs_tree(jcs, jc, jm, ss.global_batch))


@pytest.mark.parametrize("cell", list(j_base.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_on_meta_equal_jax(arch, cell):
    """Every input of the cell on ``meta`` (no bytes allocated), the
    shapes and dtypes JAX's ``ShapeDtypeStruct``s have."""
    want = j_base.input_specs(j_get_config(arch), cell)
    got = t_base.input_specs(get_config(arch), cell)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape)
        assert str(v.dtype).replace("torch.", "") == str(want[k].dtype)
    assert t_base.SHAPES[cell] == t_base.ShapeSpec(
        *(getattr(j_base.SHAPES[cell], f)
          for f in ("name", "seq_len", "global_batch", "kind")))


@pytest.mark.parametrize("case", [
    # (shape, wanted, mesh shape, axes)
    ((48, 64), ("data", "model"), (16, 16), ("data", "model")),
    ((12, 64), ("model", "data"), (16, 16), ("data", "model")),
    ((64, 64), ("data", "data"), (16, 16), ("data", "model")),
    ((64, 32), (("pod", "data"), "model"), (2, 16, 16),
     ("pod", "data", "model")),
    ((48, 32), (("pod", "data"), "data"), (2, 16, 16),
     ("pod", "data", "model")),
    ((32, 8), ("model", None), (4, 2), ("data", "model")),
    ((7,), ("seq",), (4, 2), ("data", "model")),
])
def test_mk_fallback_and_axis_used_once_equal_jax(case):
    """The divisibility fallback (an axis that does not divide the dim is
    dropped), the rule against using an axis twice, trailing trimming."""
    shape, wanted, mshape, axes = case
    got = ts._mk(ts.AbstractMesh(mshape, axes), shape, wanted)
    want = js._mk(make_abstract_mesh(mshape, axes), shape, wanted)
    assert tuple(got) == tuple(want)


def test_mk_cases_hold_what_they_name():
    m = ts.AbstractMesh((16, 16), ("data", "model"))
    assert ts._mk(m, (12, 64), ("model", "data")) == ts.Spec(None, "data")
    assert ts._mk(m, (64, 64), ("data", "data")) == ts.Spec("data")
    assert ts._mk(m, (8,), (None,)) == ts.Spec()
    assert ts.Spec(("data",), ()) == ("data", None)


@pytest.mark.parametrize("spec", [
    ("pod", "data"), (("pod", "data"), None, "model"), (None, "model"), (),
])
def test_placements_in_mesh_dim_order(spec):
    """``Shard(d)`` on each mesh dim the tensor dim ``d`` takes, a dim over
    ("pod", "data") on both; ``Replicate()`` elsewhere. ``named`` and
    ``tree_named`` carry the mesh, the spec and its placements."""
    from torch.distributed.tensor import Replicate, Shard
    m = ts.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    got = ts.placements(m, spec)
    expect = [Replicate()] * 3
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            expect[("pod", "data", "model").index(a)] = Shard(d)
    assert got == tuple(expect)
    if spec == (("pod", "data"), None, "model"):
        assert got == (Shard(0), Shard(0), Shard(2))
    n = ts.named(m, spec)
    assert (n.mesh, tuple(n.spec), n.placements) == (m, tuple(spec), got)
    tree = ts.tree_named(m, {"a": ts.Spec(*spec), "b": (ts.Spec(),)})
    assert tree["a"].placements == got
    assert tree["b"][0].placements == (Replicate(),) * 3


def test_placements_refuse_an_axis_the_mesh_lacks():
    with pytest.raises(ValueError, match="'pod'"):
        ts.placements(ts.AbstractMesh((4, 2), ("data", "model")),
                      ("pod", None))
    with pytest.raises(ValueError, match="differ in length"):
        ts.AbstractMesh((4, 2), ("data",))


@pytest.mark.parametrize("args", [
    ((64, 8), np.float32, 0, 3, 4), ((10, 3, 2), np.float16, 0, 0, 5),
    ((16,), np.int32, 0, 1, 2), ((8, 4), np.float64, 0, 7, 8)])
def test_leaf_slice_bytes_equal_jax(args):
    assert reshard.leaf_slice_bytes(*args) == j_reshard.leaf_slice_bytes(
        *args)


def test_leaf_slice_bytes_refuses_other_axes_and_takes_torch_dtypes():
    for mod in (reshard, j_reshard):
        with pytest.raises(ValueError, match="leading-axis"):
            mod.leaf_slice_bytes((4, 4), np.float32, 1, 0, 2)
    assert reshard.leaf_slice_bytes((6, 5), torch.bfloat16, 0, 1, 3) == (
        20, 20)


def test_save_unsharded_spec_equals_jax():
    cfg_j, cfg_t = j_reduced(j_get_config(ARCH)), t_base.reduced(
        get_config(ARCH))
    jp = jax.tree_util.tree_map(
        np.asarray, j_steps.init_params(jax.random.PRNGKey(0), cfg_j))
    from repro_torch import convert
    tp = convert.lm_params(jp, cfg_t, "cpu")
    assert reshard.save_unsharded_spec(tp) == j_reshard.save_unsharded_spec(
        jp)


@pytest.mark.parametrize("hq,hkv,m,want", [
    (12, 2, 2, (True, True, 6, 1)),      # qwen2-1.5b at model=2
    (12, 2, 4, (True, False, 3, 1)),     # half a kv head per rank: replicate
    (4, 1, 2, (True, False, 2, 1)),      # reduced qwen2-1.5b
    (4, 1, 4, (True, False, 1, 1)),
    (12, 3, 2, (False, False, 12, 3)),   # local q heads span two groups
    (6, 6, 4, (False, False, 6, 6)),     # 4 does not divide the heads
    (16, 16, 1, (False, False, 16, 16)),
])
def test_head_layout(hq, hkv, m, want):
    """The local-heads rule: every rank's q heads and the kv heads they
    use form a valid GQA call (``Hq_local % Hkv_local == 0``, query head
    ``h`` on kv head ``h // (Hq / Hkv)``)."""
    lay = ts.head_layout(ts.AbstractMesh((1, m), ("data", "model")), hq,
                         hkv)
    assert (lay.q_sharded, lay.kv_sharded, lay.hq_local,
            lay.kv_local) == want
    rep = hq // hkv
    for r in range(m):
        q0 = r * lay.hq_local if lay.q_sharded else 0
        k0 = r * lay.kv_local if lay.kv_sharded else lay.kv_lo(r)
        assert lay.hq_local % lay.kv_local == 0
        local_rep = lay.hq_local // lay.kv_local
        for h in range(lay.hq_local):
            assert (q0 + h) // rep == k0 + h // local_rep


def test_bundles_on_abstract_meshes_match_jax():
    """``build_step_bundle`` on the abstract production meshes: the
    argument structs on ``meta`` and the input/output specs equal JAX's
    for the four cells of qwen2-1.5b."""
    for name in MESHES:
        jm, tm = _meshes(name)
        for cell in j_base.SHAPES:
            jb = j_steps.build_step_bundle(j_get_config(ARCH), cell, jm)
            tb = steps.build_step_bundle(get_config(ARCH), cell, tm)
            assert tb.kind == jb.kind and tb.donate == jb.donate
            assert _port_leaves(tb.in_specs) == _jax_leaves(jb.in_specs)
            assert _port_leaves(tb.out_specs) == _jax_leaves(jb.out_specs)
            assert [tuple(t.shape) for _, t in tree_flatten_with_path(
                tb.arg_structs)] == [tuple(a.shape) for a in
                                     jax.tree_util.tree_leaves(
                                         jb.arg_structs)]
            assert all(t.device.type == "meta" for _, t in
                       tree_flatten_with_path(tb.arg_structs))


# ---------------------------------------------------------------------------
# gloo worlds
# ---------------------------------------------------------------------------

RANK = textwrap.dedent("""
    import os, pickle, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec, reduced
    from repro_torch.configs.registry import get_config, list_archs
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as tmesh, steps
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import blocks
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim import adamw
    from repro_torch.serving.server import ModelServer

    rank, store, inp, out, shape = (int(sys.argv[1]), sys.argv[2],
                                    sys.argv[3], sys.argv[4],
                                    tuple(int(x) for x in
                                          sys.argv[5].split(",")))
    with open(inp, "rb") as f:
        d = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4,
                            timeout=timedelta(seconds=JOIN_S))
    res_ops = None
    if shape == (1, 4):
        # this world's DTensor collectives go through gloo_cuda's
        # implementations (registered for the CPU here): the card's path
        from repro_torch.distributed import gloo_cuda
        gloo_cuda.install("CPU")
        g = dist.group.WORLD.group_name
        x = torch.arange(32, dtype=torch.float32).reshape(4, 8) + 100 * rank
        f = torch.ops._c10d_functional
        res_ops = {
            "all_gather": f.all_gather_into_tensor(x, 4, g),
            "reduce_scatter_sum": f.reduce_scatter_tensor(x, "sum", 4, g),
            "reduce_scatter_avg": f.reduce_scatter_tensor(x, "avg", 4, g),
            "all_reduce_max": f.all_reduce(x, "max", g),
            "broadcast": f.broadcast(x, 2, g),
            "all_to_all": f.all_to_all_single(x, [1] * 4, [1] * 4, g),
            "shard_dim_alltoall": torch.ops._dtensor.shard_dim_alltoall(
                x, 0, 1, g)}
        res_ops = {k: f.wait_tensor(v).numpy() for k, v in res_ops.items()}
    cfg = reduced(get_config(d["arch"]))
    ocfg = adamw.AdamWConfig(lr=d["lr"], warmup_steps=0)
    batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}
    res = {"ops": res_ops}

    def full(tree):
        return [t.full_tensor().double().numpy()
                for _, t in tree_flatten_with_path(tree)]

    def placed_as_specs(tree, specs, mesh):
        return all(tuple(t.placements) == sharding.placements(mesh, s)
                   for t, s in zip((t for _, t in
                                    tree_flatten_with_path(tree)),
                                   sharding.spec_leaves(specs)))

    try:
        mesh = tmesh.make_mesh(shape, ("data", "model"), device_type="cpu")
        p0 = convert.lm_params(d["params"], cfg, "cpu")
        pspecs = sharding.param_specs(p0, mesh)

        # activations after every block, and what the kernel was given
        seen_blocks, seen_heads = [], []
        block_train = blocks.block_train
        def spy_block(*a, **k):
            x, m = block_train(*a, **k)
            seen_blocks.append((tuple(x.shape), tuple(x.placements),
                                tuple(x.to_local().shape)))
            return x, m
        blocks.block_train = spy_block
        flash = ops.flash_attention
        def spy_flash(q, k, v, **kw):
            seen_heads.append((q.shape[2], k.shape[2], q.shape[0]))
            return flash(q, k, v, **kw)
        ops.flash_attention = spy_flash

        step = steps.make_train_step(cfg, ocfg, mesh=mesh)
        p = sharding.distribute(p0, mesh, pspecs)
        s = adamw.adamw_init(p, ocfg)
        ospecs = sharding.opt_specs(s, mesh)
        res["placed_before"] = (placed_as_specs(p, pspecs, mesh)
                                and placed_as_specs(s, ospecs, mesh))
        losses, params, placed = [], [], []
        for _ in range(d["steps"]):
            p, s, m = step(p, s, batch)
            losses.append(float(m["loss"]))
            params.append(full(p))
            placed.append(placed_as_specs(p, pspecs, mesh)
                          and placed_as_specs(s, ospecs, mesh))
            res.setdefault("grad_norms", []).append(float(m["grad_norm"]))
        blocks.block_train = block_train
        ops.flash_attention = flash
        res.update(losses=losses, params=params, placed=placed,
                   blocks=seen_blocks, heads=seen_heads,
                   count=(tuple(s.count.placements),
                          int(s.count.full_tensor())),
                   local_param_bytes=sum(
                       t.to_local().numel() * t.element_size()
                       for _, t in tree_flatten_with_path(p)))

        # TrainLoop(mesh=): bit for bit the steps above; a checkpoint
        loop = TrainLoop(cfg, opt_cfg=ocfg, mesh=mesh, device="cpu",
                         ckpt_dir=d["ckpt"] + "/a")
        res["loop_placed"] = (placed_as_specs(loop.params, pspecs, mesh)
                              and placed_as_specs(loop.opt_state, ospecs,
                                                  mesh))
        loop.params = sharding.distribute(p0, mesh, pspecs)
        loop.opt_state = adamw.adamw_init(loop.params, ocfg)
        ran = loop.run(iter([d["batch"]] * d["steps"]), steps=d["steps"],
                       log_every=0)
        res["loop_losses"] = [h["loss"] for h in ran["history"]]
        res["loop_params"] = full(loop.params)
        loop.save(block=True)

        # a checkpoint every step, the third step reported bad once: the
        # supervisor rolls every rank back to step 2, then step 3 again
        roll = TrainLoop(cfg, opt_cfg=ocfg, mesh=mesh, device="cpu",
                         ckpt_dir=d["ckpt"] + "/r")
        roll.params = sharding.distribute(p0, mesh, pspecs)
        roll.opt_state = adamw.adamw_init(roll.params, ocfg)
        good, calls = roll.train_step, []

        def bad_once(p_, s_, b_):
            calls.append(roll.step)
            out_ = good(p_, s_, b_)
            if len(calls) == 3:
                return p_, s_, dict(out_[2], skipped=1.0)
            return out_

        roll.train_step = bad_once
        rolled = {}

        def on_roll(i, m):
            if m.get("rolled_back"):
                rolled[i] = full(roll.params)

        ran = roll.run(iter([d["batch"]] * (d["steps"] + 1)),
                       steps=d["steps"], ckpt_every=1, max_bad_steps=1,
                       log_every=0, on_metrics=on_roll)
        res["rollback"] = {
            "calls": calls, "rolled": rolled, "step": roll.step,
            "flags": [h.get("rolled_back", 0.0) for h in ran["history"]],
            "params": full(roll.params),
            "placed": (placed_as_specs(roll.params, pspecs, mesh)
                       and placed_as_specs(roll.opt_state, ospecs, mesh))}
        if shape == (2, 2):
            # reshard: onto (4, 1), which saves for the meshless restore
            mesh41 = tmesh.make_mesh((4, 1), ("data", "model"),
                                     device_type="cpu")
            other = TrainLoop(cfg, opt_cfg=ocfg, mesh=mesh41,
                              device="cpu", ckpt_dir=d["ckpt"] + "/a")
            assert other.restore()
            res["reshard_step"] = other.step
            res["reshard_params"] = full(other.params)
            res["reshard_opt"] = full(other.opt_state)
            res["reshard_placed"] = placed_as_specs(
                other.params, sharding.param_specs(other.params, mesh41),
                mesh41)
            other.ckpt = type(other.ckpt)(d["ckpt"] + "/b")
            other.save(block=True)

            # the pod axis composes with data; the int8 pod reduce
            pod = tmesh.make_mesh((2, 2, 1), ("pod", "data", "model"),
                                  device_type="cpu")
            pp = sharding.param_specs(p0, pod)
            for c in (False, True):
                st = steps.make_train_step(cfg, ocfg, mesh=pod,
                                           compress_crosspod=c)
                q = sharding.distribute(p0, pod, pp)
                qs = adamw.adamw_init(q, ocfg)
                ls, ps_, gs = [], [], []
                for _ in range(d["steps"]):
                    q, qs, m = st(q, qs, batch)
                    ls.append(float(m["loss"]))
                    ps_.append(full(q))
                    gs.append(float(m["grad_norm"]))
                res[f"pod_{c}"] = (ls, ps_, placed_as_specs(q, pp, pod), gs)

        # serving: the prefill and decode bundles against ModelServer
        B, P_, C, N = d["serve"]
        toks = d["prompts"]
        srv = ModelServer(cfg, p0, batch=B, cache_len=C)
        srv.prefill(toks)
        srv.decode(N)
        res["server_tokens"] = np.array(srv.generated)
        pb = steps.build_step_bundle(cfg, ShapeSpec("prompt", P_, B,
                                                    "prefill"), mesh,
                                     cache_len=C)
        db = steps.build_step_bundle(cfg, ShapeSpec("serve", C, B,
                                                    "decode"), mesh)
        params, t = pb.place(p0, torch.from_numpy(toks))
        logits, caches = pb.fn(params, t)
        cache_ok = [placed_as_specs(caches, db.in_specs[1], mesh)]
        tok = torch.argmax(logits.full_tensor(), -1).to(torch.int32)
        pos = torch.full((B,), P_, dtype=torch.int32)
        got = [tok]
        for _ in range(N):
            td = sharding.distribute(tok, mesh, db.in_specs[2])
            pd = sharding.distribute(pos, mesh, db.in_specs[3])
            logits, caches = db.fn(params, caches, td, pd)
            cache_ok.append(placed_as_specs(caches, db.out_specs[1], mesh))
            tok = torch.argmax(logits.full_tensor(), -1).to(torch.int32)
            pos = pos + 1
            got.append(tok)
        res["bundle_tokens"] = torch.stack(got, 1).numpy()
        res["cache_placed"] = cache_ok

        # every registered arch, the encoder-decoder among them, builds a
        # train step and a decode bundle on the mesh (the bundle's specs
        # those of the abstract mesh of this shape); reduced seamless
        # takes one train step there
        am = sharding.AbstractMesh(shape, ("data", "model"))
        res["built"] = {}
        for arch in list_archs():
            rc = reduced(get_config(arch))
            made = steps.make_train_step(rc, ocfg, mesh=mesh)
            b = steps.build_step_bundle(rc, "decode_32k", mesh)
            ab = steps.build_step_bundle(rc, "decode_32k", am)
            res["built"][arch] = (
                callable(made), b.kind, b.mesh is mesh,
                [tuple(x) for x in sharding.spec_leaves(b.in_specs)]
                == [tuple(x) for x in sharding.spec_leaves(ab.in_specs)])
        seamless = reduced(get_config("seamless-m4t-medium"))
        sp = steps.init_params(torch.Generator().manual_seed(0), seamless)
        sp = sharding.distribute(sp, mesh, sharding.param_specs(sp, mesh))
        _, _, m = steps.make_train_step(seamless, ocfg, mesh=mesh)(
            sp, adamw.adamw_init(sp, ocfg),
            {k: torch.from_numpy(v) for k, v in d["seamless"].items()})
        res["seamless"] = (float(m["loss"]), float(m["grad_norm"]))

        # batches the data axis does not split into even rows (B=1: the
        # sequence-sharded cache): train, prefill and decode
        if shape == (2, 2):
            res["uneven"] = {}
            for b, (ub, uprompts) in d["uneven"].items():
                q = sharding.distribute(p0, mesh, pspecs)
                qs = adamw.adamw_init(q, ocfg)
                ls, ps_, gs = [], [], []
                for _ in range(d["steps"]):
                    q, qs, m = step(q, qs, {k: torch.from_numpy(v)
                                            for k, v in ub.items()})
                    ls.append(float(m["loss"]))
                    ps_.append(full(q))
                    gs.append(float(m["grad_norm"]))
                srv = ModelServer(cfg, p0, batch=b, cache_len=C)
                srv.prefill(uprompts)
                srv.decode(N)
                pb = steps.build_step_bundle(
                    cfg, ShapeSpec("prompt", P_, b, "prefill"), mesh,
                    cache_len=C)
                db = steps.build_step_bundle(
                    cfg, ShapeSpec("serve", C, b, "decode"), mesh)
                params, t = pb.place(p0, torch.from_numpy(uprompts))
                logits, caches = pb.fn(params, t)
                placed_c = [placed_as_specs(caches, db.in_specs[1], mesh)]
                tok = torch.argmax(logits.full_tensor(), -1).to(torch.int32)
                pos = torch.full((b,), P_, dtype=torch.int32)
                got = [tok]
                for _ in range(N):
                    logits, caches = db.fn(
                        params, caches,
                        sharding.distribute(tok, mesh, db.in_specs[2]),
                        sharding.distribute(pos, mesh, db.in_specs[3]))
                    placed_c.append(placed_as_specs(caches, db.out_specs[1],
                                                    mesh))
                    tok = torch.argmax(logits.full_tensor(), -1).to(
                        torch.int32)
                    pos = pos + 1
                    got.append(tok)
                res["uneven"][b] = {
                    "train": (ls, ps_, gs, placed_as_specs(q, pspecs, mesh)),
                    "server_tokens": np.array(srv.generated),
                    "bundle_tokens": torch.stack(got, 1).numpy(),
                    "cache_placed": placed_c}
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
""").replace("JOIN_S", str(JOIN_S))

JAX_REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.compat import make_mesh
    from repro.configs.base import reduced
    from repro.configs.registry import get_config
    from repro.launch.steps import make_train_step
    from repro.optim.adamw import AdamWConfig, adamw_init

    with open(sys.argv[1], "rb") as f:
        d = pickle.load(f)
    cfg = reduced(get_config(d["arch"]))
    ocfg = AdamWConfig(lr=d["lr"], warmup_steps=0)
    batch = {k: jnp.asarray(v) for k, v in d["batch"].items()}
    res = {}
    for name, mesh, c in (("plain", None, False),
                          ("pod_int8", make_mesh((2, 2, 1), ("pod", "data",
                                                             "model")),
                           True)):
        step = jax.jit(make_train_step(cfg, ocfg, mesh=mesh,
                                       compress_crosspod=c))
        p = jax.tree_util.tree_map(jnp.asarray, d["params"])
        s = adamw_init(p, ocfg)
        ls, ps, gs = [], [], []
        for _ in range(d["steps"]):
            if mesh is not None:
                with mesh:
                    p, s, m = step(p, s, batch)
            else:
                p, s, m = step(p, s, batch)
            ls.append(float(m["loss"]))
            ps.append([np.asarray(x, np.float64)
                       for x in jax.tree_util.tree_leaves(p)])
            gs.append(float(m["grad_norm"]))
        res[name] = (ls, ps, gs)
    res["uneven"] = {}
    step = jax.jit(make_train_step(cfg, ocfg))
    for b, (ub, _) in d["uneven"].items():
        p = jax.tree_util.tree_map(jnp.asarray, d["params"])
        s = adamw_init(p, ocfg)
        ls, ps, gs = [], [], []
        for _ in range(d["steps"]):
            p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in ub.items()})
            ls.append(float(m["loss"]))
            ps.append([np.asarray(x, np.float64)
                       for x in jax.tree_util.tree_leaves(p)])
            gs.append(float(m["grad_norm"]))
        res["uneven"][b] = (ls, ps, gs)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(res, f)
""")


def _run_all(procs, start):
    """Join every process by one deadline, JOIN_S seconds after ``start``
    (``time.monotonic()`` when the fixture began); kill the rest."""
    try:
        for name, p in procs:
            try:
                _, err = p.communicate(timeout=_left(start, JOIN_S))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name} did not end {JOIN_S} s after "
                                     f"the fixture began")
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _left(start, limit):
    """Seconds left of ``limit`` since ``start``; at least one, so a
    process that ended in time still hands over its output."""
    return max(start + limit - time.monotonic(), 1.0)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three 4-rank worlds and JAX's reference, run together once
    for the module: (inputs, {world: [rank results]}, JAX's results,
    the checkpoint dir)."""
    start = time.monotonic()
    tmp = tmp_path_factory.mktemp("worlds")
    jc = j_reduced(j_get_config(ARCH))
    jp = jax.tree_util.tree_map(
        np.asarray, j_steps.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(11)
    d = {"arch": ARCH, "lr": LR, "steps": STEPS, "params": jp,
         "batch": {k: rng.integers(0, jc.vocab_size, (8, 16))
                   .astype(np.int32) for k in ("tokens", "targets")},
         "serve": (4, 8, 32, 6),
         "prompts": rng.integers(0, jc.vocab_size, (4, 8)).astype(np.int32),
         "uneven": {b: ({k: rng.integers(0, jc.vocab_size, (b, 16))
                         .astype(np.int32) for k in ("tokens", "targets")},
                        rng.integers(0, jc.vocab_size, (b, 8))
                        .astype(np.int32)) for b in UNEVEN}}
    d["seamless"] = dict(
        enc_embeds=rng.standard_normal((4, 8, 64)).astype(np.float32),
        **{k: rng.integers(0, 256, (4, 6)).astype(np.int32)
           for k in ("tokens", "targets")})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    (tmp / "rank.py").write_text(RANK)
    (tmp / "jax_ref.py").write_text(JAX_REF)
    inp = tmp / "in.pkl"
    procs = []
    for w, shape in WORLDS.items():
        dw = dict(d, ckpt=str(tmp / f"ckpt_{w}"))
        (tmp / f"in_{w}.pkl").write_bytes(pickle.dumps(dw))
        procs += [(f"{w} rank {r}", subprocess.Popen(
            [sys.executable, str(tmp / "rank.py"), str(r),
             str(tmp / f"store_{w}"), str(tmp / f"in_{w}.pkl"),
             str(tmp / f"out_{w}_{r}.pkl"), ",".join(map(str, shape))],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)) for r in range(4)]
    inp.write_bytes(pickle.dumps(d))
    procs.append(("jax", subprocess.Popen(
        [sys.executable, str(tmp / "jax_ref.py"), str(inp),
         str(tmp / "jax.pkl")], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    _run_all(procs, start)
    ranks = {w: [pickle.loads((tmp / f"out_{w}_{r}.pkl").read_bytes())
                 for r in range(4)] for w in WORLDS}
    return d, ranks, pickle.loads((tmp / "jax.pkl").read_bytes()), tmp


def _rel_l2(got, want):
    num = sum(float(np.sum((np.asarray(a) - np.asarray(b)) ** 2))
              for a, b in zip(got, want))
    den = sum(float(np.sum(np.asarray(b) ** 2)) for b in want)
    return (num / den) ** 0.5


def _port_plain_steps(d, batch=None):
    """The port's meshless step from the same parameters on ``batch``
    (the module's by default): (loss, parameters, gradient norm) after
    each step."""
    from repro_torch import convert
    cfg = t_base.reduced(get_config(ARCH))
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=0)
    step = steps.make_train_step(cfg, ocfg)
    p = convert.lm_params(d["params"], cfg, "cpu")
    s = adamw.adamw_init(p, ocfg)
    tb = {k: torch.from_numpy(v) for k, v in (batch or d["batch"]).items()}
    out = []
    for _ in range(STEPS):
        p, s, m = step(p, s, tb)
        out.append((float(m["loss"]), [t.double().numpy() for _, t in
                                       tree_flatten_with_path(p)],
                    float(m["grad_norm"])))
    return out


@pytest.mark.parametrize("world", list(WORLDS))
def test_train_steps_match_jax_and_the_meshless_step(worlds, world):
    """Losses and the global gradient norm of each step within 1e-5
    relative of JAX's meshless step and of the port's (a gradient summed
    where it should be averaged over ``data`` moves the norm, which Adam
    would hide from the parameters), the parameters within 1e-4
    relative L2; every rank reads the same losses and norms."""
    d, ranks, jres, _ = worlds
    jl, jp, jg = jres["plain"]
    plain = _port_plain_steps(d)
    for r in range(4):
        assert ranks[world][r]["losses"] == ranks[world][0]["losses"]
        assert ranks[world][r]["grad_norms"] == ranks[world][0]["grad_norms"]
    res = ranks[world][0]
    np.testing.assert_allclose(res["losses"], jl, rtol=1e-5)
    np.testing.assert_allclose(res["losses"], [l for l, _, _ in plain],
                               rtol=1e-5)
    np.testing.assert_allclose(res["grad_norms"], jg, rtol=1e-5)
    np.testing.assert_allclose(res["grad_norms"], [g for _, _, g in plain],
                               rtol=1e-5)
    for i in range(STEPS):
        assert _rel_l2(res["params"][i], jp[i]) <= 1e-4
        assert _rel_l2(res["params"][i], plain[i][1]) <= 1e-4


@pytest.mark.parametrize("world", list(WORLDS))
def test_every_carried_leaf_keeps_its_placements(worlds, world):
    """Parameters and optimizer state placed by their specs before the
    first step and after every step, on every rank; ``count`` replicated
    and counting the steps."""
    _, ranks, _, _ = worlds
    for res in ranks[world]:
        assert res["placed_before"] and all(res["placed"])
        pl, n = res["count"]
        assert n == STEPS and all(type(x).__name__ == "Replicate"
                                  for x in pl)


@pytest.mark.parametrize("world", list(WORLDS))
def test_fsdp_keeps_the_batch_sharded_after_every_block(worlds, world):
    """After each block the activations are (B, S, d) sharded over
    ``data`` on the batch where the data axis divides it, replicated over
    ``model``: FSDP gathered the weights, not the activations. Each
    rank's parameter and optimizer bytes are its shards' (a
    1/(data·model) share of the sharded leaves)."""
    from torch.distributed.tensor import Replicate, Shard
    _, ranks, _, _ = worlds
    data, model = WORLDS[world]
    for res in ranks[world]:
        # 2 layers a step (the remat recompute stops before a block
        # returns: torch.utils.checkpoint's early stop)
        assert len(res["blocks"]) == 2 * STEPS
        for shape, pl, local in res["blocks"]:
            assert pl == ((Shard(0) if data > 1 else Replicate()),
                          Replicate())
            assert local == (shape[0] // data,) + shape[1:]
    if data * model > 1:
        assert ranks[world][0]["local_param_bytes"] < (
            sum(a.nbytes for a in ranks[world][0]["params"][0]) // 2)


@pytest.mark.parametrize("world", list(WORLDS))
def test_kernels_see_whole_local_heads(worlds, world):
    """Reduced qwen2-1.5b has 4 q heads and 1 kv head: at model=2 or 4 a
    rank takes 4/m q heads with the one kv head (replicated, so each
    rank's K/V is the whole kv head, never half of it); every local call
    is a valid GQA call over the rank's share of the batch (2 layers a
    step, each run again by the remat recompute)."""
    _, ranks, _, _ = worlds
    data, model = WORLDS[world]
    for res in ranks[world]:
        assert len(res["heads"]) == 2 * 2 * STEPS
        for hq, hkv, b in res["heads"]:
            assert (hq, hkv, b) == (4 // model, 1, 8 // data)
            assert hq % hkv == 0


@pytest.mark.parametrize("world", list(WORLDS))
def test_train_loop_on_the_mesh_is_make_train_step(worlds, world):
    _, ranks, _, _ = worlds
    for res in ranks[world]:
        assert res["loop_placed"]
        assert res["loop_losses"] == res["losses"]
        for a, b in zip(res["loop_params"], res["params"][-1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", list(WORLDS))
def test_rollback_after_a_bad_step_restores_one_step_on_every_rank(
        worlds, world):
    """``TrainLoop.run`` with a checkpoint every step, the third step
    reported bad once (``max_bad_steps=1``): every rank rolls back to
    step 2, holding step 2's parameters bit for bit, then takes step 3
    again; the final parameters are the plain run's, bit for bit, the
    same on every rank and in their specs' placements."""
    _, ranks, _, _ = worlds
    for res in ranks[world]:
        rb = res["rollback"]
        assert rb["calls"] == [0, 1, 2, 2] and rb["step"] == STEPS
        assert rb["flags"] == [0.0, 0.0, 1.0, 0.0] and rb["placed"]
        assert list(rb["rolled"]) == [2]
        for a, b in zip(rb["rolled"][2], res["params"][1]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(rb["params"], res["loop_params"]):
            np.testing.assert_array_equal(a, b)


def test_reshard_2x2_to_4x1_to_no_mesh_bit_for_bit(worlds):
    """A checkpoint saved by ``TrainLoop`` on (2, 2) restores onto a
    (4, 1) loop, placed by that mesh's rules, bit for bit; saved again
    there, it restores onto the meshless loop bit for bit."""
    from repro_torch.launch.train import TrainLoop
    _, ranks, _, tmp = worlds
    res = ranks["2x2"][0]
    assert res["reshard_step"] == STEPS and res["reshard_placed"]
    for a, b in zip(res["reshard_params"], res["loop_params"]):
        np.testing.assert_array_equal(a, b)
    cfg = t_base.reduced(get_config(ARCH))
    loop = TrainLoop(cfg, opt_cfg=adamw.AdamWConfig(lr=LR), device="cpu",
                     ckpt_dir=str(tmp / "ckpt_2x2" / "b"))
    assert loop.restore() and loop.step == STEPS
    got = [t.double().numpy() for _, t in tree_flatten_with_path(
        loop.params)]
    for a, b in zip(got, res["loop_params"]):
        np.testing.assert_array_equal(a, b)
    got = [t.double().numpy() for _, t in tree_flatten_with_path(
        loop.opt_state)]
    for a, b in zip(got, res["reshard_opt"]):
        np.testing.assert_array_equal(a, b)


def test_pod_axis_composes_with_data(worlds):
    """A (2, 2, 1) mesh over ("pod", "data", "model"): the uncompressed
    step (the batch over pod and data) within the module's tolerance of
    JAX's meshless step; the int8 pod reduce against JAX's compressed
    step on a (2, 2, 1) mesh of four host devices, within the pod
    tolerance of ``tests/test_torch_distributed.py``. Both steps' global
    gradient norms within 1e-5 relative of JAX's."""
    _, ranks, jres, _ = worlds
    res = ranks["2x2"][0]
    jl, jp, jg = jres["plain"]
    ls, ps, placed, gs = res["pod_False"]
    assert placed
    np.testing.assert_allclose(ls, jl, rtol=1e-5)
    np.testing.assert_allclose(gs, jg, rtol=1e-5)
    for i in range(STEPS):
        assert _rel_l2(ps[i], jp[i]) <= 1e-4
    ls, ps, placed, gs = res["pod_True"]
    cl, cp, cg = jres["pod_int8"]
    assert placed
    np.testing.assert_allclose(ls, cl, rtol=1e-5)
    np.testing.assert_allclose(gs, cg, rtol=1e-5)
    flips = total = 0
    for got, want in zip(ps, cp):
        for a, b in zip(got, want):
            diff = np.abs(a - b)
            assert diff.max() <= STEPS * 2 * LR
            flips += int((diff > 1e-2 * LR).sum())
            total += diff.size
    assert flips <= 1e-3 * total, (flips, total)
    for r in range(4):
        assert ranks["2x2"][r]["pod_True"][0] == ls


@pytest.mark.parametrize("world", list(WORLDS))
def test_decode_bundle_greedy_tokens_equal_model_server(worlds, world):
    """Prefill then 6 decode steps through the bundles on the mesh: the
    greedy tokens equal the meshless ``ModelServer``'s, and the caches
    keep the placements ``cache_specs_tree`` gives them."""
    _, ranks, _, _ = worlds
    for res in ranks[world]:
        np.testing.assert_array_equal(res["bundle_tokens"],
                                      res["server_tokens"])
        assert all(res["cache_placed"])


@pytest.mark.parametrize("arch", ARCHS)
def test_every_registered_arch_builds_on_a_wide_mesh(worlds, arch):
    """Every registered config, reduced, the encoder-decoder included,
    builds a train step and a decode bundle on each world's mesh, the
    bundle's input specs those of the abstract mesh of its shape: no
    config is refused where the data or model axis has several ranks."""
    _, ranks, _, _ = worlds
    for w in WORLDS:
        for res in ranks[w]:
            assert res["built"][arch] == (True, "decode", True, True), w


@pytest.mark.parametrize("world", list(WORLDS))
def test_the_encoder_decoder_trains_on_the_mesh(worlds, world):
    """One step of reduced seamless-m4t-medium on the world from seeded
    parameters: the loss and the gradient norm within 1e-5 relative of
    the port's meshless step, on every rank
    (``tests/test_torch_sharding_encdec.py`` holds it to JAX)."""
    d, ranks, _, _ = worlds
    cfg = t_base.reduced(get_config("seamless-m4t-medium"))
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=0)
    p = steps.init_params(torch.Generator().manual_seed(0), cfg)
    _, _, m = steps.make_train_step(cfg, ocfg)(
        p, adamw.adamw_init(p, ocfg),
        {k: torch.from_numpy(v) for k, v in d["seamless"].items()})
    want = (float(m["loss"]), float(m["grad_norm"]))
    for res in ranks[world]:
        np.testing.assert_allclose(res["seamless"], want, rtol=1e-5)


@pytest.mark.parametrize("b", UNEVEN)
def test_uneven_batches_train_on_2x2(worlds, b):
    """Batches of 1, 3, 6 and 10 rows on (2, 2): ``data`` does not divide
    1, 3 or 10 (the activations stay replicated over it) and gives 6 three
    rows a rank. Three steps of ``make_train_step`` against JAX's meshless
    step and the port's, at the module's tolerances, every carried leaf
    still in its placements; every rank reads the same losses."""
    d, ranks, jres, _ = worlds
    jl, jp, jg = jres["uneven"][b]
    plain = _port_plain_steps(d, d["uneven"][b][0])
    ls, ps, gs, placed = ranks["2x2"][0]["uneven"][b]["train"]
    assert placed
    for r in range(4):
        assert ranks["2x2"][r]["uneven"][b]["train"][0] == ls
    np.testing.assert_allclose(ls, jl, rtol=1e-5)
    np.testing.assert_allclose(ls, [l for l, _, _ in plain], rtol=1e-5)
    np.testing.assert_allclose(gs, jg, rtol=1e-5)
    np.testing.assert_allclose(gs, [g for _, _, g in plain], rtol=1e-5)
    for i in range(STEPS):
        assert _rel_l2(ps[i], jp[i]) <= 1e-4
        assert _rel_l2(ps[i], plain[i][1]) <= 1e-4


@pytest.mark.parametrize("b", UNEVEN)
def test_uneven_batches_serve_on_2x2(worlds, b):
    """The prefill and decode bundles at 1, 3, 6 and 10 slots on (2, 2):
    greedy tokens equal to the meshless ``ModelServer``'s, the caches in
    the placements ``cache_specs_tree`` gives them (at B=1 and 3 the
    sequence over ``data``)."""
    _, ranks, _, _ = worlds
    for res in ranks["2x2"]:
        u = res["uneven"][b]
        np.testing.assert_array_equal(u["bundle_tokens"], u["server_tokens"])
        assert all(u["cache_placed"])


def test_gloo_cuda_collectives_in_the_1x4_world(worlds):
    """``distributed/gloo_cuda.py``'s implementations of DTensor's
    functional collectives (registered for the CPU in the (1, 4) world,
    whose train, serve and reshard cases above all ran through them):
    each op against its definition on the four ranks' inputs."""
    _, ranks, _, _ = worlds
    xs = [np.arange(32, dtype=np.float32).reshape(4, 8) + 100 * r
          for r in range(4)]
    stacked = np.concatenate(xs, 0)
    total = sum(xs)
    for r, res in enumerate(ranks["1x4"]):
        ops_ = res["ops"]
        np.testing.assert_array_equal(ops_["all_gather"], stacked)
        np.testing.assert_array_equal(ops_["reduce_scatter_sum"],
                                      total[r:r + 1])
        np.testing.assert_allclose(ops_["reduce_scatter_avg"],
                                   total[r:r + 1] / 4, rtol=1e-6)
        np.testing.assert_array_equal(ops_["all_reduce_max"], xs[3])
        np.testing.assert_array_equal(ops_["broadcast"], xs[2])
        np.testing.assert_array_equal(
            ops_["all_to_all"], np.stack([xs[j][r] for j in range(4)]))
        np.testing.assert_array_equal(ops_["shard_dim_alltoall"],
                                      np.split(stacked, 4, axis=1)[r])
    for w in ("2x2", "4x1"):
        assert ranks[w][0]["ops"] is None
