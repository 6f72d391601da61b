"""Port training path (``repro_torch.models.lm.loss_fn``,
``repro_torch.optim``, ``repro_torch.launch.{steps,train}``,
``repro_torch.data.pipeline``, ``repro_torch.checkpoint``) against the JAX
package's on the same numpy inputs, on the CPU.

Parameters are drawn by the JAX package and carried across with
``repro_torch.convert.lm_params`` (optimizer state with
``convert.opt_state``); batches are numpy. Configs are the reduced
qwen2-1.5b and qwen1.5-0.5b (f32, 2 layers, d 64), and for the other
decoder-only families the reduced granite-moe-3b-a800m (MoE, its aux
losses folded into the loss), jamba-v0.1-52b (one period: Mamba-2, MoE
and attention blocks), mamba2-780m and qwen2-vl-7b (frontend embeddings,
the loss on the text positions).

Tolerances: loss ``rtol 1e-4`` and every gradient within ``1e-4``
relative L2 (f32; the model tier's logits tolerance); optimizer updates,
schedules and norms ``rtol 1e-6`` (f32 elementwise arithmetic, the pow
and cos of the two libraries may differ in the last bit); one train step's
new parameters ``rtol 1e-5`` relative L2; a trainer's loss history over
its steps ``rtol 1e-4``; the host pipeline and the checkpoint files exact.
One train step from zero moments: ``m`` within ``1e-4`` relative L2, the
new parameters within ``1e-2·lr`` absolute, and within the step's bound
``2·lr`` where the gradient is within ``100·eps`` of 0 (the first Adam
step is ``lr·g/(|g|+eps)`` elementwise, so such a gradient carries the
libraries' f32 rounding of ``g`` into its update).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.data.pipeline import HostPipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import HostPipeline, PipelineConfig
from repro_torch.launch import steps, train
from repro_torch.models import lm
from repro_torch.models.tree import tree_flatten_with_path, tree_unflatten
from repro_torch.optim import adamw

torch.set_num_threads(1)

ARCHS = ("qwen2-1.5b", "qwen1.5-0.5b")
FAMILIES = ("granite-moe-3b-a800m", "jamba-v0.1-52b", "mamba2-780m")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(arch, **kw):
    return (dataclasses.replace(jreduced(jget_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jparams(jc, seed=1):
    return _np(jlm.init_lm(jax.random.PRNGKey(seed), jc))


def _batch(cfg, b=4, s=16, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if masked:
        tgt[0, :3] = -100
    out = {"tokens": toks, "targets": tgt}
    if cfg.frontend:        # unit-RMS stand-ins for the stub's embeddings
        e = rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
        out["embeds"] = (e / np.sqrt((e * e).mean(-1, keepdims=True))
                         ).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree):
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                       else x, np.float64)
            for _, x in tree_flatten_with_path(tree)]


def _jleaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_jax(arch, remat):
    jc, tc = _cfgs(arch, remat=remat)
    jp = _jparams(jc)
    batch = _batch(jc)
    (jl, jm), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, jc, _j(batch))
    tp = convert.lm_params(jp, tc, "cpu")
    flat = tree_flatten_with_path(tp)
    leaves = [p.requires_grad_() for _, p in flat]
    tl, tm = lm.loss_fn(tree_unflatten(tp, leaves), tc, _t(batch))
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tm["nll"].detach()), float(jm["nll"]),
                               rtol=1e-4)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jflat) == len(grads)
    for (jpath, jgv), (path, _), g in zip(jflat, flat, grads):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in jpath)
        assert name == "/".join(str(k) for k in path)
        assert _rel_l2(g.numpy().astype(np.float64),
                       np.asarray(jgv, np.float64)) < 1e-4, name


def _grads_equal_jax(jc, tc, jp, batch):
    (jl, jm), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, jc, _j(batch))
    tp = convert.lm_params(jp, tc, "cpu")
    flat = tree_flatten_with_path(tp)
    leaves = [p.requires_grad_() for _, p in flat]
    tl, tm = lm.loss_fn(tree_unflatten(tp, leaves), tc, _t(batch))
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jflat) == len(grads)
    for (jpath, jgv), (path, _), g in zip(jflat, flat, grads):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in jpath)
        assert name == "/".join(str(k) for k in path)
        assert bool(torch.isfinite(g).all()), name
        assert _rel_l2(g.numpy().astype(np.float64),
                       np.asarray(jgv, np.float64)) < 1e-4, name
    return tm


@pytest.mark.parametrize("arch", FAMILIES + ("qwen2-vl-7b",))
def test_family_loss_and_gradients_equal_jax(arch):
    """``loss_fn`` (with the MoE fold ``aux_coef·moe_aux/n_layers +
    router_z_coef·moe_zloss/n_layers`` and its metrics) and the gradient
    of every parameter, Mamba, expert and router leaves included."""
    jc, tc = _cfgs(arch)
    batch = _batch(jc)
    tm = _grads_equal_jax(jc, tc, _jparams(jc), batch)
    assert ("moe_aux" in tm) == (tc.moe is not None)
    if tc.moe is not None:
        folded = (tm["nll"] + tc.moe.aux_coef * tm["moe_aux"] / tc.n_layers
                  + tc.moe.router_z_coef * tm["moe_zloss"] / tc.n_layers)
        assert float(tm["loss"].detach()) == float(folded.detach())
        assert float(tm["loss"].detach()) > float(tm["nll"].detach())


def test_remat_changes_no_value():
    _, tc = _cfgs("qwen2-1.5b")
    jc, _ = _cfgs("qwen2-1.5b")
    jp = _jparams(jc)
    batch = _t(_batch(jc))
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tc, remat=remat)
        tp = convert.lm_params(jp, cfg, "cpu")
        leaves = [p.requires_grad_() for _, p in tree_flatten_with_path(tp)]
        loss, _ = lm.loss_fn(tree_unflatten(tp, leaves), cfg, batch)
        out[remat] = [float(loss.detach())] + [
            g.numpy() for g in torch.autograd.grad(loss, leaves)]
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1:], out["none"][1:]):
            np.testing.assert_array_equal(a, b, err_msg=remat)


def test_remat_dots_with_moe_chooses_the_same_experts():
    """jamba (remat ``dots``): the selective checkpoint recomputes the
    router's top-k, the sort and the gathers in the backward pass; the
    loss and every gradient are those of remat ``none``, bit for bit."""
    jc, tc = _cfgs("jamba-v0.1-52b")
    assert get_config("jamba-v0.1-52b").remat == "dots"
    jp = _jparams(jc, seed=2)
    batch = _t(_batch(jc, seed=2))
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(tc, remat=remat)
        tp = convert.lm_params(jp, cfg, "cpu")
        leaves = [p.requires_grad_() for _, p in tree_flatten_with_path(tp)]
        loss, m = lm.loss_fn(tree_unflatten(tp, leaves), cfg, batch)
        out[remat] = [float(loss.detach()),
                      float(m["moe_aux"].detach())] + [
            g.numpy() for g in torch.autograd.grad(loss, leaves)]
    for remat in ("dots", "full"):
        assert out[remat][:2] == out["none"][:2]
        for a, b in zip(out[remat][2:], out["none"][2:]):
            np.testing.assert_array_equal(a, b, err_msg=remat)


def test_training_params_keep_the_head_in_the_graph():
    """No cached f32 head in training: the head's gradient reaches the
    (tied) embedding."""
    _, tc = _cfgs("qwen2-1.5b")
    jc, _ = _cfgs("qwen2-1.5b")
    tp = convert.lm_params(_jparams(jc), tc, "cpu")
    tp["embed"].requires_grad_()
    loss, _ = lm.loss_fn(tp, tc, _t(_batch(jc)))
    g, = torch.autograd.grad(loss, [tp["embed"]])
    # rows of tokens that never appear as inputs still get the head's grad
    assert float(g.abs().sum(-1).min()) > 0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched", ["constant", "linear", "cosine"])
def test_schedules_equal_jax(sched):
    cfg = dict(lr=1.0, schedule=sched, warmup_steps=10, total_steps=100,
               min_lr_frac=0.1)
    f = adamw.make_schedule(adamw.AdamWConfig(**cfg))
    jf = jadamw.make_schedule(jadamw.AdamWConfig(**cfg))
    steps_ = np.arange(0, 121)
    got = f(torch.tensor(steps_, dtype=torch.int32)).numpy()
    want = np.asarray(jf(jnp.asarray(steps_)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0
    assert got[10] == pytest.approx(1.0, rel=1e-5)


def _opt_tree(rng, dtype=np.float32):
    shapes = {"embed": (8, 4), "final_norm": {"scale": (4,)},
              "blocks": ({"attn": {"wq": {"w": (4, 4), "b": (4,)}},
                          "norm1": {"scale": (4,)},
                          "mlp": {"wi": (4, 6)}},),
              "D": (3,), "A_log": (2,), "mamba": {"dt_bias": (2,)}}
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s).astype(dtype), shapes,
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(i, int) for i in x))


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(a), tree)


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_update_equals_jax(master, clip):
    rng = np.random.default_rng(0)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip,
               warmup_steps=2, total_steps=10, master_weights=master)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    js = jadamw.adamw_init(params, jcfg)
    ts = adamw.adamw_init(_to_torch(params), tcfg)
    jp, tp = params, _to_torch(params)
    for _ in range(3):
        jp, js, jm = jadamw.adamw_update(grads, js, jp, jcfg)
        tp, ts, tm = adamw.adamw_update(_to_torch(grads), ts, tp, tcfg)
        for a, b in zip(_leaves(tp), _jleaves(jp)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        for a, b in zip(_leaves(ts.m) + _leaves(ts.v),
                        _jleaves(js.m) + _jleaves(js.v)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-10)
        assert int(ts.count) == int(js.count)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        if clip is not None:
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
    assert (ts.master is None) == (not master)


def test_decay_mask_equals_jax_on_model_trees():
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        jp = _jparams(jc)
        jmask = [jadamw._decay_mask(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(jp)[0]]
        tmask = [adamw._decay_mask(p) for p, _ in
                 tree_flatten_with_path(convert.lm_params(jp, tc, "cpu"))]
        assert tmask == jmask and not all(tmask) and any(tmask)


def test_clip_by_global_norm_equals_jax():
    rng = np.random.default_rng(2)
    g = _opt_tree(rng)
    jc, jn = jadamw.clip_by_global_norm(g, 1.0)
    tc, tn = adamw.clip_by_global_norm(_to_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(_leaves(tc), _jleaves(jc)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, schedule="constant",
                            warmup_steps=0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw.adamw_init(params, cfg)
    target = torch.ones(3)
    for _ in range(300):
        w = params["w"].clone().requires_grad_()
        g, = torch.autograd.grad(((w - target) ** 2).sum(), [w])
        params, opt, _ = adamw.adamw_update({"w": g}, opt, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_opt_state_carries_across():
    jc, tc = _cfgs("qwen2-1.5b")
    jp = _jparams(jc)
    jcfg = jadamw.AdamWConfig(master_weights=True)
    js = jadamw.adamw_init(jp, jcfg)
    g = jax.tree_util.tree_map(lambda a: jnp.ones_like(a) * 0.01, jp)
    _, js, _ = jadamw.adamw_update(g, js, jp, jcfg)
    ts = convert.opt_state(_np(js), tc, "cpu")
    assert int(ts.count) == 1
    for a, b in zip(_leaves(ts.m) + _leaves(ts.v) + _leaves(ts.master),
                    _jleaves(js.m) + _jleaves(js.v) + _jleaves(js.master)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_jax(arch, accum):
    jc, tc = _cfgs(arch)
    jp = _jparams(jc)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jo = jadamw.AdamWConfig(**ocfg)
    to = adamw.AdamWConfig(**ocfg)
    batch = _batch(jc)
    jstep = jsteps.make_train_step(jc, jo, accum=accum)
    tstep = steps.make_train_step(tc, to, accum=accum)
    jp2, js2, jm = jstep(jp, jadamw.adamw_init(jp, jo), _j(batch))
    tp = convert.lm_params(jp, tc, "cpu")
    tp2, ts2, tm = tstep(tp, adamw.adamw_init(tp, to), _t(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert float(tm["skipped"]) == float(jm["skipped"]) == 0.0
    # m is linear in the (clipped) gradient; the first Adam step moves
    # each element by lr·g/(|g|+eps), so an element whose gradient is
    # within 100·eps of 0 carries the two libraries' f32 rounding of g
    # into its update at O(1): such elements are held to the step's bound
    # 2·lr, the others to 1e-2·lr
    for a, b in zip(_leaves(ts2.m), _jleaves(js2.m)):
        assert _rel_l2(a, b) < 1e-4
    for a, b, m in zip(_leaves(tp2), _jleaves(jp2), _jleaves(js2.m)):
        near = np.abs(m) / (1.0 - to.b1) < 100 * to.eps
        np.testing.assert_allclose(a[~near], b[~near], rtol=0,
                                   atol=1e-2 * to.lr)
        assert np.all(np.abs(a - b)[near] <= 2 * to.lr)
    assert int(ts2.count) == int(js2.count) == 1
    # the caller's parameters are left as they were
    for a, b in zip(_leaves(tp), _jleaves(jp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_equals_jax(arch, accum):
    """One ``make_train_step`` step: the loss, the grad norm and the MoE
    metrics (each microbatch's, averaged) as JAX's, and the new
    parameters within the first Adam step's bounds."""
    jc, tc = _cfgs(arch)
    jp = _jparams(jc)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jo, to = jadamw.AdamWConfig(**ocfg), adamw.AdamWConfig(**ocfg)
    batch = _batch(jc)
    jp2, js2, jm = jsteps.make_train_step(jc, jo, accum=accum)(
        jp, jadamw.adamw_init(jp, jo), _j(batch))
    tp = convert.lm_params(jp, tc, "cpu")
    tp2, ts2, tm = steps.make_train_step(tc, to, accum=accum)(
        tp, adamw.adamw_init(tp, to), _t(batch))
    assert sorted(tm) == sorted(jm)
    for k in ("loss", "nll", "grad_norm") + (
            ("moe_aux", "moe_zloss") if tc.moe else ()):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(tm["skipped"]) == float(jm["skipped"]) == 0.0
    for a, b in zip(_leaves(ts2.m), _jleaves(js2.m)):
        assert _rel_l2(a, b) < 1e-4
    for a, b, m in zip(_leaves(tp2), _jleaves(jp2), _jleaves(js2.m)):
        near = np.abs(m) / (1.0 - to.b1) < 100 * to.eps
        np.testing.assert_allclose(a[~near], b[~near], rtol=0,
                                   atol=1e-2 * to.lr)
        assert np.all(np.abs(a - b)[near] <= 2 * to.lr)


def test_nonfinite_guard_in_train_step():
    """A NaN gradient step leaves params and optimizer state untouched
    and reports skipped, as JAX's does; a clean step is not skipped."""
    jc, tc = _cfgs("qwen1.5-0.5b")
    jp = _jparams(jc, seed=0)
    ocfg = dict(lr=1e-3)
    jo, to = jadamw.AdamWConfig(**ocfg), adamw.AdamWConfig(**ocfg)
    bad = {"tokens": np.zeros((2, 8), np.int32),
           "targets": np.zeros((2, 8), np.int32)}
    jpois = jax.tree_util.tree_map(lambda a: a * np.nan, jp)
    _, js2, jm = jsteps.make_train_step(jc, jo)(
        jpois, jadamw.adamw_init(jp, jo), _j(bad))
    step = steps.make_train_step(tc, to)
    tpois = convert.lm_params(_np(jpois), tc, "cpu")
    opt = adamw.adamw_init(tpois, to)
    p2, o2, m = step(tpois, opt, _t(bad))
    assert float(m["skipped"]) == float(jm["skipped"]) == 1.0
    # the select keeps the old values bit for bit (NaN payloads too)
    def bits(tree):
        return [t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                        8: torch.int64}[t.element_size()])
                for _, t in tree_flatten_with_path(tree)]

    for a, b in zip(bits(p2) + bits(o2), bits(tpois) + bits(opt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(o2.count) == int(js2.count) == 0
    tp = convert.lm_params(jp, tc, "cpu")
    _, o3, m3 = step(tp, adamw.adamw_init(tp, to), _t(bad))
    assert float(m3["skipped"]) == 0.0 and int(o3.count) == 1


def test_compress_crosspod_is_not_ported():
    """``compress_crosspod=True`` without a mesh is the plain step, as in
    the JAX package (whose step compresses only over a mesh's ``pod``
    axis): the same parameters, optimizer state and metrics, bit for
    bit."""
    jc, tc = _cfgs("qwen2-1.5b")
    jp = _jparams(jc)
    batch = _t(_batch(jc))
    to = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    tp = convert.lm_params(jp, tc, "cpu")
    out = [steps.make_train_step(tc, to, compress_crosspod=c)(
        tp, adamw.adamw_init(tp, to), batch) for c in (True, False)]
    (pc, sc, mc), (pp, sp, mp) = out
    for a, b in zip(_leaves(pc) + _leaves(sc), _leaves(pp) + _leaves(sp)):
        np.testing.assert_array_equal(a, b)
    assert sorted(mc) == sorted(mp)
    for k in mp:
        assert float(mc[k]) == float(mp[k]), k


# ---------------------------------------------------------------------------
# host pipeline
# ---------------------------------------------------------------------------

def _jittered(i):
    time.sleep(0.001 * ((i * 7) % 5))           # jittered producers
    return i


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pipeline_in_order_delivery(pkg):
    P, C = ((HostPipeline, PipelineConfig) if pkg == "port"
            else (JPipeline, JPipelineConfig))
    p = P(_jittered, n_batches=20, cfg=C(prefetch=4, n_workers=3))
    assert list(p) == list(range(20))


def test_pipeline_propagates_errors():
    def producer(i):
        if i == 3:
            raise RuntimeError("producer died")
        return i

    p = HostPipeline(producer, n_batches=10)
    with pytest.raises(RuntimeError, match="producer died"):
        list(p)


def test_pipeline_hedges_a_straggler():
    """The first attempt at batch 2 stalls past the hedge deadline (it
    waits on an event the test sets afterwards); the hedge answers."""
    import threading
    release = threading.Event()
    seen = set()
    lock = threading.Lock()

    def producer(i):
        with lock:
            first = (i == 2 and i not in seen)
            seen.add(i)
        if first:
            release.wait(10.0)
        return i

    p = HostPipeline(producer, n_batches=5,
                     cfg=PipelineConfig(prefetch=2, n_workers=1,
                                        hedge_after_s=0.05))
    try:
        assert list(p) == list(range(5))
        assert p.stats["hedges"] >= 1 and p.stats["hedge_wins"] >= 1
    finally:
        release.set()
        p.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ttree(step):
    return {"params": {"w": torch.full((4, 4), float(step)),
                       "b": torch.arange(4.0) + step},
            "opt": {"m": torch.zeros((4, 4)),
                    "count": torch.tensor(step, dtype=torch.int32)}}


def _jtree(step):
    return {"params": {"w": jnp.full((4, 4), float(step)),
                       "b": jnp.arange(4.0) + step},
            "opt": {"m": jnp.zeros((4, 4)), "count": jnp.asarray(step)}}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retain=3, async_save=False)
    mgr.save(5, _ttree(5), extra={"note": "x"})
    got, meta = mgr.restore(None, _ttree(0))
    assert meta.step == 5 and meta.extra["note"] == "x"
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  np.full((4, 4), 5.0, np.float32))
    assert int(got["opt"]["count"]) == 5


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retain=2, async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, _ttree(s))
    mgr.wait()
    assert mgr.all_steps() == [2, 3]            # retention


def test_retention_with_archive(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retain=1, archive_every=2,
                            async_save=False)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, _ttree(s))
    assert mgr.all_steps() == [2, 4, 5]         # archives 2,4 + newest 5


def test_crc_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _ttree(1))
    d = os.path.join(str(tmp_path), "step_0000000001")
    victim = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    arr = np.load(os.path.join(d, victim)).reshape(-1).copy()
    arr.flat[0] += 1.0
    np.save(os.path.join(d, victim), arr)
    with pytest.raises(IOError, match="crc"):
        mgr.restore(1, _ttree(0))
    mgr.restore(1, _ttree(0), validate=False)   # the forensics path


def test_atomic_publish_no_partial_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    os.makedirs(os.path.join(str(tmp_path), "tmp.9.zzz"))
    mgr.save(3, _ttree(3))
    assert mgr.all_steps() == [3]


def test_checkpoint_files_equal_jax_and_restore_across(tmp_path):
    """The same tree written by both packages gives the same leaf names,
    shapes, dtypes, crcs and bytes; each restores the other's."""
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    CheckpointManager(pdir, async_save=False).save(7, _ttree(7))
    JCkpt(jdir, async_save=False).save(7, _jtree(7))
    man = {}
    for name, d in (("port", pdir), ("jax", jdir)):
        with open(os.path.join(d, "step_0000000007", "manifest.json")) as f:
            m = json.load(f)
        man[name] = sorted((l["name"], tuple(l["shape"]), l["dtype"],
                            l["crc32"]) for l in m["leaves"])
    assert man["port"] == man["jax"]
    got, meta = CheckpointManager(jdir).restore(7, _ttree(0))
    assert meta.step == 7
    np.testing.assert_array_equal(got["params"]["b"].numpy(),
                                  np.arange(4.0, dtype=np.float32) + 7)
    jgot, _ = JCkpt(pdir).restore(7, _jtree(0))
    np.testing.assert_array_equal(np.asarray(jgot["params"]["w"]),
                                  np.full((4, 4), 7.0, np.float32))


def test_jax_written_training_checkpoint_restores_in_the_port(tmp_path):
    """A JAX trainer's checkpoint (params + OptState, bf16 parameters
    included) restores into the port's TrainLoop state bit for bit."""
    jc, tc = _cfgs("qwen2-1.5b", param_dtype="bfloat16")
    jp = jlm.init_lm(jax.random.PRNGKey(4), jc)
    jo = jadamw.AdamWConfig()
    js = jadamw.adamw_init(jp, jo)
    g = jax.tree_util.tree_map(lambda a: jnp.ones(a.shape, a.dtype), jp)
    jp2, js2, _ = jadamw.adamw_update(g, js, jp, jo)
    JCkpt(str(tmp_path), async_save=False).save(
        3, {"params": jp2, "opt": js2}, extra={"step": 3})
    tp = lm.init_lm(torch.Generator().manual_seed(0), tc)
    like = {"params": tp, "opt": adamw.adamw_init(tp, adamw.AdamWConfig())}
    got, meta = CheckpointManager(str(tmp_path)).restore(None, like)
    assert meta.extra["step"] == 3
    assert got["params"]["embed"].dtype == torch.bfloat16
    want = convert.lm_params(_np(jp2), tc, "cpu")
    for (pa, a), (_, b) in zip(tree_flatten_with_path(got["params"]),
                               tree_flatten_with_path(want)):
        assert torch.equal(a, b), pa
    assert int(got["opt"].count) == int(js2.count) == 1
    for a, b in zip(_leaves(got["opt"].m) + _leaves(got["opt"].v),
                    _jleaves(js2.m) + _jleaves(js2.v)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _loops(tmp_path=None, arch="qwen1.5-0.5b", steps_=12, lr=1e-3):
    """A port and a JAX TrainLoop from the same (JAX-drawn) state."""
    jc, tc = _cfgs(arch)
    ocfg = dict(lr=lr, warmup_steps=2, total_steps=steps_)
    jl = jtrain.TrainLoop(jc, opt_cfg=jadamw.AdamWConfig(**ocfg),
                          ckpt_dir=str(tmp_path / "jax") if tmp_path
                          else None, retain=2)
    tl = train.TrainLoop(tc, opt_cfg=adamw.AdamWConfig(**ocfg),
                         ckpt_dir=str(tmp_path / "port") if tmp_path
                         else None, retain=2, device="cpu")
    tl.params = convert.lm_params(_np(jl.params), tc, "cpu")
    tl.opt_state = adamw.adamw_init(tl.params, tl.opt_cfg)
    return jc, tc, jl, tl


def _pool(cfg, n, b=4, s=16):
    return [bt for bt, _ in zip(train.make_batches(cfg, batch=b, seq=s,
                                                   seed=0, pipeline=False),
                                range(n))]


def test_loss_decreases_as_jax_does():
    jc, tc, jl, tl = _loops(steps_=12)
    batches = _pool(tc, 12, s=32)
    assert all(np.array_equal(a["tokens"], b["tokens"]) for a, b in zip(
        batches, _pool(jc, 12, s=32)))
    th = tl.run(iter(batches), steps=12, log_every=0)["history"]
    jh = jl.run(iter(batches), steps=12, log_every=0)["history"]
    np.testing.assert_allclose([m["loss"] for m in th],
                               [m["loss"] for m in jh], rtol=1e-4)
    first = np.mean([m["loss"] for m in th[:3]])
    last = np.mean([m["loss"] for m in th[-3:]])
    assert np.isfinite(last) and last < first, (first, last)


def test_checkpoint_resume_exact(tmp_path):
    """Interrupted at step 4 and resumed in a new loop: the same
    parameters, bit for bit, as the run that went straight to step 8."""
    _, tc, _, straight = _loops(steps_=8)
    batches = _pool(tc, 8)
    straight.run(iter(batches), steps=8, log_every=0)
    _, _, _, first = _loops(tmp_path, steps_=8)
    first.run(iter(batches[:4]), steps=4, ckpt_every=4, log_every=0)
    _, _, _, second = _loops(tmp_path, steps_=8)
    assert second.restore() and second.step == 4
    second.run(iter(batches[4:]), steps=8, log_every=0)
    for (p, a), (_, b) in zip(tree_flatten_with_path(second.params),
                              tree_flatten_with_path(straight.params)):
        assert torch.equal(a, b), p
    for (p, a), (_, b) in zip(tree_flatten_with_path(second.opt_state),
                              tree_flatten_with_path(straight.opt_state)):
        assert torch.equal(a, b), p


def test_supervisor_rolls_back_on_nan(tmp_path):
    _, tc, _, loop = _loops(tmp_path, steps_=20)
    good = _pool(tc, 4)
    loop.run(iter(good), steps=2, ckpt_every=2, log_every=0)
    loop.ckpt.wait()
    assert loop.ckpt.latest_step() == 2
    loop.params = tree_unflatten(loop.params, [
        p * float("nan") for _, p in tree_flatten_with_path(loop.params)])

    def poisoned_stream():
        while True:
            yield good[0]

    out = loop.run(poisoned_stream(), steps=6, ckpt_every=0,
                   max_bad_steps=2, log_every=0)
    assert all(torch.isfinite(p).all()
               for _, p in tree_flatten_with_path(loop.params))
    assert any(m.get("rolled_back") for m in out["history"])


def test_make_batches_equal_jax_and_refuse_unported_frontends():
    """Tokens and targets equal to the JAX package's; a vision model's
    batches also carry ``embeds`` (f32, (batch, frontend_len, d_model),
    unit RMS, drawn anew for each batch index, the same on a second
    pass). An encoder-decoder's batches carry ``enc_embeds`` (f32,
    (batch, seq, d_model)); ``tests/test_torch_encdec.py`` holds them
    further."""
    for arch in ("qwen2-1.5b", "qwen2-vl-7b"):
        jc, tc = _cfgs(arch)
        got = _pool(tc, 3)
        want = [b for b, _ in zip(jtrain.make_batches(
            jc, batch=4, seq=16, seed=0, pipeline=False), range(3))]
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in ("tokens", "targets"):
                np.testing.assert_array_equal(a[k], b[k])
        if arch == "qwen2-vl-7b":
            shape = (4, tc.frontend_len, tc.d_model)
            assert all(b["embeds"].shape == shape
                       and b["embeds"].dtype == np.float32 for b in got)
            rms = np.sqrt((got[0]["embeds"] ** 2).mean(-1))
            np.testing.assert_allclose(rms, 1.0, rtol=1e-4)
            assert not np.array_equal(got[0]["embeds"], got[1]["embeds"])
            again = _pool(tc, 2)
            np.testing.assert_array_equal(again[1]["embeds"],
                                          got[1]["embeds"])
    enc = _pool(reduced(get_config("seamless-m4t-medium")), 2, b=2, s=8)
    assert all(b["enc_embeds"].shape == (2, 8, 64)
               and b["enc_embeds"].dtype == np.float32 for b in enc)


def test_vision_train_loop_on_the_cpu():
    """A TrainLoop of reduced qwen2-vl-7b on ``make_batches`` (through the
    host pipeline): the embeddings reach the loss, which stays finite and
    falls over the steps on the repeated pool."""
    _, tc = _cfgs("qwen2-vl-7b")
    loop = train.TrainLoop(tc, opt_cfg=adamw.AdamWConfig(
        lr=3e-3, warmup_steps=1, total_steps=16), device="cpu")
    batches = train.make_batches(tc, batch=2, seq=16, seed=0)
    try:
        hist = loop.run(batches, steps=16, log_every=0)["history"]
    finally:
        batches.close()
    losses = [m["loss"] for m in hist]
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_train_loop_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _cfgs("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.TrainLoop(tc, opt_cfg=adamw.AdamWConfig())


def test_trainer_cli_on_the_cpu(tmp_path):
    out = tmp_path / "m.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--reduced", "--arch", "qwen2-1.5b", "--steps", "4",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "2", "--metrics-out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "final loss" in r.stdout and "on cpu" in r.stdout
    hist = json.loads(out.read_text())["history"]
    assert len(hist) == 4 and np.isfinite(hist[-1]["loss"])
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [2, 4]
