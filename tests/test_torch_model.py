"""Port model tier: layers, attention blocks, ``lm.prefill`` /
``lm.decode_step``, ``ModelServer`` and ``launch.serve --decode`` against
the JAX package on reduced ``qwen2-1.5b`` (GQA, here MQA: 4 query heads
over 1 KV head) and ``qwen1.5-0.5b`` (MHA), in f32.

JAX parameters are drawn with ``jax.random`` and carried across with
``repro_torch.convert.lm_params``; both packages then run the same
function on the same numbers. Tolerances (f32): 1e-5 for single layers,
1e-4 for logits and caches after whole models (two layers, another
summation order in each matmul); greedy tokens are equal.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.serving.server import ModelServer as JModelServer
from repro_torch import convert
from repro_torch.configs.base import param_count, reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import attention, layers, lm
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.serving.server import ModelServer

torch.set_num_threads(1)

ARCHS = ["qwen2-1.5b", "qwen1.5-0.5b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **changes):
    jc = dataclasses.replace(j_reduced(j_get_config(arch)), **changes)
    tc = dataclasses.replace(reduced(get_config(arch)), **changes)
    return jc, tc


def _model(arch, seed=0, **changes):
    jc, tc = _cfgs(arch, **changes)
    jp = j_lm.init_lm(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, convert.lm_params(_np(jp), tc, "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), np.asarray(want, np.float32),
        rtol=tol, atol=tol)


def _caches_close(got, want, tol):
    want = _np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("k", "v"):
            assert tuple(g[name].shape) == w[name].shape
            _close(g[name], w[name], tol)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_configs_match_the_jax_package():
    from repro.configs.base import param_count as j_param_count
    from repro.configs.registry import list_archs as j_list
    from repro_torch.configs.registry import list_archs
    assert list_archs() == j_list()
    for arch in list_archs():
        jc, tc = j_get_config(arch), get_config(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert param_count(tc) == j_param_count(jc)
        assert dataclasses.asdict(reduced(tc)) == dataclasses.asdict(
            j_reduced(jc))
    assert get_config("qwen2-1.5b").compute_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_layout_and_size(arch):
    tc = reduced(get_config(arch))
    jc = j_reduced(j_get_config(arch))
    p = lm.init_lm(torch.Generator().manual_seed(0), tc)
    jp = j_lm.init_lm(jax.random.PRNGKey(0), jc)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert tree_map(lambda t: tuple(t.shape), p) == shapes
    n = sum(t.numel() for t in tree_leaves(p))
    assert n == param_count(tc) + tc.d_model          # + final norm


def test_convert_keeps_bf16_bit_for_bit():
    jc = j_reduced(j_get_config("qwen2-1.5b"))
    jc = dataclasses.replace(jc, dtype="bfloat16", param_dtype="bfloat16")
    tc = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                             dtype="bfloat16", param_dtype="bfloat16")
    jp = _np(j_lm.init_lm(jax.random.PRNGKey(3), jc))
    tp = convert.lm_params(jp, tc, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  np.asarray(jp["embed"], np.float32))
    with pytest.raises(ValueError, match="parameter tree"):
        convert.lm_params({"embed": jp["embed"]}, tc, "cpu")


@pytest.mark.parametrize("arch,what", [
    ("mamba2-780m", "Mamba-2"), ("mixtral-8x22b", "MoE"),
    ("seamless-m4t-medium", "encoder-decoder"),
    ("qwen2-vl-7b", "frontend")])
def test_unported_block_kinds_raise(arch, what):
    cfg = reduced(get_config(arch))
    with pytest.raises(NotImplementedError, match=what):
        lm.init_lm(torch.Generator().manual_seed(0), cfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)}
    tp = {"scale": torch.from_numpy(scale)}
    if kind == "layernorm":
        jp["bias"], tp["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    _close(layers.apply_norm(tp, torch.from_numpy(x), kind),
           j_layers.apply_norm(jp, jnp.asarray(x), kind), 1e-5)
    # bf16 in, bf16 out, statistics in f32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.apply_norm(tp, xb, kind)
    want = j_layers.apply_norm(jp, jnp.asarray(x, jnp.bfloat16), kind)
    assert got.dtype == torch.bfloat16
    _close(got, want, 1e-2)


@pytest.mark.parametrize("mrope", [None, (4, 2, 2)])
def test_apply_rope(mrope):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    if mrope:
        pos = np.stack([pos, pos // 2, pos // 3])
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            mrope)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, mrope)
    _close(got, want, 1e-4)      # angles up to 5000 rad in f32


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
         (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    _close(layers.apply_mlp({k: torch.from_numpy(v) for k, v in w.items()},
                            torch.from_numpy(x), act),
           j_layers.apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                              jnp.asarray(x), act), 1e-5)


# ---------------------------------------------------------------------------
# attention blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_attend_prefill_and_decode(arch):
    jc, tc = _cfgs(arch)
    jp = _np(j_attn.init_attention(jax.random.PRNGKey(1), jc))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(3)
    B, S, L = 2, 9, 16
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jo, jcache = j_attn.attend_prefill(jp, jnp.asarray(x), jc,
                                       jnp.asarray(pos), L)
    to, tcache = attention.attend_prefill(tp, torch.from_numpy(x), tc,
                                          torch.from_numpy(pos.copy()), L)
    _close(to, jo, 1e-5)
    _caches_close((tcache,), (jcache,), 1e-5)
    xd = rng.standard_normal((B, tc.d_model)).astype(np.float32)
    p = np.asarray([S, 3], np.int32)
    jo, jcache = j_attn.attend_decode(jp, jnp.asarray(xd), jc, jcache,
                                      jnp.asarray(p))
    to, tcache2 = attention.attend_decode(tp, torch.from_numpy(xd), tc,
                                          tcache, torch.from_numpy(p))
    assert tcache2 is tcache                       # written in place
    _close(to, jo, 1e-5)
    _caches_close((tcache,), (jcache,), 1e-5)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _prefill_decode(jc, tc, jp, tp, toks, cut, cache_len):
    jl, jcache = j_lm.prefill(jp, jc, jnp.asarray(toks[:, :cut]), cache_len)
    tl, tcache = lm.prefill(tp, tc, torch.from_numpy(toks[:, :cut]),
                            cache_len)
    _close(tl, jl, 1e-4)
    _caches_close(tcache, jcache, 1e-4)
    jstep = jax.jit(lambda p, c, t, pos: j_lm.decode_step(p, jc, c, t, pos))
    B = toks.shape[0]
    for i in range(cut, toks.shape[1]):
        pos = np.full((B,), i, np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i]),
                           jnp.asarray(pos))
        tl, tcache = lm.decode_step(tp, tc, tcache,
                                    torch.from_numpy(toks[:, i]),
                                    torch.from_numpy(pos))
        assert tl.dtype == torch.float32
        _close(tl, jl, 1e-4)
    _caches_close(tcache, jcache, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_jax(arch):
    jc, tc, jp, tp = _model(arch)
    toks = np.random.default_rng(4).integers(
        0, tc.vocab_size, (2, 14)).astype(np.int32)
    _prefill_decode(jc, tc, jp, tp, toks, cut=6, cache_len=16)


def test_decode_continues_from_a_converted_jax_cache():
    """``convert.lm_cache``: a JAX prefill's cache carried across decodes
    in the port as it does in JAX."""
    jc, tc, jp, tp = _model("qwen2-1.5b", seed=1)
    toks = np.random.default_rng(7).integers(
        0, tc.vocab_size, (2, 7)).astype(np.int32)
    _, jcache = j_lm.prefill(jp, jc, jnp.asarray(toks[:, :6]), 8)
    tcache = convert.lm_cache(_np(jcache), tc, "cpu")
    pos = np.full((2,), 6, np.int32)
    jl, jcache = j_lm.decode_step(jp, jc, jcache, jnp.asarray(toks[:, 6]),
                                  jnp.asarray(pos))
    tl, tcache = lm.decode_step(tp, tc, tcache, torch.from_numpy(toks[:, 6]),
                                torch.from_numpy(pos))
    _close(tl, jl, 1e-4)
    _caches_close(tcache, jcache, 1e-4)
    with pytest.raises(ValueError, match="pattern positions"):
        convert.lm_cache(_np(jcache) * 2, tc, "cpu")


def test_lm_sliding_window_ring_decodes_past_the_window():
    """A 16-long sliding window: the cache is a 16-slot ring; decode runs
    to position 39, so the ring wraps twice."""
    jc, tc, jp, tp = _model("qwen2-1.5b", seed=2, sliding_window=16)
    toks = np.random.default_rng(5).integers(
        0, tc.vocab_size, (2, 40)).astype(np.int32)
    _prefill_decode(jc, tc, jp, tp, toks, cut=16, cache_len=16)


def test_lm_f32_head_is_the_same_product():
    _, tc, _, tp = _model("qwen2-1.5b")
    toks = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    a, _ = lm.prefill(tp, tc, toks, 4)
    b, _ = lm.prefill(lm.with_f32_head(tp, tc), tc, toks, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# ModelServer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_server_matches_jax(arch):
    """Two admissions at different times, an idle slot, and decoding until
    every slot's position is past ``cache_len`` (their writes dropped)."""
    jc, tc, jp, tp = _model(arch, seed=4)
    rng = np.random.default_rng(6)
    p1 = rng.integers(0, tc.vocab_size, (2, 8)).astype(np.int32)
    p2 = rng.integers(0, tc.vocab_size, (1, 5)).astype(np.int32)
    js = JModelServer(jc, jp, batch=4, cache_len=24)
    ts = ModelServer(tc, tp, batch=4, cache_len=24)
    assert js.prefill(p1) == ts.prefill(p1) == [0, 1]
    js.decode(steps=6)
    ts.decode(steps=6)
    assert js.prefill(p2) == ts.prefill(p2) == [2]
    jt = js.decode(steps=20)
    tt = ts.decode(steps=20)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    positions = ts.positions.numpy()
    np.testing.assert_array_equal(positions, np.asarray(js.positions))
    assert positions[3] > ts.cache_len               # the idle slot
    assert ts.generated == js.generated
    assert [len(g) for g in ts.generated] == [27, 27, 21, 0]
    _caches_close(ts.caches, js.caches, 1e-4)
    ts.release([0])
    assert ts.prefill(p2) == [0]
    with pytest.raises(RuntimeError, match="no free slots"):
        ts.prefill(p1)


def test_serve_decode_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--requests", "128", "--batch", "64", "--events",
                       "2000", "--keys", "64", "--decode", "--device",
                       "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["device"] == "cpu"
    assert report["qps"] > 0 and report["n_features"] == 10
    assert report["decode_tokens_per_s"] > 0
    toks = report["decode_tokens"]
    assert len(toks) == 4 and all(len(t) == 17 for t in toks)
    vocab = reduced(get_config("qwen1.5-0.5b")).vocab_size
    assert all(0 <= t < vocab for row in toks for t in row)


def test_hedged_dispatch_takes_the_fast_attempt():
    import threading
    import time
    from repro_torch.serving.server import hedged
    calls, lock = {"n": 0}, threading.Lock()

    def call():
        with lock:
            calls["n"] += 1
            me = calls["n"]
        if me == 1:
            time.sleep(0.3)            # the first attempt is the straggler
        return me

    assert hedged(call, after_s=0.02) == 2
    assert hedged(lambda: 7, after_s=1.0) == 7
    with pytest.raises(ValueError):
        hedged(lambda: (_ for _ in ()).throw(ValueError("x")), after_s=1.0)
