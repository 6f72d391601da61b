"""Port model tier: layers, attention blocks, ``lm.prefill`` /
``lm.decode_step``, ``ModelServer`` and ``launch.serve --decode`` against
the JAX package on reduced ``qwen2-1.5b`` (GQA, here MQA: 4 query heads
over 1 KV head) and ``qwen1.5-0.5b`` (MHA), in f32; and every other
decoder-only family at reduced size: ``mamba2-780m`` (``m-`` blocks),
``granite-moe-3b-a800m`` and ``mixtral-8x22b`` (``ae``; mixtral with its
sliding window), ``jamba-v0.1-52b`` (one period of ``md``/``me``/``ad``
blocks) and ``qwen2-vl-7b`` (vision frontend embeddings, M-RoPE).

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
from repro_torch.models.blocks import normalize_pattern
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.serving.server import ModelServer

torch.set_num_threads(1)

ARCHS = ["qwen2-1.5b", "qwen1.5-0.5b"]
# the decoder-only families beyond the dense ones: Mamba-2, MoE, hybrid
FAMILIES = ["mamba2-780m", "granite-moe-3b-a800m", "mixtral-8x22b",
            "jamba-v0.1-52b"]


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
        assert sorted(g) == sorted(w)
        for name in w:
            assert tuple(g[name].shape) == w[name].shape
            assert str(g[name].dtype) == "torch." + str(w[name].dtype)
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


@pytest.mark.parametrize("arch", ARCHS + FAMILIES + ["qwen2-vl-7b"])
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
    ("seamless-m4t-medium",
     "encoder-decoder: models.encdec runs it.*launch.steps.init_params")])
def test_unported_block_kinds_raise(arch, what):
    """The decoder-only ``lm`` refuses an encoder-decoder config and names
    where it runs (``tests/test_torch_encdec.py`` holds that against the
    JAX package)."""
    cfg = reduced(get_config(arch))
    with pytest.raises(ValueError, match=what):
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
# Mamba-2, MoE, hybrid and vision families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_decode_match_jax(arch):
    """Prefill, then decode step by step: logits and caches ({k, v} and
    {conv, ssm}) at 1e-4, greedy tokens equal. mixtral decodes to position
    39 over its 16-slot ring (window 16 at reduced size); jamba runs all 8
    positions of its pattern."""
    jc, tc, jp, tp = _model(arch, seed=11)
    toks = np.random.default_rng(12).integers(
        0, tc.vocab_size, (2, 40)).astype(np.int32)
    _prefill_decode(jc, tc, jp, tp, toks, cut=13,
                    cache_len=tc.sliding_window or 48)
    if arch == "jamba-v0.1-52b":
        assert normalize_pattern(tc) == ("md", "me", "md", "me", "ad", "me",
                                         "md", "me")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_greedy_tokens_equal_jax(arch):
    """Greedy generation from the same prompt: the same tokens."""
    jc, tc, jp, tp = _model(arch, seed=13)
    toks = np.random.default_rng(14).integers(
        0, tc.vocab_size, (2, 9)).astype(np.int32)
    jl, jcache = j_lm.prefill(jp, jc, jnp.asarray(toks), 24)
    tl, tcache = lm.prefill(tp, tc, torch.from_numpy(toks), 24)
    jstep = jax.jit(lambda p, c, t, pos: j_lm.decode_step(p, jc, c, t, pos))
    jt, tt = [], []
    for i in range(9, 20):
        jn = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tn = torch.argmax(tl, -1).to(torch.int32)
        jt.append(jn)
        tt.append(tn.numpy())
        pos = np.full((2,), i, np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(jn), jnp.asarray(pos))
        tl, tcache = lm.decode_step(tp, tc, tcache, tn,
                                    torch.from_numpy(pos))
        _close(tl, jl, 1e-4)
    np.testing.assert_array_equal(np.stack(tt), np.stack(jt))


def test_sliding_window_prefill_keeps_the_last_window_in_its_ring():
    """A prompt of 20 over a window of 16 with ``cache_len`` 48: the port's
    prefill keeps positions 4..19 in a 16-slot ring (position p at slot
    p % 16), where the JAX package keeps all 20 in 48 slots; decoding on
    from either gives the same logits, since the window masks the rest."""
    jc, tc, jp, tp = _model("mixtral-8x22b", seed=20)
    toks = np.random.default_rng(20).integers(
        0, tc.vocab_size, (2, 30)).astype(np.int32)
    jl, jcache = j_lm.prefill(jp, jc, jnp.asarray(toks[:, :20]), 48)
    tl, tcache = lm.prefill(tp, tc, torch.from_numpy(toks[:, :20]), 48)
    _close(tl, jl, 1e-4)
    jk = np.asarray(jcache[0]["k"])                 # (reps, B, 48, H, D)
    assert tuple(tcache[0]["k"].shape[2:3]) == (16,) and jk.shape[2] == 48
    slots = np.arange(4, 20) % 16
    _close(tcache[0]["k"][:, :, slots], jk[:, :, 4:20], 1e-4)
    for i in range(20, 30):
        pos = np.full((2,), i, np.int32)
        jl, jcache = j_lm.decode_step(jp, jc, jcache, jnp.asarray(toks[:, i]),
                                      jnp.asarray(pos))
        tl, tcache = lm.decode_step(tp, tc, tcache,
                                    torch.from_numpy(toks[:, i]),
                                    torch.from_numpy(pos))
        _close(tl, jl, 1e-4)
    # a ModelServer with cache_len over the window admits into its ring
    srv = ModelServer(tc, tp, batch=2, cache_len=48)
    assert srv.prefill(toks[:, :20]) == [0, 1]
    assert tuple(srv.caches[0]["k"].shape[2:3]) == (16,)


def test_mamba_decode_equals_the_full_forward():
    """The port's SSM decode from the prefill state reproduces the
    teacher-forced logits (SSD duality), as the JAX package's test does."""
    _, tc, _, tp = _model("mamba2-780m", seed=15)
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, tc.vocab_size, (2, 12)).astype(np.int32))
    full, _ = lm.forward_train(tp, tc, toks)
    _, caches = lm.prefill(tp, tc, toks[:, :6], 12)
    for i in range(6, 12):
        logits, caches = lm.decode_step(tp, tc, caches, toks[:, i],
                                        torch.full((2,), i, dtype=torch.int32))
        _close(logits, full[:, i].numpy(), 1e-4)


def test_mamba_cache_does_not_grow_with_cache_len():
    tc = reduced(get_config("mamba2-780m"))
    cpu = torch.device("cpu")
    small = lm.init_cache(tc, 4, 16, cpu)
    large = lm.init_cache(tc, 4, 4096, cpu)
    nbytes = [sum(t.numel() * t.element_size() for t in tree_leaves(c))
              for c in (small, large)]
    assert nbytes[0] == nbytes[1] > 0
    assert sorted(small[0]) == ["conv", "ssm"]
    assert small[0]["ssm"].dtype == torch.float32


def test_decode_continues_from_a_converted_jax_ssm_cache():
    """``convert.lm_cache`` of a jamba prefill ({conv, ssm} and {k, v}
    caches) decodes on in the port as in JAX."""
    jc, tc, jp, tp = _model("jamba-v0.1-52b", seed=16)
    toks = np.random.default_rng(16).integers(
        0, tc.vocab_size, (2, 9)).astype(np.int32)
    _, jcache = j_lm.prefill(jp, jc, jnp.asarray(toks[:, :8]), 12)
    tcache = convert.lm_cache(_np(jcache), tc, "cpu")
    assert sorted(tcache[0]) == ["conv", "ssm"] \
        and sorted(tcache[4]) == ["k", "v"]
    pos = np.full((2,), 8, np.int32)
    jl, jcache = j_lm.decode_step(jp, jc, jcache, jnp.asarray(toks[:, 8]),
                                  jnp.asarray(pos))
    tl, tcache = lm.decode_step(tp, tc, tcache, torch.from_numpy(toks[:, 8]),
                                torch.from_numpy(pos))
    _close(tl, jl, 1e-4)
    _caches_close(tcache, jcache, 1e-4)
    bad = list(_np(jcache))
    bad[0], bad[4] = bad[4], bad[0]
    with pytest.raises(ValueError, match="block kind"):
        convert.lm_cache(tuple(bad), tc, "cpu")


def test_vision_prefill_step_and_decode_match_jax():
    """qwen2-vl-7b: ``make_prefill_step`` with the JAX package's stub patch
    embeddings (passed to both as numpy) ahead of the prompt, M-RoPE
    positions over both, then decode steps; logits 1e-4, caches 1e-4."""
    from repro.launch.steps import make_prefill_step as j_make_prefill
    from repro.models import frontend as j_frontend
    from repro_torch.launch.steps import make_prefill_step
    jc, tc, jp, tp = _model("qwen2-vl-7b", seed=17)
    emb = np.asarray(j_frontend.stub_frontend(jax.random.PRNGKey(3), jc, 2),
                     np.float32)
    assert emb.shape == (2, tc.frontend_len, tc.d_model)
    toks = np.random.default_rng(17).integers(
        0, tc.vocab_size, (2, 12)).astype(np.int32)
    F_ = emb.shape[1]
    jl, jcache = j_make_prefill(jc, 32)(jp, jnp.asarray(toks[:, :6]),
                                        jnp.asarray(emb))
    tl, tcache = make_prefill_step(tc, 32)(tp, torch.from_numpy(toks[:, :6]),
                                           torch.from_numpy(emb.copy()))
    _close(tl, jl, 1e-4)
    _caches_close(tcache, jcache, 1e-4)
    for i in range(6, 12):
        pos = np.full((2,), F_ + i, np.int32)
        jl, jcache = j_lm.decode_step(jp, jc, jcache, jnp.asarray(toks[:, i]),
                                      jnp.asarray(pos))
        tl, tcache = lm.decode_step(tp, tc, tcache,
                                    torch.from_numpy(toks[:, i]),
                                    torch.from_numpy(pos))
        _close(tl, jl, 1e-4)
    _caches_close(tcache, jcache, 1e-4)


def test_frontend_stubs_shape_dtype_rms_and_seed():
    from repro_torch.models import frontend
    cfg = get_config("qwen2-vl-7b")
    small = dataclasses.replace(reduced(cfg), dtype="bfloat16")
    x = frontend.stub_frontend(torch.Generator().manual_seed(1), small, 3)
    assert tuple(x.shape) == (3, small.frontend_len, small.d_model)
    assert x.dtype == torch.bfloat16
    rms = x.float().pow(2).mean(-1).sqrt()
    torch.testing.assert_close(rms, torch.ones_like(rms), rtol=1e-2,
                               atol=1e-2)
    again = frontend.stub_frontend(torch.Generator().manual_seed(1), small, 3)
    other = frontend.stub_frontend(torch.Generator().manual_seed(2), small, 3)
    assert torch.equal(x, again) and not torch.equal(x, other)
    v = frontend.stub_vision_embeddings(torch.Generator(), small, 1)
    assert v.shape[1] == (224 // 14) ** 2          # the 14x14 patch grid
    a = frontend.stub_audio_frames(torch.Generator(), small, 2)
    assert tuple(a.shape) == (2, 250, small.d_model)   # 5 s at 50 Hz
    assert frontend.stub_frontend(torch.Generator(),
                                  reduced(get_config("qwen2-1.5b")), 2) \
        is None
    with pytest.raises(ValueError, match="frontend"):
        frontend.stub_frontend(torch.Generator(), dataclasses.replace(
            small, frontend="smell"), 1)


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


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_model_server_matches_jax(arch):
    """The same admissions as for the dense models: two at different
    times, an idle slot, decoding past ``cache_len`` (and past mixtral's
    16-slot ring). Every slot's token takes MoE capacity in each step, the
    idle one's too, in both packages. mixtral's port server has
    ``cache_len`` 24 over its window of 16, which the JAX server cannot
    take (its prefill pads to 24, its ring has 16 slots): it is held to
    the JAX server with ``cache_len`` 16, the same 16-slot ring."""
    jc, tc, jp, tp = _model(arch, seed=18)
    rng = np.random.default_rng(19)
    p1 = rng.integers(0, tc.vocab_size, (2, 8)).astype(np.int32)
    p2 = rng.integers(0, tc.vocab_size, (1, 5)).astype(np.int32)
    js = JModelServer(jc, jp, batch=4, cache_len=tc.sliding_window or 24)
    ts = ModelServer(tc, tp, batch=4, cache_len=24)
    assert js.prefill(p1) == ts.prefill(p1) == [0, 1]
    js.decode(steps=6)
    ts.decode(steps=6)
    assert js.prefill(p2) == ts.prefill(p2) == [2]
    jt = js.decode(steps=20)
    tt = ts.decode(steps=20)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert ts.generated == js.generated
    _caches_close(ts.caches, js.caches, 1e-4)


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


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-vl-7b"])
def test_serve_decode_runs_the_families_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--requests", "64", "--batch", "64", "--events",
                       "1000", "--keys", "32", "--decode", "--arch", arch,
                       "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["decode_arch"] == arch
    toks = report["decode_tokens"]
    assert len(toks) == 4 and all(len(t) == 17 for t in toks)
    vocab = reduced(get_config(arch)).vocab_size
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
