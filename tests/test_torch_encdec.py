"""Port encoder-decoder (``repro_torch.models.encdec``, the cross-attention
of ``models/attention.py``, the encoder-decoder steps of
``launch/steps.py``, ``ModelServer``, ``convert`` and the launchers)
against the JAX package's on reduced seamless-m4t-medium: 2 encoder and 2
decoder layers, d_model 64, 4 heads of 16, 8 audio frames, f32.

JAX parameters are drawn with ``jax.random`` and carried across with
``repro_torch.convert.lm_params``; inputs are numpy from a seed. Tolerances
(f32): cross-attention 1e-5 (one layer); encoder output, logits and
caches after whole models 1e-4 (another summation order in each matmul);
the loss ``rtol 1e-4`` and every gradient within 1e-4 relative L2, as the
dense models are held (``tests/test_torch_train.py``); greedy tokens
equal.

The JAX package's ``ModelServer`` cannot serve an encoder-decoder (it
calls the three-argument prefill step with the tokens only); the port's
serves it, and is held to the JAX steps driven by hand.
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
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import attention as j_attn
from repro.models import encdec as j_encdec
from repro.serving.server import ModelServer as JModelServer
from repro_torch import convert
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.launch import steps, train
from repro_torch.models import attention, encdec, lm
from repro_torch.models.tree import tree_flatten_with_path, tree_map
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving.server import ModelServer

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(**changes):
    jc = dataclasses.replace(j_reduced(j_get_config(ARCH)), **changes)
    tc = dataclasses.replace(reduced(get_config(ARCH)), **changes)
    return jc, tc


def _model(seed=0, **changes):
    jc, tc = _cfgs(**changes)
    jp = _np(j_encdec.init_encdec(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, convert.lm_params(jp, tc, "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _frames(rng, cfg, b, n=None):
    e = rng.standard_normal((b, n or cfg.frontend_len, cfg.d_model))
    return (e / np.sqrt((e * e).mean(-1, keepdims=True))).astype(np.float32)


def _caches_close(got, want, tol):
    want = _np(want)
    assert sorted(got) == sorted(want) == ["k", "v"]
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        _close(got[name], want[name], tol)


def test_the_configs_are_the_jax_packages():
    jc, tc = _cfgs()
    assert tc.is_encdec and (tc.encoder_layers, tc.n_layers) == (2, 2)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    full = get_config(ARCH)
    assert (full.encoder_layers, full.n_layers, full.d_model,
            full.frontend_len) == (12, 12, 1024, 1024)


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [3, 8, 13])
def test_cross_attention_matches_jax(S):
    """``cross_attend`` with the decoder length S shorter than, equal to
    and longer than the encoder's 8 frames, and ``cross_attend_decode``,
    within 1e-5 of the JAX package's (no rope, no mask)."""
    jc, tc = _cfgs()
    jp = _np(j_attn.init_cross_attention(jax.random.PRNGKey(2), jc))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(S)
    B, Se = 2, tc.frontend_len
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, Se, tc.d_model)).astype(np.float32)
    jo = j_attn.cross_attend(jp, jnp.asarray(x), jnp.asarray(enc), jc)
    to = attention.cross_attend(tp, torch.from_numpy(x),
                                torch.from_numpy(enc), tc)
    assert tuple(to.shape) == (B, S, tc.d_model)
    _close(to, jo, 1e-5)
    jo = j_attn.cross_attend_decode(jp, jnp.asarray(x[:, -1]),
                                    jnp.asarray(enc), jc)
    to = attention.cross_attend_decode(tp, torch.from_numpy(x[:, -1]),
                                       torch.from_numpy(enc), tc)
    _close(to, jo, 1e-5)


# ---------------------------------------------------------------------------
# parameters and the model
# ---------------------------------------------------------------------------

def test_init_encdec_layout_and_convert_round_trip():
    """The port's own parameters have the JAX tree's paths, shapes and
    dtypes (bf16 too); ``convert.lm_params`` carries a JAX tree across bit
    for bit and refuses a tree of the wrong model."""
    for dtype in ("float32", "bfloat16"):
        jc, tc = _cfgs(dtype=dtype, param_dtype=dtype)
        jp = _np(j_encdec.init_encdec(jax.random.PRNGKey(1), jc))
        own = steps.init_params(torch.Generator().manual_seed(1), tc)
        tp = convert.lm_params(jp, tc, "cpu")
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        for flat in (tree_flatten_with_path(own),
                     tree_flatten_with_path(tp)):
            assert len(flat) == len(jflat)
            for (jpath, jv), (path, v) in zip(jflat, flat):
                assert tuple(k.key for k in jpath) == path
                assert tuple(v.shape) == jv.shape
                assert str(v.dtype) == "torch." + str(jv.dtype)
        for (_, jv), (_, v) in zip(jflat, tree_flatten_with_path(tp)):
            np.testing.assert_array_equal(v.float().numpy(),
                                          np.asarray(jv, np.float32))
    with pytest.raises(ValueError, match="parameter tree"):
        convert.lm_params({"embed": jp["embed"]}, tc, "cpu")


def test_lm_refuses_an_encoder_decoder():
    """The decoder-only entry points would build the wrong model for an
    encoder-decoder config; they say where it runs."""
    _, tc = _cfgs()
    for call in (lambda: lm.init_lm(torch.Generator(), tc),
                 lambda: lm.init_cache(tc, 2, 8, torch.device("cpu"))):
        with pytest.raises(ValueError, match="models.encdec.*init_params"):
            call()


def test_encode_and_forward_train_match_jax():
    jc, tc, jp, tp = _model(seed=3)
    rng = np.random.default_rng(5)
    frames = _frames(rng, tc, 2)
    toks = rng.integers(0, tc.vocab_size, (2, 11)).astype(np.int32)
    je = j_encdec.encode(jp, jc, jnp.asarray(frames))
    te = encdec.encode(tp, tc, torch.from_numpy(frames))
    assert te.dtype == torch.float32 and tuple(te.shape) == (2, 8, 64)
    _close(te, je, 1e-4)
    jl = j_encdec.forward_train(jp, jc, jnp.asarray(frames),
                                jnp.asarray(toks))
    tl = encdec.forward_train(tp, tc, torch.from_numpy(frames),
                              torch.from_numpy(toks))
    assert tl.dtype == torch.float32
    assert tuple(tl.shape) == (2, 11, tc.vocab_size)
    _close(tl, jl, 1e-4)


def test_loss_and_gradients_match_jax():
    """``loss_fn`` (masked mean NLL, ``{"loss", "nll"}``) within rtol 1e-4
    and every gradient leaf within 1e-4 relative L2 of ``jax.grad``'s (the
    cross-attention's K bias, whose gradient is zero, within 1e-6),
    through ``launch.steps._value_and_grad`` (the loss the train step
    differentiates dispatches on ``cfg.is_encdec``)."""
    jc, tc, jp, tp = _model(seed=4)
    rng = np.random.default_rng(6)
    batch = {"enc_embeds": _frames(rng, tc, 3, 10),
             "tokens": rng.integers(0, tc.vocab_size, (3, 9)
                                    ).astype(np.int32),
             "targets": rng.integers(0, tc.vocab_size, (3, 9)
                                     ).astype(np.int32)}
    batch["targets"][0, :4] = -100
    (jl, jm), jg = jax.value_and_grad(j_encdec.loss_fn, has_aux=True)(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm, tg = steps._value_and_grad(
        tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(tm) == sorted(jm) == ["loss", "nll"]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=1e-4)
    jflat = jax.tree_util.tree_leaves(jg)
    flat = tree_flatten_with_path(tg)
    assert len(flat) == len(jflat)
    for (path, g), jv in zip(flat, jflat):
        g, jv = g.numpy().astype(np.float64), np.asarray(jv, np.float64)
        if path[1:] == ("cross_attn", "wk", "b"):
            # zero in exact arithmetic: the bias adds q·b to every logit
            # of a query alike (no rope), which the softmax cancels; both
            # packages give f32 rounding noise, held to 1e-6 absolute
            assert np.abs(g).max() < 1e-6 and np.abs(jv).max() < 1e-6
            continue
        rel = np.linalg.norm(g - jv) / max(np.linalg.norm(jv), 1e-30)
        assert rel < 1e-4, (path, rel)


def test_prefill_and_decode_steps_match_jax():
    """``make_prefill_step`` (encode, then ``dec_prefill``) and 6
    ``make_serve_step`` calls against the JAX steps: logits within 1e-4,
    the caches within 1e-4, the greedy tokens equal; the serve step writes
    the cache in place."""
    jc, tc, jp, tp = _model(seed=7)
    rng = np.random.default_rng(8)
    frames = _frames(rng, tc, 2)
    toks = rng.integers(0, tc.vocab_size, (2, 5)).astype(np.int32)
    cache_len = 16
    jl, jcache = jax.jit(j_steps.make_prefill_step(jc, cache_len))(
        jp, jnp.asarray(frames), jnp.asarray(toks))
    tl, tcache = steps.make_prefill_step(tc, cache_len)(
        tp, torch.from_numpy(frames), torch.from_numpy(toks))
    _close(tl, jl, 1e-4)
    _caches_close(tcache, jcache, 1e-4)
    jenc = j_encdec.encode(jp, jc, jnp.asarray(frames))
    tenc = encdec.encode(tp, tc, torch.from_numpy(frames))
    jstep = jax.jit(j_steps.make_serve_step(jc))
    tstep = steps.make_serve_step(tc)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.argmax(tl, -1).to(torch.int32)
    for i in range(6):
        pos = np.full((2,), 5 + i, np.int32)
        jl, jcache = jstep(jp, jcache, jt, jnp.asarray(pos), jenc)
        tl, tcache2 = tstep(tp, tcache, tt, torch.from_numpy(pos), tenc)
        assert tcache2 is tcache
        _close(tl, jl, 1e-4)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _caches_close(tcache, jcache, 1e-4)


def test_decode_continues_from_a_converted_jax_cache():
    """``convert.lm_cache`` of the decoder cache: a JAX prefill's cache
    decodes in the port as it does in JAX."""
    jc, tc, jp, tp = _model(seed=9)
    rng = np.random.default_rng(10)
    frames = _frames(rng, tc, 2)
    toks = rng.integers(0, tc.vocab_size, (2, 7)).astype(np.int32)
    jenc = j_encdec.encode(jp, jc, jnp.asarray(frames))
    _, jcache = j_encdec.dec_prefill(jp, jc, jenc, jnp.asarray(toks[:, :6]),
                                     8)
    tcache = convert.lm_cache(_np(jcache), tc, "cpu")
    pos = np.full((2,), 6, np.int32)
    jl, jcache = j_encdec.dec_decode_step(jp, jc, jenc, jcache,
                                          jnp.asarray(toks[:, 6]),
                                          jnp.asarray(pos))
    tl, tcache = encdec.dec_decode_step(
        tp, tc, torch.from_numpy(np.array(jenc)), tcache,
        torch.from_numpy(toks[:, 6]), torch.from_numpy(pos))
    _close(tl, jl, 1e-4)
    _caches_close(tcache, jcache, 1e-4)
    with pytest.raises(ValueError, match="decoder cache"):
        convert.lm_cache((_np(jcache),), tc, "cpu")


def test_decode_equals_forward_train():
    """Decoding token t (after a one-token prefill) gives row t of
    ``forward_train``'s logits, within 1e-4."""
    _, tc, _, tp = _model(seed=11)
    rng = np.random.default_rng(12)
    frames = torch.from_numpy(_frames(rng, tc, 2))
    toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 9)
                                         ).astype(np.int32))
    full = encdec.forward_train(tp, tc, frames, toks)
    enc = encdec.encode(tp, tc, frames)
    logits, caches = encdec.dec_prefill(tp, tc, enc, toks[:, :1], 12)
    got = [logits]
    for t in range(1, 9):
        pos = torch.full((2,), t, dtype=torch.int32)
        logits, caches = encdec.dec_decode_step(tp, tc, enc, caches,
                                                toks[:, t], pos)
        got.append(logits)
    _close(torch.stack(got, 1), full.detach(), 1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_model_server_matches_the_jax_steps_by_hand():
    """The port's ModelServer (3 slots; two prompts admitted, 4 steps, a
    third admitted into the idle slot, 5 more steps) gives every slot the
    greedy tokens of the JAX package's jitted ``make_prefill_step`` and
    ``make_serve_step`` driven by hand for that slot's prompt; the slot
    buffer holds each admission's encoder output."""
    jc, tc, jp, tp = _model(seed=13)
    rng = np.random.default_rng(14)
    p1 = rng.integers(0, tc.vocab_size, (2, 6)).astype(np.int32)
    f1 = _frames(rng, tc, 2)
    p2 = rng.integers(0, tc.vocab_size, (1, 4)).astype(np.int32)
    f2 = _frames(rng, tc, 1)
    cache_len = 16
    jprefill = jax.jit(j_steps.make_prefill_step(jc, cache_len))
    jserve = jax.jit(j_steps.make_serve_step(jc))

    def by_hand(prompts, frames, steps_):
        logits, caches = jprefill(jp, jnp.asarray(frames),
                                  jnp.asarray(prompts))
        enc = j_encdec.encode(jp, jc, jnp.asarray(frames))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out = [np.asarray(tok)]
        for i in range(steps_):
            pos = jnp.full((len(prompts),), prompts.shape[1] + i, jnp.int32)
            logits, caches = jserve(jp, caches, tok, pos, enc)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            out.append(np.asarray(tok))
        return np.stack(out, 1).tolist(), np.asarray(enc)

    want1, enc1 = by_hand(p1, f1, 9)
    want2, enc2 = by_hand(p2, f2, 5)
    srv = ModelServer(tc, tp, batch=3, cache_len=cache_len)
    assert tuple(srv.enc_out.shape) == (3, tc.frontend_len, tc.d_model)
    assert srv.prefill(p1, f1) == [0, 1]
    srv.decode(4)
    assert srv.prefill(p2, torch.from_numpy(f2)) == [2]
    srv.decode(5)
    assert srv.generated == want1 + want2
    _close(srv.enc_out[:2], enc1, 1e-4)
    _close(srv.enc_out[2:], enc2, 1e-4)
    np.testing.assert_array_equal(srv.positions.numpy(), [15, 15, 9])


def test_the_jax_model_server_cannot_serve_an_encoder_decoder():
    """The JAX package's ModelServer calls its encoder-decoder prefill
    step with the tokens only and raises; the port's differs on purpose
    (the test above)."""
    jc, _, jp, _ = _model(seed=15)
    srv = JModelServer(jc, jp, batch=2, cache_len=16)
    with pytest.raises(TypeError, match="tokens"):
        srv.prefill(np.ones((2, 4), np.int32))


def test_model_server_checks_the_frames():
    _, tc, _, tp = _model(seed=16)
    srv = ModelServer(tc, tp, batch=2, cache_len=16, enc_len=5)
    assert tuple(srv.enc_out.shape) == (2, 5, tc.d_model)
    toks = np.ones((1, 4), np.int32)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="enc_embeds of shape"):
        srv.prefill(toks, _frames(rng, tc, 1))          # 8 frames, not 5
    with pytest.raises(ValueError, match="enc_embeds of shape"):
        srv.prefill(toks)
    assert srv.prefill(toks, _frames(rng, tc, 1, 5)) == [0]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _pool(cfg, n):
    return [b for b, _ in zip(train.make_batches(
        cfg, batch=2, seq=12, seed=0, pipeline=False), range(n))]


def test_make_batches_carries_enc_embeds():
    """Batches have the JAX package's keys and tokens; ``enc_embeds`` is
    f32 (batch, seq, d_model) at unit RMS, drawn anew per batch index and
    the same on a second pass."""
    jc, tc = _cfgs()
    got = _pool(tc, 3)
    want = [b for b, _ in zip(j_train.make_batches(
        jc, batch=2, seq=12, seed=0, pipeline=False), range(3))]
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        assert "enc_embeds" in a
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(a[k], b[k])
        e = a["enc_embeds"]
        assert e.shape == (2, 12, tc.d_model) and e.dtype == np.float32
        np.testing.assert_allclose(np.sqrt((e ** 2).mean(-1)), 1.0,
                                   rtol=1e-4)
    assert not np.array_equal(got[0]["enc_embeds"], got[1]["enc_embeds"])
    np.testing.assert_array_equal(_pool(tc, 2)[1]["enc_embeds"],
                                  got[1]["enc_embeds"])


def test_train_loop_on_make_batches():
    """A TrainLoop of reduced seamless through the host pipeline: the
    encoder frames reach the loss, which stays finite and falls over the
    repeated pool."""
    _, tc = _cfgs()
    loop = train.TrainLoop(tc, opt_cfg=AdamWConfig(
        lr=3e-3, warmup_steps=1, total_steps=12), device="cpu")
    batches = train.make_batches(tc, batch=2, seq=12, seed=0)
    try:
        hist = loop.run(batches, steps=12, log_every=0)["history"]
    finally:
        batches.close()
    losses = [m["loss"] for m in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not any(m["skipped"] for m in hist)


def test_train_cli_on_cpu(tmp_path):
    out = tmp_path / "m.json"
    assert train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "8",
                       "--metrics-out", str(out)]) == 0
    hist = json.loads(out.read_text())["history"]
    assert len(hist) == 3 and all(np.isfinite(m["loss"]) for m in hist)


def test_serve_cli_decodes_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--requests", "64", "--batch", "64", "--events",
                       "1000", "--keys", "32", "--decode", "--arch", ARCH,
                       "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["decode_arch"] == ARCH
    toks = report["decode_tokens"]
    assert len(toks) == 4 and all(len(t) == 17 for t in toks)
    assert all(0 <= t < reduced(get_config(ARCH)).vocab_size
               for row in toks for t in row)


def test_every_registered_config_serves_and_trains():
    """Each config of the registry, reduced, serves two steps through
    ModelServer and trains one step through TrainLoop on the CPU."""
    from repro_torch.configs.registry import list_archs
    from repro_torch.models import frontend
    for arch in list_archs():
        cfg = reduced(get_config(arch))
        params = steps.init_params(torch.Generator().manual_seed(0), cfg)
        srv = ModelServer(cfg, params, batch=2, cache_len=16)
        frames = (frontend.stub_audio_frames(torch.Generator(), cfg, 2,
                                             srv.enc_len)
                  if cfg.is_encdec else None)
        srv.prefill(np.ones((2, 4), np.int32), frames)
        assert srv.decode(2).shape == (2,)
        loop = train.TrainLoop(cfg, opt_cfg=AdamWConfig(),
                               device="cpu")
        batch = next(iter(train.make_batches(cfg, batch=2, seq=8, seed=0,
                                             pipeline=False)))
        hist = loop.run(iter([batch]), steps=1, log_every=0)["history"]
        assert np.isfinite(hist[0]["loss"]), arch
