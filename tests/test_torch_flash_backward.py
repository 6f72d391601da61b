"""The flash attention backward's plain version against JAX, on the CPU.

``ref.flash_attention_bwd_ref`` (the FlashAttention-2 formulas the backward
kernel computes: P recomputed from the scores and each row's log-sum-exp,
``Di = rowsum(dO ∘ O)``, ``dS = P ∘ (dP − Di)``) and
``ref.flash_attention_lse_ref`` (the output and the log-sum-exp the
training forward returns) against ``jax.vjp`` of the JAX package's
``flash_attention_ref`` and the log-sum-exp of its masked logits, on the
same numpy inputs made from a seed: GQA at rep 1, 3 and 6; causal,
windowed and non-causal with Sq < Sk; ragged lengths; and a
context-parallel rank's rows at ``q_offset`` against the whole-sequence
vjp with dO zero outside those rows.

Tolerances: 1e-5 in f32 (another summation order); 2e-2 in bf16, where
JAX rounds the logits and every product to bf16 and the plain backward,
as the kernel, sums in f32 and rounds P and dS only as product operands.
No shape here has a query row that keeps no key (the kernels write 0 and
give it zero gradient; the references average V uniformly there).

The CUDA kernel is held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; the ops' meta shapes
and FLOP formulas are in ``tests/test_torch_dryrun.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref as tref

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(x, jd) for x in xs],
            [torch.from_numpy(x).to(td) for x in xs])


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _jax_grads(jq, jk, jv, jdo, causal, window):
    out, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=causal, window=window), jq, jk, jv)
    return out, vjp(jdo)


def _jax_lse(jq, jk, causal, window, q_offset=None):
    """Each row's log-sum-exp of JAX's masked logits (the reference's
    logits, masked with its NEG_INF), (B, Hq, Sq) f32."""
    B, Sq, Hq, D = jq.shape
    Sk, Hkv = jk.shape[1], jk.shape[2]
    qg = jq.reshape(B, Sq, Hkv, Hq // Hkv, D)
    logits = jnp.einsum("bqhrd,bkhd->bhrqk", qg, jk).astype(
        jnp.float32) * D ** -0.5
    qpos = jnp.arange(Sq)[:, None] + (Sk - Sq if q_offset is None
                                      else q_offset)
    kpos = jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), jnp.bool_)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = jnp.where(mask, logits, jref.NEG_INF)
    return jax.nn.logsumexp(logits, axis=-1).reshape(B, Hq, Sq)


SHAPES = [(2, 64, 64, 4, 4, 32),      # rep 1
          (1, 48, 48, 6, 2, 16),      # rep 3
          (2, 40, 72, 12, 2, 64),     # rep 6, Sq < Sk
          (2, 37, 53, 6, 2, 16)]      # ragged lengths
MASKS = [(True, None), (True, 16), (False, None)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_bwd_ref_matches_jax_vjp(B, Sq, Sk, Hq, Hkv, D,
                                                 causal, window, dtype):
    """dq, dk and dv of the plain backward (fed the plain forward's output
    and log-sum-exp) against ``jax.vjp``; the log-sum-exp against JAX's
    masked logits."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        3, dtype, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
        (B, Sq, Hq, D))
    tol = DTYPES[dtype][2]
    out, lse = tref.flash_attention_lse_ref(tq, tk, tv, causal=causal,
                                            window=window)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    _close(lse, _jax_lse(jq, jk, causal, window), tol, "lse")
    jout, (jdq, jdk, jdv) = _jax_grads(jq, jk, jv, jdo, causal, window)
    _close(out, jout, tol, "out")
    got = tref.flash_attention_bwd_ref(tdo, tq, tk, tv, out, lse,
                                       causal=causal, window=window)
    for g, w, t, name in zip(got, (jdq, jdk, jdv), (tq, tk, tv),
                             ("dq", "dk", "dv")):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, tol, name)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 12)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_bwd_ref_at_a_query_offset(m, causal, window,
                                                   dtype):
    """A context-parallel rank's call: rows ``[r·c, (r+1)·c)`` at
    ``q_offset = r·c`` against the whole K/V. JAX's whole-sequence vjp
    with dO zero outside those rows gives the rank's dq rows (and zero
    elsewhere) and its dk/dv partials; the rank's lse equals those rows of
    the whole sequence's."""
    B, S, Hq, Hkv, D = 2, 64, 6, 2, 16
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        5, dtype, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
        (B, S, Hq, D))
    tol = DTYPES[dtype][2]
    c = S // m
    full_lse = _jax_lse(jq, jk, causal, window)
    for r in range(m):
        rows = slice(r * c, (r + 1) * c)
        keep = np.zeros((1, S, 1, 1), np.float32)
        keep[:, rows] = 1.0
        jdo_r = jdo * jnp.asarray(keep, jdo.dtype)
        _, (jdq, jdk, jdv) = _jax_grads(jq, jk, jv, jdo_r, causal, window)
        q_r = tq[:, rows].contiguous()
        out, lse = tref.flash_attention_lse_ref(
            q_r, tk, tv, causal=causal, window=window, q_offset=r * c)
        _close(lse, full_lse[:, :, rows], tol, f"lse rank {r}")
        dq, dk, dv = tref.flash_attention_bwd_ref(
            tdo[:, rows].contiguous(), q_r, tk, tv, out, lse, causal=causal,
            window=window, q_offset=r * c)
        _close(dq, np.asarray(jdq, np.float32)[:, rows], tol,
               f"dq rank {r}")
        _close(dk, jdk, tol, f"dk rank {r}")
        _close(dv, jdv, tol, f"dv rank {r}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_bwd_ref_gives_rows_without_keys_no_gradient(dtype):
    """Query rows before every key (``q_offset`` −3, causal): the plain
    log-sum-exp is the −1e30 sentinel there, and with the kernel's output
    for those rows (0) the rows get zero dq and add nothing to dk and dv:
    the gradient equals the one of the rows that keep keys alone."""
    B, Sq, Sk, Hq, Hkv, D, off = 1, 12, 16, 4, 2, 16, -3
    _, (tq, tk, tv, tdo) = _inputs(6, dtype, (B, Sq, Hq, D),
                                   (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                                   (B, Sq, Hq, D))
    out, lse = tref.flash_attention_lse_ref(tq, tk, tv, q_offset=off)
    assert bool((lse[:, :, :-off] == tref.ATTN_NEG_INF).all())
    assert bool((lse[:, :, -off:] > -1e3).all())
    out[:, :-off] = 0
    dq, dk, dv = tref.flash_attention_bwd_ref(tdo, tq, tk, tv, out, lse,
                                              q_offset=off)
    assert not bool(dq[:, :-off].any())
    rows = slice(-off, Sq)
    want = tref.flash_attention_bwd_ref(
        tdo[:, rows].contiguous(), tq[:, rows].contiguous(), tk, tv,
        out[:, rows].contiguous(), lse[:, :, rows].contiguous(), q_offset=0)
    for g, w in zip((dq[:, rows], dk, dv), want):
        assert torch.equal(g, w)


def test_ops_flash_attention_trains_through_the_plain_version_on_the_cpu(
        monkeypatch):
    """CPU tensors that need a gradient keep autograd through the plain
    version: no backward op, the gradients of ``flash_attention_ref``."""
    _, (q, k, v, do) = _inputs(7, "f32", (1, 24, 4, 16), (1, 24, 2, 16),
                               (1, 24, 2, 16), (1, 24, 4, 16))
    calls = []
    monkeypatch.setattr(tref, "flash_attention_bwd_ref",
                        lambda *a, **kw: calls.append(a))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ins, window=8), ins, do)
    ins2 = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tref.flash_attention_ref(*ins2, window=8),
                               ins2, do)
    assert calls == []
    for g, w in zip(got, want):
        assert torch.equal(g, w)
