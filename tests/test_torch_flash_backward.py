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
from repro_torch.configs import base as t_base
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
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


# ---------------------------------------------------------------------------
# the backward's plan: routes, grid and the dK/dV parts' summation order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(fa.DTYPES))
def test_plan_routes_every_head_dim_and_dtype(D, dtype):
    """bf16 at head dims 64 and 128 takes the wgmma kernels, bf16 at the
    others the mma.sync kernels, f32 the FMA kernels; every launch of the
    plan has blocks and the row scratch covers the padded rows."""
    p = fb.plan(2, 100, 130, 12, 4, D, dtype)
    want = ("fma" if dtype == torch.float32 else
            "wgmma" if D in (64, 128) else "mma")
    assert p.route == want and p.route in fb.ROUTES
    assert [n for n, _ in p.blocks][0] == "di"
    assert all(b > 0 for _, b in p.blocks)
    assert p.sq_pad >= 100 and p.scratch_bytes >= 4 * 2 * 12 * p.sq_pad
    if want == "wgmma":
        assert p.sq_pad % 64 == 0 and 3 % p.split == 0
    else:
        assert (p.split, p.wg_q, p.sq_pad) == (1, 1, 100)


def test_plan_fills_the_card_at_the_training_call():
    """qwen2-1.5b's training call (B 4, S 512, 12/2 heads of 128, bf16):
    64 key tiles of (KV head, batch) alone leave SMs idle, so each group's
    six heads are cut into three blocks of two heads (two warpgroups
    each): 192 dK/dV blocks, with the parts' f32 dK and dV in a 12.6 MB
    scratch."""
    p = fb.plan(4, 512, 512, 12, 2, 128, torch.bfloat16)
    blocks = dict(p.blocks)
    assert p.route == "wgmma" and (p.split, p.wg_q) == (3, 2)
    assert blocks["dkdv"] >= fb.SMS and blocks["dkdv"] == 192
    assert blocks["dq"] == 192 and blocks["dkdv_sum"] == 512
    assert p.scratch_bytes == 4 * (2 * 4 * 12 * 512
                                   + 3 * 2 * 4 * 512 * 2 * 128)


def _training_calls(cfg, B, S):
    """(Sq, Sk, Hq, Hkv, D, causal, window) of each attention call one
    training step of ``cfg`` makes at batch B and length S: causal
    self-attention (with the config's window); an encoder-decoder adds
    its encoder's non-causal self-attention over the frontend's frames
    and the decoder's non-causal cross-attention onto them."""
    if not any(kind.startswith("a") for kind in cfg.pattern):
        return []
    calls = [(S, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd, True,
              cfg.sliding_window)]
    if cfg.is_encdec:
        F = cfg.frontend_len
        calls += [(F, F, cfg.n_heads, cfg.n_kv_heads, cfg.hd, False, None),
                  (S, F, cfg.n_heads, cfg.n_kv_heads, cfg.hd, False, None)]
    return calls


@pytest.mark.parametrize("arch", list_archs())
def test_plan_names_a_route_for_every_registered_training_call(arch):
    """Every registered config's training attention (train_4k's length at
    one and four sequences a card, the config's dtype) has a route with
    its grid and scratch; bf16 at head dims 64 and 128 is the wgmma
    route, and its dK/dV grid reaches every SM wherever the heads allow."""
    cfg = get_config(arch)
    calls = _training_calls(cfg, 1, t_base.SHAPES["train_4k"].seq_len)
    assert calls or cfg.family == "ssm"
    for B in (1, 4):
        for Sq, Sk, Hq, Hkv, D, causal, window in _training_calls(
                cfg, B, t_base.SHAPES["train_4k"].seq_len):
            p = fb.plan(B, Sq, Sk, Hq, Hkv, D, cfg.compute_dtype)
            assert p.route in fb.ROUTES and p.scratch_bytes > 0
            assert p.route == ("wgmma" if D in (64, 128) else "mma")
            rep = Hq // Hkv
            assert rep % p.split == 0 and rep % p.wg_q == 0
            blocks = dict(p.blocks)
            assert blocks["dkdv"] >= fb.SMS or p.split == rep
            assert ("dkdv_sum" in blocks) == (p.split > 1)


def _query_band(k0, k1, Sq, causal, window, q_offset):
    """The kernel's QueryBand: the first and the end query row that see a
    key of [k0, k1), the first rounded down to a 64-row tile."""
    lo, hi = 0, Sq
    if causal:
        lo = max(k0 - q_offset, 0)
    if window is not None:
        hi = min(k1 - 1 + window - q_offset, Sq)
    return lo - lo % 64, hi


_KV_GROUPS = 2   # consumer warpgroups of a dK/dV block (kKvGroups)


def _split_order(dout, q, k, v, out, lse, p, causal=True, window=None,
                 q_offset=None):
    """dK and dV summed in the wgmma route's order, in plain PyTorch: for
    each 64-key tile, block pb of the split walks steps u = (head of its
    part, query tile of the key tile's band), head-major; warpgroup
    u % 2 adds step u's dK and dV (the plain backward on those rows and
    keys alone) in step order; a block is warpgroup 0's sum plus
    warpgroup 1's (shared memory), and the blocks are added in block
    order (flash_bwd_dkdv_sum_kernel)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    off = Sk - Sq if q_offset is None else q_offset
    rep = Hq // Hkv
    heads = rep // p.split
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kvh in range(Hkv):
        for k0 in range(0, Sk, 64):
            k1 = min(k0 + 64, Sk)
            lo, hi = _query_band(k0, k1, Sq, causal, window, off)
            n_qt = -(-(hi - lo) // 64) if hi > lo else 0
            ks = (slice(None), slice(k0, k1), slice(kvh, kvh + 1))
            total_k = total_v = 0
            for pb in range(p.split):
                wgs = [[0, 0] for _ in range(_KV_GROUPS)]
                for u in range(heads * n_qt):
                    h = kvh * rep + pb * heads + u // n_qt
                    i0 = lo + (u % n_qt) * 64
                    i1 = min(i0 + 64, Sq)
                    qs = (slice(None), slice(i0, i1), slice(h, h + 1))
                    _, gk, gv = tref.flash_attention_bwd_ref(
                        dout[qs].contiguous(), q[qs].contiguous(),
                        k[ks].contiguous(), v[ks].contiguous(),
                        out[qs].contiguous(),
                        lse[:, h:h + 1, i0:i1].contiguous(), causal=causal,
                        window=window, q_offset=off + i0 - k0)
                    acc = wgs[u % _KV_GROUPS]
                    acc[0], acc[1] = acc[0] + gk, acc[1] + gv
                total_k = total_k + sum(a[0] for a in wgs)
                total_v = total_v + sum(a[1] for a in wgs)
            dk[ks], dv[ks] = total_k, total_v
    return dk, dv


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,split,opts", [
    (4, 512, 512, 12, 2, 64, 3, {}),                # rep 6, 2 heads a block
    (1, 200, 200, 3, 1, 64, 3, {"window": 37}),     # rep 3
    (2, 40, 72, 6, 2, 128, 3, {"causal": False}),   # Sq < Sk
    (1, 130, 150, 8, 1, 64, 8, {"q_offset": -13}),  # rows without keys
])
def test_the_wgmma_routes_summation_order_equals_the_plain_backward(
        B, Sq, Sk, Hq, Hkv, D, split, opts):
    """The wgmma route's dK/dV summation order (the plan's split parts,
    the steps dealt to two warpgroups), modelled in plain PyTorch in f32,
    equals the plain backward at 1e-6 of each element plus 1e-6 of the
    largest: the two add the same f32 terms in another order (the plain
    backward contracts a group's heads and queries in one product)."""
    p = fb.plan(B, Sq, Sk, Hq, Hkv, D, torch.bfloat16)
    assert p.route == "wgmma" and p.split == split
    _, (q, k, v, do) = _inputs(9, "f32", (B, Sq, Hq, D), (B, Sk, Hkv, D),
                               (B, Sk, Hkv, D), (B, Sq, Hq, D))
    out, lse = tref.flash_attention_lse_ref(q, k, v, **opts)
    out = torch.where((lse > -1e29).permute(0, 2, 1)[..., None], out, 0.0)
    want = tref.flash_attention_bwd_ref(do, q, k, v, out, lse, **opts)
    got = _split_order(do, q, k, v, out, lse, p, **opts)
    for g, w, name in zip(got, want[1:], ("dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()),
                                   err_msg=name)
