"""Port attention: the plain versions (``repro_torch.kernels.ref``
``flash_attention_ref`` / ``decode_attention_ref``) against the JAX
references and the Pallas kernels (interpret mode) on the shapes of
``tests/test_kernels.py``, plus the attention wrappers' input checks.

The same numpy inputs go to both packages. Tolerances: 2e-5 in f32 (another
summation order); in bf16 the two references round at the same places
(logits in bf16, softmax in f32, probabilities cast back before PV), so
they are held at 1e-2, one bf16 rounding step. Against the Pallas kernels,
which compute in f32 throughout, the bf16 tolerance is 2e-2, as in
``tests/test_kernels.py``. No shape here has a query row that keeps no
key: there the kernels write 0 and the references the uniform average.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``; the
arithmetic of the CUDA decode kernel's split and combine passes is
modelled here in plain PyTorch and held against both references.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(x, jd) for x in xs],
            [torch.from_numpy(x).to(td) for x in xs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


FLASH_SHAPES = [(2, 128, 128, 4, 4, 64),     # MHA
                (1, 128, 128, 8, 2, 64),     # GQA 4x
                (2, 64, 128, 4, 1, 32),      # MQA, cross lengths
                (2, 37, 53, 6, 2, 16)]       # ragged lengths
MASKS = [(True, None), (True, 32), (False, None)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_ref_matches_jax(B, Sq, Sk, Hq, Hkv, D, causal,
                                         window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, dtype, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, Hq, D)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_ref_matches_pallas(causal, window, dtype):
    from repro.kernels.flash_attention import flash_attention_pallas
    B, Sq, Sk, Hq, Hkv, D = 1, 128, 128, 8, 2, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        1, dtype, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  interpret=True)
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    _close(got, want, 2e-2 if dtype == "bf16" else 2e-5)


DECODE_SHAPES = [(4, 128, 4, 4, 64), (2, 256, 8, 2, 64), (3, 64, 4, 1, 32),
                 (2, 1024, 12, 2, 128)]     # qwen2-1.5b's heads


@pytest.mark.parametrize("B,S,Hq,Hkv,D", DECODE_SHAPES)
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_ref_matches_jax(B, S, Hq, Hkv, D, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        2, dtype, (B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    lengths = np.random.default_rng(2).integers(1, S + 1, B).astype(np.int32)
    lengths[0] = S + 7                      # a length past the cache
    got = tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths),
                                    window=window)
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths),
                                     window=window)
    assert got.dtype == tq.dtype and got.shape == (B, Hq, D)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("window", [None, 48])
def test_decode_attention_ref_matches_pallas(window):
    from repro.kernels.decode_attention import decode_attention_pallas
    B, S, Hq, Hkv, D = 2, 256, 8, 2, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(3, "f32", (B, Hq, D),
                                         (B, S, Hkv, D), (B, S, Hkv, D))
    lengths = np.asarray([100, 256], np.int32)
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths),
                                   window=window, interpret=True)
    got = tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths),
                                    window=window)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("S,window,steps", [(16, 8, 20), (8, 8, 12),
                                            (16, None, 11)])
def test_decode_attention_ring_matches_prefix_and_jax(S, window, steps):
    """Ring-layout decode past the window == prefix-layout decode on the
    same history, in both packages, and the Pallas kernel in ring mode."""
    B, Hq, Hkv, D = 2, 4, 2, 16
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    hist_k = rng.standard_normal((B, steps, Hkv, D)).astype(np.float32)
    hist_v = rng.standard_normal((B, steps, Hkv, D)).astype(np.float32)
    kr = np.zeros((B, S, Hkv, D), np.float32)
    vr = np.zeros((B, S, Hkv, D), np.float32)
    for t in range(steps):
        kr[:, t % S], vr[:, t % S] = hist_k[:, t], hist_v[:, t]
    pos = np.full((B,), steps - 1, np.int32)
    lengths = np.full((B,), steps, np.int32)
    T = torch.from_numpy
    prefix = tref.decode_attention_ref(T(q), T(hist_k), T(hist_v),
                                       T(lengths), window=window)
    ring = tref.decode_attention_ref(T(q), T(kr), T(vr), T(pos),
                                     window=window, ring=True)
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(kr),
                                     jnp.asarray(vr), jnp.asarray(pos),
                                     window=window, ring=True)
    _close(ring, prefix.numpy(), 1e-5)
    _close(ring, want, 2e-5)
    from repro.kernels.decode_attention import decode_attention_pallas
    got_p = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kr),
                                    jnp.asarray(vr), jnp.asarray(pos),
                                    window=window, ring=True,
                                    interpret=True, block_k=8)
    _close(ring, got_p, 2e-5)


def _split_kv_decode(q, kc, vc, lengths, window, ring, chunk):
    """Plain model of the CUDA decode kernel's two passes (f32, log2
    domain). Split pass: split i of a sequence covers the live slots
    [i·chunk, (i+1)·chunk) ∩ [lo, hi) and yields (m, l, acc); a split with
    nothing live keeps l = 0, m = −1e30. Combine pass: m* = max m_i,
    l = Σ l_i·2^(m_i−m*), o = Σ acc_i·2^(m_i−m*) / l, l = 0 writing 0.
    Returns the output and the number of empty splits."""
    B, Hq, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    rep = Hq // Hkv
    n_split = -(-S // chunk)
    qg = q.reshape(B, Hkv, rep, D) * (D ** -0.5 * np.log2(np.e))
    out = torch.zeros(B, Hkv, rep, D)
    empty = 0
    for b in range(B):
        L = int(lengths[b])
        if ring:
            lo, hi = 0, min(S, L + 1)
        else:
            lo, hi = (max(0, L - window) if window else 0), min(S, L)
        m = torch.full((n_split, Hkv, rep), -1e30)
        l = torch.zeros(n_split, Hkv, rep)
        acc = torch.zeros(n_split, Hkv, rep, D)
        for i in range(n_split):
            s0, s1 = max(lo, i * chunk), min(hi, (i + 1) * chunk)
            if s0 >= s1:
                empty += 1
                continue
            sc = torch.einsum("hrd,jhd->hrj", qg[b], kc[b, s0:s1])
            if ring:
                kpos = torch.arange(s0, s1)
                ap = L - (L - kpos + S * (L // S + 1)) % S
                keep = ap >= 0
                if window:
                    keep = keep & (ap > L - window)
                sc = sc.masked_fill(~keep, float("-inf"))
            m[i] = torch.clamp(sc.amax(-1), min=-1e30)
            p = torch.exp2(sc - m[i][..., None])
            l[i] = p.sum(-1)
            acc[i] = torch.einsum("hrj,jhd->hrd", p, vc[b, s0:s1])
        w = torch.exp2(m - m.amax(0))
        lt = (l * w).sum(0)
        o = (acc * w[..., None]).sum(0)
        out[b] = o / torch.where(lt > 0, lt, torch.ones_like(lt))[..., None]
    return out.reshape(B, Hq, D), empty


@pytest.mark.parametrize("ring,window", [(False, None), (False, 100),
                                         (True, 100), (True, None)])
@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_split_kv_merge_matches_refs(ring, window, chunk):
    """The split-KV decode (per-split partials, then the merge) equals the
    plain decode and the JAX reference in f32, at lengths on and around
    the split edges, past the cache (prefix) and positions far past the
    ring (ring), in a cache whose size is no multiple of the split."""
    B, S, Hq, Hkv, D = 6, 300, 6, 2, 16
    _, (q, kc, vc) = _inputs(6, "f32", (B, Hq, D), (B, S, Hkv, D),
                             (B, S, Hkv, D))
    if ring:
        lengths = [0, S // 2, S - 1, S, 3 * S + 5, 10 * S + 1]
    else:
        lengths = [1, chunk - 1, chunk + 1, 2 * chunk, S, S + 9]
    lengths = np.asarray(lengths, np.int32)
    got, empty = _split_kv_decode(q, kc, vc, lengths, window, ring, chunk)
    assert empty > 0                    # some splits hold nothing live
    T = torch.from_numpy
    want = tref.decode_attention_ref(q, kc, vc, T(lengths), window=window,
                                     ring=ring)
    _close(got, want.numpy(), 1e-5)
    want_j = jref.decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
        jnp.asarray(vc.numpy()), jnp.asarray(lengths), window=window,
        ring=ring)
    _close(got, want_j, 1e-5)


def test_decode_attention_matches_flash_last_row():
    """Decoding token t equals row t of full causal attention."""
    B, S, Hq, Hkv, D = 2, 64, 6, 2, 32
    _, (q_full, k, v) = _inputs(4, "f32", (B, S, Hq, D), (B, S, Hkv, D),
                                (B, S, Hkv, D))
    full = tref.flash_attention_ref(q_full, k, v, causal=True)
    dec = tref.decode_attention_ref(q_full[:, -1].contiguous(), k, v,
                                    torch.full((B,), S, dtype=torch.int32))
    _close(dec, full[:, -1].numpy(), 1e-5)


def test_ops_dispatch_cpu_tensors_to_the_plain_versions():
    _, (q, k, v) = _inputs(5, "f32", (1, 8, 4, 16), (1, 8, 2, 16),
                           (1, 8, 2, 16))
    torch.testing.assert_close(ops.flash_attention(q, k, v, window=4),
                               tref.flash_attention_ref(q, k, v, window=4))
    lengths = torch.tensor([5], dtype=torch.int32)
    torch.testing.assert_close(
        ops.decode_attention(q[:, 0].contiguous(), k, v, lengths),
        tref.decode_attention_ref(q[:, 0].contiguous(), k, v, lengths))


@pytest.mark.parametrize("fn,args", [
    (flash_attention_cuda, ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16))),
    (decode_attention_cuda, ((1, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16))),
])
def test_attention_wrappers_refuse_cpu_tensors(fn, args):
    ts = [torch.zeros(s) for s in args]
    extra = ((torch.ones(1, dtype=torch.int32),)
             if fn is decode_attention_cuda else ())
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        fn(*ts, *extra)


# ---------------------------------------------------------------------------
# the streaming plain version (JAX's flash_attention_xla) and q_offset
# ---------------------------------------------------------------------------

STREAM_TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [(2, 128, 128, 4, 2, 32),
                                              (1, 64, 128, 6, 2, 16)])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("block_k", [16, 64, 48])     # 48: the fallback
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_stream_matches_jax_xla(B, Sq, Sk, Hq, Hkv, D,
                                                causal, window, block_k,
                                                dtype):
    """The online softmax over KV blocks against JAX's streaming form, on
    the same numpy inputs: both compute in f32 and round once to the
    input dtype (1e-5 in f32, another summation order; 2e-2 in bf16, as
    the kernels are held). A block that does not divide Sk is the dense
    reference in both packages."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        7, dtype, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    got = tref.flash_attention_stream(tq, tk, tv, causal=causal,
                                      window=window, block_k=block_k)
    want = jref.flash_attention_xla(jq, jk, jv, causal=causal,
                                    window=window, block_k=block_k)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, Hq, D)
    _close(got, want, STREAM_TOL[dtype])


@pytest.mark.parametrize("block_k,Sk,streams", [(16, 64, True),
                                                (64, 64, False),
                                                (0, 64, False)])
def test_ops_flash_attention_block_k_takes_the_streaming_version(
        monkeypatch, block_k, Sk, streams):
    """``block_k`` set and ``Sk > block_k``: CPU tensors reach the
    streaming plain version (as JAX's op reaches ``flash_attention_xla``),
    otherwise the dense one, with the same values either way."""
    _, (q, k, v) = _inputs(8, "f32", (1, 32, 4, 16), (1, Sk, 2, 16),
                           (1, Sk, 2, 16))
    calls = []
    stream = tref.flash_attention_stream

    def counted(*a, **kw):
        calls.append(kw["block_k"])
        return stream(*a, **kw)

    monkeypatch.setattr(tref, "flash_attention_stream", counted)
    got = ops.flash_attention(q, k, v, window=24, block_k=block_k)
    assert calls == ([block_k] if streams else [])
    _close(got, tref.flash_attention_ref(q, k, v, window=24).numpy(), 1e-5)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("m", [2, 4])
def test_flash_attention_ref_q_offset_gives_the_rows_exactly(causal, window,
                                                             m):
    """A context-parallel rank's call: rows ``[r·c, (r+1)·c)`` of q at
    ``q_offset = r·c`` against the whole K/V equal those rows of the
    whole-sequence call bit for bit, and so does the streaming version
    against its own whole-sequence call."""
    B, S, Hq, Hkv, D = 2, 64, 6, 2, 16
    _, (q, k, v) = _inputs(9, "f32", (B, S, Hq, D), (B, S, Hkv, D),
                           (B, S, Hkv, D))
    c = S // m
    for fn, kw in ((tref.flash_attention_ref, {}),
                   (tref.flash_attention_stream, {"block_k": 16})):
        full = fn(q, k, v, causal=causal, window=window, **kw)
        for r in range(m):
            rows = fn(q[:, r * c:(r + 1) * c].contiguous(), k, v,
                      causal=causal, window=window, q_offset=r * c, **kw)
            assert torch.equal(rows, full[:, r * c:(r + 1) * c]), (fn, r)
