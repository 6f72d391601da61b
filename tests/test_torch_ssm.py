"""Port Mamba-2 block (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the same numpy inputs, on the CPU.

Inputs are drawn with numpy from a seed; block parameters are drawn by the
JAX package (``init_mamba``) and carried across as numpy. Sizes are the
reduced mamba2-780m's (d 64, d_state 16, headdim 16, chunk 8).

Tolerances (f32): 1e-5 for the SSD scan, the conv and the block's outputs
and states (another summation order in each einsum); gradients within
1e-4 relative L2 (the model tier's gradient tolerance). The port's
``softplus`` is ``F.softplus``, the identity above 20 where
``jax.nn.softplus`` is not; the two differ there by less than 2.1e-9,
far inside these tolerances. bf16 outputs within 2e-2 relative L2: the
casts sit where the JAX package has them, but each library rounds its
own products.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import ssm as j_ssm
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import ssm
from repro_torch.models.tree import tree_map

torch.set_num_threads(1)


def _cfgs(**changes):
    return (dataclasses.replace(j_reduced(j_get_config("mamba2-780m")),
                                **changes),
            dataclasses.replace(reduced(get_config("mamba2-780m")),
                                **changes))


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _params(jc, seed=0):
    jp = jax.tree_util.tree_map(np.asarray,
                                j_ssm.init_mamba(jax.random.PRNGKey(seed), jc))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _ssd_inputs(rng, B=2, L=16, H=4, P=8, G=2, N=6):
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    a = -np.abs(rng.standard_normal((B, L, H))).astype(np.float32) * 0.5
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    return x, a, Bm, Cm


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def test_segsum_and_its_masked_gradient():
    a = np.random.default_rng(0).standard_normal((3, 5, 8)).astype(
        np.float32)
    got = ssm._segsum(torch.from_numpy(a))
    want = np.asarray(j_ssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-5,
                               atol=1e-5)
    # exp after the mask: the masked entries carry a 0 gradient, not NaN
    t = torch.from_numpy(a).requires_grad_()
    g, = torch.autograd.grad(torch.exp(ssm._segsum(t)).sum(), [t])
    jg = jax.grad(lambda v: jnp.sum(jnp.exp(j_ssm._segsum(v))))(
        jnp.asarray(a))
    assert bool(torch.isfinite(g).all())
    # each entry sums up to 8 terms as large as 1e2 that cancel: relative
    assert _rel_l2(g.numpy(), jg) < 1e-5


def test_segsum_sums_each_segment_where_jax_subtracts_prefix_sums():
    """The one place the port computes differently from the JAX package:
    at a chunk of 256 with a mamba block's log-decays (Δt·A down to
    -16·softplus), JAX's prefix-sum difference loses |Σa|·2^-24 in each
    exponent; the port's segment sums stay near f32 rounding of the
    segment itself. Both against the exact sums in float64."""
    rng = np.random.default_rng(9)
    dt = np.log1p(np.exp(rng.standard_normal((4, 256))))
    A = -np.linspace(1.0, 16.0, 4)[:, None]
    a = (dt * A).astype(np.float32)
    exact = ssm._segsum(torch.from_numpy(a.astype(np.float64))).numpy()
    fin = np.isfinite(exact)
    port = ssm._segsum(torch.from_numpy(a)).numpy()
    jx = np.asarray(j_ssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isfinite(port), fin)
    # decay factors exp(S) that are not negligible (exp(S) > 1e-6)
    big = fin & (exact > np.log(1e-6))
    err_port = np.abs(np.exp(port[big]) - np.exp(exact[big])).max()
    err_jax = np.abs(np.exp(jx[big]) - np.exp(exact[big])).max()
    assert err_port < 1e-6 < err_jax
    assert err_jax < 1e-3        # small: at chunk 8 the parity holds 1e-5


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("L", [16, 13, 5])
def test_ssd_chunked_equals_jax(L, with_h0):
    """Lengths that divide the chunk (16), leave a padded tail (13) and
    are shorter than one chunk (5); from zero and from a given state."""
    rng = np.random.default_rng(L)
    x, a, Bm, Cm = _ssd_inputs(rng, L=L)
    h0 = (rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
          if with_h0 else None)
    jy, jh = j_ssm.ssd_chunked(jnp.asarray(x), jnp.asarray(a),
                               jnp.asarray(Bm), jnp.asarray(Cm), 8,
                               None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.ssd_chunked(torch.from_numpy(x), torch.from_numpy(a),
                             torch.from_numpy(Bm), torch.from_numpy(Cm), 8,
                             None if h0 is None else torch.from_numpy(h0))
    assert tuple(ty.shape) == jy.shape and th.dtype == torch.float32
    _close(ty, jy, 1e-5)
    _close(th, jh, 1e-5)


def test_ssd_chunked_gradients_equal_jax():
    rng = np.random.default_rng(5)
    x, a, Bm, Cm = _ssd_inputs(rng, L=13)
    w = rng.standard_normal((2, 13, 4, 8)).astype(np.float32)
    wh = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)

    def jloss(x, a, Bm, Cm):
        y, h = j_ssm.ssd_chunked(x, a, Bm, Cm, 8)
        return jnp.sum(y * w) + jnp.sum(h * wh)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (x, a, Bm, Cm)))
    ts = [torch.from_numpy(v).requires_grad_() for v in (x, a, Bm, Cm)]
    y, h = ssm.ssd_chunked(*ts, 8)
    loss = (y * torch.from_numpy(w)).sum() + (h * torch.from_numpy(wh)).sum()
    tg = torch.autograd.grad(loss, ts)
    for name, g, want in zip(("x", "a", "B", "C"), tg, jg):
        assert bool(torch.isfinite(g).all()), name
        assert _rel_l2(g.numpy(), want) < 1e-4, name


# ---------------------------------------------------------------------------
# the Mamba-2 block
# ---------------------------------------------------------------------------

def test_init_mamba_layout():
    jc, tc = _cfgs()
    jp, _ = _params(jc)
    p = ssm.init_mamba(torch.Generator().manual_seed(0), tc)
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)), p) == \
        jax.tree_util.tree_map(
            lambda a: (a.shape, "torch." + str(a.dtype)), jp)
    # log(linspace(1, 16, nh)): the libraries may differ in the last bit
    np.testing.assert_allclose(p["A_log"].numpy(), jp["A_log"], rtol=1e-6)


def test_causal_conv_equals_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    rng = np.random.default_rng(1)
    _, _, _, conv_ch = ssm._dims(tc)
    xbc = rng.standard_normal((2, 11, conv_ch)).astype(np.float32)
    b = rng.standard_normal(conv_ch).astype(np.float32)
    _close(ssm._causal_conv(torch.from_numpy(xbc), tp["conv_w"],
                            torch.from_numpy(b)),
           j_ssm._causal_conv(jnp.asarray(xbc), jp["conv_w"],
                              jnp.asarray(b)), 1e-5)


@pytest.mark.parametrize("L", [16, 11])
def test_mamba_train_equals_jax(L):
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = np.random.default_rng(L).standard_normal(
        (2, L, tc.d_model)).astype(np.float32)
    _close(ssm.mamba_train(tp, torch.from_numpy(x), tc),
           j_ssm.mamba_train(jp, jnp.asarray(x), jc), 1e-5)


def test_mamba_train_gradients_equal_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, tc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 13, tc.d_model)).astype(np.float32)
    jgp, jgx = jax.grad(
        lambda p, x: jnp.sum(j_ssm.mamba_train(p, x, jc) * w),
        argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, jp),
                        jnp.asarray(x))
    names = sorted(tp)          # the nested norm dict sorts as "norm"
    leaves = {k: (v.requires_grad_() if isinstance(v, torch.Tensor) else
                  {kk: vv.requires_grad_() for kk, vv in v.items()})
              for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    loss = (ssm.mamba_train(leaves, xt, tc) * torch.from_numpy(w)).sum()
    flat = [leaves[k] if k != "norm" else leaves[k]["scale"] for k in names]
    grads = torch.autograd.grad(loss, flat + [xt])
    for k, g in zip(names + ["x"], grads):
        want = (jgx if k == "x" else jgp[k]["scale"] if k == "norm"
                else jgp[k])
        assert bool(torch.isfinite(g).all()), k
        assert _rel_l2(g.numpy(), want) < 1e-4, k


def test_mamba_decode_steps_equal_jax_and_write_in_place():
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed=1)
    rng = np.random.default_rng(2)
    jcache = j_ssm.init_mamba_cache(jc, 3, jnp.float32)
    tcache = ssm.init_mamba_cache(tc, 3, torch.float32, torch.device("cpu"))
    conv, state = tcache["conv"], tcache["ssm"]
    for _ in range(6):
        x = rng.standard_normal((3, tc.d_model)).astype(np.float32)
        jy, jcache = j_ssm.mamba_decode(jp, jnp.asarray(x), jc, jcache)
        ty, tc2 = ssm.mamba_decode(tp, torch.from_numpy(x), tc, tcache)
        assert tc2 is tcache and tcache["conv"] is conv \
            and tcache["ssm"] is state
        _close(ty, jy, 1e-5)
        for k in ("conv", "ssm"):
            _close(tcache[k], jcache[k], 1e-5)


def test_prefill_state_equals_decode_state():
    """The chunked prefill's conv tail and final state, and decoding on
    from them, equal the token-by-token recurrence (SSD duality), in the
    port as in JAX: both at 1e-5, and against each other."""
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed=2)
    x = np.random.default_rng(4).standard_normal(
        (2, 14, tc.d_model)).astype(np.float32)
    cut = 11                                        # 8 + a padded tail
    ty, tcache = ssm.mamba_prefill(tp, torch.from_numpy(x[:, :cut]), tc)
    full = ssm.mamba_train(tp, torch.from_numpy(x), tc)
    _close(ty, full[:, :cut], 1e-5)
    rec = ssm.init_mamba_cache(tc, 2, torch.float32, torch.device("cpu"))
    for i in range(cut):
        y, rec = ssm.mamba_decode(tp, torch.from_numpy(x[:, i]), tc, rec)
        _close(y, full[:, i], 1e-5)
    for k in ("conv", "ssm"):
        _close(tcache[k], rec[k], 1e-5)
    for i in range(cut, 14):
        y, tcache = ssm.mamba_decode(tp, torch.from_numpy(x[:, i]), tc,
                                     tcache)
        _close(y, full[:, i], 1e-5)
    jfull = j_ssm.mamba_train(jp, jnp.asarray(x), jc)
    _close(full, jfull, 1e-5)


def test_block_prefill_keeps_the_jax_cache():
    """``blocks.block_prefill`` of an ``m-`` block: the output and the
    ``{conv, ssm}`` cache (the raw conv input's last 3 rows, the final
    SSD state) equal the JAX package's inline prefill."""
    from repro.models import blocks as j_blocks
    from repro_torch.models import blocks
    jc, tc = _cfgs()
    jp = jax.tree_util.tree_map(np.asarray, j_blocks.init_block(
        jax.random.PRNGKey(8), jc, "m-"))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(8).standard_normal(
        (2, 13, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    jy, jcache = j_blocks.block_prefill(jp, jnp.asarray(x), jc, "m-",
                                        jnp.asarray(pos), 16)
    ty, tcache = blocks.block_prefill(tp, torch.from_numpy(x), tc, "m-",
                                      torch.from_numpy(pos.copy()), 16)
    _close(ty, jy, 1e-5)
    assert sorted(tcache) == sorted(jcache) == ["conv", "ssm"]
    for k in ("conv", "ssm"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        _close(tcache[k], jcache[k], 1e-5)


def test_mamba_bf16_keeps_the_casts():
    jc, tc = _cfgs(dtype="bfloat16", param_dtype="bfloat16")
    jp = j_ssm.init_mamba(jax.random.PRNGKey(6), jc)
    from repro_torch import convert
    tp = convert._tree_tensors(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tp["in_proj"].dtype == torch.bfloat16
    assert tp["A_log"].dtype == torch.float32
    x = np.random.default_rng(6).standard_normal(
        (2, 13, tc.d_model)).astype(np.float32)
    got = ssm.mamba_train(tp, torch.from_numpy(x).to(torch.bfloat16), tc)
    want = j_ssm.mamba_train(jp, jnp.asarray(x, jnp.bfloat16), jc)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got.float().numpy(), np.asarray(want, np.float32)) < 2e-2
