"""Port MoE layer (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the same numpy inputs, on the CPU.

Parameters are drawn by the JAX package (``init_moe``) and carried across
as numpy; activations are drawn with numpy from a seed. Configs are the
reduced granite-moe-3b-a800m and mixtral-8x22b (f32, d 64, 4 experts,
top-2).

Tolerances (f32): outputs, ``moe_aux`` and ``moe_zloss`` 1e-5 (another
summation order in each product); the chosen experts, the capacity and
``moe_drop_frac`` exact; gradients within 1e-4 relative L2 (the model
tier's gradient tolerance). bf16 outputs within 2e-2 relative L2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import moe as j_moe
from repro_torch.configs.base import MoEConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import moe
from repro_torch.models.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b")


def _cfgs(arch, moe_changes=None, **changes):
    jc = j_reduced(j_get_config(arch))
    tc = reduced(get_config(arch))
    if moe_changes:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                             **moe_changes))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             **moe_changes))
    return (dataclasses.replace(jc, **changes),
            dataclasses.replace(tc, **changes))


def _params(jc, seed=0):
    jp = jax.tree_util.tree_map(np.asarray,
                                j_moe.init_moe(jax.random.PRNGKey(seed), jc))
    return jp, tree_map(lambda a: torch.from_numpy(np.array(a)), jp)


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float(), np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_experts(jp, xf, k):
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(jp["router"]), -1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
def test_expert_capacity_equals_jax_and_is_flop_honest(cf):
    for E, K in ((8, 2), (40, 8), (16, 2), (4, 2)):
        kw = dict(num_experts=E, top_k=K, d_ff_expert=64, capacity_factor=cf)
        for n in (1, 7, 8, 100, 1024, 4096, 8192):
            cap = moe.expert_capacity(n, MoEConfig(**kw))
            assert cap == j_moe.expert_capacity(n, JMoEConfig(**kw))
            assert cap % 8 == 0 and cap >= 8
            assert cap >= n * K * cf / E
        # the slab is the active experts' work, far below all of T
        assert moe.expert_capacity(1024, MoEConfig(**kw)) <= 1024


def test_init_moe_layout():
    jc, tc = _cfgs("granite-moe-3b-a800m", {"num_shared": 1})
    jp, _ = _params(jc)
    p = moe.init_moe(torch.Generator().manual_seed(0), tc)
    assert tree_map(lambda t: tuple(t.shape), p) == \
        jax.tree_util.tree_map(lambda a: a.shape, jp)
    E, d, ff = tc.moe.num_experts, tc.d_model, tc.moe.d_ff_expert
    assert tuple(p["experts"]["wi"].shape) == (E, d, ff)
    assert tuple(p["shared"]["wo"].shape) == (1, ff, d)
    # each expert drawn on its own
    assert not torch.equal(p["experts"]["wi"][0], p["experts"]["wi"][1])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_equals_jax(arch, groups):
    jc, tc = _cfgs(arch, moe_groups=groups)
    jp, tp = _params(jc, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (4, 16, tc.d_model)).astype(np.float32)
    jy, jm = j_moe.apply_moe(jp, jnp.asarray(x), jc)
    ty, tm = moe.apply_moe(tp, torch.from_numpy(x), tc)
    _close(ty, jy, 1e-5)
    for k in ("moe_aux", "moe_zloss"):
        _close(tm[k], jm[k], 1e-5)
    assert float(tm["moe_drop_frac"]) == float(jm["moe_drop_frac"])
    xf = x.reshape(-1, tc.d_model)
    _, _, _, eidx = moe.route(tp["router"], torch.from_numpy(xf),
                              tc.moe.top_k)
    np.testing.assert_array_equal(eidx.numpy(),
                                  _jax_experts(jp, xf, tc.moe.top_k))


@pytest.mark.parametrize("groups", [1, 4])
def test_overflow_is_dropped_as_in_jax(groups):
    """A capacity factor of 0.25 drops a good share of the assignments:
    which ones (the stable sort's order) shows in every output row."""
    jc, tc = _cfgs("mixtral-8x22b", {"capacity_factor": 0.25},
                   moe_groups=groups)
    jp, tp = _params(jc, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (4, 32, tc.d_model)).astype(np.float32)
    jy, jm = j_moe.apply_moe(jp, jnp.asarray(x), jc)
    ty, tm = moe.apply_moe(tp, torch.from_numpy(x), tc)
    drop = float(tm["moe_drop_frac"])
    assert drop == float(jm["moe_drop_frac"]) and drop > 0.2
    _close(ty, jy, 1e-5)


def test_groups_that_do_not_divide_fall_back_to_one():
    jc, tc = _cfgs("mixtral-8x22b", {"capacity_factor": 64.0})
    _, tp = _params(jc, seed=5)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 16, tc.d_model)).astype(np.float32))
    y1, m1 = moe.apply_moe(tp, x, tc)
    y4, m4 = moe.apply_moe(tp, x, dataclasses.replace(tc, moe_groups=4))
    y7, _ = moe.apply_moe(tp, x, dataclasses.replace(tc, moe_groups=7))
    assert float(m1["moe_drop_frac"]) == float(m4["moe_drop_frac"]) == 0.0
    torch.testing.assert_close(y1, y4, rtol=0, atol=0)
    torch.testing.assert_close(y1, y7, rtol=0, atol=0)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "geglu"])
def test_shared_experts_and_activations_equal_jax(act):
    jc, tc = _cfgs("granite-moe-3b-a800m", {"num_shared": 2}, act=act)
    jp, tp = _params(jc, seed=6)
    x = np.random.default_rng(6).standard_normal(
        (2, 8, tc.d_model)).astype(np.float32)
    jy, _ = j_moe.apply_moe(jp, jnp.asarray(x), jc)
    ty, _ = moe.apply_moe(tp, torch.from_numpy(x), tc)
    _close(ty, jy, 1e-5)


def test_an_idle_slot_takes_capacity_at_decode():
    """Decode hands every slot's token to the MoE as one (B, 1, d) call.
    Eleven idle slots holding one token fill both of their experts'
    capacity (8) before the active slot 11, whose nearby token chooses
    the same two experts: its assignments are dropped, in the port as in
    JAX. Alone, the same token is not dropped."""
    jc, tc = _cfgs("mixtral-8x22b")
    jp, tp = _params(jc, seed=7)
    rng = np.random.default_rng(7)
    idle = rng.standard_normal(tc.d_model).astype(np.float32)
    x = np.repeat(idle[None, None, :], 12, axis=0)
    x[11, 0] += 1e-3 * rng.standard_normal(tc.d_model).astype(np.float32)
    xf = x.reshape(12, tc.d_model)
    experts = _jax_experts(jp, xf, 2)
    assert (experts == experts[0]).all()           # one pair of experts
    assert moe.expert_capacity(12, tc.moe) == 8
    jy, jm = j_moe.apply_moe(jp, jnp.asarray(x), jc)
    ty, tm = moe.apply_moe(tp, torch.from_numpy(x), tc)
    _close(ty, jy, 1e-5)
    assert float(tm["moe_drop_frac"]) == float(jm["moe_drop_frac"]) \
        == float(np.float32(8) / np.float32(24))
    assert float(ty[11].abs().max()) == 0.0        # dropped: residual only
    alone, m1 = moe.apply_moe(tp, torch.from_numpy(x[11:]), tc)
    jalone, _ = j_moe.apply_moe(jp, jnp.asarray(x[11:]), jc)
    assert float(m1["moe_drop_frac"]) == 0.0
    assert float(alone.abs().max()) > 0.0
    _close(alone, jalone, 1e-5)


def test_combine_is_deterministic():
    jc, tc = _cfgs("granite-moe-3b-a800m")
    _, tp = _params(jc, seed=8)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 16, tc.d_model)).astype(np.float32))
    a, _ = moe.apply_moe(tp, x, tc)
    b, _ = moe.apply_moe(tp, x, tc)
    assert torch.equal(a, b)


def test_bf16_apply_moe_close_to_jax():
    jc, tc = _cfgs("granite-moe-3b-a800m", dtype="bfloat16",
                   param_dtype="bfloat16")
    jp = j_moe.init_moe(jax.random.PRNGKey(9), jc)
    from repro_torch import convert
    tp = convert._tree_tensors(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(9).standard_normal(
        (2, 16, tc.d_model)).astype(np.float32)
    jy, _ = j_moe.apply_moe(jp, jnp.asarray(x, jnp.bfloat16), jc)
    ty, _ = moe.apply_moe(tp, torch.from_numpy(x).to(torch.bfloat16), tc)
    assert ty.dtype == torch.bfloat16
    assert _rel_l2(ty.float().numpy(), np.asarray(jy, np.float32)) < 2e-2


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 4])
def test_apply_moe_gradients_equal_jax(groups):
    """Gradients of a weighted sum of the output and the aux losses, with
    a capacity that drops assignments (their rows get no gradient)."""
    jc, tc = _cfgs("granite-moe-3b-a800m", {"capacity_factor": 0.5,
                                            "num_shared": 1},
                   moe_groups=groups)
    jp, tp = _params(jc, seed=10)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 32, tc.d_model)).astype(np.float32)
    w = rng.standard_normal((4, 32, tc.d_model)).astype(np.float32)

    def jloss(p, x):
        y, m = j_moe.apply_moe(p, x, jc)
        return jnp.sum(y * w) + 3.0 * m["moe_aux"] + 0.5 * m["moe_zloss"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    leaves = tree_map(lambda t: t.requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    y, m = moe.apply_moe(leaves, xt, tc)
    assert float(m["moe_drop_frac"]) > 0
    loss = ((y * torch.from_numpy(w)).sum() + 3.0 * m["moe_aux"]
            + 0.5 * m["moe_zloss"])
    grads = torch.autograd.grad(loss, tree_leaves(leaves) + [xt])
    names = [f"{k}/{kk}" if isinstance(v, dict) else k
             for k, v in leaves.items()
             for kk in (v if isinstance(v, dict) else [None])] + ["x"]
    named = dict(zip(names, grads))
    assert len(named) == len(grads) == 8
    for name, g in named.items():
        if name == "x":
            want = jgx
        elif name == "router":
            want = jgp["router"]
        else:
            group, k = name.split("/")
            want = jgp[group][k]
        assert bool(torch.isfinite(g).all()), name
        assert _rel_l2(g.numpy(), want) < 1e-4, name
