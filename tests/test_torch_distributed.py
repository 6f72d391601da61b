"""Port pod axis (``repro_torch.optim.compression``,
``repro_torch.distributed.collectives``, ``repro_torch.launch.mesh`` and
``launch.steps.make_train_step(mesh=..., compress_crosspod=True)``)
against the JAX package's on the CPU.

* Compression: ``compress_int8`` / ``decompress_int8`` bit for bit (both
  round half to even), top-k on distinct magnitudes, error feedback.
* Collectives on two ranks: two processes of the port joined by a gloo
  process group (a ``FileStore`` under ``tmp_path``, no TCP port), each
  holding its pod's values, against JAX's ``psum_int8`` / ``pmean`` under
  ``jax.vmap(axis_name="pod")`` on the same values: bit for bit.
* The compressed train step on two ranks (a ``(2, 1, 1)`` mesh over
  ``("pod", "data", "model")``): reduced qwen1.5-0.5b, f32, 3 steps of a
  global batch of 4, against JAX's ``make_train_step(mesh=(2, 1, 1),
  compress_crosspod=True)`` on two host devices in a subprocess. The
  losses within ``rtol 1e-5``; every parameter element within the 3
  steps' bound ``3·2·lr`` of JAX's, and all but 1e-3 of the elements
  within ``1e-2·lr``. The few beyond: an element whose int8 gradient code
  differs between the packages (a gradient within f32 noise of a rounding
  boundary k + 1/2 of the shared scale, so its Adam step moves it by up
  to ``lr`` more or less), or whose gradient is near Adam's eps (1 and
  11 of 297,024 elements on two ranks and on one).
* The uncompressed step on the same two ranks (an f32 gradient mean)
  against JAX's plain step on the global batch, with the same tolerance,
  and ``TrainLoop(mesh=..., compress=True)`` there bit-equal to the
  compressed steps.
* One rank, in this process: the same step on a ``(1, 1, 1)`` mesh
  against JAX's on its one device, the uncompressed one against the
  plain step.
* Reduced seamless-m4t-medium on the two ranks' ``(1, 2, 1)`` mesh (the
  data axis over both): the compressed step against JAX's on two host
  devices and against the port's uncompressed step.

Spawned ranks and the JAX subprocess are started together and joined by
one ``JOIN_S`` deadline from the fixture's start; every one still running
is killed.
"""
import contextlib
import os
import pickle
import subprocess
import sys
import textwrap
import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro.compat import make_mesh as j_make_mesh
from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.distributed.collectives import psum_int8 as j_psum_int8
from repro.launch import steps as j_steps
from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro_torch import convert
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.distributed import collectives
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.optim import adamw, compression

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCH = "qwen1.5-0.5b"
LR = 1e-3
STEPS = 3
# One deadline for every process a fixture starts, counted from the
# fixture's start, and the ranks' gloo timeout: over 3x the slowest
# world fixture seen (276 s, the gloo test modules run together on 6
# xdist workers over 8 cores).
JOIN_S = 900


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """The leaves of a port or JAX tree as f64 numpy, in JAX's order."""
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                       np.float64) for _, x in tree_flatten_with_path(tree)]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 1000), scale=st.floats(1e-3, 1e3))
def test_property_int8_codes_and_scale_equal_jax(seed, scale):
    """The counterpart of the JAX package's round-trip property: the int8
    codes, the scale and the round trip equal JAX's bit for bit, and the
    error stays within half a quantization step, stated in f32: the
    decoded value ``q·scale`` is rounded once more in f32, so the bound
    is ``0.5·scale`` plus one ulp of ``max|x|``."""
    x = np.random.default_rng(seed).normal(0, scale, 257).astype(np.float32)
    jq, js = j_comp.compress_int8(jnp.asarray(x))
    tq, ts = compression.compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    y = compression.decompress_int8(tq, ts)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(j_comp.decompress_int8(jq, js)))
    bound = float(ts) * 0.5 + float(np.spacing(np.abs(x).max()))
    assert float((torch.from_numpy(x) - y).abs().max()) <= bound


@pytest.mark.parametrize("scale", [1e-3, 77.7, 1e3])
def test_int8_roundtrip_error_at_seed_759(scale):
    """A fixed draw where the f32 rounding of ``q·scale`` shows: the
    round-trip error exceeds ``0.5·scale`` and stays within ``0.5·scale``
    plus one ulp of ``max|x|``; the codes still equal JAX's."""
    x = np.random.default_rng(759).normal(0, scale, 257).astype(np.float32)
    jq, js = j_comp.compress_int8(jnp.asarray(x))
    tq, ts = compression.compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    err = float((torch.from_numpy(x)
                 - compression.decompress_int8(tq, ts)).abs().max())
    assert err > float(ts) * 0.5
    assert err <= float(ts) * 0.5 + float(np.spacing(np.abs(x).max()))


def test_int8_of_zeros_takes_the_floor_scale():
    q, s = compression.compress_int8(torch.zeros(5))
    jq, js = j_comp.compress_int8(jnp.zeros(5))
    assert float(s) == float(js) == np.float32(1e-12)
    assert not q.any() and not np.asarray(jq).any()


@pytest.mark.parametrize("k_frac", [0.01, 0.1, 0.5, 1.0])
def test_topk_matches_jax_on_distinct_magnitudes(k_frac):
    """Distinct magnitudes (a permutation of distinct values, random
    signs), so the kept set and its order are defined."""
    rng = np.random.default_rng(int(k_frac * 100))
    mags = rng.permutation(np.arange(1, 301, dtype=np.float32)) / 7.0
    x = (mags * rng.choice([-1.0, 1.0], 300)).astype(np.float32)
    x = x.reshape(12, 25)
    jv, ji, jshape = j_comp.compress_topk(jnp.asarray(x), k_frac)
    tv, ti, tshape = compression.compress_topk(torch.from_numpy(x), k_frac)
    assert tshape == tuple(jshape) == (12, 25)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        compression.decompress_topk(tv, ti, tshape).numpy(),
        np.asarray(j_comp.decompress_topk(jv, ji, jshape)))


def test_error_feedback_matches_jax():
    """``ErrorFeedback.init`` zeros each leaf in f32; 50 error-feedback
    round trips give JAX's applied gradients and residuals bit for bit,
    and the applied sum tracks the true sum within the last residual."""
    params = {"a": torch.ones((3, 4), dtype=torch.bfloat16),
              "b": (torch.ones(5),)}
    ef = compression.ErrorFeedback.init(params)
    assert all(t.dtype == torch.float32 and not t.any()
               for t in (ef.residual["a"], ef.residual["b"][0]))
    assert ef.residual["a"].shape == (3, 4)
    rng = np.random.default_rng(0)
    res, jres = torch.zeros(32), jnp.zeros(32, jnp.float32)
    true_sum = applied_sum = np.zeros(32, np.float64)
    for _ in range(50):
        g = (rng.normal(0, 1, 32) * 1e-4).astype(np.float32)
        applied, res = compression.ef_int8_roundtrip(torch.from_numpy(g),
                                                     res)
        japplied, jres = j_comp.ef_int8_roundtrip(jnp.asarray(g), jres)
        np.testing.assert_array_equal(applied.numpy(), np.asarray(japplied))
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
        true_sum = true_sum + g
        applied_sum = applied_sum + applied.numpy()
    assert np.abs(true_sum - applied_sum).max() <= (
        np.abs(res.numpy()).max() + 1e-6)


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo process group from a FileStore, destroyed after
    the test."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=timedelta(seconds=JOIN_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_need_an_initialised_group_of_their_size(tmp_path):
    """No group: every mesh raises, naming init_process_group, and sets
    none up. A one-rank group: the local mesh is (1, 1) over ("data",
    "model"); a mesh of another size raises."""
    assert not dist.is_initialized()
    for call in (lambda: tmesh.make_local_mesh(device_type="cpu"),
                 lambda: tmesh.make_production_mesh(device_type="cpu"),
                 lambda: tmesh.make_mesh((1, 1, 1), ("pod", "data",
                                                     "model"),
                                         device_type="cpu")):
        with pytest.raises(RuntimeError, match="init_process_group"):
            call()
    assert not dist.is_initialized()
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        m = tmesh.make_local_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (1, 1) and m.device_type == "cpu"
        with pytest.raises(ValueError, match="holds 512 ranks"):
            tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        with pytest.raises(ValueError, match="holds 2 ranks"):
            tmesh.make_mesh((2, 1, 1), ("pod", "data", "model"),
                            device_type="cpu")
    finally:
        dist.destroy_process_group()


def _jax_model():
    jc = j_reduced(j_get_config(ARCH))
    tc = reduced(get_config(ARCH))
    jp = _np(j_steps.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, tc.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    return jc, tc, jp, batch


def _jax_steps(jc, jp, batch, mesh):
    """JAX's compressed step on ``mesh``, or its plain step where
    ``mesh`` is None: (losses, params after each step)."""
    ocfg = j_adamw.AdamWConfig(lr=LR, warmup_steps=0)
    step = jax.jit(j_steps.make_train_step(jc, ocfg, mesh=mesh,
                                           compress_crosspod=True))
    p = jax.tree_util.tree_map(jnp.asarray, jp)
    s = j_adamw.adamw_init(p, ocfg)
    losses, params = [], []
    with mesh if mesh is not None else contextlib.nullcontext():
        for _ in range(STEPS):
            p, s, m = step(p, s, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
            losses.append(float(m["loss"]))
            params.append(_flat(p))
    return losses, params


def _hold_steps(losses, params, jlosses, jparams):
    """The compressed steps against JAX's (see the module docstring)."""
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    flips = total = 0
    for got, want in zip(params, jparams):
        for a, b in zip(got, want):
            d = np.abs(a - b)
            assert d.max() <= STEPS * 2 * LR
            flips += int((d > 1e-2 * LR).sum())
            total += d.size
    assert flips <= 1e-3 * total, (flips, total)


def test_compressed_step_on_one_rank_matches_jax(one_rank):
    """One pod: ``psum_int8`` is the int8 round trip (not the identity),
    so the step applies AdamW to the round-tripped gradients; 3 steps
    against JAX's step on a (1, 1, 1) mesh of its one device. Also a mesh
    without a ``pod`` axis leaves ``compress_crosspod`` the plain step and
    ``crosspod_grad_mean`` the gradients as they are."""
    jc, tc, jp, batch = _jax_model()
    jlosses, jparams = _jax_steps(jc, jp, batch,
                                  j_make_mesh((1, 1, 1),
                                              ("pod", "data", "model")))
    mesh = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"),
                           device_type="cpu")
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=0)
    step = steps.make_train_step(tc, ocfg, mesh=mesh, compress_crosspod=True)
    p = convert.lm_params(jp, tc, "cpu")
    s = adamw.adamw_init(p, ocfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, params = [], []
    for _ in range(STEPS):
        p, s, m = step(p, s, tb)
        losses.append(float(m["loss"]))
        params.append(_flat(p))
    _hold_steps(losses, params, jlosses, jparams)

    # the round trip is not the identity: the step differs from the plain
    _, _, g = steps._value_and_grad(convert.lm_params(jp, tc, "cpu"), tc,
                                    tb)
    gc = collectives.crosspod_grad_mean(g, mesh, compress=True)
    gf = collectives.crosspod_grad_mean(g, mesh, compress=False)
    moved = 0
    for (_, a), (_, b), (_, c) in zip(tree_flatten_with_path(gc),
                                      tree_flatten_with_path(gf),
                                      tree_flatten_with_path(g)):
        assert torch.equal(b, c)
        bound = float(c.abs().max()) / 127.0 * 0.5
        assert float((a - c).abs().max()) <= bound * (1 + 1e-6)
        moved += int((a != c).sum())
    assert moved > 0

    plain = steps.make_train_step(tc, ocfg)
    flat = tmesh.make_local_mesh(device_type="cpu")      # no pod axis
    no_pod = steps.make_train_step(tc, ocfg, mesh=flat,
                                   compress_crosspod=True)
    p0 = convert.lm_params(jp, tc, "cpu")
    a = _flat(no_pod(p0, adamw.adamw_init(p0, ocfg), tb)[0])
    b = _flat(plain(p0, adamw.adamw_init(p0, ocfg), tb)[0])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert collectives.crosspod_grad_mean(g, flat, compress=True) is g


def test_uncompressed_step_on_one_pod_is_the_plain_step(one_rank):
    """``compress_crosspod=False`` on a (1, 1, 1) mesh takes the pod
    branch with the f32 mean over one rank: 3 steps bit-equal to the
    meshless plain step."""
    _, tc, jp, batch = _jax_model()
    mesh = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"),
                           device_type="cpu")
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = []
    for m in (mesh, None):
        step = steps.make_train_step(tc, ocfg, mesh=m)
        p = convert.lm_params(jp, tc, "cpu")
        s = adamw.adamw_init(p, ocfg)
        out = []
        for _ in range(STEPS):
            p, s, met = step(p, s, tb)
            out.append((float(met["loss"]), _flat(p)))
        runs.append(out)
    for (la, pa), (lb, pb) in zip(*runs):
        assert la == lb
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

RANK = textwrap.dedent("""
    import pickle, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import convert
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import mesh as tmesh, steps
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim import adamw

    rank, store_path, inp, out = (int(sys.argv[1]), sys.argv[2],
                                  sys.argv[3], sys.argv[4])
    with open(inp, "rb") as f:
        d = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=JOIN_S))
    res = {}
    try:
        pod = tmesh.make_mesh((2,), ("pod",), device_type="cpu")
        res["psum"] = collectives.psum_int8(
            torch.from_numpy(d["x"][rank]), pod.get_group("pod")).numpy()
        grads = {k: torch.from_numpy(v[rank]) for k, v in d["g"].items()}
        for c in (False, True):
            r = collectives.crosspod_grad_mean(grads, pod, compress=c)
            res[f"mean_{c}"] = {k: v.numpy() for k, v in r.items()}
        cfg = reduced(get_config(d["arch"]))
        mesh = tmesh.make_mesh((2, 1, 1), ("pod", "data", "model"),
                               device_type="cpu")
        ocfg = adamw.AdamWConfig(lr=d["lr"], warmup_steps=0)
        batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}
        for c in (True, False):
            step = steps.make_train_step(cfg, ocfg, mesh=mesh,
                                         compress_crosspod=c)
            p = convert.lm_params(d["params"], cfg, "cpu")
            s = adamw.adamw_init(p, ocfg)
            losses, params = [], []
            for _ in range(d["steps"]):
                p, s, m = step(p, s, batch)
                losses.append(float(m["loss"]))
                params.append([t.numpy().astype(np.float64)
                               for _, t in tree_flatten_with_path(p)])
            res[f"losses_{c}"], res[f"params_{c}"] = losses, params
        loop = TrainLoop(cfg, opt_cfg=ocfg, mesh=mesh, compress=True,
                         device="cpu")
        loop.params = convert.lm_params(d["params"], cfg, "cpu")
        loop.opt_state = adamw.adamw_init(loop.params, ocfg)
        ran = loop.run(iter([d["batch"]] * d["steps"]), steps=d["steps"],
                       log_every=0)
        res["loop_losses"] = [h["loss"] for h in ran["history"]]
        res["loop_params"] = [t.numpy().astype(np.float64)
                              for _, t in tree_flatten_with_path(loop.params)]
        # reduced seamless on a (1, 2, 1) mesh: its data axis shards the
        # batch over the two ranks, and the one pod's int8 reduce is the
        # round trip of every gradient
        wide = tmesh.make_mesh((1, 2, 1), ("pod", "data", "model"),
                               device_type="cpu")
        scfg = reduced(get_config("seamless-m4t-medium"))
        sp = convert.lm_params(d["seamless_params"], scfg, "cpu")
        sb = {k: torch.from_numpy(v) for k, v in d["seamless"].items()}
        for c in (False, True):
            step = steps.make_train_step(scfg, ocfg, mesh=wide,
                                         compress_crosspod=c)
            p = sharding.distribute(sp, wide, sharding.param_specs(sp, wide))
            s = adamw.adamw_init(p, ocfg)
            losses, params = [], []
            for _ in range(d["steps"]):
                p, s, m = step(p, s, sb)
                losses.append(float(m["loss"]))
                params.append([t.full_tensor().numpy().astype(np.float64)
                               for _, t in tree_flatten_with_path(p)])
            res[f"wide_{c}"] = (losses, params)
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
""").replace("JOIN_S", str(JOIN_S))

JAX_STEP = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
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
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"))
    ocfg = AdamWConfig(lr=d["lr"], warmup_steps=0)
    step = jax.jit(make_train_step(cfg, ocfg, mesh=mesh,
                                   compress_crosspod=True))
    p = jax.tree_util.tree_map(jnp.asarray, d["params"])
    s = adamw_init(p, ocfg)
    batch = {k: jnp.asarray(v) for k, v in d["batch"].items()}
    res = {"losses": [], "params": []}
    with mesh:
        for _ in range(d["steps"]):
            p, s, m = step(p, s, batch)
            res["losses"].append(float(m["loss"]))
            res["params"].append([np.asarray(x, np.float64)
                                  for x in jax.tree_util.tree_leaves(p)])
    # reduced seamless, compressed, on (1, 2, 1)
    scfg = reduced(get_config("seamless-m4t-medium"))
    wide = make_mesh((1, 2, 1), ("pod", "data", "model"))
    step = jax.jit(make_train_step(scfg, ocfg, mesh=wide,
                                   compress_crosspod=True))
    p = jax.tree_util.tree_map(jnp.asarray, d["seamless_params"])
    s = adamw_init(p, ocfg)
    batch = {k: jnp.asarray(v) for k, v in d["seamless"].items()}
    res["wide"] = ([], [])
    with wide:
        for _ in range(d["steps"]):
            p, s, m = step(p, s, batch)
            res["wide"][0].append(float(m["loss"]))
            res["wide"][1].append([np.asarray(x, np.float64)
                                   for x in jax.tree_util.tree_leaves(p)])
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
def two_ranks(tmp_path_factory):
    """Two port ranks and JAX's two-device step, run together once for
    the module: (the inputs, the ranks' results, JAX's step results)."""
    start = time.monotonic()
    tmp = tmp_path_factory.mktemp("pods")
    rng = np.random.default_rng(7)
    _, _, jp, batch = _jax_model()
    d = {"arch": ARCH, "lr": LR, "steps": STEPS, "params": jp,
         "batch": batch,
         "x": rng.normal(0, 3.0, (2, 1000)).astype(np.float32),
         "g": {"w": rng.normal(0, 1e-2, (2, 64, 48)).astype(np.float32),
               "b": rng.normal(0, 5.0, (2, 48)).astype(np.float32),
               "z": np.zeros((2, 7), np.float32)}}
    d["x"][1, :4] = [0.0, 2.5, -7.5, 1e-9]
    d["seamless_params"] = _np(j_steps.init_params(
        jax.random.PRNGKey(2), j_reduced(j_get_config("seamless-m4t-medium"))))
    d["seamless"] = dict(
        enc_embeds=rng.standard_normal((4, 8, 64)).astype(np.float32),
        **{k: rng.integers(0, 256, (4, 6)).astype(np.int32)
           for k in ("tokens", "targets")})
    inp = tmp / "in.pkl"
    inp.write_bytes(pickle.dumps(d))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    (tmp / "rank.py").write_text(RANK)
    (tmp / "jax_step.py").write_text(JAX_STEP)
    procs = [(f"rank {r}", subprocess.Popen(
        [sys.executable, str(tmp / "rank.py"), str(r), str(tmp / "store"),
         str(inp), str(tmp / f"out{r}.pkl")], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)) for r in (0, 1)]
    procs.append(("jax", subprocess.Popen(
        [sys.executable, str(tmp / "jax_step.py"), str(inp),
         str(tmp / "jax.pkl")], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    _run_all(procs, start)
    ranks = [pickle.loads((tmp / f"out{r}.pkl").read_bytes())
             for r in (0, 1)]
    return d, ranks, pickle.loads((tmp / "jax.pkl").read_bytes())


def test_psum_int8_on_two_ranks_equals_jax(two_ranks):
    """Each rank's ``psum_int8`` of its values over a gloo ("pod",) group
    equals JAX's ``psum_int8`` under ``jax.vmap(axis_name="pod")`` of the
    same two rows, bit for bit, on both ranks."""
    d, ranks, _ = two_ranks
    want = np.asarray(jax.vmap(lambda a: j_psum_int8(a, "pod"),
                               axis_name="pod")(jnp.asarray(d["x"])))
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["psum"], want[r])


@pytest.mark.parametrize("compress", [False, True])
def test_crosspod_grad_mean_on_two_ranks_equals_jax(two_ranks, compress):
    """``crosspod_grad_mean`` of each rank's gradients: with ``compress``
    JAX's per-leaf ``psum_int8 / 2``, without it JAX's ``pmean``, under
    ``jax.vmap(axis_name="pod")``; bit for bit (a zero leaf included)."""
    d, ranks, _ = two_ranks
    if compress:
        fn = lambda a: j_psum_int8(a, "pod") / 2
    else:
        fn = lambda a: jax.lax.pmean(a, "pod")
    for k, v in d["g"].items():
        want = np.asarray(jax.vmap(fn, axis_name="pod")(jnp.asarray(v)))
        for r in (0, 1):
            np.testing.assert_array_equal(ranks[r][f"mean_{compress}"][k],
                                          want[r], err_msg=k)


def test_compressed_step_on_two_ranks_matches_jax(two_ranks):
    """3 compressed steps, each rank on its half of the batch, against
    JAX's step on two host devices (tolerance in the module docstring);
    both ranks end every step with the same parameters."""
    _, ranks, jres = two_ranks
    for a, b in zip(ranks[0]["params_True"], ranks[1]["params_True"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert ranks[0]["losses_True"] == ranks[1]["losses_True"]
    _hold_steps(ranks[0]["losses_True"], ranks[0]["params_True"],
                jres["losses"], jres["params"])


def test_uncompressed_step_on_two_ranks_matches_jax_plain_step(two_ranks):
    """``compress_crosspod=False`` on the (2, 1, 1) mesh is data parallel
    too: each rank on its half of the batch, the gradients averaged by an
    f32 all-reduce. 3 steps against JAX's plain step on the global batch
    (every row holds as many targets, so the mean of the two halves' mean
    losses is the global mean); the tolerance of the module docstring
    (f32 summation order only, so no int8 code to flip; the elements
    beyond 1e-2·lr have gradients near Adam's eps). Both ranks agree."""
    d, ranks, _ = two_ranks
    for a, b in zip(ranks[0]["params_False"], ranks[1]["params_False"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert ranks[0]["losses_False"] == ranks[1]["losses_False"]
    jlosses, jparams = _jax_steps(j_reduced(j_get_config(ARCH)),
                                  d["params"], d["batch"], None)
    _hold_steps(ranks[0]["losses_False"], ranks[0]["params_False"],
                jlosses, jparams)


def test_train_loop_on_a_pod_mesh_runs_the_compressed_step(two_ranks):
    """``TrainLoop(mesh=..., compress=True)`` on the two-rank mesh, from
    the same parameters and batches: its losses and final parameters are
    the ``make_train_step`` ones bit for bit, on both ranks."""
    _, ranks, _ = two_ranks
    for r in (0, 1):
        assert ranks[r]["loop_losses"] == ranks[r]["losses_True"]
        for x, y in zip(ranks[r]["loop_params"], ranks[r]["params_True"][-1]):
            np.testing.assert_array_equal(x, y)


def test_compressed_seamless_step_on_a_wide_mesh(two_ranks):
    """Reduced seamless-m4t-medium on the two ranks' (1, 2, 1) mesh (its
    ``data`` axis over both): the compressed step runs on the ``(data,
    model)`` submesh and reduces over the one pod with the int8 round
    trip, both ranks alike. Against JAX's compressed step on the same
    mesh of two host devices, with the module's tolerance; against the
    port's uncompressed step on the mesh: the first loss equal (the
    reduce comes after it), every element within the 3 steps' bound
    ``3·2·lr``, and some element moved by the round trip (an element
    whose gradient is below the int8 step moves by up to ``lr`` more or
    less, so the later losses part by the int8 error, not by 1e-5)."""
    _, ranks, jres = two_ranks
    (lu, pu), (lc, pc) = ranks[0]["wide_False"], ranks[0]["wide_True"]
    assert ranks[1]["wide_True"][0] == lc
    for a, b in zip(ranks[1]["wide_True"][1], pc):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    _hold_steps(lc, pc, *jres["wide"])
    assert lc[0] == lu[0]
    moved = 0
    for got, want in zip(pc, pu):
        for a, b in zip(got, want):
            assert np.abs(a - b).max() <= STEPS * 2 * LR
            moved += int((a != b).sum())
    assert moved
