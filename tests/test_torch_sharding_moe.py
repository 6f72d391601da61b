"""MoE's dispatch and expert parallelism on a wide mesh
(``repro_torch.models.moe`` on DTensors, ``launch.steps`` with ``e``
blocks) against the JAX package's meshless step and the port's, on the
CPU.

Gloo worlds of 4 ranks, one per mesh shape, ``(2, 2)``, ``(4, 1)`` and
``(1, 4)`` over ``("data", "model")``, started together with one JAX
reference process in a module fixture (ranks joined by a ``FileStore``
under ``tmp_path``, all joined by one ``JOIN_S`` deadline from the
fixture's start). The
``(2, 2)`` world, the card's layout, registers ``distributed/gloo_cuda.py``'s
collectives for the CPU, so its exchanges run through the implementations
the card's gloo worlds use; the ``(4, 1)`` world runs gloo's own.

Configs: reduced granite-moe-3b-a800m (f32, d 64, 4 experts, top-2,
expert ff 128), so EP on every world whose data axis has several ranks,
and the same with 3 experts (the non-EP layout on ``(2, 2)`` and
``(4, 1)``). Each at ``moe_groups`` 0 (one group: the token stream
gathered) and D, the data axis's size (local groups, the all-to-all
exchange under EP), over 3 train steps from JAX's parameters: losses,
gradient norms, ``moe_aux`` and ``moe_zloss`` within 1e-5 relative,
parameters within 1e-4 relative L2; each layer's ``moe_drop_frac``
exactly the meshless port's. E=4 also at ``remat='dots'`` (the
backward recomputing the routing and the collectives). Also: every
carried leaf keeps its
placements; an EP expert leaf reaches ``_expert_ffn`` still sharded on
the expert dim (E/D experts a rank); the decode bundle's greedy tokens
equal ``ModelServer``'s; a batch of 3 on ``(2, 2)``; a shared expert
beside 4 routed ones on ``(2, 2)``; the all-to-all against its
definition, forward and backward.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.launch import steps as j_steps
from repro_torch import convert
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as ts
from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.optim import adamw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCH = "granite-moe-3b-a800m"
EXPERTS = {"e4": 4, "e3": 3}
SHARED = {"e4s": 4}          # 4 experts and one shared expert
LR = 1e-3
STEPS = 3
# One deadline for every process a fixture starts, counted from the
# fixture's start, and the ranks' gloo timeout: over 3x the slowest
# world fixture seen (276 s, the gloo test modules run together on 6
# xdist workers over 8 cores).
JOIN_S = 900
WORLDS = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
GROUPS = ("0", "D")


def _groups(world, g):
    return 0 if g == "0" else WORLDS[world][0]


def _cfg(reduce, get, name, groups, remat="none"):
    c = reduce(get(ARCH))
    return dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, num_experts={**EXPERTS,
                                                       **SHARED}[name],
                                   num_shared=int(name in SHARED)),
        moe_groups=groups, remat=remat)


@pytest.mark.parametrize("e,d,want", [
    (40, 16, (False, 40)), (40, 2, (True, 20)), (8, 16, (False, 8)),
    (8, 2, (True, 4)), (4, 4, (True, 1)), (3, 2, (False, 3)),
    (4, 1, (False, 4))])
def test_expert_layout(e, d, want):
    """The EP rule (the expert dim over ``data`` where it divides it, as
    ``spec_for_leaf`` shards the expert leaves): granite's 40 and
    mixtral's 8 experts are EP at data=2, not at the production 16."""
    lay = ts.expert_layout(ts.AbstractMesh((d, 2), ("data", "model")), e)
    assert (lay.ep, lay.local) == want
    owned = [x for r in range(d) for x in range(lay.lo(r),
                                                lay.lo(r) + lay.local)]
    assert owned == (list(range(e)) * (1 if lay.ep else d))
    spec = ts.spec_for_leaf("blocks/0/moe/experts/wi", (2, e, 64, 128),
                            ts.AbstractMesh((d, 2), ("data", "model")))
    assert (spec[1] == "data") == lay.ep


RANK = textwrap.dedent("""
    import dataclasses, pickle, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import mesh as tmesh, steps
    from repro_torch.models import moe
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim import adamw
    from repro_torch.serving.server import ModelServer

    rank, store, inp, out, shape = (int(sys.argv[1]), sys.argv[2],
                                    sys.argv[3], sys.argv[4],
                                    tuple(int(x) for x in
                                          sys.argv[5].split(",")))
    with open(inp, "rb") as f:
        d = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4,
                            timeout=timedelta(seconds=JOIN_S))
    if shape == (2, 2):
        from repro_torch.distributed import gloo_cuda
        gloo_cuda.install("CPU")
    ocfg = adamw.AdamWConfig(lr=d["lr"], warmup_steps=0)
    res = {"train": {}, "serve": {}}

    def cfg_of(name, groups, remat="none"):
        c = reduced(get_config(d["arch"]))
        return dataclasses.replace(
            c, moe=dataclasses.replace(
                c.moe, num_experts=d["all_experts"][name],
                num_shared=int(name in d["shared"])), moe_groups=groups,
            remat=remat)

    def full(tree):
        return [t.full_tensor().double().numpy()
                for _, t in tree_flatten_with_path(tree)]

    def placed_as_specs(tree, specs, mesh):
        return all(tuple(t.placements) == sharding.placements(mesh, s)
                   for t, s in zip((t for _, t in
                                    tree_flatten_with_path(tree)),
                                   sharding.spec_leaves(specs)))

    def train(name, groups, batch, mesh, remat="none"):
        cfg = cfg_of(name, groups, remat)
        p0 = convert.lm_params(d["params"][name], cfg, "cpu")
        pspecs = sharding.param_specs(p0, mesh)
        p = sharding.distribute(p0, mesh, pspecs)
        s = adamw.adamw_init(p, ocfg)
        ospecs = sharding.opt_specs(s, mesh)
        step = steps.make_train_step(cfg, ocfg, mesh=mesh)
        apply_moe, ffn = moe.apply_moe, moe._expert_ffn
        layers, seen = [], []

        def spy_moe(*a, **k):
            y, m = apply_moe(*a, **k)
            layers.append([float(m[n].full_tensor()) for n in
                           ("moe_aux", "moe_zloss", "moe_drop_frac")])
            return y, m

        def spy_ffn(experts, x, act, **kw):
            seen.append((tuple(experts["wi"].shape),
                         tuple(experts["wo"].shape), type(experts["wi"])
                         .__name__))
            return ffn(experts, x, act, **kw)

        out_ = {"losses": [], "grad_norms": [], "aux": [], "zloss": [],
                "params": [], "placed": []}
        for i in range(d["steps"]):
            if i == 0:
                moe.apply_moe, moe._expert_ffn = spy_moe, spy_ffn
            p, s, m = step(p, s, batch)
            moe.apply_moe, moe._expert_ffn = apply_moe, ffn
            for k, n in (("losses", "loss"), ("grad_norms", "grad_norm"),
                         ("aux", "moe_aux"), ("zloss", "moe_zloss")):
                out_[k].append(float(m[n]))
            out_["params"].append(full(p))
            out_["placed"].append(placed_as_specs(p, pspecs, mesh)
                                  and placed_as_specs(s, ospecs, mesh))
        out_["layers"], out_["ffn"] = layers, seen
        return out_

    def serve(name, prompts, mesh):
        cfg = cfg_of(name, 0)
        B, P_, C, N = prompts.shape[0], prompts.shape[1], d["cache"], d["n"]
        p0 = convert.lm_params(d["params"][name], cfg, "cpu")
        srv = ModelServer(cfg, p0, batch=B, cache_len=C)
        srv.prefill(prompts)
        srv.decode(N)
        pb = steps.build_step_bundle(cfg, ShapeSpec("prompt", P_, B,
                                                    "prefill"), mesh,
                                     cache_len=C)
        db = steps.build_step_bundle(cfg, ShapeSpec("serve", C, B,
                                                    "decode"), mesh)
        params, t = pb.place(p0, torch.from_numpy(prompts))
        logits, caches = pb.fn(params, t)
        placed = [placed_as_specs(caches, db.in_specs[1], mesh)]
        tok = torch.argmax(logits.full_tensor(), -1).to(torch.int32)
        pos = torch.full((B,), P_, dtype=torch.int32)
        got = [tok]
        for _ in range(N):
            logits, caches = db.fn(
                params, caches, sharding.distribute(tok, mesh, db.in_specs[2]),
                sharding.distribute(pos, mesh, db.in_specs[3]))
            placed.append(placed_as_specs(caches, db.out_specs[1], mesh))
            tok = torch.argmax(logits.full_tensor(), -1).to(torch.int32)
            pos = pos + 1
            got.append(tok)
        return {"server": np.array(srv.generated),
                "bundle": torch.stack(got, 1).numpy(), "placed": placed}

    try:
        mesh = tmesh.make_mesh(shape, ("data", "model"), device_type="cpu")
        batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}
        for name in d["experts"]:
            for g in (0, shape[0]):
                res["train"][(name, g)] = train(name, g, batch, mesh)
            res["serve"][name] = serve(name, d["prompts"], mesh)
        # under the selective checkpoint the backward recomputes the
        # routing and the layer's collectives
        res["train_remat"] = {g: train("e4", g, batch, mesh, "dots")
                              for g in (0, shape[0])}
        if shape == (2, 2):
            b3 = {k: torch.from_numpy(v) for k, v in d["batch3"].items()}
            res["train3"] = train("e4", 2, b3, mesh)
            res["train_shared"] = train("e4s", 2, batch, mesh)
            res["serve3"] = serve("e4", d["prompts"][:3], mesh)
        # the exchange itself, forward and backward, over ``data``
        x = (torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
             + 100 * rank).requires_grad_()
        y = collectives.all_to_all(x, mesh, "data")
        (y * (torch.arange(8, dtype=torch.float32)[:, None] + 1)).sum(
            ).backward()
        res["a2a"] = (y.detach().numpy(), x.grad.numpy(),
                      mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"), rank)
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
""").replace("JOIN_S", str(JOIN_S))

JAX_REF = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs.base import reduced
    from repro.configs.registry import get_config
    from repro.launch.steps import make_train_step
    from repro.optim.adamw import AdamWConfig, adamw_init

    with open(sys.argv[1], "rb") as f:
        d = pickle.load(f)
    ocfg = AdamWConfig(lr=d["lr"], warmup_steps=0)
    res = {}
    for key, (name, g, bname, remat) in d["jax_cases"].items():
        c = reduced(get_config(d["arch"]))
        cfg = dataclasses.replace(
            c, moe=dataclasses.replace(
                c.moe, num_experts=d["all_experts"][name],
                num_shared=int(name in d["shared"])), moe_groups=g,
            remat=remat)
        step = jax.jit(make_train_step(cfg, ocfg))
        p = jax.tree_util.tree_map(jnp.asarray, d["params"][name])
        s = adamw_init(p, ocfg)
        batch = {k: jnp.asarray(v) for k, v in d[bname].items()}
        out = {"losses": [], "grad_norms": [], "aux": [], "zloss": [],
               "params": []}
        for _ in range(d["steps"]):
            p, s, m = step(p, s, batch)
            for k, n in (("losses", "loss"), ("grad_norms", "grad_norm"),
                         ("aux", "moe_aux"), ("zloss", "moe_zloss")):
                out[k].append(float(m[n]))
            out["params"].append([np.asarray(x, np.float64)
                                  for x in jax.tree_util.tree_leaves(p)])
        res[key] = out
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


def _jax_key(name, g, bname="batch", remat="none"):
    """JAX's reference run for a case: one group at ``moe_groups`` 0 or
    1, as both packages read them."""
    return f"{name}/{0 if g <= 1 else g}/{bname}/{remat}"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds and JAX's reference, run together once for the
    module: (inputs, {world: [rank results]}, JAX's results)."""
    start = time.monotonic()
    tmp = tmp_path_factory.mktemp("moe_worlds")
    params = {}
    for name in list(EXPERTS) + list(SHARED):
        jc = _cfg(j_reduced, j_get_config, name, 0)
        params[name] = jax.tree_util.tree_map(
            np.asarray, j_steps.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(13)
    vocab = j_reduced(j_get_config(ARCH)).vocab_size
    cases = {_jax_key(n, _groups(w, g)): (n, _groups(w, g), "batch", "none")
             for n in EXPERTS for w in WORLDS for g in GROUPS}
    cases.update({_jax_key("e4", _groups(w, g), remat="dots"):
                  ("e4", _groups(w, g), "batch", "dots")
                  for w in WORLDS for g in GROUPS})
    cases[_jax_key("e4", 2, "batch3")] = ("e4", 2, "batch3", "none")
    cases[_jax_key("e4s", 2)] = ("e4s", 2, "batch", "none")
    d = {"arch": ARCH, "lr": LR, "steps": STEPS, "params": params,
         "experts": EXPERTS, "all_experts": {**EXPERTS, **SHARED},
         "shared": list(SHARED),
         "cache": 32, "n": 6, "jax_cases": cases,
         "batch": {k: rng.integers(0, vocab, (8, 16)).astype(np.int32)
                   for k in ("tokens", "targets")},
         "batch3": {k: rng.integers(0, vocab, (3, 16)).astype(np.int32)
                    for k in ("tokens", "targets")},
         "prompts": rng.integers(0, vocab, (4, 8)).astype(np.int32)}
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    (tmp / "rank.py").write_text(RANK)
    (tmp / "jax_ref.py").write_text(JAX_REF)
    (tmp / "in.pkl").write_bytes(pickle.dumps(d))
    procs = []
    for w, shape in WORLDS.items():
        procs += [(f"{w} rank {r}", subprocess.Popen(
            [sys.executable, str(tmp / "rank.py"), str(r),
             str(tmp / f"store_{w}"), str(tmp / "in.pkl"),
             str(tmp / f"out_{w}_{r}.pkl"), ",".join(map(str, shape))],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)) for r in range(4)]
    procs.append(("jax", subprocess.Popen(
        [sys.executable, str(tmp / "jax_ref.py"), str(tmp / "in.pkl"),
         str(tmp / "jax.pkl")], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    _run_all(procs, start)
    ranks = {w: [pickle.loads((tmp / f"out_{w}_{r}.pkl").read_bytes())
                 for r in range(4)] for w in WORLDS}
    return d, ranks, pickle.loads((tmp / "jax.pkl").read_bytes())


def _rel_l2(got, want):
    num = sum(float(np.sum((np.asarray(a) - np.asarray(b)) ** 2))
              for a, b in zip(got, want))
    den = sum(float(np.sum(np.asarray(b) ** 2)) for b in want)
    return (num / den) ** 0.5


_PLAIN = {}


def _plain_of(d, name, g, bname="batch", remat="none"):
    """The port's meshless step from JAX's parameters: per step (loss,
    gradient norm, moe_aux, moe_zloss, parameters), and the first step's
    per-layer (aux, zloss, drop share). One group at ``moe_groups`` 0 or
    1 alike."""
    g = 0 if g <= 1 else g
    if (name, g, bname, remat) in _PLAIN:
        return _PLAIN[(name, g, bname, remat)]
    cfg = _cfg(reduced, get_config, name, g, remat)
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=0)
    step = steps.make_train_step(cfg, ocfg)
    p = convert.lm_params(d["params"][name], cfg, "cpu")
    s = adamw.adamw_init(p, ocfg)
    batch = {k: torch.from_numpy(v) for k, v in d[bname].items()}
    apply_moe, layers = moe.apply_moe, []

    def spy(*a, **k):
        y, m = apply_moe(*a, **k)
        layers.append([float(m[n].detach()) for n in ("moe_aux", "moe_zloss",
                                             "moe_drop_frac")])
        return y, m

    out = []
    for i in range(STEPS):
        moe.apply_moe = spy if i == 0 else apply_moe
        try:
            p, s, m = step(p, s, batch)
        finally:
            moe.apply_moe = apply_moe
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    float(m["moe_aux"]), float(m["moe_zloss"]),
                    [t.double().numpy() for _, t in
                     tree_flatten_with_path(p)]))
    _PLAIN[(name, g, bname, remat)] = out, layers
    return out, layers


def _check_train(res, jres, plain):
    """A mesh run against JAX's meshless run and the port's."""
    runs, _ = plain
    for key, i in (("losses", 0), ("grad_norms", 1), ("aux", 2),
                   ("zloss", 3)):
        np.testing.assert_allclose(res[key], jres[key], rtol=1e-5)
        np.testing.assert_allclose(res[key], [r[i] for r in runs], rtol=1e-5)
    for i in range(STEPS):
        assert _rel_l2(res["params"][i], jres["params"][i]) <= 1e-4
        assert _rel_l2(res["params"][i], runs[i][4]) <= 1e-4


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("name", list(EXPERTS))
@pytest.mark.parametrize("world", list(WORLDS))
def test_moe_train_steps_match_jax_and_the_meshless_step(worlds, world,
                                                         name, groups):
    """Three steps on the mesh against JAX's meshless step and the
    port's: losses, gradient norms and the MoE aux terms within 1e-5
    relative, parameters within 1e-4 relative L2; every rank reads the
    same losses."""
    d, ranks, jres = worlds
    g = _groups(world, groups)
    res = ranks[world][0]["train"][(name, g)]
    for r in range(4):
        assert ranks[world][r]["train"][(name, g)]["losses"] == res["losses"]
    _check_train(res, jres[_jax_key(name, g)], _plain_of(d, name, g))


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("name", list(EXPERTS))
@pytest.mark.parametrize("world", list(WORLDS))
def test_moe_layer_metrics_equal_the_meshless_layers(worlds, world, name,
                                                     groups):
    """Each MoE layer's metrics in the first step: ``moe_drop_frac``
    exactly the meshless port's (the same assignments dropped),
    ``moe_aux`` and ``moe_zloss`` within 1e-5 relative; alike on every
    rank."""
    d, ranks, _ = worlds
    g = _groups(world, groups)
    _, want = _plain_of(d, name, g)
    for res in ranks[world]:
        got = res["train"][(name, g)]["layers"]
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a[2] == b[2]
            np.testing.assert_allclose(a[:2], b[:2], rtol=1e-5)


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_moe_train_steps_under_remat_match_jax_and_the_meshless_step(
        worlds, world, groups):
    """``remat='dots'`` (mixtral's setting), E=4: the selective
    checkpoint's backward recomputes the routing, the all-to-all (under
    EP with local groups), the gathers and the f32 reduce over ``model``.
    Three steps against JAX's meshless step and the port's at the same
    remat, as in the cases without it; every rank reads the same
    losses."""
    d, ranks, jres = worlds
    g = _groups(world, groups)
    res = ranks[world][0]["train_remat"][g]
    for r in range(4):
        assert ranks[world][r]["train_remat"][g]["losses"] == res["losses"]
    assert all(res["placed"])
    _check_train(res, jres[_jax_key("e4", g, remat="dots")],
                 _plain_of(d, "e4", g, remat="dots"))


@pytest.mark.parametrize("world", list(WORLDS))
def test_moe_carried_leaves_keep_their_placements(worlds, world):
    """Parameters and optimizer state in their specs' placements after
    every step of every case, EP expert leaves sharded on the expert
    dim."""
    _, ranks, _ = worlds
    for res in ranks[world]:
        for run in list(res["train"].values()) + [res.get("train3")]:
            if run is not None:
                assert all(run["placed"])


@pytest.mark.parametrize("name", list(EXPERTS))
@pytest.mark.parametrize("world", list(WORLDS))
def test_expert_weights_reach_the_ffn_as_the_layout_says(worlds, world,
                                                         name):
    """What ``_expert_ffn`` was given in the first step, each layer, both
    group modes: local tensors; under EP the rank's E/D experts, never
    gathered over ``data``; otherwise every expert with its ``d_model``
    dim gathered; the ``ff`` dim over ``model`` in both."""
    _, ranks, _ = worlds
    data, model = WORLDS[world]
    e = EXPERTS[name]
    lay = ts.expert_layout(ts.AbstractMesh((data, model),
                                           ("data", "model")), e)
    ff = 128 // model
    for res in ranks[world]:
        for g in (0, data):
            seen = res["train"][(name, g)]["ffn"]
            assert len(seen) == 2           # one call a layer
            for wi, wo, kind in seen:
                assert kind == "Tensor"
                assert wi == (lay.local, 64, ff) and wo == (lay.local, ff, 64)


@pytest.mark.parametrize("name", list(EXPERTS))
@pytest.mark.parametrize("world", list(WORLDS))
def test_moe_decode_bundle_greedy_tokens_equal_model_server(worlds, world,
                                                            name):
    """Prefill, then 6 decode steps through the bundles on the mesh (each
    decode step's (B, 1, d) tokens through the MoE): greedy tokens equal
    the meshless ``ModelServer``'s; the caches keep their placements."""
    _, ranks, _ = worlds
    for res in ranks[world]:
        sv = res["serve"][name]
        np.testing.assert_array_equal(sv["bundle"], sv["server"])
        assert all(sv["placed"])


def test_moe_batch_of_three_on_2x2(worlds):
    """B=3 on (2, 2): ``data`` does not divide the batch, so the
    activations stay replicated and ``moe_groups=2`` falls back to one
    group; the train steps against both references, the serving tokens
    against ``ModelServer``."""
    d, ranks, jres = worlds
    res = ranks["2x2"][0]
    _check_train(res["train3"], jres[_jax_key("e4", 2, "batch3")],
                 _plain_of(d, "e4", 2, "batch3"))
    for r in ranks["2x2"]:
        np.testing.assert_array_equal(r["serve3"]["bundle"],
                                      r["serve3"]["server"])


def test_moe_shared_expert_on_2x2(worlds):
    """A shared (always-on) expert beside 4 routed ones on (2, 2), local
    groups: the shared MLP runs on the DTensor path (its ``d_model`` dim
    gathered, its ``ff`` over ``model``); the train steps against both
    references."""
    d, ranks, jres = worlds
    _check_train(ranks["2x2"][0]["train_shared"], jres[_jax_key("e4s", 2)],
                 _plain_of(d, "e4s", 2))


@pytest.mark.parametrize("world", list(WORLDS))
def test_all_to_all_forward_and_backward(worlds, world):
    """``collectives.all_to_all`` over ``data``: chunk ``j`` of each
    rank's rows to data rank ``j``; its gradient the reverse exchange
    (rank ``i``'s rows get the weights of the rows they became)."""
    _, ranks, _ = worlds
    data, _ = WORLDS[world]
    by = {(r["a2a"][2], r["a2a"][3]): r["a2a"] for r in ranks[world]}
    n = 8 // data
    for (i, m), (y, gx, _, _, _) in by.items():
        for j in range(data):
            rank_j = by[(j, m)][4]
            x_j = np.arange(24, dtype=np.float32).reshape(8, 3) + 100 * rank_j
            np.testing.assert_array_equal(y[j * n:(j + 1) * n],
                                          x_j[i * n:(i + 1) * n])
            # my rows i*n.. went to rank j, landing at its rows j*n..
            w = np.arange(8, dtype=np.float32)[i * n:(i + 1) * n] + 1
            np.testing.assert_array_equal(gx[j * n:(j + 1) * n],
                                          np.repeat(w[:, None], 3, 1))


@pytest.mark.parametrize("shapes", [((6, 8), (8, 5)),
                                    ((3, 6, 8), (3, 8, 5))])
def test_mm_f32_keeps_the_f32_sums_and_the_plain_backward(shapes):
    """``sharding.mm_f32`` of bf16 operands (a row-parallel product's
    partial sum, the experts' last product): the f32 sums unrounded,
    equal to the widened operands' product; its gradients, in bf16,
    those of the plain bf16 product; f32 operands take the plain
    product."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(*shapes[0], generator=g).bfloat16().requires_grad_()
    w = torch.randn(*shapes[1], generator=g).bfloat16().requires_grad_()
    y = ts.mm_f32(x, w)
    assert y.dtype == torch.float32
    assert torch.equal(y, x.detach().float() @ w.detach().float())
    gy = torch.randn(y.shape, generator=g).bfloat16()
    got = torch.autograd.grad(y, (x, w), gy.float())
    want = torch.autograd.grad(x @ w, (x, w), gy)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    xf, wf = x.detach().float(), w.detach().float()
    assert torch.equal(ts.mm_f32(xf, wf), xf @ wf)
