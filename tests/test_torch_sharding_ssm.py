"""Mamba-2's SSD mixer and the vision frontend on a wide mesh
(``repro_torch.models.ssm`` and ``models.lm`` on DTensors,
``launch.steps`` with ``m`` blocks and ``embeds``) against the JAX
package's meshless step and the port's, on the CPU.

Gloo worlds of 4 ranks, one per mesh shape, ``(2, 2)``, ``(4, 1)`` and
``(1, 4)`` over ``("data", "model")``, started together with one JAX
reference process in a module fixture (ranks joined by a ``FileStore``
under ``tmp_path``, all joined by one ``JOIN_S`` deadline from the
fixture's start). The
``(2, 2)`` world, the card's layout, registers ``distributed/gloo_cuda.py``'s
collectives for the CPU.

Configs (f32): reduced mamba2-780m (d 64: 8 SSD heads of 16, d_state 16,
d_proj 296, conv_ch 160, chunk 8, so a sequence of 16 crosses a chunk
boundary), the same at d 48 (6 heads: ``model`` = 4 divides neither the
heads nor ``d_proj``, but does divide ``conv_ch`` and ``out_proj``'s
rows, which then split a head), reduced jamba-v0.1-52b (one period of 8:
``md``/``me`` SSD layers beside an ``ad`` attention layer, 4 experts,
``remat='dots'``) and reduced qwen2-vl-7b (8 stub patch embeddings ahead
of 16 tokens, M-RoPE, QKV bias, ``remat='dots'``). Each over 3 train
steps from JAX's parameters against JAX's ``make_train_step`` and the
port's meshless step: losses within 1e-5 relative, parameters within
1e-4 relative L2, the first step's gradient norm within 1e-5, and each
later step's within 1e-5 of the meshless gradient norm at the mesh
run's own parameters (the gradient held at the same point) and of the
meshless runs' own. Reduced jamba's later norms at lr 1e-3 are held at
the same point only: with no mesh at all the port's and JAX's
trajectories part there by up to 1.3e-4, through AdamW's first step on
elements whose gradient is near 0 (``lr·g / (|g| + eps)`` moves them
whatever their size), which a test shows; jamba's trajectory is held at
lr 1e-5 on ``(1, 4)``, where that gap is within 1e-5. Every carried leaf keeps
its placements. Serving: the prefill and decode bundles' greedy tokens equal
``ModelServer``'s (qwen2-vl's, with the patch embeddings, the meshless
``make_prefill_step`` / ``make_serve_step``'s), the ``conv``/``ssm``
caches in their specs' placements after every step. Also: batches of 1
and 3 on ``(2, 2)``; ``TrainLoop(mesh=)`` bit for bit ``make_train_step``;
what the scan was given (local heads, or every head where ``model`` does
not divide them); and a gated norm taken over the local heads only
(the sums of squares not all-reduced) moves the losses far outside the
tolerance, so the comparisons above would catch it.
"""
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
from repro_torch.models.tree import (tree_flatten_with_path, tree_leaves,
                                     tree_unflatten)
from repro_torch.optim import adamw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
# name -> (arch, d_model)
CONFIGS = {"mamba2": ("mamba2-780m", 64), "mamba2_d48": ("mamba2-780m", 48),
           "jamba": ("jamba-v0.1-52b", 64), "qwen2vl": ("qwen2-vl-7b", 64)}
LR = 1e-3
SMALL_LR = LR / 100      # jamba's trajectory against JAX's, on (1, 4)
STEPS = 3
# One deadline for every process a fixture starts, counted from the
# fixture's start, and the ranks' gloo timeout: over 3x the slowest
# world fixture seen (276 s, the gloo test modules run together on 6
# xdist workers over 8 cores).
JOIN_S = 900
WORLDS = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
UNEVEN = (1, 3)          # batches (2, 2)'s data axis does not split evenly


def _cfg(reduce, get, name):
    arch, d = CONFIGS[name]
    return reduce(get(arch), d_model=d)


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
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as tmesh, steps
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import ssm
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
    small = adamw.AdamWConfig(lr=d["small_lr"], warmup_steps=0)
    SMALL_LR_WORLD = (1, 4)
    res = {"train": {}, "serve": {}}

    def cfg_of(name):
        arch, dm = d["configs"][name]
        return reduced(get_config(arch), d_model=dm)

    def full(tree):
        return [t.full_tensor().double().numpy()
                for _, t in tree_flatten_with_path(tree)]

    def placed_as_specs(tree, specs, mesh):
        return all(tuple(t.placements) == sharding.placements(mesh, s)
                   for t, s in zip((t for _, t in
                                    tree_flatten_with_path(tree)),
                                   sharding.spec_leaves(specs)))

    def batch_of(bname):
        return {k: torch.from_numpy(v) for k, v in d[bname].items()}

    def train(name, bname, mesh, steps_=None, ocfg=ocfg):
        cfg = cfg_of(name)
        p0 = convert.lm_params(d["params"][name], cfg, "cpu")
        pspecs = sharding.param_specs(p0, mesh)
        p = sharding.distribute(p0, mesh, pspecs)
        s = adamw.adamw_init(p, ocfg)
        ospecs = sharding.opt_specs(s, mesh)
        step = steps.make_train_step(cfg, ocfg, mesh=mesh)
        scan, seen = ssm._scan, []

        def spy(xc, Bc, Cc, dt, *a):
            seen.append((type(xc).__name__, dt.shape[-1], tuple(xc.shape)))
            return scan(xc, Bc, Cc, dt, *a)

        out_ = {"losses": [], "grad_norms": [], "params": [], "placed": []}
        batch = batch_of(bname)
        for i in range(steps_ or d["steps"]):
            ssm._scan = spy if i == 0 else scan
            try:
                p, s, m = step(p, s, batch)
            finally:
                ssm._scan = scan
            out_["losses"].append(float(m["loss"]))
            out_["grad_norms"].append(float(m["grad_norm"]))
            out_["params"].append(full(p))
            out_["placed"].append(placed_as_specs(p, pspecs, mesh)
                                  and placed_as_specs(s, ospecs, mesh))
        out_["scan"] = seen
        return out_

    def serve(name, prompts, mesh, embeds=None):
        cfg = cfg_of(name)
        B, P_, C, N = prompts.shape[0], prompts.shape[1], d["cache"], d["n"]
        p0 = convert.lm_params(d["params"][name], cfg, "cpu")
        if embeds is None:
            srv = ModelServer(cfg, p0, batch=B, cache_len=C)
            srv.prefill(prompts)
            srv.decode(N)
            want = np.array(srv.generated)
        else:
            pf = steps.make_prefill_step(cfg, C)
            sv = steps.make_serve_step(cfg)
            logits, caches = pf(p0, torch.from_numpy(prompts),
                                torch.from_numpy(embeds))
            tok = torch.argmax(logits, -1).to(torch.int32)
            pos = torch.full((B,), P_ + embeds.shape[1], dtype=torch.int32)
            got = [tok]
            for _ in range(N):
                logits, caches = sv(p0, caches, tok, pos)
                tok = torch.argmax(logits, -1).to(torch.int32)
                pos = pos + 1
                got.append(tok)
            want = torch.stack(got, 1).numpy()
        F_ = 0 if embeds is None else embeds.shape[1]
        pb = steps.build_step_bundle(cfg, ShapeSpec("prompt", P_ + F_, B,
                                                    "prefill"), mesh,
                                     cache_len=C)
        db = steps.build_step_bundle(cfg, ShapeSpec("serve", C, B,
                                                    "decode"), mesh)
        args = (p0, torch.from_numpy(prompts)) + (
            () if embeds is None else (torch.from_numpy(embeds),))
        placed_args = pb.place(*args)
        logits, caches = pb.fn(*placed_args)
        params = placed_args[0]
        placed = [placed_as_specs(caches, db.in_specs[1], mesh)]
        tok = torch.argmax(logits.full_tensor(), -1).to(torch.int32)
        pos = torch.full((B,), P_ + F_, dtype=torch.int32)
        got = [tok]
        for _ in range(N):
            logits, caches = db.fn(
                params, caches, sharding.distribute(tok, mesh, db.in_specs[2]),
                sharding.distribute(pos, mesh, db.in_specs[3]))
            placed.append(placed_as_specs(caches, db.out_specs[1], mesh))
            tok = torch.argmax(logits.full_tensor(), -1).to(torch.int32)
            pos = pos + 1
            got.append(tok)
        return {"want": want, "bundle": torch.stack(got, 1).numpy(),
                "placed": placed}

    try:
        mesh = tmesh.make_mesh(shape, ("data", "model"), device_type="cpu")
        for name in d["configs"]:
            res["train"][name] = train(name, d["batch_of"][name], mesh)
            res["serve"][name] = serve(
                name, d["prompts"], mesh,
                d["embeds"] if name == "qwen2vl" else None)
        if shape == SMALL_LR_WORLD:
            res["train"]["jamba_small_lr"] = train("jamba", "batch", mesh,
                                                   ocfg=small)
        # TrainLoop(mesh=): the same steps as make_train_step
        cfg = cfg_of("mamba2")
        p0 = convert.lm_params(d["params"]["mamba2"], cfg, "cpu")
        loop = TrainLoop(cfg, opt_cfg=ocfg, mesh=mesh, device="cpu")
        loop.params = sharding.distribute(p0, mesh,
                                          sharding.param_specs(p0, mesh))
        loop.opt_state = adamw.adamw_init(loop.params, ocfg)
        ran = loop.run(iter([d["batch"]] * d["steps"]), steps=d["steps"],
                       log_every=0)
        res["loop"] = ([h["loss"] for h in ran["history"]],
                       full(loop.params))
        # the gated norm over the local heads only: each rank's own sums
        # of squares, as if over its d_inner share
        if shape[1] > 1:
            model_sum = ssm._model_sum
            ssm._model_sum = lambda lay, t: t * shape[1]
            try:
                res["local_norm"] = train("mamba2", "batch", mesh, 1)
            finally:
                ssm._model_sum = model_sum
        if shape == (2, 2):
            res["uneven"] = {}
            for b in d["uneven"]:
                res["uneven"][b] = {
                    "train": train("mamba2", f"batch{b}", mesh),
                    "train_vl": train("qwen2vl", f"batch_vl{b}", mesh),
                    "serve": serve("mamba2", d["prompts"][:b], mesh)}
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
""").replace("JOIN_S", str(JOIN_S))

JAX_REF = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs.base import reduced
    from repro.configs.registry import get_config
    from repro.launch.steps import make_train_step
    from repro.optim.adamw import AdamWConfig, adamw_init

    with open(sys.argv[1], "rb") as f:
        d = pickle.load(f)
    res = {}
    for key, (name, bname, lr) in d["jax_cases"].items():
        ocfg = AdamWConfig(lr=lr, warmup_steps=0)
        arch, dm = d["configs"][name]
        cfg = reduced(get_config(arch), d_model=dm)
        step = jax.jit(make_train_step(cfg, ocfg))
        p = jax.tree_util.tree_map(jnp.asarray, d["params"][name])
        s = adamw_init(p, ocfg)
        batch = {k: jnp.asarray(v) for k, v in d[bname].items()}
        out = {"losses": [], "grad_norms": [], "params": []}
        for _ in range(d["steps"]):
            p, s, m = step(p, s, batch)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
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


def _batch(rng, vocab, b, s):
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "targets")}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds and JAX's reference, run together once for the
    module: (inputs, {world: [rank results]}, JAX's results)."""
    start = time.monotonic()
    tmp = tmp_path_factory.mktemp("ssm_worlds")
    params = {}
    for name in CONFIGS:
        jc = _cfg(j_reduced, j_get_config, name)
        params[name] = jax.tree_util.tree_map(
            np.asarray, j_steps.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(17)
    vocab = j_reduced(j_get_config("mamba2-780m")).vocab_size
    vl = j_reduced(j_get_config("qwen2-vl-7b"))

    def embeds(b):
        return rng.standard_normal((b, vl.frontend_len, 64)).astype(
            np.float32)

    d = {"configs": CONFIGS, "lr": LR, "small_lr": SMALL_LR, "steps": STEPS,
         "params": params,
         "cache": 32, "n": 6, "uneven": UNEVEN,
         "batch": _batch(rng, vocab, 4, 16),
         "batch_vl": dict(_batch(rng, vocab, 4, 16), embeds=embeds(4)),
         "prompts": rng.integers(0, vocab, (4, 10)).astype(np.int32),
         "embeds": embeds(4)}
    for b in UNEVEN:
        d[f"batch{b}"] = _batch(rng, vocab, b, 16)
        d[f"batch_vl{b}"] = dict(_batch(rng, vocab, b, 16), embeds=embeds(b))
    d["batch_of"] = {n: "batch_vl" if n == "qwen2vl" else "batch"
                     for n in CONFIGS}
    d["jax_cases"] = {n: (n, d["batch_of"][n], LR) for n in CONFIGS}
    d["jax_cases"]["jamba/small_lr"] = ("jamba", "batch", SMALL_LR)
    for b in UNEVEN:
        d["jax_cases"][f"mamba2/{b}"] = ("mamba2", f"batch{b}", LR)
        d["jax_cases"][f"qwen2vl/{b}"] = ("qwen2vl", f"batch_vl{b}", LR)
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


def _plain_of(d, name, bname, lr=LR):
    """The port's meshless step from JAX's parameters: per step (loss,
    gradient norm, parameters)."""
    if (name, bname, lr) in _PLAIN:
        return _PLAIN[(name, bname, lr)]
    cfg = _cfg(reduced, get_config, name)
    ocfg = adamw.AdamWConfig(lr=lr, warmup_steps=0)
    step = steps.make_train_step(cfg, ocfg)
    p = convert.lm_params(d["params"][name], cfg, "cpu")
    s = adamw.adamw_init(p, ocfg)
    batch = {k: torch.from_numpy(v) for k, v in d[bname].items()}
    out = []
    for _ in range(STEPS):
        p, s, m = step(p, s, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    [t.double().numpy() for _, t in
                     tree_flatten_with_path(p)]))
    _PLAIN[(name, bname, lr)] = out
    return out


def _at_mesh_points(d, name, bname, res):
    """The port's meshless loss and global gradient norm at the
    parameters the mesh run held before each of its steps after the
    first: the mesh's gradient held at the same point, whatever its
    trajectory."""
    cfg = _cfg(reduced, get_config, name)
    tmpl = convert.lm_params(d["params"][name], cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in d[bname].items()}
    out = []
    for leaves in res["params"][:-1]:
        p = tree_unflatten(tmpl, [
            torch.from_numpy(a).to(t.dtype)
            for a, (_, t) in zip(leaves, tree_flatten_with_path(tmpl))])
        loss, _, grads = steps._value_and_grad(p, cfg, batch)
        out.append((float(loss), float(torch.sqrt(sum(
            (g.double() ** 2).sum() for g in tree_leaves(grads))))))
    return out


def _check_train(res, jres, plain, d, name, bname, trajectory=True):
    """A mesh run against JAX's meshless run and the port's: losses
    within 1e-5 relative, parameters within 1e-4 relative L2; the first
    step's gradient norm within 1e-5, and each later step's within 1e-5
    of the meshless gradient norm at the mesh's own parameters, and
    with ``trajectory`` also of the meshless runs' own."""
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-5)
    np.testing.assert_allclose(res["losses"], [r[0] for r in plain],
                               rtol=1e-5)
    n = STEPS if trajectory else 1
    np.testing.assert_allclose(res["grad_norms"][:n], jres["grad_norms"][:n],
                               rtol=1e-5)
    np.testing.assert_allclose(res["grad_norms"][:n],
                               [r[1] for r in plain][:n], rtol=1e-5)
    same = _at_mesh_points(d, name, bname, res)
    np.testing.assert_allclose(res["losses"][1:], [a for a, _ in same],
                               rtol=1e-5)
    np.testing.assert_allclose(res["grad_norms"][1:], [b for _, b in same],
                               rtol=1e-5)
    for i in range(STEPS):
        assert _rel_l2(res["params"][i], jres["params"][i]) <= 1e-4
        assert _rel_l2(res["params"][i], plain[i][2]) <= 1e-4


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("world", list(WORLDS))
def test_ssm_and_frontend_train_steps_match_jax_and_the_meshless_step(
        worlds, world, name):
    """Three steps on the mesh against JAX's meshless step and the
    port's: losses and gradient norms within 1e-5 relative (a partial
    gradient of a replicated leaf summed where it should not be, or not
    summed, moves the norm, which Adam would hide from the parameters),
    parameters within 1e-4 relative L2; every rank reads the same losses
    and norms."""
    d, ranks, jres = worlds
    res = ranks[world][0]["train"][name]
    for r in range(4):
        got = ranks[world][r]["train"][name]
        assert (got["losses"], got["grad_norms"]) == (res["losses"],
                                                      res["grad_norms"])
    bname = d["batch_of"][name]
    _check_train(res, jres[name], _plain_of(d, name, bname), d, name, bname,
                 trajectory=name != "jamba")


def test_jamba_trajectory_at_a_small_lr_matches_jax_and_the_meshless_step(
        worlds):
    """Reduced jamba's three steps on the (1, 4) world (the SSD's heads,
    its norm and ``out_proj`` split over ``model``) at ``SMALL_LR``, held
    as the other models are at ``LR``: every step's gradient norm within
    1e-5 of JAX's and of the meshless port's (the trajectory), losses
    within 1e-5, parameters within 1e-4 relative L2. One world only: the
    file's worlds share the test run's cores with other files."""
    d, ranks, jres = worlds
    res = ranks["1x4"][0]["train"]["jamba_small_lr"]
    for r in range(4):
        got = ranks["1x4"][r]["train"]["jamba_small_lr"]
        assert (got["losses"], got["grad_norms"]) == (res["losses"],
                                                      res["grad_norms"])
    _check_train(res, jres["jamba/small_lr"],
                 _plain_of(d, "jamba", "batch", SMALL_LR), d, "jamba",
                 "batch")


def test_jamba_meshless_gap_to_jax_comes_from_adams_first_step(worlds):
    """Why jamba's later gradient norms are held at the same point at
    ``LR``: with no mesh at all the port's and JAX's trajectories part,
    and only through AdamW's first step on gradients near 0. Every
    element whose first update differs between the two by more than
    ``LR / 100`` has a gradient below 1e-5 (Adam moves it by up to
    ``lr·g / (|g| + eps)`` whatever its size, so its rounding decides the
    move), and at ``SMALL_LR`` the trajectories agree within 1e-5 in
    every step: the gap scales with the step, no layer amplifies it."""
    d, _, jres = worlds
    cfg = _cfg(reduced, get_config, "jamba")
    p0 = convert.lm_params(d["params"]["jamba"], cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}
    _, _, grads = steps._value_and_grad(p0, cfg, batch)
    plain = _plain_of(d, "jamba", "batch")
    off, g_off = 0, 0.0
    for a, b, g in zip(plain[0][2], jres["jamba"]["params"][0],
                       tree_leaves(grads)):
        moved = np.abs(a - b) > LR / 100
        off += int(moved.sum())
        if moved.any():
            g_off = max(g_off, float(np.abs(g.double().numpy()[moved]).max()))
    gaps = {lr: [abs(p[1] - j) / j for p, j in zip(
        _plain_of(d, "jamba", "batch", lr), jres[key]["grad_norms"])]
        for lr, key in ((LR, "jamba"), (SMALL_LR, "jamba/small_lr"))}
    print(f"jamba meshless port vs JAX: {off} elements' first updates "
          f"differ by > lr/100, their largest |gradient| {g_off:.3e}; "
          f"gradient-norm gaps by step at lr {LR:g}: {gaps[LR]}, at "
          f"{SMALL_LR:g}: {gaps[SMALL_LR]}")
    assert g_off < 1e-5
    assert max(gaps[SMALL_LR]) <= 1e-5


@pytest.mark.parametrize("world", list(WORLDS))
def test_ssm_carried_leaves_keep_their_placements(worlds, world):
    """Parameters and optimizer state in their specs' placements after
    every step of every case."""
    _, ranks, _ = worlds
    for res in ranks[world]:
        runs = list(res["train"].values())
        runs += [u[k] for u in res.get("uneven", {}).values()
                 for k in ("train", "train_vl")]
        for run in runs:
            assert all(run["placed"])


@pytest.mark.parametrize("name", ["mamba2", "mamba2_d48", "jamba"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_the_scan_runs_on_the_heads_the_layout_gives(worlds, world, name):
    """What the scan was given in the first step: local tensors, of the
    rank's ``nh / model`` heads where ``model`` divides the heads, of
    every head where it does not (d 48's 6 heads on ``(1, 4)``), with the
    rank's rows of the batch."""
    _, ranks, _ = worlds
    data, model = WORLDS[world]
    cfg = _cfg(reduced, get_config, name)
    nh = cfg.ssm.nheads(cfg.d_model)
    heads = nh // model if nh % model == 0 else nh
    n_m = sum(t[0] == "m" for t in cfg.pattern) * (
        cfg.n_layers // len(cfg.pattern))
    for res in ranks[world]:
        seen = res["train"][name]["scan"]
        # forward, and under remat='dots' the recompute in the backward
        assert len(seen) == n_m * (2 if cfg.remat == "dots" else 1)
        for kind, h, shape in seen:
            assert kind == "Tensor" and h == heads
            assert shape == (4 // data, 16, heads * cfg.ssm.headdim)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("world", list(WORLDS))
def test_ssm_and_frontend_decode_bundles_equal_the_meshless_server(
        worlds, world, name):
    """Prefill, then 6 decode steps through the bundles on the mesh:
    greedy tokens equal ``ModelServer``'s (qwen2-vl's, whose prompts
    carry 8 patch embeddings, the meshless prefill and serve steps'); the
    ``conv``/``ssm`` and KV caches keep their specs' placements after the
    prefill and every step."""
    _, ranks, _ = worlds
    for res in ranks[world]:
        sv = res["serve"][name]
        np.testing.assert_array_equal(sv["bundle"], sv["want"])
        assert all(sv["placed"])


@pytest.mark.parametrize("world", list(WORLDS))
def test_ssm_train_loop_on_the_mesh_is_make_train_step(worlds, world):
    """``TrainLoop(mesh=)`` over reduced mamba2: bit for bit the steps of
    ``make_train_step`` on the same mesh."""
    _, ranks, _ = worlds
    for res in ranks[world]:
        losses, params = res["loop"]
        assert losses == res["train"]["mamba2"]["losses"]
        for a, b in zip(params, res["train"]["mamba2"]["params"][-1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", ["2x2", "1x4"])
def test_a_gated_norm_over_local_heads_is_caught(worlds, world):
    """With each rank's sums of squares standing for the whole
    ``d_inner`` (the norm taken over its local heads), the first step's
    loss and gradient norm land far outside the 1e-5 the comparisons
    hold: what they would catch."""
    d, ranks, _ = worlds
    plain = _plain_of(d, "mamba2", "batch")
    for res in ranks[world]:
        bad = res["local_norm"]
        good = res["train"]["mamba2"]
        assert good["losses"][0] == pytest.approx(plain[0][0], rel=1e-5)
        assert (abs(bad["losses"][0] - plain[0][0]) > 1e-3 * plain[0][0]
                or abs(bad["grad_norms"][0] - plain[0][1])
                > 1e-3 * plain[0][1])


@pytest.mark.parametrize("b", UNEVEN)
def test_ssm_and_frontend_uneven_batches_on_2x2(worlds, b):
    """Batches of 1 and 3 on (2, 2): ``data`` does not divide them, so
    the activations and the caches stay replicated over it. Reduced
    mamba2 and qwen2-vl (with its patch embeddings) train against both
    references; mamba2's bundles serve ``b`` slots equal to
    ``ModelServer``'s."""
    d, ranks, jres = worlds
    u = ranks["2x2"][0]["uneven"][b]
    for key, name, bname in (("train", "mamba2", f"batch{b}"),
                             ("train_vl", "qwen2vl", f"batch_vl{b}")):
        _check_train(u[key], jres[f"{name}/{b}"], _plain_of(d, name, bname),
                     d, name, bname)
    for res in ranks["2x2"]:
        sv = res["uneven"][b]["serve"]
        np.testing.assert_array_equal(sv["bundle"], sv["want"])
        assert all(sv["placed"])


def _trimmed(*entries):
    out = list(entries)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("name", ["mamba2", "mamba2_d48", "jamba"])
def test_ssm_cache_specs_follow_the_layout(name):
    """The ``conv`` and ``ssm`` cache specs on the worlds' meshes: the
    conv's channels over ``model`` where it divides ``conv_ch``, the
    state's heads where it divides ``nh``, the batch over ``data`` where
    it divides the batch: the layout the block computes with."""
    cfg = _cfg(reduced, get_config, name)
    s = cfg.ssm
    nh = s.nheads(cfg.d_model)
    conv_ch = s.d_inner(cfg.d_model) + 2 * s.ngroups * s.d_state
    for data, m in WORLDS.values():
        mesh = ts.AbstractMesh((data, m), ("data", "model"))
        for b in (4, 3):
            cs = ts.cache_specs_tree(steps.cache_struct(cfg, b, 32), cfg,
                                     mesh, b)
            dp = "data" if data > 1 and b % data == 0 else None
            tm = "model" if m > 1 else None
            for r, tok in enumerate(cfg.pattern):
                if tok[0] != "m":
                    continue
                assert tuple(cs[r]["conv"]) == _trimmed(
                    None, dp, None, tm if conv_ch % m == 0 else None)
                assert tuple(cs[r]["ssm"]) == _trimmed(
                    None, dp, tm if nh % m == 0 else None)
