"""The encoder-decoder on a wide mesh (``repro_torch.models.encdec`` and
the cross-attention of ``models/attention.py`` on DTensors,
``launch.steps`` with ``enc_embeds`` and ``enc_out``) against the JAX
package's meshless steps and the port's, on the CPU.

Gloo worlds of 4 ranks, one per mesh shape, ``(2, 2)``, ``(4, 1)`` and
``(1, 4)`` over ``("data", "model")``, started together with one JAX
reference process (4 host devices, for the pod mesh) in a module fixture:
ranks joined by a ``FileStore`` under ``tmp_path``, all processes joined
by one ``JOIN_S`` deadline from the fixture's start. The ``(2, 2)`` world,
the card's layout,
registers ``distributed/gloo_cuda.py``'s collectives for the CPU.

Configs (f32, 2 encoder and 2 decoder layers, 16 frames and 12 tokens,
so the cross-attention's ``Sq != Sk``): reduced seamless-m4t-medium (d
64, 4 q and 4 kv heads of 16, vocab 256: the vocab rows over ``model``);
``heads6`` (d 48, 6 and 6 heads of 8, vocab 255: ``model`` = 4 divides
neither the heads, so every rank takes every head of a replicated K/V,
nor the vocab, so the embedding stays replicated); ``gqa`` (d 64, 8 q
heads and 2 kv heads of 8: on ``(1, 4)`` each rank's two q heads read one
kv head sliced from a replicated K/V, whose gradient comes back partial
over ``model``). Each over 3 train steps from JAX's parameters against
JAX's ``make_train_step`` and the port's meshless step: losses and
gradient norms within 1e-5 relative, parameters within 1e-4 relative L2
(``heads6`` on ``(2, 2)`` and ``(1, 4)``, ``gqa`` on ``(1, 4)``, where
they reach a layout reduced seamless does not);
every carried leaf keeps its placements; what the flash and decode
kernels were given (each rank's whole local heads and rows, non-causal
at ``Sq != Sk`` in cross-attention). Serving: the prefill and decode
bundles, the encoder output from ``make_prefill_step(with_enc_out=True)``
placed by ``batch_specs``' ``enc_out`` spec; teacher-forced logits
within 1e-4 of JAX's ``make_prefill_step`` / ``make_serve_step``
(``encdec.dec_prefill`` / ``dec_decode_step``), greedy tokens equal to
the meshless ``ModelServer``'s, the caches in their specs' placements.
Also: batches of 1 and 3 on ``(2, 2)`` (at 1 the sequence-sharded
cache); the ``(2, 2, 1)`` pod mesh, plain and int8-compressed, against
JAX's steps; ``TrainLoop(mesh=)`` bit for bit ``make_train_step``.
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
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.optim import adamw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCH = "seamless-m4t-medium"
# name -> the changes to the reduced config
CONFIGS = {"seamless": {},
           "heads6": dict(d_model=48, n_heads=6, n_kv_heads=6, head_dim=8,
                          d_ff=96, vocab_size=255),
           "gqa": dict(n_heads=8, n_kv_heads=2, head_dim=8)}
LR = 1e-3
STEPS = 3
# One deadline for every process a fixture starts, counted from the
# fixture's start, and the ranks' gloo timeout: over 3x the slowest
# world fixture seen (276 s, the gloo test modules run together on 6
# xdist workers over 8 cores).
JOIN_S = 900
WORLDS = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
# the configs each world runs: the others reach no other layout there
# (on (4, 1) no model axis; gqa's kv heads divide (2, 2)'s model axis)
RUNS = {"2x2": ("seamless", "heads6"), "4x1": ("seamless",),
        "1x4": ("seamless", "heads6", "gqa")}
CASES = [(w, n) for w, names in RUNS.items() for n in names]
UNEVEN = (1, 3)          # batches (2, 2)'s data axis does not split evenly
FRAMES, TOKENS = 16, 12  # encoder frames, decoder tokens a row
PROMPT, CACHE, N = 6, 16, 5


def _cfg(reduce, get, name):
    return dataclasses.replace(reduce(get(ARCH)), **CONFIGS[name])


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
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as tmesh, steps
    from repro_torch.launch.train import TrainLoop
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

    # what the attention kernels are given: (kernel, causal, q, k shapes)
    seen = []
    flash, decode = ops.flash_attention, ops.decode_attention

    def spy_flash(q, k, v, **kw):
        seen.append(("flash", kw["causal"], tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    def spy_decode(q, k, v, *a, **kw):
        seen.append(("decode", None, tuple(q.shape), tuple(k.shape)))
        return decode(q, k, v, *a, **kw)

    ops.flash_attention, ops.decode_attention = spy_flash, spy_decode

    def cfg_of(name):
        return dataclasses.replace(reduced(get_config(d["arch"])),
                                   **d["configs"][name])

    def full(tree):
        return [t.full_tensor().double().numpy()
                for _, t in tree_flatten_with_path(tree)]

    def placed_as_specs(tree, specs, mesh):
        return all(tuple(t.placements) == sharding.placements(mesh, s)
                   for t, s in zip((t for _, t in
                                    tree_flatten_with_path(tree)),
                                   sharding.spec_leaves(specs)))

    def inputs(key, cfg):
        # d[key]; the batch and the served inputs at the config's width
        v = d[key]
        return v[cfg.d_model] if key in ("batch", "serve") else v

    def train(name, bname, mesh, compress=False):
        cfg = cfg_of(name)
        p0 = convert.lm_params(d["params"][name], cfg, "cpu")
        pspecs = sharding.param_specs(p0, mesh)
        p = sharding.distribute(p0, mesh, pspecs)
        s = adamw.adamw_init(p, ocfg)
        ospecs = sharding.opt_specs(s, mesh)
        step = steps.make_train_step(cfg, ocfg, mesh=mesh,
                                     compress_crosspod=compress)
        out_ = {"losses": [], "grad_norms": [], "params": [], "placed": []}
        batch = {k: torch.from_numpy(v)
                 for k, v in inputs(bname, cfg).items()}
        for i in range(d["steps"]):
            del seen[:]
            p, s, m = step(p, s, batch)
            if i == 0:
                out_["kernels"] = list(seen)
            out_["losses"].append(float(m["loss"]))
            out_["grad_norms"].append(float(m["grad_norm"]))
            out_["params"].append(full(p))
            out_["placed"].append(placed_as_specs(p, pspecs, mesh)
                                  and placed_as_specs(s, ospecs, mesh))
        return out_

    def serve(name, sname, mesh):
        cfg = cfg_of(name)
        frames, toks = inputs(sname, cfg)
        B = toks.shape[0]
        P, C, N = d["prompt"], d["cache"], d["n"]
        p0 = convert.lm_params(d["params"][name], cfg, "cpu")
        srv = ModelServer(cfg, p0, batch=B, cache_len=C,
                          enc_len=frames.shape[1])
        srv.prefill(toks[:, :P], frames)
        srv.decode(N)
        pb = steps.build_step_bundle(cfg, ShapeSpec("prompt", P, B,
                                                    "prefill"), mesh,
                                     cache_len=C)
        db = steps.build_step_bundle(cfg, ShapeSpec("serve", C, B,
                                                    "decode"), mesh)
        with_enc = steps.make_prefill_step(cfg, C, with_enc_out=True)
        params, emb, prompt = pb.place(p0, torch.from_numpy(frames),
                                       torch.from_numpy(toks[:, :P]))
        o = {"want": np.array(srv.generated), "placed": [],
             "enc_placed": True, "same_prefill": True}

        def run(teacher):
            del seen[:]
            logits, caches = pb.fn(params, emb, prompt)
            n_pf = len(seen)
            # the encoder's output a server keeps for the decode bundle
            l2, _, enc_out = with_enc(params, emb, prompt)
            o["same_prefill"] &= torch.equal(l2.full_tensor(),
                                             logits.full_tensor())
            enc = sharding.distribute(enc_out, mesh, db.in_specs[4])
            o["enc_placed"] &= tuple(enc.placements) == sharding.placements(
                mesh, db.in_specs[4])
            o["placed"].append(placed_as_specs(caches, db.in_specs[1], mesh))
            got = [logits.full_tensor()]
            pos = torch.full((B,), P, dtype=torch.int32)
            for i in range(N):
                tok = (torch.from_numpy(toks[:, P + i]) if teacher else
                       torch.argmax(got[-1], -1).to(torch.int32))
                n0 = len(seen)
                logits, caches = db.fn(
                    params, caches,
                    sharding.distribute(tok, mesh, db.in_specs[2]),
                    sharding.distribute(pos, mesh, db.in_specs[3]), enc)
                if i == 0 and teacher:
                    o["kernels_decode"] = seen[n0:]
                o["placed"].append(placed_as_specs(caches, db.out_specs[1],
                                                   mesh))
                got.append(logits.full_tensor())
                pos = pos + 1
            if teacher:
                o["kernels_prefill"] = seen[:n_pf]
            return torch.stack(got)

        o["teacher"] = run(True).numpy()
        o["greedy"] = torch.argmax(run(False), -1).T.numpy()
        return o

    try:
        mesh = tmesh.make_mesh(shape, ("data", "model"), device_type="cpu")
        for name in d["runs"][d["world_of"][shape]]:
            res["train"][name] = train(name, "batch", mesh)
            res["serve"][name] = serve(name, "serve", mesh)
        # TrainLoop(mesh=): the same steps as make_train_step
        cfg = cfg_of("seamless")
        p0 = convert.lm_params(d["params"]["seamless"], cfg, "cpu")
        loop = TrainLoop(cfg, opt_cfg=ocfg, mesh=mesh, device="cpu")
        loop.params = sharding.distribute(p0, mesh,
                                          sharding.param_specs(p0, mesh))
        loop.opt_state = adamw.adamw_init(loop.params, ocfg)
        ran = loop.run(iter([inputs("batch", cfg)] * d["steps"]),
                       steps=d["steps"], log_every=0)
        res["loop"] = ([h["loss"] for h in ran["history"]],
                       full(loop.params))
        if shape == (2, 2):
            res["uneven"] = {b: {"train": train("seamless", f"batch{b}",
                                                mesh),
                                 "serve": serve("seamless", f"serve{b}",
                                                mesh)}
                             for b in d["uneven"]}
            pod = tmesh.make_mesh((2, 2, 1), ("pod", "data", "model"),
                                  device_type="cpu")
            res["pod"] = {c: train("seamless", "batch", pod, compress=c)
                          for c in (False, True)}
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
""").replace("JOIN_S", str(JOIN_S))

JAX_REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.compat import make_mesh
    from repro.configs.base import reduced
    from repro.configs.registry import get_config
    from repro.launch import steps
    from repro.models import encdec
    from repro.optim.adamw import AdamWConfig, adamw_init

    with open(sys.argv[1], "rb") as f:
        d = pickle.load(f)
    ocfg = AdamWConfig(lr=d["lr"], warmup_steps=0)
    res = {"train": {}, "serve": {}}

    def cfg_of(name):
        return dataclasses.replace(reduced(get_config(d["arch"])),
                                   **d["configs"][name])

    def inputs(key, cfg):
        v = d[key]
        return v[cfg.d_model] if key in ("batch", "serve") else v

    def train(name, bname, mesh=None):
        cfg = cfg_of(name)
        step = jax.jit(steps.make_train_step(cfg, ocfg, mesh=mesh,
                                             compress_crosspod=mesh
                                             is not None))
        p = jax.tree_util.tree_map(jnp.asarray, d["params"][name])
        s = adamw_init(p, ocfg)
        batch = {k: jnp.asarray(v) for k, v in inputs(bname, cfg).items()}
        out = {"losses": [], "grad_norms": [], "params": []}
        for _ in range(d["steps"]):
            if mesh is None:
                p, s, m = step(p, s, batch)
            else:
                with mesh:
                    p, s, m = step(p, s, batch)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            out["params"].append([np.asarray(x, np.float64)
                                  for x in jax.tree_util.tree_leaves(p)])
        return out

    def teacher(name, sname):
        cfg = cfg_of(name)
        frames, toks = inputs(sname, cfg)
        P, C, N = d["prompt"], d["cache"], d["n"]
        p = jax.tree_util.tree_map(jnp.asarray, d["params"][name])
        pf = jax.jit(steps.make_prefill_step(cfg, C))
        sv = jax.jit(steps.make_serve_step(cfg))
        logits, caches = pf(p, jnp.asarray(frames), jnp.asarray(toks[:, :P]))
        enc = encdec.encode(p, cfg, jnp.asarray(frames))
        got = [logits]
        for i in range(N):
            pos = jnp.full((toks.shape[0],), P + i, jnp.int32)
            logits, caches = sv(p, caches, jnp.asarray(toks[:, P + i]), pos,
                                enc)
            got.append(logits)
        return np.stack([np.asarray(g, np.float64) for g in got])

    for name in d["configs"]:
        res["train"][name] = train(name, "batch")
        res["serve"][name] = teacher(name, "serve")
    for b in d["uneven"]:
        res["train"][f"seamless/{b}"] = train("seamless", f"batch{b}")
        res["serve"][f"seamless/{b}"] = teacher("seamless", f"serve{b}")
    res["pod_int8"] = train("seamless", "batch",
                            make_mesh((2, 2, 1), ("pod", "data", "model")))
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


def _frames(rng, b, d):
    e = rng.standard_normal((b, FRAMES, d))
    return (e / np.sqrt((e * e).mean(-1, keepdims=True))).astype(np.float32)


def _inputs(rng, b, d, vocab):
    """A train batch and served (frames, tokens) of ``b`` rows at width
    ``d``; every config's vocab holds the tokens."""
    batch = {"enc_embeds": _frames(rng, b, d)}
    batch.update({k: rng.integers(0, vocab, (b, TOKENS)).astype(np.int32)
                  for k in ("tokens", "targets")})
    serve = (_frames(rng, b, d),
             rng.integers(0, vocab, (b, PROMPT + N)).astype(np.int32))
    return batch, serve


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds and JAX's reference, run together once for the
    module: (inputs, {world: [rank results]}, JAX's results)."""
    start = time.monotonic()
    tmp = tmp_path_factory.mktemp("encdec_worlds")
    params = {}
    for name in CONFIGS:
        jc = _cfg(j_reduced, j_get_config, name)
        params[name] = jax.tree_util.tree_map(
            np.asarray, j_steps.init_params(jax.random.PRNGKey(0), jc))
    widths = {_cfg(reduced, get_config, n).d_model for n in CONFIGS}
    assert len(widths) == 2            # the frames are drawn per width
    vocab = min(_cfg(reduced, get_config, n).vocab_size for n in CONFIGS)
    rng = np.random.default_rng(23)
    d = {"arch": ARCH, "configs": CONFIGS, "runs": RUNS,
         "world_of": {v: k for k, v in WORLDS.items()}, "lr": LR,
         "steps": STEPS,
         "params": params, "prompt": PROMPT, "cache": CACHE, "n": N,
         "uneven": UNEVEN}
    # one batch and one set of served inputs per width
    for key in ("batch", "serve"):
        d[key] = {}
    for w in sorted(widths):
        d["batch"][w], d["serve"][w] = _inputs(rng, 4, w, vocab)
    for b in UNEVEN:
        d[f"batch{b}"], d[f"serve{b}"] = _inputs(rng, b, 64, vocab)
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


def _plain_of(d, name, bname):
    """The port's meshless step from JAX's parameters: per step (loss,
    gradient norm, parameters)."""
    if (name, bname) in _PLAIN:
        return _PLAIN[(name, bname)]
    cfg = _cfg(reduced, get_config, name)
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=0)
    step = steps.make_train_step(cfg, ocfg)
    p = convert.lm_params(d["params"][name], cfg, "cpu")
    s = adamw.adamw_init(p, ocfg)
    raw = d[bname][cfg.d_model] if bname == "batch" else d[bname]
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    out = []
    for _ in range(STEPS):
        p, s, m = step(p, s, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    [t.double().numpy() for _, t in
                     tree_flatten_with_path(p)]))
    _PLAIN[(name, bname)] = out
    return out


def _check_train(res, jres, plain):
    """A mesh run against JAX's meshless run and the port's: losses and
    gradient norms within 1e-5 relative, parameters within 1e-4 relative
    L2 after every step."""
    for want in (jres["losses"], [r[0] for r in plain]):
        np.testing.assert_allclose(res["losses"], want, rtol=1e-5)
    for want in (jres["grad_norms"], [r[1] for r in plain]):
        np.testing.assert_allclose(res["grad_norms"], want, rtol=1e-5)
    for i in range(STEPS):
        assert _rel_l2(res["params"][i], jres["params"][i]) <= 1e-4
        assert _rel_l2(res["params"][i], plain[i][2]) <= 1e-4


@pytest.mark.parametrize("world,name", CASES)
def test_encdec_train_steps_match_jax_and_the_meshless_step(
        worlds, world, name):
    """Three steps on the mesh against JAX's meshless step and the
    port's (``_check_train``); every rank reads the same losses and
    gradient norms."""
    d, ranks, jres = worlds
    res = ranks[world][0]["train"][name]
    for r in range(4):
        got = ranks[world][r]["train"][name]
        assert (got["losses"], got["grad_norms"]) == (res["losses"],
                                                      res["grad_norms"])
    _check_train(res, jres["train"][name], _plain_of(d, name, "batch"))


@pytest.mark.parametrize("world", list(WORLDS))
def test_encdec_carried_leaves_keep_their_placements(worlds, world):
    """Parameters and optimizer state in their specs' placements after
    every step of every case (the pod mesh's and the uneven batches'
    too)."""
    _, ranks, _ = worlds
    for res in ranks[world]:
        runs = list(res["train"].values())
        runs += [u["train"] for u in res.get("uneven", {}).values()]
        runs += list(res.get("pod", {}).values())
        assert runs
        for run in runs:
            assert all(run["placed"])


def _local_heads(name, world):
    """(q heads, kv heads) each rank gives a kernel: its share where
    ``model`` divides the heads (``sharding.head_layout``), one kv head
    sliced from a replicated K/V where it divides the q heads only,
    every head otherwise."""
    cfg = _cfg(reduced, get_config, name)
    lay = ts.head_layout(ts.AbstractMesh(WORLDS[world], ("data", "model")),
                         cfg.n_heads, cfg.n_kv_heads)
    return lay.hq_local, lay.kv_local


@pytest.mark.parametrize("world,name", CASES)
def test_attention_kernels_see_whole_local_heads(worlds, world, name):
    """What the kernels were given on every rank: in the first train step
    and the prefill, the flash kernel per encoder layer (non-causal over
    the frames), per decoder layer self-attention (causal over the
    tokens) then cross-attention (non-causal, ``Sq`` tokens over ``Sk``
    frames); in a decode step, per decoder layer the decode kernel over
    the cache then over every frame. Each call on the rank's rows of the
    batch and its whole local heads."""
    _, ranks, _ = worlds
    data = WORLDS[world][0]
    cfg = _cfg(reduced, get_config, name)
    hq, hkv = _local_heads(name, world)
    D = cfg.hd

    def flash_calls(b, s):
        enc = [("flash", False, (b, FRAMES, hq, D), (b, FRAMES, hkv, D))]
        dec = [("flash", True, (b, s, hq, D), (b, s, hkv, D)),
               ("flash", False, (b, s, hq, D), (b, FRAMES, hkv, D))]
        return enc * cfg.encoder_layers + dec * cfg.n_layers

    b = 4 // data
    assert hq < cfg.n_heads or WORLDS[world][1] == 1 or name == "heads6"
    for res in ranks[world]:
        assert res["train"][name]["kernels"] == flash_calls(b, TOKENS)
        sv = res["serve"][name]
        assert sv["kernels_prefill"] == flash_calls(b, PROMPT)
        assert sv["kernels_decode"] == [
            ("decode", None, (b, hq, D), (b, CACHE, hkv, D)),
            ("decode", None, (b, hq, D), (b, FRAMES, hkv, D))
        ] * cfg.n_layers


@pytest.mark.parametrize("world,name", CASES)
def test_encdec_teacher_forced_logits_match_jax(worlds, world, name):
    """The prefill bundle then 5 decode-bundle steps fed the given next
    tokens: every step's logits within 1e-4 of JAX's prefill and serve
    steps on the same inputs, on every rank; the encoder output from
    ``make_prefill_step(with_enc_out=True)`` (the prefill bundle's logits
    bit for bit) placed by the ``enc_out`` spec."""
    _, ranks, jres = worlds
    want = jres["serve"][name]
    for res in ranks[world]:
        sv = res["serve"][name]
        assert sv["same_prefill"] and sv["enc_placed"]
        np.testing.assert_allclose(sv["teacher"], want, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("world,name", CASES)
def test_encdec_decode_bundles_equal_the_meshless_server(
        worlds, world, name):
    """Greedy decoding through the bundles on the mesh: the tokens equal
    the meshless ``ModelServer``'s; the caches keep their specs'
    placements after the prefill and every step."""
    _, ranks, _ = worlds
    for res in ranks[world]:
        sv = res["serve"][name]
        np.testing.assert_array_equal(sv["greedy"], sv["want"])
        assert all(sv["placed"])


@pytest.mark.parametrize("world", list(WORLDS))
def test_encdec_train_loop_on_the_mesh_is_make_train_step(worlds, world):
    """``TrainLoop(mesh=)`` over reduced seamless: bit for bit the steps
    of ``make_train_step`` on the same mesh."""
    _, ranks, _ = worlds
    for res in ranks[world]:
        losses, params = res["loop"]
        assert losses == res["train"]["seamless"]["losses"]
        for a, b in zip(params, res["train"]["seamless"]["params"][-1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("b", UNEVEN)
def test_encdec_uneven_batches_on_2x2(worlds, b):
    """Batches of 1 and 3 on (2, 2): ``data`` does not divide them, so
    the activations and the encoder output stay replicated over it (at 1
    the decoder cache's sequence goes over ``data``). Training against
    both references; the teacher-forced logits against JAX's, the greedy
    tokens against ``ModelServer``'s, the caches in their placements."""
    d, ranks, jres = worlds
    u = ranks["2x2"][0]["uneven"][b]
    _check_train(u["train"], jres["train"][f"seamless/{b}"],
                 _plain_of(d, "seamless", f"batch{b}"))
    for res in ranks["2x2"]:
        sv = res["uneven"][b]["serve"]
        np.testing.assert_allclose(sv["teacher"],
                                   jres["serve"][f"seamless/{b}"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], sv["want"])
        assert all(sv["placed"]) and sv["same_prefill"]


def test_encdec_cache_specs_on_the_uneven_batch():
    """The decoder cache's specs on (2, 2) at 4 and 1 slots: the batch
    over ``data`` and the kv heads over ``model``, or at one slot the
    sequence over ``data``: the layouts the serving cases above ran."""
    cfg = _cfg(reduced, get_config, "seamless")
    mesh = ts.AbstractMesh((2, 2), ("data", "model"))
    for b, want in ((4, (None, "data", None, "model")),
                    (1, (None, None, "data", "model"))):
        cs = ts.cache_specs_tree(steps.cache_struct(cfg, b, CACHE), cfg,
                                 mesh, b)
        assert tuple(cs["k"]) == tuple(cs["v"]) == want


@pytest.mark.parametrize("compress", [False, True])
def test_encdec_pod_axis_composes_with_data(worlds, compress):
    """A (2, 2, 1) mesh over ("pod", "data", "model"): the uncompressed
    step (the batch over pod and data) within the module's tolerance of
    JAX's meshless step; the int8 pod reduce against JAX's compressed
    step on four host devices: losses and gradient norms within 1e-5,
    every element within the 3 steps' bound of ``2·lr`` a step and all
    but 1e-3 of them within ``1e-2·lr`` (an int8 code can flip at a
    rounding boundary, ``tests/test_torch_distributed.py``); every rank
    reads the same losses."""
    d, ranks, jres = worlds
    res = ranks["2x2"][0]["pod"][compress]
    for r in range(4):
        assert ranks["2x2"][r]["pod"][compress]["losses"] == res["losses"]
    if not compress:
        _check_train(res, jres["train"]["seamless"],
                     _plain_of(d, "seamless", "batch"))
        return
    want = jres["pod_int8"]
    np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(res["grad_norms"], want["grad_norms"],
                               rtol=1e-5)
    flips = total = 0
    for got, exp in zip(res["params"], want["params"]):
        for a, b in zip(got, exp):
            diff = np.abs(a - b)
            assert diff.max() <= STEPS * 2 * LR
            flips += int((diff > 1e-2 * LR).sum())
            total += diff.size
    assert flips <= 1e-3 * total, (flips, total)
