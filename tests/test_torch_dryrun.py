"""The production-mesh dry run (``repro_torch.launch.dryrun``) on the CPU,
on fake CPU tensors (the kernels' plain versions, as JAX's dry run takes
on its CPU placeholder devices).

* (a) Every registered arch × shape × production mesh at one layer
  period: the argument bytes rank 0 holds once ``StepBundle.place`` has
  placed fake arguments on a fake world of 256 or 512 ranks equal the
  bytes JAX's ``build_step_bundle`` structs and specs give on
  ``make_abstract_mesh`` (each leaf's ``∏ ceil(dim / axis size) ×
  itemsize``); no step traced. One process per world, 300 s each.
* (b) The collective bytes, by kind and by mesh axis, of a train and a
  decode step counted by ``StepCounter`` on a fake ``(2, 2)`` world
  equal those counted on a real 4-rank gloo world (reduced qwen2-1.5b at
  1 layer; reduced granite with its experts over ``data``, whose local
  groups exchange by all-to-all), all joined by one ``JOIN_S`` deadline.
* (c) A meshless dense train step at ``remat='none'``: the counted FLOPs
  equal the sum of ``2·m·n·k`` over every product, forward and twice
  that backward, within 0.1 %.
* (d) The attention kernels' torch ops on ``meta`` tensors: the kernels'
  output shapes, and FLOP formulas equal to hand counts.
* (e) Every arch's train, prefill and decode steps trace under
  ``FakeTensorMode`` with no host sync (``_local_scalar_dense``); a
  non-finite step keeps the state bit for bit and reports a tensor
  ``skipped == 1``.
* (g) The vocab-parallel loss at qwen2-1.5b ``train_4k``'s logits on
  the fake ``pod`` world: its peak at most four local shards, nothing
  with the whole vocab or microbatch, only its all-reduces; and that
  cell at one layer period fits the card.
* (h) JAX's streaming layout (``--attn-block 512``) at qwen2-1.5b
  ``train_4k`` on the fake ``pod`` at one period: the traced rank is the
  last ``model`` coordinate's (its causal rows keep the most pairs), its
  argument bytes are the cell's without the option, its flash calls take
  256 query rows at that rank's offset, and nothing at its peak holds a
  local-batch × heads × 4096² score tensor; a later cell in the same
  process (rank 0 again) runs.
* (f) The CLI with ``--device cpu`` on one small cell writes a cell with
  JAX's keys and the port's listed additions, and runs two cells one
  after another in one process; ``--device cuda`` without a CUDA build
  of torch refuses; with ``--attn-block`` the cells go to their own
  directory.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
from jax.sharding import PartitionSpec as P

from repro.compat import make_abstract_mesh
from repro.configs import base as j_base
from repro.configs.registry import get_config as j_get_config
from repro.launch import steps as j_steps
from repro_torch.configs.base import ShapeSpec, reduced, scale_layers
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.distributed import sharding as ts
from repro_torch.kernels import decode_attention, flash_attention  # noqa
from repro_torch.launch import dryrun, steps
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.optim.adamw import AdamWConfig, adamw_init

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCHS = list_archs()
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
# One deadline for every process a fixture starts, counted from the
# fixture's start (and the gloo ranks' timeout): over 3x the slowest
# world fixture seen (276 s, the gloo test modules run together on 6
# xdist workers over 8 cores; these two took up to 108 s and 37 s).
WORLD_S = 900        # the two fake worlds (every arch × shape)
JOIN_S = 900         # the (2, 2) world and the fake world beside it

# JAX's run_cell keys, and what the port's cell adds to them
JAX_KEYS = {"arch", "shape", "mesh", "rules", "status", "skip_reason",
            "kind", "accum", "remat", "attn_block", "n_chips",
            "measure_mode", "raw_full_compile", "lower_s", "compile_s",
            "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collectives", "compute_s",
            "memory_s", "collective_s", "dominant", "step_s_est", "params",
            "params_active", "model_flops_per_device", "useful_flop_ratio",
            "roofline_frac", "memory"}
PORT_KEYS = {"device", "fits", "peak_live", "collectives_by_axis",
             "collective_links", "datasheet", "flops_model_rank"}
JAX_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "alias_bytes"}


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


def _run(cmd, timeout, what):
    p = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, f"{what}: {p.stderr[-3000:]}"
    return p


# ---------------------------------------------------------------------------
# (a) argument bytes on the production meshes against JAX's specs
# ---------------------------------------------------------------------------

PLACE = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import SHAPES, scale_layers
    from repro_torch.configs.registry import get_config, list_archs
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_step_bundle

    mesh_kind, out = sys.argv[1], sys.argv[2]
    res = {}
    with dryrun.fake_world(mesh_kind, "cpu") as mesh:
        for arch in list_archs():
            cfg = scale_layers(get_config(arch), 1)
            for shape in SHAPES:
                if not dryrun.applicable(cfg, shape)[0]:
                    continue
                b = build_step_bundle(cfg, shape, mesh)
                with FakeTensorMode():
                    args = tuple(dryrun._fake_args(s, "cpu")
                                 for s in b.arg_structs)
                    placed, _ = dryrun.place_arguments(b, args)
                    res[f"{arch}/{shape}"] = dryrun.argument_bytes(placed)
    with open(out, "w") as f:
        json.dump(res, f)
""")


@pytest.fixture(scope="module")
def placed_bytes(tmp_path_factory):
    """{mesh: {"arch/shape": rank 0's argument bytes}}, one fake world a
    process, both worlds at once."""
    start = time.monotonic()
    tmp = tmp_path_factory.mktemp("dryrun_place")
    (tmp / "place.py").write_text(PLACE)
    procs = {m: subprocess.Popen(
        [sys.executable, str(tmp / "place.py"), m, str(tmp / f"{m}.json")],
        env=_env(), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for m in MESHES}
    try:
        for m, p in procs.items():
            try:
                _, err = p.communicate(
                    timeout=max(start + WORLD_S - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"the {m} world did not end {WORLD_S} "
                                     f"s after the fixture began")
            assert p.returncode == 0, f"{m} world: {err[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {m: json.loads((tmp / f"{m}.json").read_text()) for m in MESHES}


def _jax_bytes(arch, shape, mesh_kind):
    """Per-device bytes of JAX's bundle arguments: each leaf's
    ``∏ ceil(dim / axis size) × itemsize`` under its in_spec."""
    dims, axes = MESHES[mesh_kind]
    sizes = dict(zip(axes, dims))
    jb = j_steps.build_step_bundle(j_base.scale_layers(j_get_config(arch),
                                                       1),
                                   shape, make_abstract_mesh(dims, axes))

    def one(spec, sub):
        total = 0
        for leaf in jax.tree_util.tree_leaves(sub):
            n = np.dtype(leaf.dtype).itemsize
            ents = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
            for d, e in zip(leaf.shape, ents):
                names = (e,) if isinstance(e, str) else (e or ())
                n *= -(-d // math.prod(sizes[a] for a in names))
            total += n
        return total

    per = jax.tree_util.tree_map(one, jb.in_specs, jb.arg_structs,
                                 is_leaf=lambda x: isinstance(x, P))
    return sum(jax.tree_util.tree_leaves(per))


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_jax_specs(placed_bytes, arch, mesh_kind):
    jcfg = j_get_config(arch)
    for shape in j_base.SHAPES:
        # JAX's applicable: long_500k needs a sub-quadratic path
        jax_ok = shape != "long_500k" or jcfg.long_context_ok
        assert dryrun.applicable(get_config(arch), shape)[0] == jax_ok
        key = f"{arch}/{shape}"
        assert (key in placed_bytes[mesh_kind]) == jax_ok
        if jax_ok:
            assert placed_bytes[mesh_kind][key] == _jax_bytes(
                arch, shape, mesh_kind), key


# ---------------------------------------------------------------------------
# (b) collective bytes: a fake (2, 2) world against a real gloo one
# ---------------------------------------------------------------------------

COUNT = textwrap.dedent("""
    import dataclasses, pickle, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs.base import ShapeSpec, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step_bundle, init_params
    from repro_torch.models.tree import tree_flatten_with_path, tree_unflatten
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    CASES = {
        "qwen2": reduced(get_config("qwen2-1.5b"), layers=1),
        "granite": dataclasses.replace(
            reduced(get_config("granite-moe-3b-a800m"), layers=1),
            moe_groups=2)}
    SHAPES = {"train": ShapeSpec("t", 16, 4, "train"),
              "decode": ShapeSpec("d", 32, 4, "decode")}

    def counts(c):
        return {"kinds": c.collectives, "axes": c.by_axis,
                "n": c.n_collectives}

    rank, out = int(sys.argv[1]), sys.argv[2]
    res = {}
    if rank < 0:                                     # the fake world
        with dryrun.fake_world("2x2", "cpu") as mesh:
            for name, cfg in CASES.items():
                for kind, ss in SHAPES.items():
                    tr = dryrun.trace_step(cfg, ss, mesh, "cpu")
                    res[f"{name}/{kind}"] = counts(tr["counter"])
    else:                                            # a gloo rank
        dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], 4),
                                rank=rank, world_size=4,
                                timeout=timedelta(seconds=JOIN_S))
        from repro_torch.distributed import gloo_cuda
        gloo_cuda.install("CPU")
        try:
            mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
            rng = np.random.default_rng(5)
            for name, cfg in CASES.items():
                params = init_params(torch.Generator().manual_seed(3), cfg)
                for kind, ss in SHAPES.items():
                    b = build_step_bundle(cfg, ss, mesh,
                                          opt_cfg=AdamWConfig())
                    rest = []
                    for st in b.arg_structs[1:]:
                        leaves = []
                        for _, t in tree_flatten_with_path(st):
                            if t.dtype.is_floating_point:
                                leaves.append(torch.zeros(t.shape,
                                                          dtype=t.dtype))
                            else:
                                leaves.append(torch.tensor(rng.integers(
                                    0, 8, t.shape), dtype=t.dtype))
                        rest.append(tree_unflatten(st, leaves))
                    if kind == "train":
                        rest[0] = adamw_init(params, AdamWConfig())
                    _, given = dryrun.place_arguments(b, (params, *rest))
                    with dryrun.StepCounter(mesh) as c:
                        b.fn(*given)
                    res[f"{name}/{kind}"] = counts(c)
        finally:
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
""").replace("JOIN_S", str(JOIN_S))


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """(the fake world's counts, each gloo rank's), run together."""
    start = time.monotonic()
    tmp = tmp_path_factory.mktemp("dryrun_count")
    (tmp / "count.py").write_text(COUNT)
    procs = [(f"rank {r}", subprocess.Popen(
        [sys.executable, str(tmp / "count.py"), str(r),
         str(tmp / f"out{r}.pkl"), str(tmp / "store")], env=_env(),
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for r in (-1, 0, 1, 2, 3)]
    try:
        for name, p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(start + JOIN_S - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name} did not end {JOIN_S} s after "
                                     f"the fixture began")
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = {r: pickle.loads((tmp / f"out{r}.pkl").read_bytes())
           for r in (-1, 0, 1, 2, 3)}
    return out[-1], [out[r] for r in range(4)]


@pytest.mark.parametrize("case", ["qwen2/train", "qwen2/decode",
                                  "granite/train", "granite/decode"])
def test_collective_bytes_fake_world_equal_gloo_world(counted, case):
    fake, ranks = counted
    assert fake[case]["n"] > 0
    # every real rank issues the collectives rank 0 does
    for r in ranks:
        assert r[case] == ranks[0][case]
    assert fake[case]["kinds"] == ranks[0][case]["kinds"]
    assert fake[case]["axes"] == ranks[0][case]["axes"]
    if case == "granite/train":          # EP: local groups exchange
        assert fake[case]["kinds"]["all-to-all"] > 0
        assert fake[case]["axes"]["data"]["all-to-all"] > 0


# ---------------------------------------------------------------------------
# (c) counted FLOPs of a meshless dense train step
# ---------------------------------------------------------------------------

def test_train_flops_equal_the_sum_of_products():
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b"), layers=2),
                              remat="none")
    B, S = 2, 24
    tr = dryrun.trace_step(cfg, ShapeSpec("t", S, B, "train"), None, "cpu")
    T, d, hd = B * S, cfg.d_model, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    per_layer = (2 * T * d * hq * hd + 2 * 2 * T * d * hkv * hd   # q, k, v
                 + 2 * T * hq * hd * d                           # o
                 + 2 * 2 * B * hq * S * S * hd                   # QK^T, PV
                 + 3 * 2 * T * d * cfg.d_ff)                     # mlp
    forward = cfg.n_layers * per_layer + 2 * T * d * cfg.vocab_size  # head
    want = 3 * forward                    # backward: twice the forward
    got = tr["counter"].flops
    assert abs(got - want) <= 1e-3 * want, (got, want)


# ---------------------------------------------------------------------------
# (d) the attention ops on meta tensors
# ---------------------------------------------------------------------------

def _pairs(Sq, Sk, causal, window, q_offset=None):
    """(query, key) pairs kept, one by one, as the plain version masks."""
    n = 0
    for i in range(Sq):
        pos = i + (Sk - Sq if q_offset is None else q_offset)
        for j in range(Sk):
            if causal and j > pos:
                continue
            if window is not None and j <= pos - window:
                continue
            n += 1
    return n


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (2, 32, 32, 8, 2, 64, True, None),        # causal prefill
    (1, 40, 40, 4, 4, 128, True, 16),         # sliding window
    (2, 24, 56, 6, 2, 64, True, 10),          # window, Sq < Sk
    (3, 17, 50, 4, 1, 32, False, None),       # non-causal, cross shapes
    (1, 12, 30, 2, 2, 16, False, 8),          # non-causal window
])
def test_flash_op_on_meta_shape_and_flops(B, Sq, Sk, Hq, Hkv, D, causal,
                                          window):
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.empty(B, Sq, Hq, D, device="meta", dtype=torch.bfloat16)
    k = torch.empty(B, Sk, Hkv, D, device="meta", dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fc:
        out = torch.ops.repro_torch.flash_attention_fwd(q, k, k, causal,
                                                        window, D ** -0.5)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert fc.get_total_flops() == 4 * B * Hq * D * _pairs(Sq, Sk, causal,
                                                           window)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window,q_offset", [
    (2, 32, 32, 8, 2, 64, True, None, None),  # causal prefill
    (1, 40, 40, 4, 4, 128, True, 16, None),   # sliding window
    (3, 17, 50, 4, 1, 32, False, None, None),  # non-causal, cross shapes
    (2, 48, 144, 6, 2, 16, True, 24, 48),     # a context-parallel rank
])
def test_flash_train_ops_on_meta_shape_and_flops(B, Sq, Sk, Hq, Hkv, D,
                                                causal, window, q_offset):
    """The training ops on meta tensors: ``flash_attention_fwd_lse`` gives
    the output and a (B, Hq, Sq) f32 log-sum-exp and counts the forward's
    ``4·B·Hq·D`` a kept pair; ``flash_attention_bwd`` gives dq, dk and dv
    shaped like q, k and v and counts its seven products, ``14·B·Hq·D`` a
    kept pair."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import flash_attention_bwd  # noqa: F401
    q = torch.empty(B, Sq, Hq, D, device="meta", dtype=torch.bfloat16)
    k = torch.empty(B, Sk, Hkv, D, device="meta", dtype=torch.bfloat16)
    pairs = _pairs(Sq, Sk, causal, window, q_offset)
    with FlopCounterMode(display=False) as fc:
        out, lse = torch.ops.repro_torch.flash_attention_fwd_lse(
            q, k, k, causal, window, D ** -0.5, q_offset)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    assert fc.get_total_flops() == 4 * B * Hq * D * pairs
    with FlopCounterMode(display=False) as fc:
        grads = torch.ops.repro_torch.flash_attention_bwd(
            out, q, k, k, out, lse, causal, window, D ** -0.5, q_offset)
    for g, t in zip(grads, (q, k, k)):
        assert g.shape == t.shape and g.dtype == t.dtype
    assert fc.get_total_flops() == 14 * B * Hq * D * pairs


@pytest.mark.parametrize("q_offset", [0, 16, 48, 96])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_flash_op_flops_at_a_query_offset(q_offset, causal, window):
    """A context-parallel rank's call (48 rows of a sequence of 144
    against all of its keys, the rows starting at ``q_offset``): the FLOP
    formula counts the pairs the plain version keeps at that offset, and
    without ``q_offset`` the right-aligned ones."""
    from torch.utils.flop_counter import FlopCounterMode
    B, Sq, Sk, Hq, Hkv, D = 2, 48, 144, 4, 2, 32
    q = torch.empty(B, Sq, Hq, D, device="meta", dtype=torch.bfloat16)
    k = torch.empty(B, Sk, Hkv, D, device="meta", dtype=torch.bfloat16)
    for off in (q_offset, None):
        with FlopCounterMode(display=False) as fc:
            out = torch.ops.repro_torch.flash_attention_fwd(
                q, k, k, causal, window, D ** -0.5, off)
        assert out.shape == q.shape
        assert fc.get_total_flops() == 4 * B * Hq * D * _pairs(
            Sq, Sk, causal, window, off)
        assert flash_attention.kept_pairs(Sq, Sk, causal, window,
                                          off) == _pairs(Sq, Sk, causal,
                                                         window, off)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,ring", [
    (4, 1000, 12, 2, 128, None, False),       # prefix
    (2, 64, 8, 8, 64, 16, False),             # prefix, window
    (3, 4096, 48, 8, 128, 4096, True),        # ring (mixtral's window)
])
def test_decode_op_on_meta_shape_and_flops(B, S, Hq, Hkv, D, window, ring):
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.empty(B, Hq, D, device="meta", dtype=torch.float32)
    kc = torch.empty(B, S, Hkv, D, device="meta", dtype=torch.float32)
    lengths = torch.empty(B, device="meta", dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        out = torch.ops.repro_torch.decode_attention(q, kc, kc, lengths,
                                                     window, D ** -0.5, ring)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert fc.get_total_flops() == 4 * B * Hq * D * S     # every slot read


def test_decode_op_fake_allocates_the_split_scratch():
    fake = dryrun._tracked_fake_mode("cpu")
    with fake:
        q = torch.empty(2, 8, 64)
        kc = torch.empty(2, 300, 2, 64)
        lengths = torch.empty(2, dtype=torch.int32)
        fake.tracking = True
        torch.ops.repro_torch.decode_attention(q, kc, kc, lengths, None,
                                               0.125, False)
        fake.tracking = False
    want = 4 * (2 * 2 * -(-300 // decode_attention.SPLIT) * 4 * 66)
    assert decode_attention.scratch_floats(2, 300, 8, 2, 64) * 4 == want
    assert fake.peak == want + 2 * 8 * 64 * 4      # scratch + output


def test_tracker_counts_new_storage_only():
    """Views of the arguments are no temporaries, and ``wait_tensor``'s
    output is its input, as on a real run (a fake one copies it)."""
    fake = dryrun._tracked_fake_mode("cpu")
    with fake:
        a = torch.empty(1000)                         # an argument
        fake.hold([a])
        fake.tracking = True
        v = a.detach().view(10, 100)                  # nothing new
        b = a * 2                                     # 4000 bytes
        w = torch.ops._c10d_functional.wait_tensor(b)
        c = w + v.view(-1)                            # 4000 more
        fake.tracking = False
    assert fake.peak == 8000 and c.shape == (1000,)


def test_stock_mem_tracker_misses_what_the_tracker_counts():
    """Why the dry run keeps its own tracker: ``MemTracker`` runs above
    the fake mode and does not see what an op's fake implementation
    allocates (the decode op's split scratch), which the tracker counts
    (``test_decode_op_fake_allocates_the_split_scratch``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    scratch = decode_attention.scratch_floats(2, 300, 8, 2, 64) * 4
    with FakeTensorMode():
        q = torch.empty(2, 8, 64)
        kc = torch.empty(2, 300, 2, 64)
        lengths = torch.empty(2, dtype=torch.int32)
        mt = MemTracker()
        with mt:
            torch.ops.repro_torch.decode_attention(q, kc, kc, lengths, None,
                                                   0.125, False)
    peak = mt.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
    assert peak < scratch


class _Seq(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_counter_without_decomposition_runs_the_step_as_it_is():
    """``StepCounter(decompose=False)``, as a mesh rank of the smoke
    counts a real training step: the ops under it are the step's own,
    one for one; with decomposition (the dry run's) they are not, and the
    counted FLOPs are the same products' either way."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                              n_layers=1, remat="none")
    ocfg = AdamWConfig()
    params = steps.init_params(torch.Generator().manual_seed(0), cfg)
    opt = adamw_init(params, ocfg)
    step = steps.make_train_step(cfg, ocfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 8)),
                             dtype=torch.int32)
             for k in ("tokens", "targets")}

    def seen(counter):
        rec = _Seq()
        with rec:
            if counter is None:
                step(params, opt, batch)
            else:
                with counter:
                    step(params, opt, batch)
        return rec.ops

    plain = seen(None)
    flat, deep = dryrun.StepCounter(decompose=False), dryrun.StepCounter()
    assert seen(flat) == plain
    assert seen(deep) != plain
    assert flat.flops == deep.flops > 0


# ---------------------------------------------------------------------------
# (e) no host sync in a step; the guard's select
# ---------------------------------------------------------------------------

class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_trace_on_fake_tensors_without_host_sync(arch, kind):
    from torch._subclasses.fake_tensor import FakeTensorMode
    full = get_config(arch)              # at the config's own dtypes,
    cfg = dataclasses.replace(reduced(full), dtype=full.dtype,  # as the
                              param_dtype=full.param_dtype)     # structs
    ss = ShapeSpec("s", 16, 2, kind)
    b = steps.build_step_bundle(cfg, ss, ts.AbstractMesh((1, 1),
                                                         ("data", "model")),
                                opt_cfg=AdamWConfig())
    rec = _Ops()
    with FakeTensorMode():
        args = tuple(dryrun._fake_args(s, "cpu") for s in b.arg_structs)
        with rec:
            out = b.fn(*args)
    assert torch.ops.aten._local_scalar_dense.default not in rec.seen
    assert all(torch.ops.aten.item.default is not f for f in rec.seen)
    if kind == "train":
        assert out[2]["skipped"].shape == ()


def test_nonfinite_step_keeps_the_state_bit_for_bit():
    cfg = reduced(get_config("qwen2-1.5b"))
    ocfg = AdamWConfig(lr=1e-3)
    params = steps.init_params(torch.Generator().manual_seed(0), cfg)
    params = {k: v for k, v in params.items()}
    step = steps.make_train_step(cfg, ocfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 8)),
                             dtype=torch.int32)
             for k in ("tokens", "targets")}
    _, warm, _ = step(params, adamw_init(params, ocfg), batch)
    poisoned = tree_flatten_with_path(params)
    leaves = [t.clone() for _, t in poisoned]
    leaves[0].view(-1)[0] = float("nan")
    from repro_torch.models.tree import tree_unflatten
    bad = tree_unflatten(params, leaves)
    p2, o2, m = step(bad, warm, batch)
    assert isinstance(m["skipped"], torch.Tensor)
    assert float(m["skipped"]) == 1.0

    def bits(tree):
        return [t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
                for _, t in tree_flatten_with_path(tree)]

    for a, b_ in zip(bits(p2) + bits(o2), bits(bad) + bits(warm)):
        assert torch.equal(a, b_)
    _, o3, m3 = step(params, warm, batch)
    assert float(m3["skipped"]) == 0.0 and int(o3.count) == 2


# ---------------------------------------------------------------------------
# (g) the vocab-parallel loss at the production layout
# ---------------------------------------------------------------------------

def test_the_loss_holds_local_pieces_at_train_4k():
    """``lm.masked_nll`` alone, forward and backward, at qwen2-1.5b
    ``train_4k``'s logits (a microbatch of 128 × 4096 × 151,936 f32) on
    the fake ``pod`` world: rank 0's temporaries peak at no more than four
    local shards (8 × 4096 × 9,496 f32, 1.245 GB), nothing it makes has
    the whole vocab or the whole microbatch, and its only collectives are
    the all-reduces of 8 × 4096 f32 rows over ``model`` (three) and of
    the masked sum and count over ``data``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import lm
    B, S, V = 128, 4096, 151936
    shard = (B // 16) * S * (V // 16) * 4
    with dryrun.fake_world("pod", "cpu") as mesh:
        fake = dryrun._tracked_fake_mode("cpu")
        with fake:
            xl = torch.empty(B // 16, S, V // 16, requires_grad=True)
            tl = torch.empty(B // 16, S, dtype=torch.int32)
            fake.hold([xl, tl])
            logits = DTensor.from_local(xl, mesh, ts.placements(
                mesh, ts.Spec("data", None, "model")), run_check=False)
            targets = DTensor.from_local(tl, mesh, ts.placements(
                mesh, ts.Spec("data")), run_check=False)
            fake.tracking = True
            with dryrun.StepCounter(mesh) as counter:
                loss = lm.masked_nll(logits, targets)
                grad, = torch.autograd.grad(loss, xl)
            fake.tracking = False
    assert grad.shape == xl.shape and loss.shape == ()
    assert 0 < fake.peak <= 4 * shard
    made = [kind[1] for kind in fake._kinds]
    assert made and all(V not in shape and B not in shape for shape in made)
    assert counter.by_axis["model"]["all-reduce"] == 3 * (B // 16) * S * 4
    assert counter.by_axis["data"]["all-reduce"] == 2 * 4
    assert counter.collectives["all-gather"] == 0


def test_qwen2_train_4k_fits_the_pod_at_one_period():
    """``run_cell`` of qwen2-1.5b ``train_4k`` on ``pod`` at one layer
    period (the loss's bytes do not depend on depth), the plain versions
    on fake CPU tensors: it fits an 80 GB card, nothing at its peak has
    the whole vocab or the whole microbatch, and the logits' vocab dim is
    not gathered over ``model``."""
    cell = dryrun.run_cell("qwen2-1.5b", "train_4k", "pod", device="cpu",
                           periods=1)
    assert cell["status"] == "ok" and cell["fits"]
    vocab = get_config("qwen2-1.5b").vocab_size
    for kind in cell["peak_live"]:
        assert kind["shape"][-1] != vocab and kind["shape"][0] != 128, kind
    # what is gathered over model is less than one local logit shard
    shard = 8 * 4096 * (vocab // 16) * 4
    assert cell["collectives_by_axis"]["model"]["all-gather"] < shard


# ---------------------------------------------------------------------------
# (h) the streaming attention layout
# ---------------------------------------------------------------------------

def test_attn_block_cell_traces_the_heaviest_rank(monkeypatch):
    """qwen2-1.5b ``train_4k`` on ``pod`` at one period with
    ``attn_block=512`` (JAX's ``act_dp=("data",)``, ``act_sp="model"``):
    the cell names model rank 15, whose argument bytes equal the cell's
    without the option; every flash call takes that rank's 256 query
    rows of 4096 at ``q_offset`` 15·256 against all 4096 keys; no tensor
    at the peak is larger than the rank's rows against every key (B_l × H
    × 256 × 4096), where the cell without the option holds B_l × H ×
    4096² (the flash backward's plain recompute). Then a cell traced on
    rank 0 runs in the same process."""
    from repro_torch.kernels import ops
    seen = []
    flash = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), k.shape[1], kw.get("q_offset"),
                     kw.get("block_k")))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cell = dryrun.run_cell("qwen2-1.5b", "train_4k", "pod", device="cpu",
                           periods=1, attn_block=512)
    cfg = get_config("qwen2-1.5b")
    B_l, S, H = 256 // 2 // 16, 4096, cfg.n_heads      # accum 2, data 16
    assert cell["status"] == "ok" and cell["flops_model_rank"] == 15
    assert seen and set(seen) == {((B_l, S // 16, H, cfg.hd), S,
                                   15 * (S // 16), 512)}
    largest = max(k["bytes"] // k["tensors"] for k in cell["peak_live"])
    assert largest <= B_l * H * (S // 16) * S * 4
    base = dryrun.run_cell("qwen2-1.5b", "train_4k", "pod", device="cpu",
                           periods=1)
    assert base["flops_model_rank"] == 0
    assert (cell["memory"]["argument_bytes"]
            == base["memory"]["argument_bytes"])
    assert max(k["bytes"] // k["tensors"] for k in base["peak_live"]) >= (
        B_l * H * S * S * 4)


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------

def test_cli_writes_a_cell_with_jax_keys(tmp_path):
    _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
          "qwen1.5-0.5b", "--shape", "decode:4x64", "--mesh", "2x2",
          "--periods", "1", "--device", "cpu", "--out", str(tmp_path)],
         240, "dryrun CLI")
    cell = json.loads((tmp_path / "qwen1.5-0.5b__decode:4x64__2x2.json")
                      .read_text())
    assert cell["status"] == "ok"
    assert set(cell) == JAX_KEYS | PORT_KEYS
    assert set(cell["memory"]) == JAX_MEMORY_KEYS
    assert set(cell["collectives"]) == set(dryrun.KINDS)
    assert cell["n_chips"] == 4 and cell["device"] == "cpu"
    assert cell["memory"]["alias_bytes"] > 0      # the caches, in place
    assert cell["dominant"] in ("compute", "memory", "collective")


def test_cli_attn_block_writes_its_own_directory(tmp_path,
                                                monkeypatch):
    """``--attn-block N`` without ``--out`` writes its cells under
    ``experiments/dryrun_torch_attn<N>`` (JAX's file names), so it cannot
    overwrite the cells without the option."""
    monkeypatch.chdir(tmp_path)
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train:4x32",
                        "--mesh", "2x2", "--periods", "1", "--device",
                        "cpu", "--attn-block", "16"]) == 0
    cell = json.loads((tmp_path / "experiments" / "dryrun_torch_attn16"
                       / "qwen1.5-0.5b__train:4x32__2x2.json").read_text())
    assert cell["status"] == "ok" and cell["attn_block"] == 16
    assert cell["flops_model_rank"] == 1
    assert not (tmp_path / "experiments" / "dryrun_torch").exists()


def test_cli_runs_cells_one_after_another_in_one_process(tmp_path):
    """``--jobs 1``: the cells run in this process, each world set up and
    taken down in turn (a meshless cell after a (2, 2) one)."""
    _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
          "qwen1.5-0.5b", "--shape", "decode:4x64", "--mesh", "2x2,none",
          "--periods", "1", "--device", "cpu", "--out", str(tmp_path)],
         240, "dryrun --jobs 1")
    for mesh_kind, chips in (("2x2", 4), ("none", 1)):
        cell = json.loads((tmp_path / f"qwen1.5-0.5b__decode:4x64__"
                                      f"{mesh_kind}.json").read_text())
        assert cell["status"] == "ok" and cell["n_chips"] == chips


def test_cli_refuses_cuda_without_a_cuda_build(tmp_path):
    if torch.backends.cuda.is_built():
        pytest.skip("this torch is built with CUDA")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh", "pod",
         "--out", str(tmp_path)], env=_env(), capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and "--device cpu" in p.stderr
    assert not list(tmp_path.iterdir())
