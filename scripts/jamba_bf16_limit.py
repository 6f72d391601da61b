"""The readings that set ``chip_smoke.REPLAYED_BF16_LIMIT``, on one card.

jamba-v0.1-52b at full width, one period of 8 of its 32 layers, served in
bf16 at the sizes of the smoke's ``mesh_families`` phase (4 prompts of
320, 8 teacher-forced steps), every bf16 run at the meshless f32 run's
expert choices (``chip_smoke.FAMILY_REPLAY``):

* ``floor``: the meshless bf16 run against its f32 twin, what bf16
  rounding alone moves the logits by;
* ``mesh``: the (2, 2) mesh's run (4 processes sharing the card over
  gloo) against the meshless bf16 run, what the smoke holds;
* ``local_norm``: the same mesh run with the SSD layers' gated RMSNorm
  taken over each rank's local heads (each rank's sums of squares
  standing for the whole ``d_inner``), a planted fault the limit has to
  catch.

Run from the repo root: ``python3 scripts/jamba_bf16_limit.py`` (about
5 minutes on an H100). It prints the three readings as one JSON line,
beside the card's name and power limit.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# jamba's bf16 serving alone (its f32 twin runs first in the reference)
cs.FAMILY_TRAIN = ()
cs.FAMILY_SERVE = (("jamba", "bfloat16"),)
KEY = "jamba_bfloat16"
MODEL = 2                                  # the model axis of (2, 2)


def rank(arg: str) -> None:
    """One rank of the (2, 2) world: jamba served as the smoke serves
    it, then again with the gated norm over the local heads."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.distributed import gloo_cuda
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ssm
    a = json.loads(arg)
    fz = cs.FamilyMeshSizes()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo", store=dist.FileStore(
        a["store"], 4), rank=a["rank"], world_size=4,
        timeout=timedelta(seconds=600))
    gloo_cuda.install()
    try:
        mesh = make_mesh((2, MODEL), ("data", "model"))
        res = {"mesh": cs.families_rank(fz, mesh, a["rank"], a["tmp"], ())}
        summed = ssm._model_sum
        ssm._model_sum = lambda lay, t: t * MODEL
        try:
            res["local_norm"] = cs.families_rank(fz, mesh, a["rank"],
                                                 a["tmp"], ())
        finally:
            ssm._model_sum = summed
    finally:
        dist.destroy_process_group()
    with open(a["out"], "wb") as f:
        pickle.dump(res, f)


def main() -> int:
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    fz = cs.FamilyMeshSizes()
    tmp = tempfile.mkdtemp(prefix="jamba-limit-")
    try:
        ref = cs.families_reference(fz, tmp)
        cs._freed()
        _build.library()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", json.dumps({
                "rank": r, "store": os.path.join(tmp, "store"), "tmp": tmp,
                "out": os.path.join(tmp, f"rank{r}.pkl")})])
            for r in range(4)]
        try:
            codes = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            print(f"ranks exited {codes}", file=sys.stderr)
            return 1
        r0 = pickle.loads(Path(tmp, "rank0.pkl").read_bytes())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"floor": cs._mesh_logits(ref[KEY], ref["jamba_float32"]),
           "mesh": cs._mesh_logits(r0["mesh"][KEY]["logits"], ref[KEY]),
           "local_norm": cs._mesh_logits(r0["local_norm"][KEY]["logits"],
                                         ref[KEY]),
           "routings_replayed": ref[f"{KEY}_routings"],
           "card": cs.card_line()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--rank":
        rank(sys.argv[2])
    else:
        sys.exit(main())
