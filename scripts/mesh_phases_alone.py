"""The smoke's mesh phases alone, with its dry run beside them, on one card.

``chip_smoke.mesh_phase`` (the ``mesh`` work with its context-parallel
part, the ``mesh_moe`` and
``mesh_families`` work on one (2, 2) world of 4 processes, ``mesh_encdec``
on a second beside it, every check of those phases) while
``chip_smoke.DryRun`` runs its four cells on one host core; then
``chip_smoke.dryrun_check``'s hold_mesh checks. hold_train needs the
smoke's ``train`` phase, which this script does not run: it is held to
its own prediction here, so only its numbers are printed.

Run from the repo root: ``python3 scripts/mesh_phases_alone.py`` (about
7 minutes on an H100). It prints the phases' seconds, the mesh ranks'
step times, hold_mesh's gaps and the launches as one JSON line.
"""
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(cs.SRC))


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    dry = cs.DryRun().start()
    mesh, moe, fam, enc = cs.mesh_phase("cuda")
    t_mesh = time.perf_counter() - t
    got = dry.join()
    own = {"main": {"peak_bytes": cs._predicted_peak(
        got["cells"]["hold_train"]), "model_flops_per_step": 1.0}}
    res = cs.dryrun_check(got, mesh, own)
    print(json.dumps({
        "mesh_phases_s": t_mesh, "dryrun_s": got["seconds"],
        "mesh_s": mesh.get("seconds"), "cp_s": mesh["cp"]["seconds"],
        "moe_s": moe.get("seconds"),
        "fam_s": fam.get("seconds"), "enc_s": enc.get("seconds"),
        "world_s": mesh.get("world_s"),
        "counted_step_ms": [r["counted_step_ms"] for r in mesh["ranks"]],
        "step_ms": [r["step_ms"] for r in mesh["ranks"]],
        "hold_mesh_gaps": [(r["argument_gap"], r["peak_gap"])
                           for r in res["hold_mesh"]["ranks"]],
        "world_card_peak_bytes": fam.get("world_card_peak_bytes"),
        "launches": {"mesh": mesh["launches"],
                     "mesh_cp": mesh["cp"]["launches"],
                     "mesh_moe": moe["launches"],
                     "mesh_families": fam["launches"],
                     "mesh_encdec": enc["launches"]}}))


if __name__ == "__main__":
    main()
