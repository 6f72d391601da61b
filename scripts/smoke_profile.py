"""Where the smoke's time goes: ``chip_smoke.main()`` with its functions timed.

Every top-level function of ``chip_smoke`` and every function and method
of a few port modules (the step builders, ``ModelServer``, the model,
``TrainLoop``, the sharded and the single engine) is wrapped by a host
timer. Each call that takes more than ``MIN_S`` seconds is written, as
its start and its inclusive seconds since the script began, indented by
its depth of nesting, with the device of its first tensor argument. The
mesh phases' rank processes run under the same wrapper and write files
of their own (``rank<r>.txt``, ``enc<r>.txt``). The smoke's own checks
and output are unchanged; the wrappers add about a microsecond a call.

Run from the repo root on the card: ``python3 scripts/smoke_profile.py
[OUT_DIR]`` (default ``build/smoke_profile``); it writes ``main.txt``
and the ranks' files there and exits with the smoke's code.
"""
import functools
import importlib
import inspect
import json
import os
import subprocess as _subprocess
import sys
import threading
import time
import types

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(cs.SRC))

MIN_S = 0.5
PORT_MODULES = ("repro_torch.launch.steps", "repro_torch.serving.server",
                "repro_torch.models.lm", "repro_torch.launch.train",
                "repro_torch.shard.engine", "repro_torch.core.engine")
# called per batch or per line: not worth a wrapper
SKIP = {"main", "mesh_rank", "log", "card_line", "fraud_scorer"}

T0 = time.perf_counter()
_local = threading.local()
_lock = threading.Lock()
_out = None


def _device(args, kwargs) -> str:
    import torch
    todo, seen = list(args) + list(kwargs.values()), 0
    while todo and seen < 200:
        x = todo.pop(0)
        seen += 1
        if isinstance(x, torch.Tensor):
            return str(x.device)
        if isinstance(x, dict):
            todo += list(x.values())[:20]
        elif isinstance(x, (list, tuple)):
            todo += list(x)[:20]
    return ""


def timed(name: str, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        depth = getattr(_local, "depth", 0)
        _local.depth = depth + 1
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _local.depth = depth
            dt = time.perf_counter() - t
            if dt > MIN_S:
                line = (f"{t - T0:9.2f} {dt:9.2f} "
                        f"{threading.current_thread().name[:8]:8s} "
                        f"{'  ' * depth}{name} {_device(args, kwargs)}\n")
                with _lock:
                    _out.write(line)
                    _out.flush()
    return call


def wrap_all() -> None:
    for name, obj in list(vars(cs).items()):
        if (isinstance(obj, types.FunctionType)
                and obj.__module__ == cs.__name__ and name not in SKIP):
            setattr(cs, name, timed(name, obj))
    for modname in PORT_MODULES:
        mod = importlib.import_module(modname)
        short = modname.rsplit(".", 1)[-1]
        for name, obj in list(vars(mod).items()):
            if (isinstance(obj, types.FunctionType)
                    and obj.__module__ == mod.__name__):
                setattr(mod, name, timed(f"{short}.{name}", obj))
            elif inspect.isclass(obj) and obj.__module__ == mod.__name__:
                for attr, fn in list(vars(obj).items()):
                    if isinstance(fn, types.FunctionType) and (
                            attr == "__init__" or not attr.startswith("__")):
                        setattr(obj, attr,
                                timed(f"{short}.{name}.{attr}", fn))


class _RanksUnderThisScript:
    """``subprocess`` for ``chip_smoke``, but a mesh rank's command runs
    this script (with the same arguments) in place of the smoke."""

    def __getattr__(self, name):
        return getattr(_subprocess, name)

    def Popen(self, args, *rest, **kwargs):
        if isinstance(args, list) and args[2:3] == ["--mesh-rank"]:
            args = [args[0], HERE, *args[2:]]
        return _subprocess.Popen(args, *rest, **kwargs)


def main() -> int:
    global _out
    rank = sys.argv[1:2] == ["--mesh-rank"]
    if rank:
        a = json.loads(sys.argv[2])
        out_dir = os.environ["SMOKE_PROFILE_DIR"]
        name = f"{'enc' if a['encdec_world'] else 'rank'}{a['rank']}.txt"
    else:
        out_dir = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                                  os.path.join(ROOT, "build",
                                               "smoke_profile"))
        os.environ["SMOKE_PROFILE_DIR"] = out_dir
        sys.argv = sys.argv[:1]        # the smoke's default run
        name = "main.txt"
    os.makedirs(out_dir, exist_ok=True)
    _out = open(os.path.join(out_dir, name), "w")
    wrap_all()
    cs.subprocess = _RanksUnderThisScript()
    try:
        return cs.main()
    finally:
        _out.write(f"total {time.perf_counter() - T0:.2f}\n")
        _out.close()


if __name__ == "__main__":
    sys.exit(main())
