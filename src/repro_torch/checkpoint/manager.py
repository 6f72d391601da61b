"""Fault-tolerant checkpointing: atomic, async, retention-K, self-validating.

Design for 1000+-node operation:

* **Atomic**: write to ``<dir>/tmp.<step>.<nonce>/`` then ``os.rename`` to
  ``<dir>/step_<step>/`` — a crashed writer never corrupts a restore
  point; a restore always sees the newest *complete* step.
* **Async**: the serialize+write runs on a background thread; training
  only blocks on the previous save (single-slot pipeline) so checkpoint
  I/O overlaps the next steps' compute.
* **Retention**: keep the newest K checkpoints + optional every-Nth
  "archive" steps, delete the rest (bounded disk).
* **Self-validating**: every leaf file carries a crc32 in the manifest;
  restore verifies before handing params to the trainer.
* **Multi-host-ready layout**: one process writes (``process_count`` 1).
  In a world of several processes every save blocks: a tree of DTensors
  (a wide mesh) is saved as full arrays, every rank gathers each leaf
  (``full_tensor()``), rank 0 writes, and every rank returns from
  ``save`` once the checkpoint is published (a barrier), so all ranks
  see the same newest step.

Storage format: one ``.npy`` per tree leaf (streamable, mmap-able) + a
JSON manifest with the shapes, dtypes, crcs and step metadata: the JAX
package's ``repro.checkpoint`` format, leaf for leaf (less its
informational ``treedef``, which no restore reads).
Leaf names come from tree paths as JAX's do (``blocks__0__attn__wq__w``,
``opt__m__embed``), so either package restores what the other wrote. A
bf16 leaf is stored as JAX stores it, two raw bytes per value (``.npy``
descr ``<V2``) with ``bfloat16`` in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.tree import tree_flatten_with_path, tree_unflatten

__all__ = ["CheckpointManager", "CheckpointMeta"]


@dataclass
class CheckpointMeta:
    step: int
    timestamp: float
    leaf_count: int
    extra: Dict[str, Any] = field(default_factory=dict)


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host array; bf16 as its raw two-byte values."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)   # the caller may reuse it
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf: Any, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _tensor(arr: np.ndarray, dtype: str, like: Any) -> torch.Tensor:
    """A restored leaf as a tensor on ``like``'s device (the CPU when
    ``like`` is no tensor or a ``meta`` struct; a DTensor's local
    device)."""
    arr = np.array(arr, order="C")        # a writable copy, 0-d kept
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to("cpu" if torch.device(dev).type == "meta" else dev)


def _world() -> int:
    """The number of processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _flatten_with_names(tree: Any) -> List[Tuple[str, Any]]:
    return [("__".join(str(k) for k in path) or "root", leaf)
            for path, leaf in tree_flatten_with_path(tree)]


class CheckpointManager:
    def __init__(self, directory: str, *, retain: int = 3,
                 archive_every: int = 0, async_save: bool = True):
        self.dir = directory
        self.retain = retain
        self.archive_every = archive_every
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, extra: Optional[Dict] = None,
             block: bool = False) -> None:
        """Snapshot ``tree`` at ``step``. Device tensors are copied to
        host *synchronously* (required for consistency: the trainer goes
        on to replace them), the disk write happens on the background
        thread; in a world of several processes it blocks (see the
        module's docstring)."""
        self.wait()                      # single-slot async pipeline
        host_tree = []
        for name, leaf in _flatten_with_names(tree):
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()    # collective: every rank
            arr = _host(leaf)
            host_tree.append((name, arr, _dtype_name(leaf, arr)))
        if _world() > 1:
            block = True
            if dist.get_rank() != 0:
                dist.barrier()           # rank 0 has published
                return

        def write():
            try:
                self._write(step, host_tree, extra or {})
                self._gc()
            except BaseException as e:          # surfaced on next wait()
                self._last_error = e

        if self.async_save and not block:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()
            if _world() > 1:
                dist.barrier()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise RuntimeError(f"async checkpoint write failed: {e!r}") from e

    def _write(self, step: int, leaves: List[Tuple[str, np.ndarray, str]],
               extra: Dict) -> None:
        nonce = f"{os.getpid()}_{int(time.time() * 1e6) % 10**9}"
        tmp = os.path.join(self.dir, f"tmp.{step}.{nonce}")
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Any] = {
            "step": step, "timestamp": time.time(),
            "extra": extra, "leaves": [],
            "process_count": 1,
        }
        for name, arr, dtype in leaves:
            fn = f"{name}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "name": name, "file": fn, "shape": list(arr.shape),
                "dtype": dtype,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_"):
                try:
                    out.append(int(n[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, step: Optional[int], like: Any, *,
                validate: bool = True) -> Tuple[Any, CheckpointMeta]:
        """Restore into the structure of ``like`` (a tree of tensors, or of
        anything in their places): each leaf comes back as a tensor of the
        dtype it was saved with, on the device of ``like``'s leaf."""
        self.wait()                      # a pending save is published
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {l["name"]: l for l in manifest["leaves"]}
        flat = _flatten_with_names(like)
        arrs = []
        for name, like_leaf in flat:
            entry = by_name.get(name)
            if entry is None:
                raise KeyError(f"checkpoint {step} missing leaf {name!r}")
            arr = np.load(os.path.join(path, entry["file"]))
            if validate:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != entry["crc32"]:
                    raise IOError(
                        f"crc mismatch for {name!r} in step {step} "
                        f"(corrupt checkpoint)")
            arrs.append(_tensor(arr, entry["dtype"], like_leaf))
        tree = tree_unflatten(like, arrs)
        meta = CheckpointMeta(step=manifest["step"],
                              timestamp=manifest["timestamp"],
                              leaf_count=len(arrs),
                              extra=manifest.get("extra", {}))
        return tree, meta

    # -------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.retain:]) if self.retain else set(steps)
        if self.archive_every:
            keep |= {s for s in steps if s % self.archive_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                              ignore_errors=True)
