"""Serving runtime of the model tier: ``ModelServer`` (features or tokens
-> model decode steps; the second half of the paper's Figure 5 pipeline,
"SQL features -> ML model") and ``hedged`` (straggler re-dispatch).

The JAX package's ``FeatureServer`` needs the dynamic batcher and comes
with the serving slice (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.models.tree import tree_leaves

__all__ = ["ModelServer", "hedged"]


class ModelServer:
    """Batched greedy incremental decoding behind the prefill/decode steps.

    ``prefill(tokens (B,S)) -> slot ids``; ``decode() -> (B,) next tokens``;
    ``logits`` holds the f32 logits of the last call (the admitted prompts'
    after ``prefill``, every slot's after ``decode``). The KV caches live
    on the parameters' device; requests join/leave slots (continuous
    batching at slot granularity). Prefilled caches are copied
    into their slots in place, and each decode step writes one position per
    slot in place: no step copies the whole cache. Every slot advances on
    each step, active or not; an idle slot whose position runs past the
    cache writes nothing (as in the JAX package).
    """

    def __init__(self, cfg, params, *, batch: int, cache_len: int):
        from repro_torch.launch.steps import (make_prefill_step,
                                              make_serve_step)
        from repro_torch.models import lm
        self.cfg = cfg
        self.device = params["embed"].device
        self.params = lm.with_f32_head(params, cfg)   # f32 head, once
        self.batch = batch
        self.cache_len = cache_len
        self._prefill = make_prefill_step(cfg, cache_len)
        self._decode = make_serve_step(cfg)
        self.caches = lm.init_cache(cfg, batch, cache_len, self.device)
        self.positions = torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)
        self.tokens = torch.zeros((batch,), dtype=torch.int32,
                                  device=self.device)
        self.active = np.zeros((batch,), bool)
        self.generated: List[List[int]] = [[] for _ in range(batch)]
        self.logits = None

    def prefill(self, tokens: np.ndarray) -> List[int]:
        """Admit ``tokens (B0, S)`` sequences into free slots."""
        B0, S = tokens.shape
        free = [i for i in range(self.batch) if not self.active[i]][:B0]
        if len(free) < B0:
            raise RuntimeError("no free slots (admission control)")
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.device)
        self.logits, caches = self._prefill(self.params, toks)
        nxt = torch.argmax(self.logits, -1).to(torch.int32)
        idx = torch.as_tensor(free, dtype=torch.long, device=self.device)
        for full, new in zip(tree_leaves(self.caches), tree_leaves(caches)):
            full.index_copy_(1, idx, new.to(full.dtype))
        self.tokens[idx] = nxt
        self.positions[idx] = S
        host = nxt.cpu().numpy()
        for j, slot in enumerate(free):
            self.active[slot] = True
            self.generated[slot] = [int(host[j])]
        return free

    def decode(self, steps: int = 1) -> np.ndarray:
        """Advance every slot ``steps`` tokens (active ones record them)."""
        for _ in range(steps):
            self.logits, self.caches = self._decode(
                self.params, self.caches, self.tokens, self.positions)
            self.tokens = torch.argmax(self.logits, -1).to(torch.int32)
            self.positions = self.positions + 1
            host = self.tokens.cpu().numpy()
            for i in range(self.batch):
                if self.active[i]:
                    self.generated[i].append(int(host[i]))
        return self.tokens.cpu().numpy()

    def release(self, slots: Sequence[int]) -> None:
        for s in slots:
            self.active[s] = False


def hedged(call: Callable[[], Any], after_s: float,
           max_hedges: int = 1) -> Any:
    """Issue ``call``; if it has not returned after ``after_s``, race a
    second attempt and take the winner (tail-at-scale mitigation)."""
    result: Dict[str, Any] = {}
    done = threading.Event()

    def attempt(tag):
        try:
            r = call()
        except Exception as e:
            r = e
        if not done.is_set():
            result.setdefault("v", r)
            done.set()

    t = threading.Thread(target=attempt, args=("p",), daemon=True)
    t.start()
    n = 0
    while not done.wait(after_s) and n < max_hedges:
        n += 1
        threading.Thread(target=attempt, args=(f"h{n}",), daemon=True).start()
    done.wait()
    v = result["v"]
    if isinstance(v, Exception):
        raise v
    return v
