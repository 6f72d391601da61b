"""Serving runtime: the feature engine and the model decode steps behind
the serving front ends — the paper's online mode as a deployable server.

* ``FeatureServer`` — OpenMLDB's role: per-request real-time feature
  vectors from deployed SQL window queries (engine hot path), with the
  dynamic batcher providing deadline/size batching and admission control,
  and the table's streaming pipeline as its write path.
* ``ModelServer`` — features (or tokens) -> model decode steps (the
  second half of the paper's Figure 5 pipeline, "SQL features -> ML
  model").
* ``hedged`` — straggler re-dispatch: a request re-issued after a
  deadline, so one slow attempt does not set the tail latency.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import DeploymentHandle, Engine
from repro_torch.core.results import FeatureFrame, RequestContext
from repro_torch.models.tree import tree_leaves
from repro_torch.obs.trace import new_trace_id
from repro_torch.serving.batcher import BatcherConfig, DynamicBatcher

__all__ = ["ServerConfig", "FeatureServer", "ModelServer", "hedged"]


@dataclass(frozen=True)
class ServerConfig:
    batcher: BatcherConfig = BatcherConfig()
    # straggler re-dispatch: re-issue a request that has not returned
    # after this many seconds and take the first answer (``hedged``)
    hedge_after_s: Optional[float] = None
    # batch buckets to warm at server construction (off the serving path)
    warm_buckets: tuple = ()


class FeatureServer:
    """Online feature serving session over a deployed engine query.

    Each dispatched batch resolves the deployment handle ONCE — together
    with the batcher's version-pin grouping this guarantees a batch is
    served end-to-end by a single deployment version, even while a
    hot-swap redeploy publishes a new one mid-flight. A request may pin a
    version explicitly via ``RequestContext(version_pin=...)`` (retired
    versions keep serving pinned traffic, e.g. shadow replay).

    When the deployment's table has a streaming pipeline attached (see
    ``Engine.attach_stream``), the server also exposes the **write path**:
    ``ingest`` stages an event into the watermark buffer and returns
    immediately — it never blocks a concurrent ``request``, whose reads
    come from atomically-published table snapshots.

    The server uses only ``engine.handle(name, version=)``,
    ``engine.streams``, ``engine.cache`` and the handle's ``request``, so
    any engine with that surface can stand behind it: a
    ``repro_torch.shard.ShardedEngine`` too, whose handle admits and
    scatters each batch across the shards and whose stream facade routes
    ``ingest`` to the owning shard's pipeline."""

    def __init__(self, engine: Engine, deployment: str,
                 cfg: ServerConfig = ServerConfig()):
        self.engine = engine
        self.deployment = deployment
        self.cfg = cfg
        self._closed = False

        def serve_batch(keys, ts, payloads, ctx=None):
            handle = self._resolve(ctx)
            return handle.request(keys, ts, payloads, ctx=ctx)

        if cfg.warm_buckets and engine.cache.enabled:
            engine.handle(deployment).warm(cfg.warm_buckets)
        self.batcher = DynamicBatcher(
            serve_batch, cfg.batcher,
            tracer=getattr(engine, "tracer", None))

    def _resolve(self, ctx: Optional[RequestContext]) -> DeploymentHandle:
        """One handle per batch — the no-version-mixing pivot."""
        if ctx is not None and ctx.version_pin is not None:
            return self.engine.handle(self.deployment,
                                      version=ctx.version_pin)
        return self.engine.handle(self.deployment)

    @property
    def handle(self) -> DeploymentHandle:
        """The currently-live deployment handle."""
        return self.engine.handle(self.deployment)

    @property
    def pipeline(self):
        """The table's attached IngestPipeline, or None."""
        table = self.engine.handle(self.deployment).table
        return self.engine.streams.get(table.schema.name)

    def request(self, key, ts: float,
                row: Optional[np.ndarray] = None,
                timeout: float = 30.0,
                ctx: Optional[RequestContext] = None) -> FeatureFrame:
        # timeout is the client's give-up bound; per-request serving
        # deadlines belong in ctx, which the batcher enforces
        if ctx is None:
            ctx = RequestContext()
        if ctx.trace_id is None:
            # every request is traceable: the id is generated at the
            # serving edge when the caller didn't bring one (span
            # recording still honours the tracer's sampling decision)
            ctx = dataclasses.replace(ctx, trace_id=new_trace_id())
        tracer = getattr(self.engine, "tracer", None)
        span = None
        if tracer is not None:
            span = tracer.start("server.request", ctx.trace_id,
                                tags={"deployment": self.deployment})
            if span is not None:
                ctx = dataclasses.replace(ctx,
                                          parent_span=span.span_id)
        call = lambda: self.batcher(key, ts, row, timeout=timeout, ctx=ctx)
        try:
            if self.cfg.hedge_after_s is not None:
                res = hedged(call, self.cfg.hedge_after_s)
            else:
                res = call()
        finally:
            if span is not None:
                tracer.finish(span)
        if isinstance(res, FeatureFrame):
            res.trace_id = ctx.trace_id
        return res

    def ingest(self, key, ts: float, row: np.ndarray) -> bool:
        """Non-blocking event ingestion (requires an attached stream).
        Returns False iff the event was beyond the watermark (dropped)."""
        pipe = self.pipeline
        if pipe is None:
            raise RuntimeError(
                f"no stream attached to deployment {self.deployment!r}'s "
                f"table; call Engine.attach_stream first")
        return pipe.push(key, ts, row)

    def close(self) -> None:
        """Idempotent: closing via the context manager AND explicitly
        neither leaks nor double-joins the dispatcher threads."""
        if self._closed:
            return
        self._closed = True
        self.batcher.close()

    def __enter__(self) -> "FeatureServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


class ModelServer:
    """Batched greedy incremental decoding behind the prefill/decode steps.

    ``prefill(tokens (B,S)) -> slot ids``; ``decode() -> (B,) next tokens``;
    ``logits`` holds the f32 logits of the last call (the admitted prompts'
    after ``prefill``, every slot's after ``decode``). The caches (an
    attention layer's ``{k, v}``, a Mamba layer's ``{conv, ssm}``; the slot
    is dim 1 of each, after the layer axis) live on the parameters'
    device; requests join/leave slots (continuous batching at slot
    granularity). Prefilled caches are copied into their slots in place,
    and each decode step writes one position (or state) per slot in
    place: no step copies the whole cache. Every slot advances on each
    step, active or not, as in the JAX package: an idle slot whose
    position runs past the cache writes nothing to a KV cache, its token
    still takes MoE capacity in the step, and a Mamba layer's state of an
    idle slot is overwritten by the next admission. Tokens only: a vision
    prompt goes through ``launch.steps.make_prefill_step`` and
    ``lm.decode_step``, as in the JAX package.

    An encoder-decoder config (``cfg.is_encdec``) is served too:
    ``prefill(tokens, enc_embeds)`` encodes the admitted prompts' frames
    ``(B, enc_len, d_model)``, copies each encoder output into its slot of
    a ``(batch, enc_len, d_model)`` buffer on the device and the decoder
    caches into their slots; ``decode`` passes the buffer to the serve
    step. ``enc_len`` defaults to ``cfg.frontend_len``. The JAX package's
    ModelServer raises here: it calls its encoder-decoder prefill step
    with the tokens only.
    """

    def __init__(self, cfg, params, *, batch: int, cache_len: int,
                 enc_len: Optional[int] = None):
        from repro_torch.launch.steps import (make_prefill_step,
                                              make_serve_step)
        from repro_torch.models import encdec, lm
        self.cfg = cfg
        self.device = params["embed"].device
        self.params = lm.with_f32_head(params, cfg)   # f32 head, once
        self.batch = batch
        self.cache_len = cache_len
        self._prefill = make_prefill_step(cfg, cache_len,
                                          with_enc_out=cfg.is_encdec)
        self._decode = make_serve_step(cfg)
        if cfg.is_encdec:
            self.enc_len = cfg.frontend_len if enc_len is None else enc_len
            self.enc_out = torch.zeros(
                (batch, self.enc_len, cfg.d_model), dtype=cfg.compute_dtype,
                device=self.device)
            self.caches = encdec.init_dec_cache(cfg, batch, cache_len,
                                                self.device)
        else:
            if enc_len is not None:
                raise ValueError(f"{cfg.name} has no encoder: enc_len is "
                                 f"for encoder-decoder configs")
            self.caches = lm.init_cache(cfg, batch, cache_len, self.device)
        self.positions = torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)
        self.tokens = torch.zeros((batch,), dtype=torch.int32,
                                  device=self.device)
        self.active = np.zeros((batch,), bool)
        self.generated: List[List[int]] = [[] for _ in range(batch)]
        self.logits = None

    def prefill(self, tokens: np.ndarray,
                enc_embeds: Optional[Any] = None) -> List[int]:
        """Admit ``tokens (B0, S)`` sequences into free slots; an
        encoder-decoder also takes their frames ``enc_embeds (B0, enc_len,
        d_model)`` (numpy or a tensor)."""
        B0, S = tokens.shape
        free = [i for i in range(self.batch) if not self.active[i]][:B0]
        if len(free) < B0:
            raise RuntimeError("no free slots (admission control)")
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.device)
        idx = torch.as_tensor(free, dtype=torch.long, device=self.device)
        if self.cfg.is_encdec:
            want = (B0, self.enc_len, self.cfg.d_model)
            if enc_embeds is None or tuple(enc_embeds.shape) != want:
                raise ValueError(
                    f"{self.cfg.name}: prefill takes enc_embeds of shape "
                    f"{want}, got "
                    f"{None if enc_embeds is None else tuple(enc_embeds.shape)}")
            emb = torch.as_tensor(enc_embeds, device=self.device)
            self.logits, caches, enc_out = self._prefill(self.params, emb,
                                                         toks)
            self.enc_out.index_copy_(0, idx, enc_out)
        else:
            if enc_embeds is not None:
                raise ValueError(f"{self.cfg.name} has no encoder")
            self.logits, caches = self._prefill(self.params, toks)
        nxt = torch.argmax(self.logits, -1).to(torch.int32)
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
        extra = (self.enc_out,) if self.cfg.is_encdec else ()
        for _ in range(steps):
            self.logits, self.caches = self._decode(
                self.params, self.caches, self.tokens, self.positions,
                *extra)
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
