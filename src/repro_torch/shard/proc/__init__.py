"""Process-backed shard runtime: one subprocess per shard engine.

See DESIGN.md §11–§12. Public surface: :class:`ProcShardBackend`
(selected via ``ShardedEngine(backend="process")``,
``ShardConfig(backend="process")`` or ``REPRO_SHARD_BACKEND=process``);
``worker.py`` is the subprocess entry point (``python -m
repro_torch.shard.proc.worker``). The frame format of ``transport.py``
is that of ``repro.shard.proc.transport`` byte for byte."""
from repro_torch.shard.proc.backend import (ProcDeploymentHandle,
                                            ProcEngineClient,
                                            ProcPipelineClient,
                                            ProcShardBackend, worker_env)
from repro_torch.shard.proc.transport import (Channel, decode_args,
                                              encode_args)

__all__ = ["ProcShardBackend", "ProcEngineClient", "ProcDeploymentHandle",
           "ProcPipelineClient", "worker_env", "Channel", "encode_args",
           "decode_args"]
