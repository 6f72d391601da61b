"""Collectives over a torch ``DeviceMesh`` (the JAX package's
``repro.distributed``): the int8-compressed cross-pod gradient reduce.
The FSDP/TP/EP/SP sharding rules (``distributed/sharding.py``) are not
ported yet."""
