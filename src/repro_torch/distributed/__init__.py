"""Sharding over a torch ``DeviceMesh`` (the JAX package's
``repro.distributed``): the FSDP/TP/EP/SP rule tables as DTensor
placements (``sharding``), the int8-compressed cross-pod gradient reduce
(``collectives``), and DTensor's collectives on CUDA tensors over gloo
for processes that share a card (``gloo_cuda``)."""
