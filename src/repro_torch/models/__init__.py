"""Model zoo of the port: decoder-only, hybrid, MoE and encoder-decoder
backbones.

Params are nested dicts of tensors in the JAX package's layouts; every
module is an ``init_*(gen, cfg) -> params`` plus an apply-style function.
Layers are stacked along a leading axis, as in the JAX package, and
iterated with a Python loop.
"""
__all__ = ["lm", "encdec", "attention", "moe", "ssm", "layers", "blocks",
           "frontend", "tree"]
