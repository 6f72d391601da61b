"""Model zoo of the port: the decoder-only backbone of the serving path.

Params are nested dicts of tensors in the JAX package's layouts; every
module is an ``init_*(gen, cfg) -> params`` plus an apply-style function.
Layers are stacked along a leading axis per pattern position, as in the
JAX package, and iterated with a Python loop.
"""
__all__ = ["lm", "attention", "layers", "blocks", "tree"]
