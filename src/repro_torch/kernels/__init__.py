"""Hand-written CUDA kernels of the feature engine, for Hopper (sm_90a).

Layout per kernel: ``csrc/<name>.cu`` (the kernel and its C launch
function), ``<name>.py`` (the wrapper: checks, allocation, launch, launch
counter), ``ref.py`` (the plain PyTorch versions), ``ops.py`` (dispatch by
tensor device), ``_build.py`` (nvcc build at first use, ctypes loading).

Kernels:
    window_agg     — one window frame per request, seven aggregates
    fused_window   — a deployment's whole spec table (S frames) in one launch
    preagg_window  — bucketed pre-aggregate window lookup (paper Eq. 2)
    last_join      — point-in-time LAST JOIN row lookup over a right table
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
