"""PyTorch + CUDA port of the SQL+ML feature engine (``repro``).

The same engine on an NVIDIA GPU: ring-buffer feature tables with their
pre-aggregate tier, the SQL/DSL plan layer, and online and point-in-time
serving with LAST JOIN and PREDICT, through hand-written CUDA kernels
(``repro_torch.kernels``). Entry point: :class:`repro_torch.core.Engine`.
"""
