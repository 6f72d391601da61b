"""Launchers: the serving entry point (``python -m
repro_torch.launch.serve``), the trainer (``python -m
repro_torch.launch.train``) and the step functions they use."""
