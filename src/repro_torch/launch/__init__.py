"""Launchers: the serving entry point (``python -m
repro_torch.launch.serve``) and the step functions it uses."""
