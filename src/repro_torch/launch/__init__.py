"""Launchers: the serve CLI (``python -m repro_torch.launch.serve``)."""
