"""Command-line tools of the port (``python -m repro_torch.tools.tune``)."""
