"""Command-line tools of the port (``python -m bigslice_tpu_torch.tools.X``)."""
