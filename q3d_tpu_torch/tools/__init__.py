"""Command-line entry points of the port
(``python -m q3d_tpu_torch.tools.<name>``)."""
