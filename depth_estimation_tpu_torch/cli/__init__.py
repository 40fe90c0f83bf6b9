"""Command-line entry points of the port (``python -m
depth_estimation_tpu_torch.cli.<name>``)."""
