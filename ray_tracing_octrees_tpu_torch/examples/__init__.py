"""Runnable examples of the port (``python -m
ray_tracing_octrees_tpu_torch.examples.<name>``)."""
