"""ray_tracing_octrees_tpu_torch: the PyTorch / CUDA port of the renderer.

A second package beside ``ray_tracing_octrees_tpu`` (the JAX reference),
with the same module paths. Plain tensor code is PyTorch; the Pallas TPU
kernels become CUDA kernels written for Hopper (``trace/csrc``), built
by ``nvcc`` at first use and loaded with ``ctypes``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``, where each kernel's
plain PyTorch version runs instead.

This package imports neither ``jax`` nor ``ray_tracing_octrees_tpu``.
"""

__version__ = "0.1.0"
