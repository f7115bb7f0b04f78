"""q3d_tpu_torch — the PyTorch/CUDA port of ``q3d_tpu`` for NVIDIA Hopper.

A second package beside the JAX reference ``q3d_tpu/``: the same modules at
the same relative paths, in PyTorch idiom (``nn.Module``s, NCHW dense maps,
OIHW weights, explicit devices and generators).  The TPU's two Pallas
kernels are hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use and bound with ``ctypes`` (``ops/kernel_build.py``).

The package imports torch, numpy and PyYAML only — never jax, flax or
``q3d_tpu``.  Entry points (``models.build_network``,
``models.load_data_to_device``) default to the CUDA device and raise when
there is none; pass ``device="cpu"`` to run the plain PyTorch versions.
"""

__version__ = "0.1.0"
