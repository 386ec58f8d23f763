"""tbist_tpu_torch — the PyTorch/CUDA port of ``tbist_tpu`` for NVIDIA Hopper.

The module tree mirrors the JAX package: ``tbist_tpu_torch/<x>.py`` ports
``tbist_tpu/<x>.py``. Public functions keep the JAX package's NHWC layout;
inside, convolutions run on the NCHW view of NHWC tensors (channels-last
strides, no copy). The Pallas kernels of the JAX package are hand-written
CUDA kernels here (``kernels/`` and ``csrc/``), each beside a plain PyTorch
version that CPU tensors take.

The package imports ``torch`` and never ``jax`` or ``tbist_tpu``. Entry
points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
