"""PyTorch + CUDA port of lifelong_nnunet_tpu for one NVIDIA H100.

The JAX package ``lifelong_nnunet_tpu`` stays the reference; this package
mirrors its module paths (``models/unet.py``, ``inference/sliding_window.py``,
...) so each module's counterpart is easy to find.  It imports ``torch`` and
never ``jax``, ``flax``, ``optax``, ``msgpack`` or ``sklearn``, and nothing
of the JAX package, not even its framework-free modules: it keeps its own
copies of what it needs from them (planning, preprocessing, NIfTI and image
I/O, paths, metrics, logging, the results layout), under the same relative
paths.

The TPU kernels on the ported paths (serving and training) are hand-written
CUDA kernels for Hopper (``ops/csrc/``), built by one
``torch.utils.cpp_extension.load`` on first use (``ops/kernels/build.py``).
"""

__version__ = "0.1.0"
