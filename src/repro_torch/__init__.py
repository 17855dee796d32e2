"""PyTorch/CUDA port of the FedSDD reproduction (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
names so every module has an obvious counterpart.  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.

Ported so far: serving of dense all-GQA decoders (``serve``), the model path
it runs (``configs``, ``data.synthetic``, ``models``), the hand-written
Hopper ``paged_decode`` kernel (``kernels``), and the JAX↔torch weight bridge
(``interop``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``device.py``).
"""
