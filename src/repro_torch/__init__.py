"""PyTorch/CUDA port of the FedSDD reproduction (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
names so every module has an obvious counterpart.  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.

Ported so far: serving of dense all-GQA decoders (``serve``) and the model
path it runs (``configs``, ``data.synthetic``, ``models``); one FedSDD
round on the sequential engine (``core``, ``distill``, ``optim``,
``utils``, ``models.resnet``, ``data.partition``); the hand-written
Hopper kernels ``paged_decode`` and the dense KD family
(``kernels``); and the JAX↔torch weight bridge (``interop``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.py``).
"""
