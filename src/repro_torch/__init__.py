"""PyTorch/CUDA port of the FedSDD reproduction (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
names so every module has an obvious counterpart.  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.

Ported so far: serving of dense all-GQA decoders (``serve``) and the model
path it runs (``configs``, ``data.synthetic``, ``models``); FedSDD
rounds on the sequential and the vectorized client engine (``core``,
``distill``, ``optim``, ``utils``, ``models.resnet``, ``data.partition``)
and their CLI (``launch.train``); the hand-written Hopper kernels
``paged_decode``, the dense KD family and the weighted model average
(``kernels``); and the JAX↔torch weight bridge (``interop``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.py``).
"""
