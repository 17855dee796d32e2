"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
takes its plain version only for CPU tensors.  ``launches`` counts kernel
launches by name — one per launch, incremented nowhere else — so a run can
show that its main path went through the kernels.
"""
from collections import Counter

launches: Counter = Counter()
