"""Serving of the main global model (port of ``repro.serve``).

  paged_cache  block allocator + prefill→pool scatter
  engine       ContinuousEngine: queue, admission, prefill/decode split
  static       static-batch oracle (prefill + a loop of decode steps)

``launch/serve.py`` is the CLI over this package.
"""
from repro_torch.serve.engine import (ContinuousEngine, Request, RequestResult,
                                      run_closed_loop)
from repro_torch.serve.paged_cache import (BlockAllocator, blocks_needed,
                                           pool_bytes, scatter_prefill)
from repro_torch.serve.static import generate_static

__all__ = [
    "BlockAllocator", "ContinuousEngine", "Request", "RequestResult",
    "blocks_needed", "generate_static", "pool_bytes", "run_closed_loop",
    "scatter_prefill",
]
