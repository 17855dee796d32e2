"""Paged KV cache: one preallocated block pool + per-request block tables
(port of ``repro/serve/paged_cache.py``).

Every attention layer's K/V lives in fixed-size blocks inside ONE pool of
shape ``(num_blocks, block_size, Hkv, dh)`` shared by all in-flight
requests; a request owns an ordered list of pool blocks and addresses
token ``t`` at pool slot ``[table[t // bs], t % bs]``.

Block 0 is reserved as the null block: inactive batch slots keep an
all-zero table row and ``seq_len == 0``, so their decode writes land in it
and never corrupt live requests.  The allocator is host-side Python, run
at admission.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import to_device

NULL_BLOCK = 0


def blocks_needed(prompt_len: int, max_new_tokens: int, block_size: int) -> int:
    """Worst-case block count for a request, reserved in full at admission
    so the zero-drop invariant needs no preemption: covers the prompt
    padded to a block multiple AND every decoded token's scatter slot."""
    padded_prompt = math.ceil(prompt_len / block_size) * block_size
    return math.ceil(max(padded_prompt, prompt_len + max_new_tokens)
                     / block_size)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def pool_bytes(caches) -> int:
    """Total bytes of a paged pool tree."""
    return sum(t.numel() * t.element_size() for t in _leaves(caches))


class BlockAllocator:
    """LIFO free-list over pool blocks 1..num_blocks-1 (0 is the null
    block).  ``alloc`` is all-or-nothing: admission control asks for the
    request's full worst-case block set and backs off if the pool can't
    cover it."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"pool needs >= 2 blocks (one is the reserved "
                             f"null block), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_blocks / max(1, self.num_blocks - 1)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        ids, self._free = self._free[-n:], self._free[:-n]
        return ids[::-1]

    def free(self, ids) -> None:
        for b in ids:
            if b == NULL_BLOCK:
                raise RuntimeError("null block is never owned")
        self._free.extend(ids)


def scatter_prefill(pool, contiguous, block_ids) -> None:
    """Move one request's contiguous prefill caches into its pool blocks,
    IN PLACE.

    ``contiguous`` is the B=1 cache tree from ``Model.prefill`` over a
    block-aligned padded prompt: leaves ``(1, Lpad, Hkv, dh)`` (prefix
    layers) or ``(n_super, 1, Lpad, Hkv, dh)`` (stacked layers).
    ``block_ids`` is the ``(Lpad // bs,)`` list or tensor of owned pool
    blocks.
    """
    for pool_leaf, ctg_leaf in zip(_leaves(pool), _leaves(contiguous)):
        ids = to_device(torch.as_tensor(block_ids, dtype=torch.long), pool_leaf.device)
        bs = pool_leaf.shape[-3]
        if ctg_leaf.ndim == 5:          # (ns, 1, Lpad, Hkv, dh) stacked
            ns, _, lp, hk, dh = ctg_leaf.shape
            pool_leaf[:, ids] = ctg_leaf.reshape(ns, lp // bs, bs, hk, dh).to(pool_leaf.dtype)
        else:                           # (1, Lpad, Hkv, dh) prefix layer
            _, lp, hk, dh = ctg_leaf.shape
            pool_leaf[ids] = ctg_leaf.reshape(lp // bs, bs, hk, dh).to(pool_leaf.dtype)


def build_table(block_ids, nbmax: int) -> np.ndarray:
    """(nbmax,) int32 row for the engine's block-table array: owned blocks
    first, null-block padding after."""
    row = np.zeros((nbmax,), np.int32)
    row[:len(block_ids)] = block_ids
    return row
