"""Static-batch serving oracle (port of ``repro/serve/static.py``).

A fixed batch of uniform-length prompts, every row decoded for the full
``max_new_tokens``.  The prompt batch is right-padded to
``L + max_new_tokens`` BEFORE prefill (first-token logits read at
``last=L-1``), so the caches are born full-size; decode is a Python loop of
``Model.decode_step`` over a contiguous cache.  It runs no paged kernel,
which makes it the port's token oracle for ``ContinuousEngine``.

The padding is the reference's, and so is what it does to a recurrent
state (SSM and hybrid models): an attention cache's pads sit past the
prompt and decode overwrites them, but a recurrent state has no positions
to mask and absorbs the ``max_new_tokens`` pad tokens, so from the second
token on the output parts from a decode that starts from an empty state.
Their full forward also needs ``L + max_new_tokens`` to be a multiple of
the config's ``chunk_size``.
"""
from __future__ import annotations

import torch


@torch.inference_mode()
def generate_static(model, params, prompts, max_new_tokens: int):
    """Greedy-decode ``max_new_tokens`` for a (B, L) uniform-length prompt
    batch (array or tensor) on the params' device.  Returns
    (B, max_new_tokens) int32 generated tokens on that device."""
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    B, L = prompts.shape
    total = L + max_new_tokens
    padded = torch.nn.functional.pad(prompts, (0, max_new_tokens))
    last = torch.full((B,), L - 1, dtype=torch.int32, device=dev)
    logits, caches = model.prefill(params, {"tokens": padded}, last=last)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    for pos in range(L, total - 1):
        logits, caches = model.decode_step(params, tok[:, None], caches, pos)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)
