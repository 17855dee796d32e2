"""Static-batch serving oracle (port of ``repro/serve/static.py``).

A fixed batch of uniform-length prompts, every row decoded for the full
``max_new_tokens``.  The prompt batch is right-padded to
``L + max_new_tokens`` BEFORE prefill (first-token logits read at
``last=L-1``), so the caches are born full-size.  It runs no paged kernel,
which makes it the port's token oracle for ``ContinuousEngine``.

Step modes, with the reference's policy (``resolve_step_mode`` with
``cpu_default="scan"``; ``REPRO_ENGINE_STEP_MODE`` overrides it):

* ``"scan"`` (the default on a card and on the CPU): the prefill runs
  eagerly, then each decode step is one step program
  (``core/step_graph.py``), a CUDA graph on a card, over static buffers:
  the caches (the prefill's own, or copied in once), the current token, an int32
  position on the device that the body advances, and a
  ``(max_new_tokens - 1, B)`` token buffer the body writes at row
  ``pos - L``.  Nothing is read back to the host until the last step is
  done.  The reference's scan program holds the prefill too; here it stays
  eager, as its length and the caches it returns are the batch's own.
* ``"stepped"``: a Python loop of eager ``Model.decode_step`` calls.

Who owns a program.  A CUDA graph binds the addresses it was captured
with, parameters included, so a program serves one parameter set: it holds
the model and the parameter leaves weakly and is rebuilt (the stale one
dropped first) when a call brings other leaves of the same shapes, such as
the next round's checkpoint.  A program's buffers are a full set of
caches, so a model keeps one program (its ``StepGraphs`` set, held in a
``WeakKeyDictionary`` on the model): a call of another shape or parameter
set drops it before building its own, and the prefill's caches are freed
once loaded, so a decode holds one set.  A program is dropped when its
first parameter leaf is freed: nothing outlives its model or its
parameters.

The padding is the reference's, and so is what it does to a recurrent
state (SSM and hybrid models): an attention cache's pads sit past the
prompt and decode overwrites them, but a recurrent state has no positions
to mask and absorbs the ``max_new_tokens`` pad tokens, so from the second
token on the output parts from a decode that starts from an empty state.
Their full forward also needs ``L + max_new_tokens`` to be a multiple of
the config's ``chunk_size``.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.core.step_graph import (StepGraphs, StepProgram, copy_into,
                                         resolve_step_mode, shape_key)
from repro_torch.utils.pytree import tree_leaves, tree_map

PROGRAM = "static/decode"

_sets: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()   # model -> StepGraphs


@torch.inference_mode()
def generate_static(model, params, prompts, max_new_tokens: int, *,
                    step_mode: str = "auto"):
    """Greedy-decode ``max_new_tokens`` for a (B, L) uniform-length prompt
    batch (array or tensor) on the params' device.  Returns
    (B, max_new_tokens) int32 generated tokens on that device."""
    dev = params["embed"].device
    mode = resolve_step_mode(step_mode, cpu_default="scan", device=dev)
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    B, L = prompts.shape
    padded = torch.nn.functional.pad(prompts, (0, max_new_tokens))
    last = torch.full((B,), L - 1, dtype=torch.int32, device=dev)
    logits, caches = model.prefill(params, {"tokens": padded}, last=last)
    tok = logits.argmax(-1).to(torch.int32)
    del logits
    if max_new_tokens == 1:
        return tok[:, None]
    if mode == "scan":
        prog = load_program(model, params, tok, caches, L, max_new_tokens)
        del caches                  # the decode holds one copy: the program's
        ys = decode_scan(prog, max_new_tokens)
    else:
        ys = decode_stepped(model, params, tok, caches, L, max_new_tokens)
    return torch.cat([tok[:, None], ys.T], dim=1)


def decode_stepped(model, params, tok, caches, L: int, max_new_tokens: int):
    """The ``max_new_tokens - 1`` decode steps after the first token, each
    launched from Python; returns their (max_new_tokens - 1, B) tokens."""
    pos = torch.full((), L, dtype=torch.int32, device=tok.device)
    out = []
    for _ in range(max_new_tokens - 1):
        logits, caches = model.decode_step(params, tok[:, None], caches, pos)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        pos.add_(1)
    return torch.stack(out)


def decode_scan(prog: StepProgram, max_new_tokens: int):
    """The same steps, each one replay of a loaded program
    (``load_program``); returns a copy of its token buffer."""
    for _ in range(max_new_tokens - 1):
        prog()
    return prog.buf["ys"].clone()


class _DecodeBody:
    """One decode step over a program's buffers.  The model and the
    parameter leaves are held weakly: a program must not keep either alive,
    and ``serves`` tells whether it was built for the leaves a call brings."""

    def __init__(self, model, params, buf: dict, L: int):
        self.model = weakref.ref(model)
        self.params = tree_map(weakref.ref, params)
        self.buf, self.L = buf, L

    def serves(self, params) -> bool:
        mine = tree_leaves(self.params)
        theirs = tree_leaves(params)
        return len(mine) == len(theirs) and all(r() is x for r, x in zip(mine, theirs))

    def __call__(self) -> None:
        params = tree_map(lambda r: r(), self.params)
        buf = self.buf
        pos = buf["pos"]
        logits, _ = self.model().decode_step(params, buf["tok"][:, None], buf["caches"], pos)
        tok = logits.argmax(-1).to(torch.int32)
        buf["ys"].index_copy_(0, (pos - self.L).reshape(1).long(), tok[None])
        buf["tok"].copy_(tok)
        pos.add_(1)


def load_program(model, params, tok, caches, L: int, max_new_tokens: int) -> StepProgram:
    """The model's decode program for this batch shape and these parameter
    leaves, its buffers loaded with the prefill's token and caches.  A model
    keeps ONE static program, as each holds a full set of caches: one of
    another shape or parameter set is dropped before its replacement is
    built, and the replacement takes the prefill's caches as its buffers
    where each leaf owns its storage, so a first call copies nothing."""
    graphs = _sets.get(model)
    if graphs is None:
        graphs = _sets[model] = StepGraphs(cpu_default="scan")
    key = (PROGRAM, (L, max_new_tokens, shape_key(params, tok, caches)))
    prog = graphs.programs.get(key)
    if prog is None or not prog.body.serves(params):
        for old in list(graphs.programs.values()):
            graphs.drop(old)
        prog = graphs.program(*key, lambda: _build(model, params, tok, caches, L,
                                                   max_new_tokens))
        weakref.finalize(tree_leaves(params)[0], _forget, weakref.ref(graphs),
                         weakref.ref(prog))
    buf = prog.buf
    copy_into(buf["caches"], caches)
    buf["tok"].copy_(tok)
    buf["pos"].fill_(L)
    return prog


def _owns_storage(x: torch.Tensor) -> bool:
    return x.is_contiguous() and x.untyped_storage().nbytes() == x.numel() * x.element_size()


def _build(model, params, tok, caches, L: int, max_new_tokens: int):
    (B,), dev = tok.shape, tok.device
    buf = {"caches": tree_map(lambda x: x if _owns_storage(x) else torch.empty_like(x), caches),
           "tok": torch.empty((B,), dtype=torch.int32, device=dev),
           "pos": torch.empty((), dtype=torch.int32, device=dev),
           "ys": torch.empty((max_new_tokens - 1, B), dtype=torch.int32, device=dev)}
    return _DecodeBody(model, params, buf, L), buf


def _forget(graphs_ref, prog_ref) -> None:
    """A program's parameters were freed: its graph and buffers go too."""
    graphs, prog = graphs_ref(), prog_ref()
    if graphs is not None and prog is not None:
        graphs.drop(prog)
