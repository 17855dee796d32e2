"""Continuous-batching scheduler over the paged KV pool
(port of ``repro/serve/engine.py``).

The engine keeps a fixed number of batch slots (``max_batch``) and one
paged pool; slot occupancy changes by editing the host-side block tables.
Each ``step()``:

  1. **Cancellation / deadlines**: flagged or expired lanes are evicted
     and free their blocks before admission.
  2. **Admission**: the FIFO queue head is admitted while a slot, its
     worst-case block reservation (``blocks_needed``) and the token
     budget are all available.  Admission runs the request's prefill over
     the block-aligned padded prompt and scatters it into the pool; its
     first greedy token is the one host sync per request.
  3. **Decode**: ``chunk_steps`` micro-steps of ``paged_decode_step`` for
     every slot.  Tokens, ``seq_lens`` and the remaining budgets stay on
     the device: argmax, the seq_len advance and the budget countdown run
     there, and no micro-step reads anything back to the host.  Inactive
     slots carry ``seq_len == 0`` and an all-null block table.  Under the
     step mode ``"scan"`` (the default on a card and on the CPU, as the
     reference jits its chunk; ``REPRO_ENGINE_STEP_MODE`` overrides it)
     the whole chunk is one step program (``core/step_graph.py``): a CUDA
     graph on a card over the engine's static token, seq_len, budget and
     block-table buffers, which ``step()`` refills with ``copy_`` and the
     chunk's last node writes back in place.  ``"stepped"`` launches each
     micro-step's ops from Python.  Prefill stays eager: its length varies.
  4. **Eviction**: finished requests free their blocks; their tokens are
     copied to the host only then, from the buffered chunk outputs.

Scheduling needs no token values — lifetimes are fixed counters at
admission — so the host mirrors the device's seq_len/budget arithmetic
and only dispatches.
"""
from __future__ import annotations

import math
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analysis.sync import allowed_sync
from repro_torch.core.step_graph import StepGraphs
from repro_torch.device import to_device
from repro_torch.serve import paged_cache as pc


@dataclass
class Request:
    rid: int
    tokens: np.ndarray          # (L,) int32 prompt
    max_new_tokens: int
    t_submit: float = 0.0       # stamped by ContinuousEngine.submit
    # decode deadline in seconds after submit (None = no deadline): a
    # request still unfinished past it is expired at the next chunk
    # boundary and frees its pool blocks like a cancellation
    deadline_s: float | None = None


@dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: list[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0        # first generated token (end of prefill)
    t_finish: float = 0.0
    cancelled: bool = False     # cancel()ed or deadline-expired; ``tokens``
    #                             holds whatever was generated before

    @property
    def latency(self) -> float:
        return self.t_finish - self.t_submit

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit


class _Slot:
    __slots__ = ("req", "result", "blocks", "remaining", "start_step",
                 "cancelled", "deadline")

    def __init__(self, req, result, blocks, remaining, start_step):
        self.req = req
        self.result = result
        self.blocks = blocks
        self.remaining = remaining
        self.start_step = start_step    # index into the chunk-token buffer
        self.cancelled = False
        self.deadline = (None if req.deadline_s is None
                         else req.t_submit + req.deadline_s)


class ContinuousEngine:
    """Continuous-batching greedy decoder for one dense all-GQA model.

    Runs on the device that holds ``params``.  ``token_budget`` caps the
    sum of reserved tokens (blocks × block size) across in-flight requests,
    defaulting to the whole pool.
    """

    def __init__(self, model, params, *, max_batch: int = 8,
                 num_blocks: int = 256, block_size: int = 16,
                 max_seq_len: int = 512, token_budget: int | None = None,
                 chunk_steps: int = 8):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.max_batch = max_batch
        self.block_size = block_size
        self.max_seq_len = max_seq_len
        self.nbmax = math.ceil(max_seq_len / block_size)
        self.token_budget = (token_budget if token_budget is not None
                             else (num_blocks - 1) * block_size)
        # micro-steps per decode chunk; the scheduler runs at chunk
        # boundaries, and a lane finishing mid-chunk freezes via its rem
        # counter instead of shrinking the chunk
        self.chunk_steps = chunk_steps
        # device state: pool + decode loop carries, static buffers written in
        # place; the host never reads them mid-chunk
        dev = self.device
        self.graphs = StepGraphs(cpu_default="scan")   # the chunk jitted, as in the reference
        self.pool = model.init_paged_cache(num_blocks, block_size, device=dev)
        self._cur_tok = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self._sl_dev = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self._bt_dev = torch.zeros((max_batch, self.nbmax), dtype=torch.int32, device=dev)
        self._rem_dev = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self._dirty = False          # host tables changed since last push
        self._step_toks: list = []   # per-chunk (k, B) token tensors, on
        #                              the device until eviction reads them
        # host state
        self.alloc = pc.BlockAllocator(num_blocks)
        self.block_tables = np.zeros((max_batch, self.nbmax), np.int32)
        self.seq_lens = np.zeros((max_batch,), np.int32)
        self.slots: list[_Slot | None] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self._done_buf: list[RequestResult] = []  # cancelled-in-queue etc.
        self.reserved_tokens = 0
        self.steps = 0
        self.peak_utilization = 0.0

    def jit_programs(self) -> dict:
        """The decode chunk's step programs by label (see
        ``analysis.TraceGuard``); the prefill runs eagerly."""
        return self.graphs.jit_programs()

    # ---- queue ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        L = len(req.tokens)
        need = pc.blocks_needed(L, req.max_new_tokens, self.block_size)
        if need > self.nbmax or L + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {req.rid}: {L}+{req.max_new_tokens} tokens exceeds "
                f"max_seq_len={self.max_seq_len}")
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request.  Queued: removed now, its
        (empty) result is returned by the next ``step``.  In-flight:
        flagged — the slot is evicted and its pool blocks freed at the next
        chunk boundary.  False if the rid is unknown (already finished or
        never submitted)."""
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[i]
                res = RequestResult(rid=r.rid, prompt_len=len(r.tokens),
                                    t_submit=r.t_submit, cancelled=True)
                res.t_finish = time.perf_counter()
                self._done_buf.append(res)
                return True
        for s in self.slots:
            if s is not None and s.req.rid == rid and not s.cancelled:
                s.cancelled = True
                return True
        return False

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return (self.num_active == 0 and not self.queue
                and not self._done_buf)

    @property
    def pool_utilization(self) -> float:
        return self.alloc.utilization

    # ---- admission -----------------------------------------------------
    def _can_admit(self, req: Request) -> tuple[int, list[int]] | None:
        try:
            slot = self.slots.index(None)
        except ValueError:
            return None
        need = pc.blocks_needed(len(req.tokens), req.max_new_tokens,
                                self.block_size)
        if self.reserved_tokens + need * self.block_size > self.token_budget:
            return None
        blocks = self.alloc.alloc(need)
        if blocks is None:
            return None
        return slot, blocks

    def _admit(self, req: Request, slot: int, blocks: list[int]) -> None:
        L = len(req.tokens)
        bs = self.block_size
        lpad = math.ceil(L / bs) * bs
        toks = np.zeros((1, lpad), np.int32)
        toks[0, :L] = req.tokens
        result = RequestResult(rid=req.rid, prompt_len=L,
                               t_submit=req.t_submit,
                               t_admit=time.perf_counter())
        logits, ctg = self.model.prefill(
            self.params, {"tokens": to_device(toks, self.device)},
            last=[L - 1])
        pc.scatter_prefill(self.pool, ctg, blocks[:lpad // bs])
        tok = logits.argmax(-1).to(torch.int32)
        with allowed_sync("the one per-request sync: first token out of "
                          "prefill seeds the decode batch"):
            first = int(tok[0])
        result.t_first = time.perf_counter()
        result.tokens.append(first)
        self.block_tables[slot] = pc.build_table(blocks, self.nbmax)
        self.seq_lens[slot] = L
        self._cur_tok[slot] = tok[0]
        self._dirty = True
        self.reserved_tokens += len(blocks) * bs
        self.slots[slot] = _Slot(req, result, blocks,
                                 remaining=req.max_new_tokens - 1,
                                 start_step=len(self._step_toks))

    def _lane_tokens(self, slot: int, start: int, n: int) -> list[int]:
        """Materialize one lane's ``n`` tokens from the buffered chunk
        outputs (each touched (k, B) chunk is copied to the host once).
        Rows past the lane's budget in its final chunk are the frozen-lane
        garbage and are not taken."""
        out, t = [], start
        with allowed_sync("token materialization at eviction: chunks "
                          "convert to numpy once, after the lane is done"):
            while len(out) < n:
                if not isinstance(self._step_toks[t], np.ndarray):
                    self._step_toks[t] = self._step_toks[t].cpu().numpy()
                take = min(len(self._step_toks[t]), n - len(out))
                out.extend(int(x) for x in self._step_toks[t][:take, slot])
                t += 1
        return out

    def _evict(self, slot: int) -> RequestResult:
        s = self.slots[slot]
        # finished lanes have remaining == 0 (the full budget); cancelled/
        # expired lanes keep whatever they generated before the boundary
        s.result.tokens.extend(
            self._lane_tokens(slot, s.start_step,
                              (s.req.max_new_tokens - 1) - s.remaining))
        s.result.t_finish = time.perf_counter()
        self.alloc.free(s.blocks)
        self.reserved_tokens -= len(s.blocks) * self.block_size
        self.block_tables[slot] = 0
        self.seq_lens[slot] = 0
        self.slots[slot] = None
        self._dirty = True
        return s.result

    # ---- the step ------------------------------------------------------
    def _decode_chunk(self, k: int) -> torch.Tensor:
        """``k`` micro-steps, all on the device; returns their (k, B) tokens.
        A lane whose budget (rem) runs out mid-chunk freezes: its seq_len
        stops advancing, so its repeated scatter lands on the one slot past
        its generated text and its tokens are never read.  Live lanes only
        ever read positions below their own seq_len."""
        if self.graphs.scan(self.device):
            prog = self.graphs.program("decode/chunk", (k,), lambda: self._chunk_program(k))
            prog()
            return prog.buf["ys"].clone()
        ys = torch.empty((k, self.max_batch), dtype=torch.int32, device=self.device)
        self._chunk_body(k, ys)
        return ys

    def _chunk_body(self, k: int, ys: torch.Tensor) -> None:
        tok, sl, rem = self._cur_tok, self._sl_dev, self._rem_dev
        for i in range(k):
            logits, self.pool = self.model.paged_decode_step(
                self.params, tok[:, None], self.pool, self._bt_dev, sl)
            tok = logits.argmax(-1).to(torch.int32)
            adv = (rem > 0).to(torch.int32)
            sl, rem = sl + adv, rem - adv
            ys[i] = tok
        # the carries go back into the static buffers in place
        self._cur_tok.copy_(tok)
        self._sl_dev.copy_(sl)
        self._rem_dev.copy_(rem)

    def _chunk_program(self, k: int):
        buf = {"ys": torch.empty((k, self.max_batch), dtype=torch.int32, device=self.device)}
        me = weakref.proxy(self)     # the engine owns the program: no cycle through it
        return (lambda: me._chunk_body(k, buf["ys"])), buf

    @torch.inference_mode()
    def step(self) -> list[RequestResult]:
        """Admit what fits, decode one chunk for every active slot, evict
        what finished.  Returns the results finished this step."""
        finished, self._done_buf = self._done_buf, []
        now = time.perf_counter()
        # cancelled or expired lanes free their blocks BEFORE admission so
        # the queue head can take the reclaimed slot this very step
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if s.cancelled or (s.deadline is not None and now > s.deadline):
                s.result.cancelled = True
                finished.append(self._evict(i))
        expired = [r for r in self.queue if r.deadline_s is not None
                   and now > r.t_submit + r.deadline_s]
        for r in expired:
            self.queue.remove(r)
            res = RequestResult(rid=r.rid, prompt_len=len(r.tokens),
                                t_submit=r.t_submit, cancelled=True)
            res.t_finish = now
            finished.append(res)
        while self.queue:
            grant = self._can_admit(self.queue[0])
            if grant is None:
                break
            req = self.queue.popleft()
            self._admit(req, *grant)
            self.peak_utilization = max(self.peak_utilization,
                                        self.alloc.utilization)
            if self.slots[grant[0]].remaining == 0:     # max_new_tokens == 1
                finished.append(self._evict(grant[0]))
        if self.num_active:
            if self._dirty:
                # copied into the static buffers (queued, no wait): the host
                # arrays keep changing
                dev = self.device
                self._bt_dev.copy_(to_device(self.block_tables, dev))
                self._sl_dev.copy_(to_device(self.seq_lens, dev))
                self._rem_dev.copy_(to_device(np.asarray(
                    [0 if s is None else s.remaining for s in self.slots], np.int32), dev))
                self._dirty = False
            k = self.chunk_steps
            self._step_toks.append(self._decode_chunk(k))
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                used = min(s.remaining, k)   # host mirror of the device adv
                self.seq_lens[i] += used
                s.remaining -= used
                if s.remaining == 0:
                    finished.append(self._evict(i))
            self.steps += k
        return finished

    def run(self, requests) -> list[RequestResult]:
        """Submit everything up front and step until drained."""
        for r in requests:
            self.submit(r)
        out = []
        while not self.idle:
            out.extend(self.step())
        return out


def run_closed_loop(engine: ContinuousEngine, requests, arrivals
                    ) -> list[RequestResult]:
    """Closed-loop traffic driver: ``arrivals[i]`` seconds after start,
    request i becomes visible.  The engine steps continuously; latency is
    measured submit→finish, so queueing delay under load is included."""
    if len(arrivals) != len(requests):
        raise ValueError(f"arrivals ({len(arrivals)}) and requests "
                         f"({len(requests)}) must align one-to-one")
    order = np.argsort(arrivals, kind="stable")
    t0 = time.perf_counter()
    results, i = [], 0
    while len(results) < len(requests):
        now = time.perf_counter() - t0
        while i < len(order) and arrivals[order[i]] <= now:
            engine.submit(requests[order[i]])
            i += 1
        if engine.idle:
            time.sleep(min(1e-3, max(0.0, arrivals[order[i]] - now)))
            continue
        results.extend(engine.step())
    return results
