"""Port vs reference: serving.  The port's ``ContinuousEngine`` must emit
exactly the greedy tokens of the reference's ``generate_static`` and of
the port's own ``generate_static``, with the reference's weights carried
across, for the request mixes of ``test_serve.py``.

chunk_steps=1 is compared with the static oracles only: the reference's
own engine disagrees with its oracle there
(``test_serve.py::test_chunked_decode_token_parity[1]``).
"""
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve import generate_static as jax_generate_static  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import make_model_batch  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import (BlockAllocator, ContinuousEngine, Request,  # noqa: E402
                               blocks_needed, generate_static, pool_bytes)

ARCH = "qwen2.5-14b"


@pytest.fixture(scope="module")
def served():
    jmodel = jax_build_model(jax_get_config(ARCH).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, model, params, jmodel, jparams


def _requests(cfg, n, L, max_news, seed=0):
    prompts = make_model_batch(cfg, n, L, seed=seed)["tokens"]
    return [Request(rid=i, tokens=prompts[i], max_new_tokens=max_news[i])
            for i in range(n)]


def _static(gen, model, params, requests):
    prompts = np.stack([r.tokens for r in requests])
    n = max(r.max_new_tokens for r in requests)
    out = np.asarray(gen(model, params, prompts, n))
    return {r.rid: out[i, :r.max_new_tokens].tolist() for i, r in enumerate(requests)}


def _engine_tokens(model, params, requests, **kw):
    eng = ContinuousEngine(model, params, **kw)
    return {r.rid: r.tokens for r in eng.run(requests)}, eng


def _three_way(served, reqs, **kw):
    cfg, model, params, jmodel, jparams = served
    toks, eng = _engine_tokens(model, params, reqs, **kw)
    ref = _static(jax_generate_static, jmodel, jparams, reqs)
    assert toks == ref
    assert _static(generate_static, model, params, reqs) == ref
    assert all(len(toks[r.rid]) == r.max_new_tokens for r in reqs)
    return eng


# =========================================== continuous vs static oracles
@pytest.mark.parametrize("chunk_steps", [1, 3, 8])
def test_chunked_decode_token_parity(served, chunk_steps):
    reqs = _requests(served[0], 4, 8, [1, 7, 13, 5], seed=5)
    _three_way(served, reqs, max_batch=4, num_blocks=28, block_size=4,
               max_seq_len=24, chunk_steps=chunk_steps)


def test_join_and_evict_mid_flight(served):
    reqs = _requests(served[0], 3, 8, [3, 11, 7])
    _three_way(served, reqs, max_batch=2, num_blocks=16, block_size=4,
               max_seq_len=20, chunk_steps=2)


def test_token_budget_serializes_admission(served):
    reqs = _requests(served[0], 3, 8, [4, 4, 4])
    budget = blocks_needed(8, 4, 4) * 4
    eng = _three_way(served, reqs, max_batch=2, num_blocks=16, block_size=4,
                     max_seq_len=16, token_budget=budget, chunk_steps=2)
    assert eng.peak_utilization <= (budget / 4) / (16 - 1) + 1e-9


def test_decode_chunk_makes_no_host_sync(served, monkeypatch):
    """Inside a chunk nothing is read back to the host: every tensor→host
    conversion raises while ``_decode_chunk`` runs."""
    cfg, model, params, _, _ = served
    reqs = _requests(cfg, 2, 8, [6, 9], seed=6)
    eng = ContinuousEngine(model, params, max_batch=2, num_blocks=12,
                           block_size=4, max_seq_len=20, chunk_steps=3)
    chunk = eng._decode_chunk

    def guarded(k):
        def no_sync(*_a, **_k):
            raise AssertionError("host sync inside a decode chunk")
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                         "__int__", "__float__", "__index__"):
                m.setattr(torch.Tensor, name, no_sync)
            return chunk(k)

    eng._decode_chunk = guarded
    assert {r.rid: r.tokens for r in eng.run(reqs)} == _static(
        generate_static, model, params, reqs)


# ==================================================== allocator / pages
def test_blocks_needed_covers_prompt_padding():
    assert blocks_needed(5, 1, 4) == 2
    assert blocks_needed(4, 9, 4) == 4
    assert blocks_needed(8, 8, 8) == 2


def test_block_allocator_accounting():
    a = BlockAllocator(9)
    assert a.free_blocks == 8
    got = a.alloc(5)
    assert len(got) == 5 and 0 not in got
    assert a.alloc(4) is None
    assert a.free_blocks == 3
    a.free(got)
    assert a.free_blocks == 8 and a.used_blocks == 0
    with pytest.raises(RuntimeError, match="null block"):
        a.free([0])
    with pytest.raises(ValueError, match="null block"):
        BlockAllocator(1)


def test_engine_frees_everything_after_drain(served):
    cfg, model, params, _, _ = served
    reqs = _requests(cfg, 5, 8, [3, 9, 1, 6, 2])
    _, eng = _engine_tokens(model, params, reqs, max_batch=2, num_blocks=12,
                            block_size=4, max_seq_len=20, chunk_steps=2)
    assert eng.idle
    assert eng.alloc.used_blocks == 0 and eng.reserved_tokens == 0
    assert (eng.seq_lens == 0).all() and (eng.block_tables == 0).all()
    assert 0.0 < eng.peak_utilization <= 1.0


def test_submit_rejects_oversized_request(served):
    cfg, model, params, _, _ = served
    eng = ContinuousEngine(model, params, max_batch=1, num_blocks=8,
                           block_size=4, max_seq_len=16)
    (req,) = _requests(cfg, 1, 8, [9])
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(req)


def test_pool_is_smaller_than_static_caches(served):
    _, model, _, _, _ = served
    pb = pool_bytes(model.init_paged_cache(1 + 4 * 8, 8, device="cpu"))
    sb = pool_bytes(model.init_cache(8, 64, device="cpu"))
    assert pb < sb


# ==================================================== cancel / deadlines
def test_cancel_in_flight_frees_pool_and_keeps_neighbors(served):
    cfg, model, params, _, _ = served
    reqs = _requests(cfg, 2, 8, [20, 20], seed=13)
    eng = ContinuousEngine(model, params, max_batch=2, num_blocks=24,
                           block_size=4, max_seq_len=32, chunk_steps=2)
    for r in reqs:
        eng.submit(r)
    assert eng.step() == []
    assert eng.num_active == 2
    used_before = eng.alloc.used_blocks
    assert eng.cancel(0) is True
    assert eng.cancel(0) is False
    results = []
    while not eng.idle:
        results.extend(eng.step())
    res = {r.rid: r for r in results}
    static = _static(generate_static, model, params, reqs)
    assert res[0].cancelled and 0 < len(res[0].tokens) < 20
    assert res[0].tokens == static[0][:len(res[0].tokens)]
    assert not res[1].cancelled and res[1].tokens == static[1]
    assert eng.alloc.used_blocks == 0 < used_before
    assert eng.reserved_tokens == 0
    assert (eng.block_tables == 0).all() and (eng.seq_lens == 0).all()


def test_cancel_queued_request(served):
    cfg, model, params, _, _ = served
    reqs = _requests(cfg, 2, 8, [6, 6], seed=14)
    reqs[0].deadline_s = 60.0
    eng = ContinuousEngine(model, params, max_batch=1, num_blocks=12,
                           block_size=4, max_seq_len=16, chunk_steps=2)
    for r in reqs:
        eng.submit(r)
    assert eng.cancel(1) is True
    assert eng.cancel(99) is False
    results = []
    while not eng.idle:
        results.extend(eng.step())
    res = {r.rid: r for r in results}
    assert res[1].cancelled and res[1].tokens == []
    assert not res[0].cancelled
    assert res[0].tokens == _static(generate_static, model, params, [reqs[0]])[0]
    assert eng.alloc.used_blocks == 0 and eng.reserved_tokens == 0


def test_deadline_expires_mid_flight(served):
    cfg, model, params, _, _ = served
    (req,) = _requests(cfg, 1, 8, [24], seed=15)
    req.deadline_s = 0.05
    eng = ContinuousEngine(model, params, max_batch=1, num_blocks=16,
                           block_size=4, max_seq_len=40, chunk_steps=2)
    eng.submit(req)
    assert eng.step() == []
    assert eng.num_active == 1
    time.sleep(0.06)
    results = []
    while not eng.idle:
        results.extend(eng.step())
    (res,) = results
    assert res.cancelled and 0 < len(res.tokens) < 24
    assert eng.alloc.used_blocks == 0 and eng.reserved_tokens == 0


def test_deadline_expires_in_queue(served):
    cfg, model, params, _, _ = served
    (req,) = _requests(cfg, 1, 8, [4], seed=16)
    req.deadline_s = 0.0
    eng = ContinuousEngine(model, params, max_batch=1, num_blocks=8,
                           block_size=4, max_seq_len=16, chunk_steps=2)
    eng.submit(req)
    results = []
    while not eng.idle:
        results.extend(eng.step())
    (res,) = results
    assert res.cancelled and res.tokens == []
    assert eng.peak_utilization == 0.0
