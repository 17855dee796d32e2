"""Port vs reference: the recurrent families as models: xlstm-1.3b and
jamba-1.5-large-398b.

  (b) ``reduced()`` models (jamba at capacity factor 64, no drops), the
      reference's weights carried across: features, the loss and the
      gradient against the JAX model; ``decode_step`` from ``init_cache``
      over S = 32 against the port's full forward within 5e-4 (the
      reference's ``test_decode_matches_full_forward``) and against JAX's
      decode; the prefill states against JAX's, and under a bf16 config
      the recurrent states f32 (``init_cache`` and prefill dtypes equal to
      JAX's); ``generate_static`` tokens equal to JAX's; the reference's
      right-padding caveat pinned (the pads enter the recurrent state, so
      from the second token on the static path parts from a decode that
      starts from an empty state); ``init_paged_cache`` raises.
  (c) pure Python, no JAX compile: ``layer_schedule`` / ``split_schedule``
      of the FULL configs, and ``num_params``, ``num_active_params``,
      ``supports_decode``, ``supports_long_context`` of every registered
      arch against the reference's.
  (d) two FedSDD LM rounds of the reduced xlstm with head-fused Flash-KD
      (f32) on both engines against the JAX runner (2e-4, as
      ``test_torch_fedsdd_lm.py``); the train CLI with ``--arch
      xlstm-1.3b``; the serve CLI's static path, and ``--continuous``
      raising the reference's ``ValueError``.

Every sequence length below is a multiple of the reduced chunk (16): a
full forward (a prefill, a static batch's ``L + max_new``) needs one.
Router ties: as in ``test_torch_moe_mla.py``, every MoE input has its
k-th and (k+1)-th router probabilities at least 1e-6 apart, asserted.
Tolerances: features and the loss rtol 1e-5 (atol 1e-5 on O(1)
activations); gradients rtol 1e-4 / atol 1e-6; decode within 5e-4, the
reference's own.
"""
import dataclasses
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs as jax_list_configs  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import lm_task as jax_lm_task  # noqa: E402
from repro.data.synthetic import make_model_batch  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.serve import generate_static as jax_generate_static  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import lm_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim.optimizers import value_and_grad  # noqa: E402
from repro_torch.serve import generate_static  # noqa: E402

ARCHS = ["xlstm-1.3b", "jamba-1.5-large-398b"]
NO_DROPS = 64.0
TIE_GAP = 1e-6
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small CPU runs (the sLSTM loop is many tiny ops) are faster on
    one thread, and much faster where several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, rtol=1e-5, atol=1e-5):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=rtol, atol=atol),
                 interop.params_to_numpy(port), _np(ref))


def _cfgs(arch, **changes):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 capacity_factor=NO_DROPS))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=NO_DROPS))
    return dataclasses.replace(jcfg, **changes), dataclasses.replace(cfg, **changes)


@pytest.fixture
def router_ties(monkeypatch):
    """Every router table ``moe_ffn`` computes; the test asserts the gap."""
    seen = []
    router_probs = moe.router_probs

    def recording(p, x, cfg):
        probs = router_probs(p, x, cfg)
        seen.append((probs.detach(), cfg.moe.top_k))
        return probs

    monkeypatch.setattr(moe, "router_probs", recording)
    yield seen
    for probs, k in seen:
        top = np.sort(probs.numpy(), axis=-1)[..., ::-1]
        assert (top[..., k - 1] - top[..., k]).min() >= TIE_GAP


# -------------------------------------------------------------------- (b)
@pytest.fixture(scope="module", params=ARCHS)
def model_case(request):
    jcfg, cfg = _cfgs(request.param)
    jmodel, model = jzoo.build_model(jcfg), zoo.build_model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = interop.params_from_numpy(_np(jparams), device="cpu")
    return request.param, jmodel, jparams, model, params


def test_schedule_and_tree_match_reference(model_case):
    arch, jmodel, jparams, model, params = model_case
    assert [(k.mixer, k.ffn) for k in model.schedule] == \
        [(k.mixer, k.ffn) for k in jmodel.schedule]
    assert model.prefix_period == jmodel.prefix_period
    jflat = jax.tree_util.tree_flatten_with_path(_np(jparams))[0]
    fresh = interop.params_to_numpy(model.init(0, device="cpu"))
    flat = jax.tree_util.tree_flatten_with_path(fresh)[0]
    assert [(p, a.shape, a.dtype) for p, a in flat] == [(p, a.shape, a.dtype) for p, a in jflat]


def test_features_loss_and_grad_match_reference(model_case, router_ties):
    arch, jmodel, jparams, model, params = model_case
    nb = make_model_batch(jmodel.cfg, B, S, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    _close(model.features(params, batch), jax.jit(jmodel.features)(jparams, nb))
    (jloss, jinfo), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, nb)
    (loss, info), grads = value_and_grad(model.loss, has_aux=True)(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(info["moe_aux"]), float(jinfo["moe_aux"]), rtol=1e-5)
    _close(grads, jgrads, rtol=1e-4, atol=1e-6)
    ssm_leaves = [g for blk in [*grads.get("prefix", []), *grads["blocks"].values()]
                  if "ssm" in blk for g in blk["ssm"].values()]
    assert ssm_leaves and all(float(g.abs().max()) > 0 for g in ssm_leaves)


def test_decode_matches_forward_and_reference(model_case, router_ties):
    """Token-by-token decode from ``init_cache`` == the port's full forward
    within 5e-4 and == JAX's decode; the states are updated in place."""
    arch, jmodel, jparams, model, params = model_case
    toks = make_model_batch(model.cfg, B, S)["tokens"]
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full, _ = model.logits(params, {"tokens": tt})
        cache = model.init_cache(B, S, device="cpu")
        ptrs = {id(v): v.data_ptr() for v in jax.tree.leaves(cache)}
        dec = []
        for t in range(S):
            lg, out = model.decode_step(params, tt[:, t:t + 1], cache, t)
            assert all(a is b for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(cache)))
            dec.append(lg)
        dec = torch.stack(dec, dim=1)
    assert {id(v): v.data_ptr() for v in jax.tree.leaves(cache)} == ptrs
    assert float((dec - full).abs().max()) < 5e-4
    jcache = jmodel.init_cache(B, S)
    jstep = jax.jit(jmodel.decode_step)
    jdec = []
    for t in range(S):
        lg, jcache = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jcache, t)
        jdec.append(lg)
    np.testing.assert_allclose(dec.numpy(), np.stack([np.asarray(x) for x in jdec], 1),
                               rtol=1e-5, atol=1e-5)
    _close(cache, jcache)


def test_prefill_states_match_reference(model_case, router_ties):
    arch, jmodel, jparams, model, params = model_case
    toks = make_model_batch(model.cfg, B, S, seed=4)["tokens"]
    jl, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        pl, pc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    _close(pc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_states_stay_f32_under_bf16(arch):
    """bf16 config: ``init_cache`` and prefill give each state leaf JAX's
    dtype (the recurrent states f32, an attention layer's K/V and Mamba's
    prefill conv tail bf16); JAX's side by ``eval_shape``, no compile."""
    jcfg, cfg = _cfgs(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    jmodel, model = jzoo.build_model(jcfg), zoo.build_model(cfg)
    params = model.init(0, device="cpu")
    toks = make_model_batch(cfg, B, S)["tokens"]
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    _, jpre = jax.eval_shape(jmodel.prefill, jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        _, pre = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    dtypes = lambda tree: jax.tree.map(lambda v: str(v.dtype).removeprefix("torch."),  # noqa: E731
                                       tree)
    assert dtypes(pre) == dtypes(jpre)
    assert dtypes(model.init_cache(B, S, device="cpu")) == \
        dtypes(jax.eval_shape(lambda: jmodel.init_cache(B, S)))
    kinds = {k.mixer for k in model.schedule}
    states = [v for blk in [*pre["prefix"], *pre["blocks"].values()] for k, v in blk.items()
              if k not in ("k", "v", "conv")]
    assert states and all(v.dtype == torch.float32 for v in states), kinds


def test_generate_static_matches_jax_oracle(model_case, router_ties):
    """Right padding included: L + max_new = 32, two chunks."""
    arch, jmodel, jparams, model, params = model_case
    prompts = make_model_batch(model.cfg, B, 20, seed=5)["tokens"]
    got = generate_static(model, params, prompts, 12).numpy()
    want = np.asarray(jax_generate_static(jmodel, jparams, prompts, 12))
    np.testing.assert_array_equal(got, want)


def test_static_padding_enters_recurrent_state(model_case, router_ties):
    """The reference caveat (``repro/serve/static.py`` pads the prompts to
    L + max_new before prefill): a recurrent state absorbs the pads, so
    the static path's first token equals a decode from an empty state fed
    the prompt token by token, and its second step's logits do not."""
    arch, jmodel, jparams, model, params = model_case
    L, new = 20, 12
    prompts = torch.from_numpy(make_model_batch(model.cfg, B, L, seed=6)["tokens"])
    with torch.no_grad():
        padded = torch.nn.functional.pad(prompts, (0, new))
        lg_pad, c_pad = model.prefill(params, {"tokens": padded},
                                      last=torch.full((B,), L - 1))
        cache = model.init_cache(B, L + new, device="cpu")
        for t in range(L):
            lg, cache = model.decode_step(params, prompts[:, t:t + 1], cache, t)
        np.testing.assert_allclose(lg.numpy(), lg_pad.numpy(), atol=5e-4)
        tok = lg.argmax(-1)[:, None]
        second_clean, _ = model.decode_step(params, tok, cache, L)
        second_pad, _ = model.decode_step(params, tok, c_pad, L)
    assert float((second_clean - second_pad).abs().max()) > 1e-2


def test_paged_cache_refuses_recurrent_mixers(model_case):
    with pytest.raises(ValueError, match="GQA"):
        model_case[3].init_paged_cache(16, 8, device="cpu")


# -------------------------------------------------------------------- (c)
@pytest.mark.parametrize("arch", ARCHS)
def test_full_schedules_match_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    kinds, jkinds = zoo.layer_schedule(cfg), jzoo.layer_schedule(jcfg)
    assert [(k.mixer, k.ffn) for k in kinds] == [(k.mixer, k.ffn) for k in jkinds]
    assert zoo.split_schedule(kinds) == jzoo.split_schedule(jkinds)
    model = zoo.build_model(cfg)
    if arch == "xlstm-1.3b":
        assert model.prefix_period == (0, 4) and model.n_super == 12
        assert [k.mixer for k in model.superblock] == ["mlstm"] * 3 + ["slstm"]
    else:
        assert model.prefix_period == (0, 8) and model.n_super == 9
        assert [(k.mixer, k.ffn) for k in model.superblock] == \
            [("mamba", "dense"), ("mamba", "moe")] * 3 + [("mamba", "dense"), ("gqa", "moe")]


def test_counts_and_support_flags_match_reference():
    assert set(ARCHS) <= set(list_configs())
    for arch in list_configs():
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (get_config(arch).reduced(), jax_get_config(arch).reduced())):
            assert cfg.num_params() == jcfg.num_params(), arch
            assert cfg.num_active_params() == jcfg.num_active_params(), arch
            assert cfg.supports_decode == jcfg.supports_decode, arch
            assert cfg.supports_long_context() == jcfg.supports_long_context(), arch
    assert set(jax_list_configs()) - set(list_configs()) == set()


def test_input_shapes_match_reference():
    from repro.configs import shapes as jshapes
    from repro_torch.configs import shapes
    assert {k: dataclasses.astuple(v) for k, v in shapes.INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.INPUT_SHAPES.items()}
    assert shapes.get_shape("long_500k").seq_len == 524_288


# -------------------------------------------------------------------- (d)
ARCH = "xlstm-1.3b"
TASK = dict(num_clients=4, docs_per_client=2, seq=32, server_batches_n=2, server_batch=2)
ROUND = dict(num_clients=4, participation=1.0, local_epochs=1, client_lr=0.02, client_batch=2,
             distill_steps=3, server_lr=0.02, K=2, R=1, kd_kernel="flash", kd_head_fusion=True,
             teacher_cache_dtype="float32")


@pytest.fixture(scope="module")
def jax_rounds():
    """The JAX runner's two sequential rounds, shared by both of the port's
    engines (the reference's engines agree within its tolerance)."""
    jtask = jax_lm_task(jax_get_config(ARCH).reduced(), **TASK)
    jrunner = jax_make_runner("fedsdd", jtask, **ROUND)
    keys = jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), jrunner.cfg.K)
    init = [_np(jtask.init_fn(k)) for k in keys]
    return init, jrunner.run(rounds=2)


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_two_lm_rounds_match_jax_runner(jax_rounds, execution):
    init, jstate = jax_rounds
    task = lm_task(get_config(ARCH).reduced(), **TASK, device="cpu")
    runner = make_runner("fedsdd", task, device="cpu", execution=execution, **ROUND)
    state = runner.run(2, state=FedState(
        round=0, global_models=[interop.params_from_numpy(m, device="cpu") for m in init],
        ensemble=TeacherBank(2, 1)))
    for m, jm in zip(state.global_models, jstate.global_models):
        _close(m, jm, rtol=2e-4, atol=2e-4)
    for rec, jrec in zip(state.history, jstate.history):
        for k in ("kd_loss_first", "kd_loss_last"):
            np.testing.assert_allclose(rec[k], jrec[k], rtol=2e-4, atol=2e-4)


def test_train_cli_runs_xlstm(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import train
    out = tmp_path / "history.json"
    monkeypatch.setattr(sys, "argv", [
        "train", "--device", "cpu", "--arch", ARCH, "--clients", "4", "--rounds", "2",
        "--local-epochs", "1", "--distill-steps", "2", "--K", "2", "--kd-kernel", "flash",
        "--kd-head-fusion", "--out", str(out)])
    train.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert [re.fullmatch(r"\[fedsdd\] round (\d)/2 kd=\d+\.\d{4}", x) is not None
            for x in lines[:-1]] == [True, True], lines
    assert [rec["round"] for rec in json.loads(out.read_text())] == [1, 2]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_static_runs_and_continuous_refuses(arch, monkeypatch, capsys):
    from repro_torch.launch import serve as serve_cli
    argv = ["serve", "--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--decode-steps", "4"]
    monkeypatch.setattr(sys, "argv", argv)
    serve_cli.main()
    assert capsys.readouterr().out.startswith("static: 8 tokens")
    monkeypatch.setattr(sys, "argv", argv + ["--continuous"])
    with pytest.raises(ValueError, match="all-GQA"):
        serve_cli.main()
