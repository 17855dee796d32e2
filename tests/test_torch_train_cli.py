"""The port's training CLI, ``python -m repro_torch.launch.train``, on the
CPU: a few clients, 2 rounds on each engine, the reference's per-round
line (``[preset] round t/T acc=… kd=…``) and history file; ``--overlap``
and ``--kd-pipeline legacy`` run to a drained, complete history; the fault
flags with an attack and a robust aggregator run on both engines; a run
checkpointed with ``--ckpt-dir`` and resumed with ``--resume`` ends where the
uninterrupted one does; ``--arch`` trains each of the last families
ported (llama4-maverick's top-1 MoE, the audio and VLM frontends).
"""
import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402

ROUND_LINE = re.compile(r"^\[fedsdd\] round (\d+)/2 acc=\d\.\d{4} kd=\d+\.\d{4}$")
SMALL = ["--device", "cpu", "--model", "cnn", "--clients", "4", "--rounds", "2",
         "--local-epochs", "1", "--distill-steps", "3", "--K", "2", "--R", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small CPU runs are faster on one thread, and much faster where
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    train.main()


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_cli_runs_two_rounds(execution, monkeypatch, capsys, tmp_path):
    out = tmp_path / "history.json"
    _main(monkeypatch, *SMALL, "--execution", execution, "--out", str(out))
    lines = capsys.readouterr().out.strip().splitlines()
    rounds = [ROUND_LINE.match(line) for line in lines[:-1]]
    assert [int(m.group(1)) for m in rounds if m] == [1, 2], lines
    assert lines[-1].startswith("done in ")
    history = json.loads(out.read_text())
    assert [rec["round"] for rec in history] == [1, 2]
    assert all({"active", "t_local", "t_kd", "acc_main", "kd_loss_last"} <= rec.keys()
               for rec in history)


def test_cli_engines_agree(monkeypatch, capsys):
    """Same flags, either engine: the same per-round lines."""
    got = {}
    for execution in ("sequential", "vectorized"):
        _main(monkeypatch, *SMALL, "--execution", execution)
        got[execution] = capsys.readouterr().out.strip().splitlines()[:-1]
    assert got["sequential"] == got["vectorized"]


def test_cli_lm_task_with_head_fused_flash_kd(monkeypatch, capsys, tmp_path):
    """``--arch`` runs the LM task on the reduced architecture, here with the
    head-fused Flash-KD path: the reference's round lines (no accuracy on
    the LM task) and history."""
    out = tmp_path / "history.json"
    _main(monkeypatch, "--device", "cpu", "--arch", "stablelm-3b", "--clients", "4",
          "--rounds", "2", "--local-epochs", "1", "--distill-steps", "2", "--K", "2",
          "--kd-kernel", "flash", "--kd-head-fusion", "--out", str(out))
    lines = capsys.readouterr().out.strip().splitlines()
    assert [re.fullmatch(r"\[fedsdd\] round (\d)/2 kd=\d+\.\d{4}", x) is not None
            for x in lines[:-1]] == [True, True], lines
    history = json.loads(out.read_text())
    assert [rec["round"] for rec in history] == [1, 2]
    assert all(rec["kd_steps"] == 2 and "acc_main" not in rec for rec in history)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
def test_cli_unported_flags_raise(arch, monkeypatch, capsys, tmp_path):
    """The ``--arch`` values this CLI once refused now train 2 rounds of
    their ``reduced()`` models, head-fused Flash-KD included."""
    out = tmp_path / "history.json"
    _main(monkeypatch, "--device", "cpu", "--arch", arch, "--clients", "4", "--rounds", "2",
          "--local-epochs", "1", "--distill-steps", "2", "--K", "2", "--kd-kernel", "flash",
          "--kd-head-fusion", "--out", str(out))
    lines = capsys.readouterr().out.strip().splitlines()
    assert [re.fullmatch(r"\[fedsdd\] round (\d)/2 kd=\d+\.\d{4}", x) is not None
            for x in lines[:-1]] == [True, True], lines
    assert [rec["round"] for rec in json.loads(out.read_text())] == [1, 2]


def test_cli_deepseek_moe_mla_runs(monkeypatch, capsys, tmp_path):
    """``--arch deepseek-v2-lite-16b`` trains its ``reduced()`` MLA + MoE
    model on the LM task, head-fused Flash-KD included."""
    out = tmp_path / "history.json"
    _main(monkeypatch, "--device", "cpu", "--arch", "deepseek-v2-lite-16b", "--clients", "4",
          "--rounds", "2", "--local-epochs", "1", "--distill-steps", "2", "--K", "2",
          "--kd-kernel", "flash", "--kd-head-fusion", "--out", str(out))
    lines = capsys.readouterr().out.strip().splitlines()
    assert [re.fullmatch(r"\[fedsdd\] round (\d)/2 kd=\d+\.\d{4}", x) is not None
            for x in lines[:-1]] == [True, True], lines
    assert [rec["round"] for rec in json.loads(out.read_text())] == [1, 2]


def test_cli_fedbe_preset_runs(monkeypatch, capsys):
    """``--preset fedbe``: FedDF's client teachers plus the posterior samples."""
    _main(monkeypatch, *SMALL, "--preset", "fedbe")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.startswith("[fedbe] round ") for line in lines[:-1]] == [True, True], lines


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_cli_faults_attack_and_robust_aggregator_run(execution, monkeypatch, capsys, tmp_path):
    """``--faults`` with a dropout rate, sign-flip attacks and the median:
    each round's line carries the fault ruling, the history its fields."""
    out = tmp_path / "history.json"
    _main(monkeypatch, *SMALL, "--execution", execution, "--faults", "--dropout-rate", "0.3",
          "--attack", "sign_flip", "--attack-rate", "0.5", "--fault-seed", "3",
          "--aggregator", "median", "--out", str(out))
    lines = capsys.readouterr().out.strip().splitlines()
    assert all(" survivors=" in line for line in lines[:-1]), lines
    assert any(" attacked=" in line for line in lines[:-1]), lines
    history = json.loads(out.read_text())
    assert all({"survivors", "dropped", "attacked", "degraded_groups"} <= rec.keys()
               for rec in history)


def test_cli_checkpoint_and_resume_equal_the_uninterrupted_run(monkeypatch, capsys, tmp_path):
    """``--ckpt-dir`` after every round, then ``--resume`` from the state
    after round 1 (a KD job in flight under ``--overlap async``): the
    resumed run ends where the uninterrupted one does, bit for bit."""
    from repro_torch.fedckpt.checkpointer import Checkpointer
    flags = [*SMALL, "--overlap", "async"]
    full = tmp_path / "full"
    _main(monkeypatch, *flags, "--ckpt-dir", str(full))
    capsys.readouterr()
    part = tmp_path / "part"
    _main(monkeypatch, *flags, "--rounds", "1", "--ckpt-dir", str(part))   # the last --rounds wins
    # the killed run's state after round 1, its pending job spilled
    ck = Checkpointer(str(part), prefix="state")
    assert ck.steps() == [1]
    _main(monkeypatch, *flags, "--ckpt-dir", str(part), "--resume")
    lines = capsys.readouterr().out.strip().splitlines()
    assert "resumed from round 1" in lines
    a = Checkpointer(str(full), prefix="state")
    b = Checkpointer(str(part), prefix="state")
    assert a.latest() == b.latest() == 2
    with np.load(a._path(2)) as x, np.load(b._path(2)) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("flags", [
    ["--overlap", "async", "--execution", "vectorized"], ["--kd-pipeline", "legacy"]],
    ids=["async", "legacy"])
def test_cli_overlap_and_legacy_run(flags, monkeypatch, capsys, tmp_path):
    """``--overlap`` and the legacy KD oracle run; the run ends with the
    drain, so every record is complete (the runner's parity with the
    off-mode run is tests/test_torch_overlap.py's and
    test_torch_distillation.py's)."""
    out = tmp_path / "history.json"
    _main(monkeypatch, *SMALL, *flags, "--out", str(out))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("done in ")
    history = json.loads(out.read_text())
    assert [rec["round"] for rec in history] == [1, 2]
    assert all({"acc_main", "kd_loss_last", "kd_steps", "t_round"} <= rec.keys()
               for rec in history)
