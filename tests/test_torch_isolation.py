"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the port's entry points run on CUDA
unless the caller asks for the CPU — with no GPU they raise instead of
carrying on quietly on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    """Top-level names of every import in the file, function-local ones
    included."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_reference(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_importing_the_port_loads_no_jax_or_reference():
    code = (
        "import importlib.util, sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.interop, repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.core.fedsdd, repro_torch.core.tasks, repro_torch.distill\n"
        "import repro_torch.kernels.kd_loss.ops, repro_torch.kernels.weight_avg.ops\n"
        "import repro_torch.core.engine, repro_torch.launch.train\n"
        "import repro_torch.kernels.kd_loss.flash\n"
        "import repro_torch.kernels.flash_attention.ref, repro_torch.configs.starcoder2_3b\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    from repro_torch import device, interop
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as cli
    from repro_torch.models.model_zoo import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("qwen2.5-14b").reduced())
    for call in (device.resolve, lambda: model.init(0),
                 lambda: model.init_paged_cache(4, 4),
                 lambda: interop.params_from_numpy({})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from repro_torch.core.fedsdd import FederatedRunner, make_config, make_runner
    from repro_torch.core.tasks import classification_task
    from repro_torch.distill import KDPipeline
    from repro_torch.core.tasks import lm_task
    task = classification_task(num_clients=2, num_train=40, num_server=256, device="cpu")
    for call in (lambda: classification_task(num_clients=2, num_train=40, num_server=256),
                 lambda: lm_task(get_config("gemma-2b").reduced(), num_clients=2),
                 lambda: make_runner("fedsdd", task),
                 lambda: FederatedRunner(make_config("fedavg"), task),
                 lambda: KDPipeline(task.logits_fn, steps=1, lr=0.1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2.5-14b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main()
    from repro_torch.launch import train as train_cli
    monkeypatch.setattr(sys, "argv", ["train", "--execution", "vectorized"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main()
    assert device.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("where", ["repo, card hidden", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(where, tmp_path):
    """Exit non-zero with no result line, both in the checkout with every
    card hidden (``CUDA_VISIBLE_DEVICES=""``) and, cards visible, in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    env = dict(os.environ)
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text((ROOT / "chip_smoke.py").read_text())
    else:
        script = ROOT / "chip_smoke.py"
        env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], capture_output=True, env=env,
                         text=True, timeout=120, cwd=script.parent)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
