"""The port stands alone: ``import repro_torch`` loads neither jax nor any
module of ``repro``, and its entry points refuse to run on the CPU unless
asked to."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "torch_quickstart.py",
    ROOT / "examples" / "torch_har_federated.py", ROOT / "examples" / "torch_serve_batched.py",
    ROOT / "examples" / "torch_federated_lm.py", ROOT / "benchmarks" / "_torch_harness.py"] + sorted((ROOT / "benchmarks").glob("torch_*.py"))
_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)")

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any attempt to import jax fails
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro.")
             or m == "jax" and sys.modules[m] is not None or m.startswith("jax."))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("BAD", bad)
print("NEW", sorted(m for m in sys.modules if m.endswith((".fleet", ".quantize.ops",
                                                          ".quantize.kernel"))))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    loaded = int(out.stdout.split("LOADED")[1].split()[0])
    assert loaded >= 30, out.stdout
    assert ("NEW ['repro_torch.core.fleet', 'repro_torch.kernels.quantize.kernel', "
            "'repro_torch.kernels.quantize.ops']") in out.stdout, out.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_imports_jax_or_repro(path):
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
        m = _IMPORT.match(line)
        if m is None:
            continue
        top = m.group(1).split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name}:{lineno}: {line.strip()}"


def test_every_new_port_module_is_checked():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/core/fleet.py", "src/repro_torch/kernels/quantize/ops.py",
            "src/repro_torch/kernels/quantize/kernel.py",
            "src/repro_torch/kernels/quantize/ref.py"} <= names
    assert {f"src/repro_torch/api/{m}.py"
            for m in ("__init__", "specs", "result", "methods", "experiment")} <= names
    assert {f"src/repro_torch/telemetry/{m}.py"
            for m in ("__init__", "spans", "events", "config", "export")} <= names
    assert "examples/torch_har_federated.py" in names
    assert "examples/torch_serve_batched.py" in names
    assert {f"src/repro_torch/{m}.py" for m in (
        "telemetry/profile", "launch/hlo_stats", "launch/steps", "launch/serve",
        "configs/__init__", "models/config", "models/layers", "models/moe",
        "models/recurrent", "models/transformer", "launch/train", "data/tokens")} <= names
    assert "examples/torch_federated_lm.py" in names
    assert {f"benchmarks/{m}.py" for m in ("_torch_harness", "torch_table4_lstm",
                                           "torch_table5_mlp", "torch_table7_cloud",
                                           "torch_figs_contributors", "torch_run")} <= names


def test_session_without_device_raises_on_a_host_without_gpu(monkeypatch):
    from repro_torch.core import EnFedSession, SupervisedTask
    from repro_torch.models import MLPClassifier, MLPClassifierConfig

    task = SupervisedTask(MLPClassifier(MLPClassifierConfig(input_dim=4), device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnFedSession(task, None, None, [], {})


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Alone in a directory, or on a host with no CUDA device, the smoke
    script exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             env=env, timeout=300, cwd=tmp_path)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
