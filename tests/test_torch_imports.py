"""The PyTorch port stands alone: importing ``repro_torch`` (every module)
loads neither ``jax`` nor the JAX package ``repro``, and no source of the
port or ``chip_smoke.py`` imports them."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_sources_exist():
    mods = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for rel in ("core/types.py", "core/simnet.py", "core/combine.py",
                "core/credits.py", "core/engine.py", "core/runner.py",
                "core/oracle.py", "stores/heap.py", "stores/pointer_array.py",
                "stores/smart_art.py", "workloads/zipf.py",
                "workloads/ycsb.py", "interop.py",
                "kernels/wc_combine/ops.py", "kernels/wc_combine/ref.py",
                "kernels/scan_probe/ops.py", "kernels/scan_probe/ref.py",
                "kernels/paged_attention/ops.py",
                "kernels/paged_attention/ref.py",
                "kernels/flash_attention/ops.py",
                "kernels/flash_attention/ref.py", "models/config.py",
                "models/common.py", "models/mlp.py", "models/attention.py",
                "models/transformer.py", "models/model.py",
                "models/moe.py", "models/ssm.py", "models/rglru.py",
                "models/frontend.py",
                "configs/__init__.py", "configs/qwen3_0_6b.py",
                "serving/pagetable.py", "serving/scheduler.py",
                "launch/serve.py", "recovery/__init__.py",
                "recovery/liveness.py", "recovery/orchestrator.py",
                "dist/__init__.py", "dist/store.py", "launch/mesh.py",
                "stores/race_hash.py",
                "workloads/recovery.py", "workloads/dynamic.py",
                "workloads/openloop.py", "core/protocol.py", "core/sim.py",
                "analysis/__init__.py", "analysis/race_check.py",
                "analysis/bill_lint.py", "analysis/device_check.py",
                "train/__init__.py", "train/optimizer.py",
                "data/__init__.py", "data/pipeline.py", "dist/compress.py",
                "ckpt/__init__.py", "ckpt/checkpoint.py", "ft/__init__.py",
                "ft/failures.py", "launch/train.py", "dist/ctx.py",
                "dist/sharding.py", "dist/decode_attn.py",
                "dist/embed_grad.py", "launch/dryrun.py",
                "rooflines/__init__.py", "rooflines/roofline.py",
                "rooflines/counter.py", "rooflines/report.py"):
        assert rel in mods, rel
    for cu in ("wc_combine.cu", "scan_probe.cu", "paged_attention.cu",
               "flash_attention.cu", "flash_attention_bwd.cu"):
        assert (PORT / "kernels" / "csrc" / cu).is_file(), cu


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_importing_serving_subpackages_loads_no_jax():
    """The subpackages of the serving slice, with every module in them,
    import without ``jax`` or the reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for sub in ('models', 'configs', 'serving', 'launch'):\n"
        "    pkg = importlib.import_module('repro_torch.' + sub)\n"
        "    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "        importlib.import_module(m.name)\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "    assert not bad, (sub, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
