"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports jax or the JAX package, and its entry points run on the card unless
the caller names the CPU."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.apps import APPS
from repro_torch.core.planner import UserTarget, plan_offload
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)"
    r"|from\s+repro(\.|\s))", re.MULTILINE)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_the_jax_package():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m, mod in sys.modules.items() if mod is not "
        "None and (m in ('jax', 'repro') or m.startswith(('jax.', "
        "'repro.'))))\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_sources_name_neither_jax_nor_the_jax_package():
    assert len(PORT_SOURCES) > 20
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in PORT_SOURCES
                 for m in FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "import repro.core", "from repro.core import ga",
                 "  from repro import obs"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import ga",
                 "import jaxlib_free", "# the JAX package's repro.core"):
        assert not FORBIDDEN.search(line), line


def test_entry_points_default_to_the_card():
    app = APPS["tdFIR"]()
    if torch.cuda.is_available():
        state = app.make_inputs(seed=0, small=True)
        assert all(v.device.type == "cuda" for v in state.values())
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        app.make_inputs(seed=0, small=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_offload(app, UserTarget())


def test_entry_points_turn_tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        APPS["3mm"]().make_inputs(seed=0, small=True, device="cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_ops_give_cpu_tensors_the_plain_version():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(5, 7, generator=g), torch.randn(7, 3, generator=g)
    x, h = torch.randn(2, 40, generator=g), torch.randn(2, 6, generator=g)
    got = ops.matmul(a, b)
    assert got.device.type == "cpu" and torch.equal(got, ref.matmul_ref(a, b))
    got = ops.tdfir(x, h)
    assert got.device.type == "cpu" and torch.equal(got, ref.tdfir_ref(x, h))
