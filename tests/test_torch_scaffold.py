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


def test_the_check_walks_the_fleet_and_control_subpackages():
    """The router, health, fleet, control and observability layers are
    among the modules the no-jax import check above walks."""
    walked = set(_port_modules())
    for name in ("repro_torch.analysis", "repro_torch.analysis.findings",
                 "repro_torch.analysis.plan_lint", "repro_torch.fleet",
                 "repro_torch.fleet.placement", "repro_torch.runtime",
                 "repro_torch.runtime.control",
                 "repro_torch.runtime.elastic",
                 "repro_torch.runtime.fault_tolerance",
                 "repro_torch.dist.schedules", "repro_torch.obs.export",
                 "repro_torch.obs.metrics", "repro_torch.obs.report",
                 "repro_torch.serve.health", "repro_torch.serve.router"):
        assert name in walked, name


def test_pure_layers_import_without_torch_or_numpy():
    """Like ``tests/test_obs.py``'s jax pin: the observability package and
    the pure analysis, runtime and schedule modules pull in neither torch
    nor numpy when imported."""
    code = ("import sys\n"
            "import repro_torch.obs, repro_torch.obs.report\n"
            "import repro_torch.analysis, repro_torch.dist.schedules\n"
            "import repro_torch.runtime, repro_torch.runtime.elastic\n"
            "import repro_torch.runtime.fault_tolerance\n"
            "leaked = [m for m in ('torch', 'numpy', 'jax') "
            "if m in sys.modules]\n"
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
