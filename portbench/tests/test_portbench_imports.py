"""Nothing the benchmark runs imports JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), the
reference imports nothing of the port, and nothing reads ``benchmarks/``."""
import ast
import subprocess
import sys

import pytest

from portbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "tests" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax_no_reference_package(path):
    mods = set(top_level_imports(path))
    assert not mods & set(harness.FORBIDDEN)
    if "reference" in path.parts:
        assert "repro_torch" not in mods
    text = path.read_text()
    assert "benchmarks/" not in text and "importlib.import_module" not in text


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src'];"
            "from portbench import harness, judge, control, sweep;"
            "harness.driver('serve'); harness.driver('train');"
            "import repro_torch.serve.batching, repro_torch.train.train_step;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_modules() or \
        "repro" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_without_a_card_the_command_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    bench = harness.benchmark()
    cell = bench["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, *bench["command"][1:], "--workload", cell, "--seed",
         str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
