"""What one run of a cell holds, and the pieces every driver shares: the
configuration as the port takes it, the files found by name, the guard
against the JAX package, and the result line.

Files are found by the names in ``BENCHMARK.json``: a cell
``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``kind`` names the driver,
``drivers/<kind>.py``), ``limits/<cell>.json``, and each metric's reader
``metrics/<metric>.py`` (a function ``read(run)`` that returns the number,
or None when it finds nothing to read).
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 8.0          # the longest slice of a window the profiler traces


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def model_config(cfg: dict):
    """The port's ``ModelConfig`` built from a configuration file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["arch"], family=cfg["family"], n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_kv_heads"], d_ff=cfg["d_ff"],
        vocab_size=cfg["vocab_size"], d_head=cfg["d_head"],
        ffn_act=cfg["ffn_act"], use_bias=cfg["use_bias"], norm=cfg["norm"],
        rope_theta=cfg["rope_theta"], attn_kind="full",
        tie_embeddings=cfg["tie_embeddings"], dtype=cfg["dtype"],
        param_dtype=cfg["param_dtype"],
        vocab_pad_multiple=cfg["vocab_pad_multiple"], source=cfg["source"])


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """One run of one cell: its inputs, what the driver recorded, and the
    checks that decide ``correct``."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, t_process: float, cfg: Optional[dict] = None,
                 mix: Optional[dict] = None, limits: Optional[dict] = None):
        self.cell = cell
        self.cfg = cfg or load_json(HERE / "configs" /
                                    f"{cell['config']}.json")
        self.mix = mix or load_json(HERE / "traffic" /
                                    f"{cell['traffic']}.json")
        self.limits = limits or load_json(HERE / "limits" /
                                          f"{cell['name']}.json")
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device, self.t_process = device, t_process
        self.trace_s = TRACE_S
        self.setup_s = None
        self.window = None
        self.traced = None
        self.memory_peak = 0
        self.forbidden: list = []
        self.attempted = self.failed = 0
        self.checks: Dict[str, tuple] = {}

    def after_window(self) -> None:
        """Read the memory peak and look for JAX once the window has
        closed, before the reference runs."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated())
        self.forbidden = forbidden_modules()

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            ok for _, _, ok in self.checks.values())

    def metrics(self, names) -> dict:
        out = {}
        for name, unit in names:
            value = reader(name)(self)
            if value is not None:
                out[name] = {"value": float(value), "unit": unit}
        return out


def driver(kind: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_driver_{kind}", HERE / "drivers" / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run


def execute(run: Run) -> Run:
    """Drive the cell's window with its traffic's driver."""
    return driver(run.mix["kind"])(run)


def result(run: Run, bench: dict) -> dict:
    """The result line: the cell's end-to-end metrics (untraced) or its
    per-layer metrics (traced), the device, and the compared numbers
    last."""
    import torch
    name = run.cell["name"]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    group = bench["per_layer"] if run.trace else bench["end_to_end"]
    names = [(m["name"], m["unit"]) for m in group if applies(m)]
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": run.metrics(names)}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    if run.trace and run.traced is not None:
        dev["busy_s"] = run.traced.busy_ns() / 1e9
        dev["window_s"] = run.traced.window_s
        out["device"] = dev
        out["breakdown"] = run.traced.breakdown(
            ["portbench.admit", "train.optimizer", "portbench.step",
             "portbench.tick"])
    else:
        out["device"] = dev
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim, _) in run.checks.items()}
    return out
