"""A tiny configuration and tiny traffic for runs of the harness on the
CPU."""
import json
import time
from typing import Optional

import torch

from portbench import harness

HERE = harness.HERE


def tiny_cfg(name: str = "granite-3-2b", **kw) -> dict:
    """Two layers of few heads over a small vocabulary, in fp32; the
    published d_model keeps the logits at the served model's scale."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(n_layers=2, d_model=2048, n_heads=4, n_kv_heads=2, d_head=32,
               d_ff=256, vocab_size=500, vocab_pad_multiple=16,
               dtype="float32", param_dtype="float32")
    cfg.update(kw)
    return cfg


def tiny_mix(traffic: str) -> dict:
    mix = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    if mix["kind"] == "train":
        mix.update(batch=2, seq=32, vocab_chunk=0)
        return mix
    mix.update(prompt_len={"median": 16, "sigma": 0.8, "min": 4, "max": 40},
               output_len={"median": 6, "sigma": 0.5, "min": 2, "max": 12},
               n_slots=4, cache_len=64, lead_in_s=0.3,
               check={"min_tokens": 16, "max_requests": 4})
    if "arrivals" in mix:
        mix["arrivals"] = {"process": "poisson", "rate_per_s": 6.0}
    if "clients" in mix:
        # the first callers finish in the lead-in, so that the callers
        # submit through the window on a loaded machine
        mix.update(clients=6, lead_in_s=1.5)
    return mix


def cell(name: str) -> dict:
    """The cell ``<config>.<traffic>`` on one chip, found by its files."""
    config, traffic = name.split(".", 1)
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}


def tiny_run(cell_name: str, seed: int = 2 ** 31 + 11, seconds: Optional[float] = None,
             trace: bool = False,
             trace_s: Optional[float] = None) -> harness.Run:
    """A whole run of the cell on the CPU at the tiny size, on two
    threads (the count restored after).  A serving window is long enough
    that a closed loop's callers submit in it on a loaded machine."""
    c = cell(cell_name)
    mix = tiny_mix(c["traffic"])
    if seconds is None:
        seconds = {"train": 0.6, "open": 1.5, "closed": 3.0}[
            mix.get("loop", "train")]
    run = harness.Run(c, seed, seconds, trace, torch.device("cpu"),
                      time.perf_counter(), cfg=tiny_cfg(c["config"]),
                      mix=mix)
    if trace_s is not None:
        run.trace_s = trace_s
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.execute(run)
    finally:
        torch.set_num_threads(threads)
