"""The port's examples on the CPU (``--device cpu``), beside the
reference's: ``repro_torch.autoplan_model`` (the GA over plan genes on a
fake (pod 2, data 2, model 2) mesh of 8 ranks, each candidate's step
traced: at most one trace per unique structural key, none against a warm
disk cache, the reference's printout), ``repro_torch.train_lm`` (the loss
falls with no restart; ``--wide`` is the reference's ~100M config) and
``repro_torch.serve_lm`` over its trio.  The JAX examples are scripts;
their ``--wide`` config is rebuilt here from the reference's registry as
``examples/train_lm.py`` builds it."""
import dataclasses

import pytest
import torch

from repro.configs import get_config as jax_config
from repro_torch import autoplan_model, serve_lm, train_lm
from repro_torch.configs import ARCHS
from repro_torch.dist.plan import Plan
from repro_torch.launch import dryrun


@pytest.fixture
def traced_keys(monkeypatch):
    """The structural key of every candidate the search builds a step for
    (one build a trace)."""
    keys = []
    build = dryrun.build_step

    def counting(cfg, shape, mesh, plan, device=None):
        keys.append(plan.structural_key())
        return build(cfg, shape, mesh, plan, device)
    monkeypatch.setattr(dryrun, "build_step", counting)
    return keys


def test_autoplan_traces_each_key_once_and_none_when_warm(
        tmp_path, traced_keys, capsys):
    argv = ["--generations", "1", "--population", "4", "--device", "cpu",
            "--cache-dir", str(tmp_path), "--compile-workers", "2"]
    best, best_eval, stats = autoplan_model.main(argv)
    assert traced_keys and len(set(traced_keys)) == len(traced_keys)
    assert stats.unique_compiles == len(traced_keys)
    assert best_eval.correct and best_eval.time_s > 0
    assert isinstance(best, Plan)
    out = capsys.readouterr().out
    for gene in Plan.GENE_SPACE:
        line = next(x for x in out.splitlines()
                    if x.strip().startswith(gene.field + " "))
        assert line.endswith("[model-only]") == (not gene.structural), line
    assert "unique traces" in out and "trace time" in out
    assert "{'pod': 2, 'data': 2, 'model': 2}" in out
    assert not torch.distributed.is_initialized()

    n = len(traced_keys)
    best2, _, warm = autoplan_model.main(argv)
    assert len(traced_keys) == n              # no trace on a warm cache
    assert warm.unique_compiles == 0 and warm.disk_hits > 0
    assert best2 == best


def test_train_lm_loss_falls_without_restarts(tmp_path, capsys):
    res = train_lm.main(["--steps", "12", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    losses = [float(h["loss"]) for h in res.metrics_history if "loss" in h]
    assert len(losses) == 12 and losses[-1] < losses[0] - 0.2
    assert res.restarts == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == (f"final: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
                    f"12 steps; restarts=0")


def test_train_lm_wide_is_the_references_config():
    want = dataclasses.replace(
        jax_config("granite-3-2b").reduced(), d_model=768, n_layers=12,
        n_heads=12, n_kv_heads=4, d_head=64, d_ff=3072, vocab_size=32000,
        name="granite-3-2b-100m")
    try:
        got = train_lm.wide_config("granite-3-2b")
        assert ARCHS["granite-3-2b-100m"] is got
        for f in dataclasses.fields(want):
            if f.name not in ("moe", "ssm", "hybrid"):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.n_params() == want.n_params()
        assert 90e6 < got.n_params() < 130e6
    finally:
        ARCHS.pop("granite-3-2b-100m", None)


def test_serve_lm_serves_the_trio(capsys):
    out = serve_lm.main(["--device", "cpu", "--trace", "3", "--gen", "4"])
    assert tuple(out) == serve_lm.TRIO
    for arch, reqs in out.items():
        assert len(reqs) == 3
        assert all(len(t) == 4 for t in reqs.values()), arch
    printed = capsys.readouterr().out
    assert all(f"arch={a}" in printed for a in serve_lm.TRIO)
