"""The port's static analysis against the JAX package's on the CPU: the gene
audit (``repro_torch.analysis.gene_audit``: the same verdicts on the
default gene space and on a mislabeled one, the model-only genes invariant
in both), the CUDA kernel lint (clean on the defaults, one injected fault
caught per rule) and the lint CLI (``lint_cells`` at the reference's 16 GiB
rule for rule, ``--strict`` and the exit-1 cases of
``tests/test_analysis.py``)."""
import json

import pytest
import torch

from repro.analysis import gene_audit as jax_gene_audit
from repro.analysis.lint import lint_cells as jax_lint_cells
from repro.dist.plan import Gene as JaxGene
from repro_torch.analysis import (KernelModel, OperandSpec, audit_findings,
                                  audit_gene_space, check_model, has_errors,
                                  lint_kernels)
from repro_torch.analysis import kernel_lint
from repro_torch.analysis.gene_audit import KERNEL_TILE_GENES
from repro_torch.analysis.lint import lint_cells, main
from repro_torch.dist.plan import Gene

GiB = 1024 ** 3


def _memo(fn):
    """A trace function that traces each plan once per module."""
    seen = {}

    def traced(plan):
        key = repr(plan)
        if key not in seen:
            seen[key] = fn(plan)
        return seen[key]
    return traced


@pytest.fixture(scope="module")
def trace_fns():
    from repro_torch.analysis.gene_audit import default_trace_fn
    return (_memo(default_trace_fn()),
            _memo(jax_gene_audit.default_trace_fn()))


def _verdicts(audits):
    return [(a.field, a.declared_model_only, a.artifact_invariant,
             a.violation) for a in audits]


def test_default_gene_space_has_no_violation_in_either_package(trace_fns):
    port_fn, jax_fn = trace_fns
    mine = audit_gene_space(trace_fn=port_fn)
    theirs = jax_gene_audit.audit_gene_space(trace_fn=jax_fn)
    assert _verdicts(mine) == _verdicts(theirs)
    assert {a.field for a in mine} == {"pipeline_schedule", "virtual_stages"}
    for a in mine:
        assert a.declared_model_only and a.artifact_invariant
        assert not a.violation and a.checked_values
    fs = audit_findings(mine)
    assert [f.rule_id for f in fs] == ["G002", "G002"]
    assert [f.rule_id for f in fs] == [
        f.rule_id for f in jax_gene_audit.audit_findings(theirs)]
    assert not has_errors(fs)


def test_mislabeled_gene_space_is_caught_in_both_packages(trace_fns):
    port_fn, jax_fn = trace_fns
    (mine,) = audit_gene_space(
        trace_fn=port_fn,
        gene_space=[Gene("remat", ("none", "block", "full"),
                         structural=False)])
    (theirs,) = jax_gene_audit.audit_gene_space(
        trace_fn=jax_fn,
        gene_space=[JaxGene("remat", ("none", "block", "full"),
                            structural=False)])
    assert _verdicts([mine]) == _verdicts([theirs])
    assert mine.violation and "changes the artifact" in mine.detail
    (f,) = audit_findings([mine])
    assert f.rule_id == "G001" and f.severity == "error"


def test_kernel_tile_genes_are_invariant_and_no_violation(trace_fns):
    """Genes that set only the reference's Pallas blocking leave the port's
    artifact unchanged: a G004 that says why, never an error; remat, which
    reaches the step, is a G003 in the port."""
    port_fn, _ = trace_fns
    audits = audit_gene_space(trace_fn=port_fn,
                              fields=["attn_block_q", "remat"])
    by = {a.field: a for a in audits}
    assert by["attn_block_q"].artifact_invariant
    assert not by["remat"].artifact_invariant
    fs = {f.plan_field: f for f in audit_findings(audits)}
    assert fs["attn_block_q"].rule_id == "G004"
    assert "Pallas" in fs["attn_block_q"].message
    assert fs["remat"].rule_id == "G003"
    assert "attn_block_q" in KERNEL_TILE_GENES
    assert not has_errors(fs.values())


# ------------------------------------------------------------ kernel lint
def test_kernel_lint_is_clean_on_the_defaults():
    fs = lint_kernels()
    assert not has_errors(fs), [f.message for f in fs
                                if f.severity == "error"]
    subjects = {f.subject for f in fs}
    for name in ("matmul.float32", "matmul.bfloat16", "tdfir",
                 "tdfir_complex", "flash_attention.bfloat16",
                 "flash_attention.float32",
                 "flash_attention_bwd.dkdv.bfloat16",
                 "flash_attention_bwd.dq.float32",
                 "decode_attention.bfloat16", "decode_attention.float32"):
        assert name in subjects


@pytest.mark.parametrize("dtype,grids,smem", [
    ("bfloat16", ((64, 5, 1), (640, 1, 1)), (215080, 214056)),
    ("float32", ((128, 1, 1), (128, 10, 1)), (140288, 136064))],
    ids=["bf16 tensor cores", "fp32 CUDA cores"])
def test_kernel_lint_models_the_d256_backward(dtype, grids, smem):
    """The backward at recurrentgemma-2b's heads (10 over 1 KV head, S
    4096, D 256): bf16 on the tensor cores, a block per 64 rows and per 64
    keys and 2 of the group's heads (5 blocks a key tile, merged); fp32 on
    the CUDA cores, 32-key and 32-row tiles; both clean."""
    models, findings = kernel_lint.flash_attention_bwd_model(
        bh=10, sq=4096, skv=4096, d=256, dtype=dtype, kv_group=10)
    assert not findings
    by = {m.name.split(".")[1]: m for m in models}
    assert (by["dkdv"].grid, by["dq"].grid) == grids
    assert by["dkdv"].merge_dims == ((1,) if dtype == "bfloat16" else ())
    assert (by["dkdv"].smem, by["dq"].smem) == smem
    assert not has_errors([f for m in models for f in check_model(m)])


def _rules(findings, rule_id):
    return [f for f in findings if f.rule_id == rule_id
            and f.severity == "error"]


def _tile_model(out_map, grid=(4, 1, 1), masked=(), dims=(64,), block=(16,),
                **kw):
    return KernelModel(
        name="fault", grid=grid, threads=128, smem=0,
        inputs=[OperandSpec("x", dims, block, out_map, masked=masked)],
        outputs=[OperandSpec("y", dims, block, out_map, masked=masked)],
        **kw)


@pytest.mark.parametrize("case", ["missed", "revisited", "ragged"])
def test_kernel_lint_k001_catches_coverage_faults(case):
    if case == "missed":        # 3 blocks of 16 over 64 elements
        m = _tile_model(lambda x, y, z: (x * 16,), grid=(3, 1, 1))
    elif case == "revisited":   # a second grid dim that is no merge
        m = _tile_model(lambda x, y, z: (x * 16,), grid=(4, 2, 1))
    else:                       # 70 elements, the edge unmasked
        m = _tile_model(lambda x, y, z: (x * 16,), grid=(5, 1, 1),
                        dims=(70,))
    assert _rules(check_model(m), "K001")
    ok = _tile_model(lambda x, y, z: (x * 16,), grid=(4, 2, 1),
                     merge_dims=(1,))
    assert not has_errors(check_model(ok))


@pytest.mark.parametrize("case", ["grid_y", "threads", "smem", "oob"])
def test_kernel_lint_k002_catches_bounds_and_limits(case):
    if case == "grid_y":
        # the fp32 flash kernel puts BH on grid y: past 65535 heads it
        # cannot launch
        (m,), _ = kernel_lint.flash_attention_model(
            bh=70000, sq=64, skv=64, d=64, dtype="float32")
    elif case == "threads":
        m = _tile_model(lambda x, y, z: (x * 16,))
        m.threads = 2048
    elif case == "smem":
        m = _tile_model(lambda x, y, z: (x * 16,))
        m.smem = 300 * 1024
    else:                       # a map that runs one tile past the end
        m = _tile_model(lambda x, y, z: (x * 16 + 16,))
    assert _rules(check_model(m), "K002")
    (bf16,), _ = kernel_lint.flash_attention_model(
        bh=70000, sq=64, skv=64, d=64, dtype="bfloat16")
    assert not _rules(check_model(bf16), "K002")     # a 1-D grid


def test_kernel_lint_k003_catches_aliasing(monkeypatch):
    m = _tile_model(lambda x, y, z: (x * 16,))
    m.outputs[0].buffer = "x"
    assert _rules(check_model(m), "K003")
    from repro_torch.kernels import decode_attention as da
    (ok,), _ = kernel_lint.decode_attention_model()
    assert not _rules(check_model(ok), "K003")
    # scratch kept per device only: two streams would share it
    monkeypatch.setattr(da, "scratch_key",
                        lambda dev, stream, graph=None: (da._SCRATCH, dev))
    (bad,), _ = kernel_lint.decode_attention_model()
    assert len(_rules(check_model(bad), "K003")) == 2


@pytest.mark.parametrize("shape,grid", [((4, 96, 8, 2112, 128), (4, 32)),
                                        ((4, 10, 1, 2048, 256), (8, 4)),
                                        ((4, 32, 8, 2112, 64), (4, 32))])
def test_kernel_lint_models_the_decode_tensor_core_route(shape, grid,
                                                         monkeypatch):
    """bf16 decode of a grouped query over its KV head takes the
    tensor-core route: its model's grid is the plan's splits by (slot, KV
    head), its block holds the Q tile beside the rings (within the 227 KB
    a block may opt into), and K001-K003 are clean; a block past the limit
    is K002, and scratch kept per device alone (two streams sharing it) is
    K003."""
    from repro_torch.kernels import decode_attention as da
    b, h, kvh, s, d = shape
    (m,), errs = kernel_lint.decode_attention_model(b, h, kvh, s, d)
    assert not errs and m.name == "decode_attention.hmma.bfloat16"
    p = da.plan(b, h, kvh, s, d, torch.bfloat16)
    assert (p.route, m.grid) == ("hmma", (*grid, 1))
    assert m.smem == da.block_smem(p, h // kvh, d, torch.bfloat16)
    assert da.HMMA_ROWS * d * 2 < m.smem <= 232448
    assert not has_errors(check_model(m))
    monkeypatch.setattr(da, "block_smem", lambda *a: 240 * 1024)
    (big,), _ = kernel_lint.decode_attention_model(b, h, kvh, s, d)
    assert _rules(check_model(big), "K002")
    monkeypatch.undo()
    monkeypatch.setattr(da, "scratch_key",
                        lambda dev, stream, graph=None: (da._SCRATCH, dev))
    (shared,), _ = kernel_lint.decode_attention_model(b, h, kvh, s, d)
    assert len(_rules(check_model(shared), "K003")) == 2


def test_kernel_lint_models_refuse_what_the_wrappers_refuse():
    _, errs = kernel_lint.flash_attention_model(d=96)
    assert _rules(errs, "K001")
    _, errs = kernel_lint.decode_attention_model(h=16, kvh=1, d=256)
    assert _rules(errs, "K001")
    _, errs = kernel_lint.tdfir_model(k=40000)
    assert _rules(errs, "K002")


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("mesh", [None, "both"])
def test_lint_cells_at_16gib_equal_the_reference(mesh):
    mine = lint_cells(mesh=mesh, device_memory_bytes=16 * GiB)
    theirs = jax_lint_cells(mesh=mesh)
    assert mine == theirs          # records, rules, messages and contexts
    assert len(mine) > 0


def test_lint_cli_clean_and_writes_report(tmp_path, capsys):
    out = tmp_path / "findings.json"
    rc = main(["--no-gene-audit", "--strict", "--json", str(out)])
    assert rc == 0, capsys.readouterr().out
    report = json.loads(out.read_text())
    assert report["cells"] > 0
    assert report["severity_counts"]["error"] == 0
    assert report["severity_counts"]["warning"] == 0
    assert report["strict"] is True
    assert any(f["rule_id"] == "K001"
               for f in report["kernel_and_gene_findings"])


def test_lint_cli_exits_nonzero_on_infeasible_what_if(capsys):
    rc = main(["--plan", "train-tight-mem", "--shape", "decode_32k",
               "--mesh", "single", "--pipelined", "--strict",
               "--no-gene-audit", "--no-kernel-lint"])
    assert rc == 1
    assert "[warning]" in capsys.readouterr().out


def test_lint_cli_unknown_plan_fails():
    with pytest.raises(SystemExit):
        main(["--plan", "no-such-plan", "--no-gene-audit",
              "--no-kernel-lint"])

