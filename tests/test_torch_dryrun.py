"""The port's dry run (``repro_torch.launch.{specs,dryrun}``) and the fake
kernel calls it reaches, against the JAX package on the CPU.

``specs`` give the reference's ``jax.eval_shape`` shapes and dtypes for
every runnable arch x shape (the parameters unstacked as
``models.convert`` unstacks them); a tiny dense config traced on a (2, 2)
mesh of the fake process group has the reference's per-device
``argument_size_in_bytes`` (its compiled step on 4 forced host devices, in
a subprocess), model FLOPs and lint findings for each step kind; a
statically pruned cell gives the reference's error and findings; a cell of
the CLI keeps the reference's keys and launches nothing; and the fake
flash and decode calls record exactly their ``work`` at their operands'
dtype, with no S x S product traced.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from helpers import SRC
from repro_torch.configs import ARCHS, SHAPES, cell_runnable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.trace_analysis import TensorSpec, trace
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, specs

TINY = dict(name="dryrun-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, d_head=16,
            vocab_pad_multiple=16, dtype="float32", param_dtype="float32")
KINDS = (("train", 32), ("prefill", 32), ("decode", 64))
GiB = 1024 ** 3

REFERENCE = """
import json
import jax
from repro.analysis import findings_to_json, lint_plan
from repro.configs.base import ModelConfig, ShapeConfig
from repro.core import cost_model
from repro.launch.dryrun import build_step, default_plan, run_cell
from repro.launch.mesh import make_test_mesh
cfg = ModelConfig(**TINY)
mesh = make_test_mesh((2, 2), ("data", "model"))
out = {}
for kind, s in KINDS:
    shape = ShapeConfig("t", seq_len=s, global_batch=8, kind=kind)
    plan = default_plan(cfg, shape)
    fn, args, sh, donate = build_step(cfg, shape, mesh, plan)
    compiled = jax.jit(fn, in_shardings=sh,
                       donate_argnums=donate).lower(*args).compile()
    out[kind] = {
        "argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
        "model_flops": cost_model.model_flops_for(cfg, shape),
        "lint": findings_to_json(lint_plan(plan, mesh=mesh, cfg=cfg,
                                           shape=shape))}
pruned = run_cell("granite-3-2b", "train_4k", "single",
                  overrides={"microbatches": 3}, use_cache=False)
out["pruned"] = {k: pruned.get(k) for k in ("error", "lint")}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's tiny cells and pruned cell, in a subprocess of 4
    forced host devices started at once (the port's side runs meanwhile)."""
    code = (f"import sys\nsys.path.insert(0, {SRC!r})\n"
            f"TINY, KINDS = {TINY!r}, {KINDS!r}\n" + REFERENCE)
    proc = subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC,
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})

    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        line = next(x for x in out.splitlines() if x.startswith("RESULT "))
        return json.loads(line[len("RESULT "):])

    yield result
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def port_tiny():
    """Each step kind of the tiny config traced on a (2, 2) mesh of the
    fake process group (destroyed after)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_test_mesh
    cfg = ModelConfig(**TINY)
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
        out = {}
        for kind, s in KINDS:
            shape = ShapeConfig("t", seq_len=s, global_batch=8, kind=kind)
            plan = dryrun.default_plan(cfg, shape)
            before = ops.launch_counts()
            art, _ = dryrun.trace_cell(cfg, shape, mesh, plan, "cpu")
            assert ops.launch_counts() == before
            out[kind] = (cfg, shape, plan, art)
        return out
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", [k for k, _ in KINDS])
def test_tiny_cell_argument_bytes_equal_the_reference(reference, port_tiny,
                                                      kind):
    from repro_torch.analysis import findings_to_json, lint_plan
    from repro_torch.core import cost_model
    want = reference()[kind]
    cfg, shape, plan, art = port_tiny[kind]
    mem = art.memory
    assert mem["argument_bytes"] == want["argument_bytes"]
    assert mem["peak_estimate_bytes"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])
    assert cost_model.model_flops_for(cfg, shape) == want["model_flops"]
    got = lint_plan(plan, mesh={"data": 2, "model": 2}, cfg=cfg, shape=shape,
                    device_memory_bytes=16 * GiB)
    assert findings_to_json(got) == want["lint"]
    names = {op.name for op in art.ops}
    if kind == "decode":
        assert "kernel.decode_attention" in names
        # the decode cache is written in place: the port's donation
        assert mem["alias_bytes"] > 0
    else:
        assert "kernel.flash_attention" in names
    if kind == "train":
        assert "kernel.flash_attention_bwd" in names
        # parameters and moments are updated in place
        assert mem["alias_bytes"] >= mem["argument_bytes"] - 4096
    assert art.analyze()["collective_bytes"] > 0


def test_pruned_cell_equals_the_reference(reference):
    res = dryrun.run_cell("granite-3-2b", "train_4k", "single",
                          overrides={"microbatches": 3}, use_cache=False,
                          device="cpu")
    want = reference()["pruned"]
    assert "statically pruned" in res["error"]
    assert any(f["rule_id"] == "P002" for f in res["lint"])
    assert res["error"] == want["error"] and res["lint"] == want["lint"]
    assert "trace_s" not in res and "roofline" not in res
    assert not dist.is_initialized()


def test_cli_cell_keeps_the_reference_keys(tmp_path):
    before = ops.launch_counts()
    rc = dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                      "--device", "cpu", "--out", str(tmp_path),
                      "--no-search-cache"])
    assert rc == 0 and ops.launch_counts() == before
    res = json.loads(
        (tmp_path / "granite-3-2b__decode_32k__single.json").read_text())
    ref_keys = {"arch", "shape", "mesh", "plan", "policy", "plan_detail",
                "lint", "n_chips", "lower_s", "compile_s", "verify_s",
                "cache_hit", "xla_cost_analysis", "hlo_analysis", "memory",
                "collectives", "collective_counts", "roofline", "fits_16GiB",
                "energy", "policy_score"}
    want = (ref_keys - {"lower_s", "compile_s", "fits_16GiB"}) | {
        "trace_s", "fits_80GiB", "kernel_calls"}
    assert set(res) == want
    calls = res["kernel_calls"]["decode_attention"]
    assert calls["calls"] == 40 and calls["dtype"] == "bf16"
    assert res["n_chips"] == 256 and res["fits_80GiB"] is True
    assert set(res["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_estimate_bytes"}
    rl = res["roofline"]
    assert np.isfinite(rl["step_time_s"]) and rl["step_time_s"] > 0
    assert res["hlo_analysis"]["flops_bf16"] > 0
    assert res["energy"]["envelope"].startswith("nvidia-h100")
    assert not dist.is_initialized()


# --------------------------------------------------------------- specs
def _spec_sig(tree):
    if isinstance(tree, dict):
        return {k: _spec_sig(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_spec_sig(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def _jax_params_by_port_name(cfg):
    """The reference's ``eval_shape`` of ``Model.init`` unstacked into the
    port's names (``models.convert``), as (shape, dtype)."""
    import jax
    import jax.numpy as jnp

    from repro.dist.plan import Plan as JaxPlan
    from repro.dist.sharding import NullRules
    from repro.models.lm import Model
    from repro_torch.models import convert
    from repro_torch.models.lm import flatten

    sds = jax.eval_shape(Model(cfg, JaxPlan(), NullRules()).init,
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    dtypes = sorted({str(x.dtype) for x in jax.tree.leaves(sds)})
    # zero-byte stand-ins carrying each leaf's shape and its dtype's index
    tree = jax.tree.map(lambda x: np.broadcast_to(
        np.array(dtypes.index(str(x.dtype)), np.int8), x.shape), sds)
    layered = set(convert.stacks(cfg)) | {"tail"}
    pairs = list(flatten({k: v for k, v in tree.items()
                          if k not in layered}).items())
    pairs += list(convert._layers(tree, cfg))
    return {name: (tuple(a.shape), dtypes[int(a.flat[0])])
            for name, a in pairs}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_the_reference_eval_shape(arch):
    from repro.configs import get_config as jax_config
    from repro.configs import get_shape as jax_shape
    from repro.launch import specs as jax_specs
    cfg = ARCHS[arch]
    mine = {k: (tuple(s.shape), str(s.dtype).split(".")[-1])
            for k, s in specs.param_specs(cfg, "cpu").items()}
    assert mine == _jax_params_by_port_name(jax_config(arch))
    for name, shape in SHAPES.items():
        if not cell_runnable(cfg, shape):
            continue
        jcfg, jshape = jax_config(arch), jax_shape(name)
        assert _spec_sig(specs.batch_specs(cfg, shape, "cpu")) == \
            _spec_sig(jax_specs.batch_specs(jcfg, jshape))
        assert specs.logical_batch_axes(cfg, shape) == \
            jax_specs.logical_batch_axes(jcfg, jshape)
        if shape.kind == "decode":
            from repro.dist.plan import Plan as JaxPlan
            from repro_torch.dist.plan import Plan
            for quant in (False, True):
                assert _spec_sig(specs.cache_specs(
                    cfg, shape, Plan(kv_cache_quant=quant), "cpu")) == \
                    _spec_sig(jax_specs.cache_specs(
                        jcfg, jshape, JaxPlan(kv_cache_quant=quant)))


# ---------------------------------------------------- fake kernel calls
def _kernel_ops(art):
    return [op for op in art.ops if op.name.startswith("kernel.")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 48])
def test_fake_flash_records_its_work(dtype, window):
    bh, kv_group, s, d = 8, 2, 200, 64

    def fwd(x):
        return ops.flash_attention(*x, causal=True, kv_group=kv_group,
                                   window=window)

    qkv = (TensorSpec((bh, s, d), dtype, "cpu"),
           TensorSpec((bh // kv_group, s, d), dtype, "cpu"),
           TensorSpec((bh // kv_group, s, d), dtype, "cpu"))
    before = ops.launch_counts()
    art = trace(fwd, qkv)
    (k,) = _kernel_ops(art)
    flops, nbytes = fa.work(bh, s, s, d, kv_group, True, window,
                            dtype.itemsize)
    assert (k.name, k.flops, k.bytes) == ("kernel.flash_attention", flops,
                                          nbytes)
    assert k.dtype == ("bf16" if dtype == torch.bfloat16 else "fp32")
    # no S x S product: the plain version was not traced
    assert not any(op.name.startswith(("aten.bmm", "aten.mm", "aten.baddbmm",
                                       "aten.softmax", "aten._softmax"))
                   for op in art.ops)

    def train(x):
        q, k, v = x
        q.requires_grad_(True)
        out = ops.flash_attention(q, k, v, causal=True, kv_group=kv_group,
                                  window=window)
        return torch.autograd.grad(out.sum(), [q])

    art = trace(train, qkv)
    fwd_op, bwd_op = _kernel_ops(art)
    assert (fwd_op.flops, fwd_op.bytes) == fa.work(
        bh, s, s, d, kv_group, True, window, dtype.itemsize, lse=True)
    assert (bwd_op.name, bwd_op.flops, bwd_op.bytes) == (
        "kernel.flash_attention_bwd",
        *fab.work(bh, s, s, d, kv_group, True, window, dtype.itemsize))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("lens", ["int", "list", "tensor", "fake"])
def test_fake_decode_records_its_work(lens):
    b, h, kvh, s, d = 4, 8, 2, 256, 64
    given = {"int": 100, "list": [1, 50, 256, 300],
             "tensor": torch.tensor([1, 50, 256, 300], dtype=torch.int32)}

    def fn(x):
        q, kc, vc, *rest = x
        cache_len = rest[0] if lens == "fake" else given[lens]
        lse = torch.empty((b, h), dtype=torch.float32)
        return ops.decode_attention(q, kc, vc, cache_len, lse=lse)

    inputs = [TensorSpec((b, h, d), torch.bfloat16, "cpu"),
              TensorSpec((b, s, kvh, d), torch.bfloat16, "cpu"),
              TensorSpec((b, s, kvh, d), torch.bfloat16, "cpu")]
    if lens == "fake":
        inputs.append(TensorSpec((b,), torch.int32, "cpu"))
    art = trace(fn, inputs)
    (k,) = _kernel_ops(art)
    # a fake lens tensor cannot be read: the whole cache, an upper bound
    valid = {"int": 4 * 100, "list": 1 + 50 + 256 + 256,
             "tensor": 1 + 50 + 256 + 256, "fake": 4 * 256}[lens]
    assert da.valid_rows(s if lens == "fake" else given[lens], b, s) == valid
    assert (k.name, k.flops, k.bytes, k.dtype) == (
        "kernel.decode_attention",
        *da.work(b, h, kvh, d, valid, 2, lse=True), "bf16")


def test_fake_calls_refuse_what_the_kernels_refuse():
    def flash(x):
        return ops.flash_attention(*x)

    odd = (TensorSpec((2, 16, 96), torch.bfloat16, "cpu"),) * 3
    with pytest.raises(ValueError, match="head dim"):
        trace(flash, odd)

    def decode(x):
        return ops.decode_attention(*x, 16)

    wide = (TensorSpec((1, 11, 256), torch.bfloat16, "cpu"),
            TensorSpec((1, 32, 1, 256), torch.bfloat16, "cpu"),
            TensorSpec((1, 32, 1, 256), torch.bfloat16, "cpu"))
    with pytest.raises(ValueError, match="H/KV"):
        trace(decode, wide)


def test_fake_call_without_the_thread_sink_reaches_the_trace():
    """The autograd engine runs a card's backward (and a remat's
    recompute) on threads of its own, which carry the tracing dispatch
    mode but not the tracing thread's sink: a fake call there is recorded
    through the mode."""
    def fn(x):
        saved = ops._tls.sink
        ops._tls.sink = None          # as on an autograd device thread
        try:
            return ops.flash_attention(*x)
        finally:
            ops._tls.sink = saved

    qkv = (TensorSpec((4, 64, 32), torch.bfloat16, "cpu"),) * 3
    (k,) = _kernel_ops(trace(fn, qkv))
    assert (k.flops, k.bytes) == fa.work(4, 64, 64, 32, 1, True, 0, 2)
