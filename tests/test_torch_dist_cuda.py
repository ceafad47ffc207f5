"""The distribution layer on the card at a small size: the pod-parallel step
on one NCCL rank bitwise equal to the plain step (both reductions are
copies), and on two gloo ranks sharing the card the pod step against the
whole-batch step, the pipeline against ``sequential_apply`` on the same
microbatches and expert-parallel MoE against ``apply_moe``; the decode
kernel's ``lse`` output against the plain version's, and DTensor's
all-gather of card tensors over gloo staged through host memory.
Imports no jax: run it on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dist_cuda.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.pipeline import pipeline_apply, sequential_apply
from repro_torch.dist.plan import Plan
from repro_torch.dist.sharding import Rules
from repro_torch.launch.mesh import make_test_mesh, run_ranks
from repro_torch.models import moe
from repro_torch.models.lm import LM, init_params
from repro_torch.train import optimizer, train_step as ts

TCFG = TrainConfig(lr=1e-3, warmup_steps=1, eps=1e-4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _batch(cfg, b, s, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                             device="cuda") for k in ("tokens", "labels")}


def _lm(plan, dtype):
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              dtype=dtype, param_dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, LM(cfg, init_params(cfg, gen, "cuda"), plan)


def _one_rank(rank, world, out):
    cfg, lm = _lm(Plan(vocab_chunk=16), "bfloat16")
    mesh = make_test_mesh((1, 1, 1), ("pod", "data", "model"))
    batch = _batch(cfg, 4, 64, 1)
    snap = {n: p.detach().clone() for n, p in lm.params().items()}
    _, _, m_plain = ts.make_train_step(lm, TCFG)(
        lm.params(), optimizer.init(lm.params(), TCFG), batch, 0)
    want = {n: p.detach().clone() for n, p in lm.params().items()}
    lm.load_params(snap)
    _, _, m_pod = ts.make_pod_parallel_train_step(lm, TCFG, mesh)(
        lm.params(), optimizer.init(lm.params(), TCFG), batch, 0)
    same = all(torch.equal(want[n], p) for n, p in lm.params().items())
    torch.save({"same": same, "loss": torch.equal(m_pod["loss"],
                                                  m_plain["loss"])}, out)


@pytest.mark.gpu
def test_pod_step_on_one_nccl_rank_is_the_plain_step(tmp_path):
    _card()
    run_ranks(_one_rank, 1, str(tmp_path / "r.pt"), backend="nccl")
    got = torch.load(tmp_path / "r.pt")
    assert got["same"] and got["loss"]


def _two_ranks(rank, world, out):
    torch.cuda.set_device(0)
    res = {}
    # the pod step, pod = 2, against the whole batch in this process
    cfg, lm = _lm(Plan(vocab_chunk=16), "float32")
    batch = _batch(cfg, 4, 64, 2)
    params = lm.params()
    lm.requires_grad_(True)
    total, _ = lm.train_loss(batch)
    whole = torch.autograd.grad(total, list(params.values()))
    mesh = make_test_mesh((2,), ("pod",), device="cuda")
    pod, _, _, _ = ts.make_pod_gradients(lm, mesh)(params, None, batch)
    res["pod"] = max(((pod[n] - w).abs().max() / w.abs().max().clamp_min(
        1e-30)).item() for n, w in zip(params, whole))
    # the pipeline against sequential_apply on the same microbatches
    gen = torch.Generator(device="cuda").manual_seed(3)
    ws = torch.randn(4, 64, 64, generator=gen, device="cuda") / 8
    x = torch.randn(16, 64, generator=gen, device="cuda")

    def stage(w, h):
        return torch.tanh(h @ w)

    worst = 0.0
    for sched, v in (("gpipe", 1), ("one_f_one_b", 1), ("interleaved", 2)):
        n = 2 * v
        for m in (1, n, 4 * n):
            got = pipeline_apply(stage, ws[:n], x, mesh, microbatches=m,
                                 schedule=sched, virtual_stages=v)
            want = torch.cat([sequential_apply(stage, ws[:n], c)
                              for c in x.chunk(m)])
            worst = max(worst, (got - want).abs().max().item())
    res["pipe"] = worst
    # expert-parallel MoE over model = 2 against apply_moe
    mcfg = get_config("moonshot-v1-16b-a3b").reduced()
    p = moe.init_moe(mcfg, torch.Generator(device="cuda").manual_seed(4),
                     "cuda", torch.float32)
    xm = torch.randn(4, 16, mcfg.d_model, generator=gen, device="cuda")
    emesh = make_test_mesh((2,), ("model",), device="cuda")
    y, _ = moe.apply_moe_ep(p, mcfg, xm, rules=Rules(emesh))
    res["moe"] = (y - moe.apply_moe(p, mcfg, xm)[0]).abs().max().item()
    torch.save(res, f"{out}/rank{rank}.pt")


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card(tmp_path):
    _card()
    run_ranks(_two_ranks, 2, str(tmp_path), backend="gloo")
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["pod"] <= 2e-4, got
        assert got["pipe"] <= 1e-5, got
        assert got["moe"] <= 1e-5, got


@pytest.mark.gpu
def test_decode_kernel_writes_each_rows_lse():
    """One launch writes the output and each row's base-2 log-sum-exp,
    against the plain version's; a row of length 0 gets zeros and
    -1e30 (a kv_seq slice that holds none of the row's keys)."""
    _card()
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(4, 32, 64, generator=gen, device="cuda")
    kc, vc = (torch.randn(4, 1056, 8, 64, generator=gen, device="cuda")
              for _ in range(2))
    lens = torch.tensor([0, 5, 1000, 1056], dtype=torch.int32,
                        device="cuda")
    lse = torch.empty(4, 32, device="cuda")
    ops.reset_launch_counts()
    out = ops.decode_attention(q, kc, vc, lens, lse=lse)
    assert ops.launch_counts()["decode_attention"] == 1
    want, want_lse = ref.decode_attention_ref(q, kc, vc, lens,
                                              return_lse=True)
    torch.testing.assert_close(out, want, rtol=0, atol=2e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    assert not out[0].any()
    assert bool((lse[0] == torch.tensor(ref.NEG_INF)).all())
    assert torch.equal(out, ops.decode_attention(q, kc, vc, lens))


def _gathers(rank, world, out):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.dist import collectives as col
    torch.cuda.set_device(0)
    mesh = make_test_mesh((1, 2), ("data", "model"), device="cuda")
    x = torch.full((4, 3), float(rank), device="cuda")
    got = DTensor.from_local(x, mesh, [Replicate(), Shard(0)]).full_tensor()
    torch.save({"got": got.cpu(), "staged": col.staged_ops()},
               f"{out}/rank{rank}.pt")


@pytest.mark.gpu
def test_dtensor_gathers_card_tensors_over_gloo(tmp_path):
    """DTensor's all-gather of a card tensor over gloo (which the process
    would not survive) goes through host memory, counted."""
    _card()
    run_ranks(_gathers, 2, str(tmp_path), backend="gloo")
    want = torch.cat([torch.zeros(4, 3), torch.ones(4, 3)])
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert torch.equal(got["got"], want)
        assert got["staged"] == {"all_gather_into_tensor": 1}
