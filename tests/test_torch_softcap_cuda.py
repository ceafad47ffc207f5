"""The soft cap and the query offset in the CUDA attention kernels against
their plain versions on the card: the flash forward (bf16 on the tensor
cores, fp32 on the CUDA cores) capped and offset at every head dim, its
backward capped and offset, and decode capped, each at the uncapped
call's limits (``kernels/parity.py``).  Imports no jax: run it on the
card with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_softcap_cuda.py``."""
import pytest
import torch

from repro_torch.kernels import ops, parity, ref

CAP = 2.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator().manual_seed(29)


@pytest.mark.gpu
@pytest.mark.parametrize("d", parity.SWEEP_D)
def test_capped_offset_flash_matches_plain(d):
    gen = _card()
    for s in (63, 200):
        for rep, causal, q, k, v in parity.sweep_cases(gen, d, s):
            for off in (0, s // 3):
                kw = dict(causal=causal, kv_group=rep, softcap=CAP,
                          q_offset=off)
                got = ops.flash_attention(q[:, off:], k, v, **kw)
                ok, err, rerr = parity.within_limits(
                    got, ref.mha_ref(q[:, off:], k, v, **kw))
                assert ok, (s, rep, causal, off, err, rerr)
    q, k, v = (torch.randn(2, 200, d, generator=gen).cuda()
               for _ in range(3))
    kw = dict(softcap=CAP, q_offset=67)
    torch.testing.assert_close(ops.flash_attention(q[:, 67:], k, v, **kw),
                               ref.mha_ref(q[:, 67:], k, v, **kw),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capped_offset_backward_matches_plain(dtype):
    gen = _card()
    h, kv, sq, skv, d = 8, 2, 100, 300, 64
    q, do = (torch.randn(h, sq, d, generator=gen).to("cuda", dtype)
             for _ in range(2))
    k, v = (torch.randn(kv, skv, d, generator=gen).to("cuda", dtype)
            for _ in range(2))
    kw = dict(kv_group=h // kv, softcap=CAP, q_offset=skv - sq)
    o, lse = ops.flash_attention_lse(q, k, v, **kw)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    if dtype == torch.float32:
        want = ref.mha_backward_ref(
            q, k, v, o, do, ref.mha_ref(q, k, v, return_lse=True, **kw)[1],
            **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
    else:
        ok, err, rerr = parity.bwd_within_limits(
            got, parity.bwd_want32(q, k, v, o, do, **kw))
        assert ok, (err, rerr)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capped_decode_matches_plain(dtype):
    gen = _card()
    q = torch.randn(3, 16, 64, generator=gen).to("cuda", dtype)
    kc, vc = (torch.randn(3, 500, 4, 64, generator=gen).to("cuda", dtype)
              for _ in range(2))
    lens = torch.tensor([1, 250, 500], dtype=torch.int32, device="cuda")
    got = ops.decode_attention(q, kc, vc, lens, softcap=CAP)
    want = ref.decode_attention_ref(q, kc, vc, lens, softcap=CAP)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        ok, err, rerr = parity.within_decode_limits(
            got, want, parity.decode_want32(q, kc, vc, lens, softcap=CAP))
        assert ok, (err, rerr)
