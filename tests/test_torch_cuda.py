"""The CUDA kernels against their plain versions on the card, at the shapes
and tolerances of tests/test_kernels.py plus ragged lengths, grouped heads
and per-slot cache lengths, and the serving path on the card at a small
size.  Imports no jax: run it on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator().manual_seed(3)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    gen = _card()

    def randn(*shape):
        return torch.randn(shape, generator=gen).cuda()

    ops.reset_launch_counts()
    for m, k, n in [(32, 32, 32), (100, 70, 130), (128, 256, 64),
                    (17, 19, 23)]:
        for tdt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            a, b = randn(m, k).to(tdt), randn(k, n).to(tdt)
            torch.testing.assert_close(ops.matmul(a, b).float(),
                                       ref.matmul_ref(a, b).float(),
                                       rtol=tol, atol=tol)
    for f, n, k, bn in [(2, 128, 8, 32), (4, 300, 16, 64), (8, 256, 32, 128),
                        (1, 512, 4, 256), (4, 1000, 200, 128)]:
        x, h = randn(f, n), randn(f, k)
        torch.testing.assert_close(ops.tdfir(x, h, block_n=bn),
                                   ref.tdfir_ref(x, h), rtol=3e-4, atol=3e-4)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"matmul": 8, "tdfir": 5,
                                   "flash_attention": 0,
                                   "decode_attention": 0}


@pytest.mark.gpu
def test_cuda_attention_kernels_match_plain_versions():
    gen = _card()

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to("cuda", dtype)

    ops.reset_launch_counts()
    for bh, s, d in [(2, 64, 16), (3, 128, 32), (1, 96, 64)]:
        q, k, v = (randn(bh, s, d) for _ in range(3))
        for causal in (True, False):
            torch.testing.assert_close(
                ops.flash_attention(q, k, v, causal=causal),
                ref.mha_ref(q, k, v, causal=causal), rtol=2e-4, atol=2e-4)
    # grouped heads (rep 4), ragged S, as strided [B*H, S, D] views
    for s, dtype, tol in ((77, torch.float32, 2e-4),
                          (200, torch.bfloat16, 5e-2)):
        q = randn(1, s, 8, 64, dtype=dtype).transpose(1, 2).reshape(8, s, 64)
        k, v = (randn(1, s, 2, 64, dtype=dtype).transpose(1, 2)
                .reshape(2, s, 64) for _ in range(2))
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, kv_group=4).float(),
            ref.mha_ref(q, k, v, kv_group=4).float(), rtol=tol, atol=tol)
    for bh, s, d, clen in [(4, 256, 64, 256), (2, 512, 32, 300),
                           (1, 128, 128, 1)]:
        q = randn(bh, 1, d)
        kc, vc = randn(bh, s, 1, d), randn(bh, s, 1, d)
        torch.testing.assert_close(
            ops.decode_attention(q, kc, vc, clen),
            ref.decode_attention_ref(q, kc, vc, clen), rtol=2e-4, atol=2e-4)
    lens = torch.tensor([1, 129, 255, 300], dtype=torch.int32, device="cuda")
    q, kc, vc = randn(4, 8, 32), randn(4, 300, 2, 32), randn(4, 300, 2, 32)
    torch.testing.assert_close(ops.decode_attention(q, kc, vc, lens),
                               ref.decode_attention_ref(q, kc, vc, lens),
                               rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"matmul": 0, "tdfir": 0,
                                   "flash_attention": 8,
                                   "decode_attention": 4}
    with pytest.raises(ValueError, match="head dim"):
        x = randn(2, 16, 48)
        ops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(randn(1, 2, 48), randn(1, 8, 2, 48),
                             randn(1, 8, 2, 48), 4)


@pytest.mark.gpu
def test_serving_on_the_card_matches_generate():
    """Reduced granite in fp32 on the card: the continuous batcher's tokens
    equal batch-1 generate's, through both attention kernels."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.lm import LM, init_params
    from repro_torch.serve import ContinuousBatcher, Request
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              n_layers=3)
    lm = LM(cfg, init_params(cfg, torch.Generator("cuda").manual_seed(0)))
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in (9, 40, 17)]
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=64)
    ops.reset_launch_counts()
    out = engine.run([Request(rid=f"r{i}", arch=cfg.name,
                              prompt_len=len(t), max_gen=6, tokens=t,
                              arrival_s=i * engine.tick_s)
                      for i, t in enumerate(toks)])
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 3 * 3
    assert counts["decode_attention"] == 3 * engine.calls["decode_step"]
    for i, t in enumerate(toks):
        want = generate(lm, {"tokens": torch.from_numpy(t[None])}, len(t),
                        6, 64)
        assert np.array_equal(out[f"r{i}"], want[0].cpu().numpy()), i
