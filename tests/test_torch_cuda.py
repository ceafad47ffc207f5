"""The CUDA kernels against their plain versions on the card, at the shapes
and tolerances of tests/test_kernels.py plus a ragged N with K > tile.
Imports no jax: run it on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``."""
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)

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
    assert ops.launch_counts() == {"matmul": 8, "tdfir": 5}
