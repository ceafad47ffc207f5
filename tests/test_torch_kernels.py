"""The port's kernels: their plain versions against the JAX Pallas kernels
(interpret mode) at every shape and tolerance of tests/test_kernels.py.  The
CUDA kernels against their plain versions are in tests/test_torch_cuda.py,
which imports no jax so that it runs on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import matmul as jax_mm
from repro.kernels import tdfir as jax_fir
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (100, 70, 130),
                                   (128, 256, 64), (17, 19, 23)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_plain_matches_pallas(m, k, n, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    a, b = _normal(rng, (m, k)), _normal(rng, (k, n))
    want = jax_mm.matmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                         block_m=32, block_n=32, block_k=32, interpret=True)
    got = ops.matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("f,n,k,bn", [(2, 128, 8, 32), (4, 300, 16, 64),
                                      (8, 256, 32, 128), (1, 512, 4, 256)])
def test_tdfir_plain_matches_pallas(f, n, k, bn):
    rng = np.random.default_rng(1)
    x, h = _normal(rng, (f, n)), _normal(rng, (f, k))
    want = jax_fir.tdfir(jnp.asarray(x), jnp.asarray(h), block_n=bn,
                         interpret=True)
    got = ops.tdfir(torch.from_numpy(x), torch.from_numpy(h), block_n=bn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-4, atol=3e-4)


def test_tdfir_complex_plain_matches_pallas():
    rng = np.random.default_rng(2)
    xr, xi = _normal(rng, (2, 128)), _normal(rng, (2, 128))
    hr, hi = _normal(rng, (2, 8)), _normal(rng, (2, 8))
    want = jax_fir.tdfir_complex(*map(jnp.asarray, (xr, xi, hr, hi)),
                                 block_n=64, interpret=True)
    got = ops.tdfir_complex(*map(torch.from_numpy, (xr, xi, hr, hi)),
                            block_n=64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=3e-4, atol=3e-4)


def test_cpu_dispatch_launches_no_kernel():
    """CPU tensors take the plain version; the CUDA wrappers refuse them."""
    from repro_torch.kernels import matmul as cuda_mm
    from repro_torch.kernels import tdfir as cuda_fir
    ops.reset_launch_counts()
    a = torch.ones(4, 4)
    assert torch.equal(ops.matmul(a, a), ref.matmul_ref(a, a))
    assert torch.equal(ops.tdfir(a, a[:, :2]), ref.tdfir_ref(a, a[:, :2]))
    assert ops.launch_counts() == {"matmul": 0, "tdfir": 0,
                                   "flash_attention": 0,
                                   "decode_attention": 0}
    with pytest.raises(ValueError):
        cuda_mm.matmul(a, a)
    with pytest.raises(ValueError):
        cuda_fir.tdfir(a, a[:, :2])



def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header names a new library, so a kernel that
    includes it is rebuilt and never loaded stale."""
    import shutil

    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc/ has no header to hash"
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    assert before == {name: _build.library_path(name)
                      for name in _build.KERNELS}
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    for name in _build.KERNELS:
        assert after[name] != before[name], name
        assert after[name].parent == csrc / "build"
        assert after[name].name.startswith(f"{name}-")
