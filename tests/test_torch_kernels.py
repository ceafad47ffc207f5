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


@pytest.mark.parametrize("f,n,k", [(2, 100, 128), (3, 300, 13),
                                   (2, 600, 200), (2, 512, 128)])
def test_tdfir_complex_plain_matches_pallas_at_the_app_block(f, n, k):
    """The planner's call, ``block_n=max(128, K)``: K above N (the Pallas
    input zero-extended to K samples, which causal outputs do not see), K
    not a multiple of 4, K above 128."""
    rng = np.random.default_rng(3)
    xr, xi = _normal(rng, (f, n)), _normal(rng, (f, n))
    hr, hi = _normal(rng, (f, k)), _normal(rng, (f, k))
    ext = ((0, 0), (0, max(0, k - n)))
    want = jax_fir.tdfir_complex(
        *(jnp.asarray(np.pad(a, ext)) for a in (xr, xi)),
        jnp.asarray(hr), jnp.asarray(hi), block_n=max(128, k),
        interpret=True)
    got = ops.tdfir_complex(*map(torch.from_numpy, (xr, xi, hr, hi)),
                            block_n=max(128, k))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :n],
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("where", ["nest", "registry"])
def test_tdfir_pallas_impl_is_one_complex_call(monkeypatch, where):
    """The tdFIR FPGA-analogue impl (loop nest and function-block
    replacement) makes one ``ops.tdfir_complex`` call, launches nothing on
    the CPU, and equals the JAX package's impl at 1e-4."""
    import jax

    from repro.apps import registry as jax_registry
    from repro.apps import tdfir_app as jax_app
    from repro_torch.apps import registry, state_from_numpy, tdfir_app
    calls = []
    real = ops.tdfir_complex

    def counted(*args, **kw):
        calls.append(kw.get("block_n"))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "tdfir_complex", counted)
    state = {k: np.asarray(v) for k, v in
             jax_app.make_inputs(seed=0, small=True).items()}
    if where == "nest":
        impl = tdfir_app.build_app().nests[0].impls["pallas"]
        jax_impl = jax_app.build_app().nests[0].impls["pallas"]
    else:
        impl = registry.TDFIR_ENTRY.impls["pallas"]
        jax_impl = jax_registry.TDFIR_ENTRY.impls["pallas"]
    ops.reset_launch_counts()
    got = impl(state_from_numpy(state, "cpu"))
    want = jax_impl({k: jax.numpy.asarray(v) for k, v in state.items()})
    assert calls == [max(128, state["h_re"].shape[1])]
    assert ops.launch_counts()["tdfir"] == 0
    for key in ("y_re", "y_im"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


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
                                   "decode_attention": 0,
                                   "flash_attention_bwd": 0}
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
