"""The port's attention against the JAX package's: the plain versions of the
flash-attention and decode-attention kernels against the Pallas kernels
(interpret mode) at every shape and tolerance of tests/test_kernels.py, and
the port's GQA layers against the JAX layers with grouped heads, a ragged
prompt length and per-slot cache lengths.  The CUDA kernels against their
plain versions are in tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_da
from repro.kernels import flash_attention as jax_fa
from repro.models import layers as jax_layers
from repro_torch.kernels import ops, parity, ref
from repro_torch.models import layers


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("bh,sq,skv,d,bq,bkv", [
    (2, 64, 64, 16, 32, 32),
    (3, 128, 128, 32, 32, 64),
    (1, 96, 96, 64, 32, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(bh, sq, skv, d, bq, bkv, causal):
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, (bh, s, d)) for s in (sq, skv, skv))
    want = jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, block_q=bq, block_kv=bkv,
                                  interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert torch.equal(got, ref.mha_ref(tq, tk, tv, causal=causal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_flash_plain_matches_pallas_bf16():
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, (2, 64, 32)) for _ in range(3))
    want = jax_fa.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), block_q=32,
        block_kv=32, interpret=True)
    got = ops.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_flash_plain_matches_pallas_bf16_d128_grouped_ragged():
    """The plain version the card holds the tensor-core kernel against, at
    the shapes that kernel covers: bf16, D=128, kv_group 4, a ragged S=200
    (one 200-row block, since the Pallas wrapper needs S % block == 0)."""
    rng = np.random.default_rng(6)
    rep, s, d = 4, 200, 128
    q = _normal(rng, (2 * rep, s, d))
    k, v = _normal(rng, (2, s, d)), _normal(rng, (2, s, d))
    want = jax_fa.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16)
          for a in (q, np.repeat(k, rep, axis=0), np.repeat(v, rep, axis=0))),
        block_q=s, block_kv=s, interpret=True)
    got = ops.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        kv_group=rep)
    assert got.dtype == torch.bfloat16 and got.shape == (2 * rep, s, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_bf16_limits_pass_a_tiled_kernel_and_reject_faults(d):
    """The card's bf16 limits (absolute and row-scaled) pass the Pallas
    kernel, a sound tiled online softmax with 128-key tiles like the CUDA
    kernel's, and reject each simulated fault of ``parity.fault_controls``
    (a skipped tile or k16 step, a stale ring stage, P in fp8)."""
    rng = np.random.default_rng(7)
    rep, s = 4, 1024
    q = _normal(rng, (rep, s, d))
    k, v = _normal(rng, (1, s, d)), _normal(rng, (1, s, d))
    tiled = jax_fa.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16)
          for a in (q, np.repeat(k, rep, axis=0), np.repeat(v, rep, axis=0))),
        block_q=128, block_kv=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = ref.mha_ref(tq, tk, tv, kv_group=rep)
    got = torch.from_numpy(np.asarray(tiled, np.float32)).to(torch.bfloat16)
    assert parity.within_limits(got, want)[0]
    controls = parity.fault_controls(tq, tk, tv, rep)
    assert len(controls) == 4
    for fault, bad in controls.items():
        assert parity.row_err(bad, want) > 4 * parity.BF16_ROW_TOL, fault


@pytest.mark.parametrize("rep", [2, 4])
def test_flash_kv_group_reads_kv_head_bh_over_rep(rep):
    """Row bh reads K/V row bh // rep: equal to the Pallas kernel on K/V
    repeated per query head in the same order."""
    rng = np.random.default_rng(5)
    q = _normal(rng, (2 * rep, 64, 32))
    k, v = _normal(rng, (2, 64, 32)), _normal(rng, (2, 64, 32))
    want = jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=0)),
        jnp.asarray(np.repeat(v, rep, axis=0)), block_q=32, block_kv=32,
        interpret=True)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              kv_group=rep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bh,s,d,bkv,clen", [
    (4, 256, 64, 64, 256), (2, 512, 32, 128, 300), (1, 128, 128, 64, 1),
])
def test_decode_plain_matches_pallas(bh, s, d, bkv, clen):
    rng = np.random.default_rng(7)
    q, k, v = _normal(rng, (bh, d)), _normal(rng, (bh, s, d)), \
        _normal(rng, (bh, s, d))
    want = jax_da.decode_attention(*map(jnp.asarray, (q, k, v)),
                                   jnp.int32(clen), block_kv=bkv,
                                   interpret=True)
    # the TPU form [BH, D] / [BH, S, D] is the grouped form with H = KV = 1
    tq = torch.from_numpy(q)[:, None, :]
    tk = torch.from_numpy(k)[:, :, None, :]
    tv = torch.from_numpy(v)[:, :, None, :]
    got = ops.decode_attention(tq, tk, tv, clen)
    assert torch.equal(got, ref.decode_attention_ref(tq, tk, tv, clen))
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("h,kv", [(4, 2), (8, 2)])
@pytest.mark.parametrize("s", [37, 64])
def test_gqa_prefill_layer_matches_jax_dense_attention(h, kv, s):
    """layers.attention (flash kernel's plain version, kv_group = H / KV)
    against the JAX grouped dense attention: rep 2 and 4, a ragged S."""
    rng = np.random.default_rng(8)
    q = _normal(rng, (2, s, h, 16))
    k, v = _normal(rng, (2, s, kv, 16)), _normal(rng, (2, s, kv, 16))
    want = jax_layers.dense_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=True)
    got = layers.attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert got.shape == (2, s, h, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("h,kv", [(4, 2), (8, 2)])
def test_per_slot_decode_layer_matches_vmapped_jax(h, kv):
    """One batched call with a cache_len per slot equals the JAX engine's
    vmap of the scalar-length layer over the slots."""
    rng = np.random.default_rng(9)
    n, s, d = 4, 96, 32
    q = _normal(rng, (n, 1, h, d))
    kc, vc = _normal(rng, (n, s, kv, d)), _normal(rng, (n, s, kv, d))
    lens = np.array([1, 37, 64, 96], np.int32)
    want = jax.vmap(
        lambda q1, k1, v1, n1: jax_layers.decode_attention(
            q1[None], k1[None], v1[None], n1)[0])(
        *map(jnp.asarray, (q, kc, vc, lens)))
    got = layers.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                  torch.from_numpy(lens))
    assert got.shape == (n, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_decode_cache_len_scalar_broadcasts():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 4, 16, generator=g)
    kc, vc = (torch.randn(3, 20, 2, 16, generator=g) for _ in range(2))
    assert torch.equal(ops.decode_attention(q, kc, vc, 7),
                       ops.decode_attention(q, kc, vc,
                                            torch.tensor([7, 7, 7])))


def test_attention_layers_refuse_other_families():
    """Soft caps and query offsets, once refused, are computed: prefill
    and decode match the JAX layers at 2e-4 (tests/test_kernels.py's
    tolerance; tests/test_torch_softcap.py holds the rest).  A window is
    computed in prefill and, as in the JAX layer, ignored in decode (the
    ring holds the window)."""
    rng = np.random.default_rng(8)
    x, kx = _normal(rng, (1, 4, 2, 16)), _normal(rng, (1, 6, 2, 16))
    for kw in ({"softcap": 1.5}, {"q_offset": 2}):
        want = jax_layers.dense_attention(*map(jnp.asarray, (x, kx, kx)),
                                          causal=True, **kw)
        got = layers.attention(*map(torch.from_numpy, (x, kx, kx)),
                               causal=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
    want = jax_layers.decode_attention(*map(jnp.asarray, (x[:, :1], kx, kx)),
                                       4, softcap=1.5)
    got = layers.decode_attention(*map(torch.from_numpy, (x[:, :1], kx, kx)),
                                  4, softcap=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn(1, 4, 2, 16, generator=g) for _ in range(2))
    assert not torch.equal(layers.attention(q, k, k, causal=True, window=2),
                           layers.attention(q, k, k, causal=True))
    assert torch.equal(layers.decode_attention(q[:, :1], k, k, 4, window=2),
                       layers.decode_attention(q[:, :1], k, k, 4))


def test_cpu_attention_launches_no_kernel():
    """CPU tensors take the plain versions; the CUDA wrappers refuse
    them."""
    from repro_torch.kernels import decode_attention as cuda_da
    from repro_torch.kernels import flash_attention as cuda_fa
    ops.reset_launch_counts()
    x = torch.ones(2, 8, 16)
    ops.flash_attention(x, x, x)
    ops.decode_attention(x[:, :1], x[:, :, None], x[:, :, None], 8)
    ops.flash_attention_bwd(x, x, x, x, x, x[..., 0])
    assert ops.launch_counts() == {"matmul": 0, "tdfir": 0,
                                   "flash_attention": 0,
                                   "decode_attention": 0,
                                   "flash_attention_bwd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fa.flash_attention(x, x, x)
    from repro_torch.kernels import flash_attention_bwd as cuda_fab
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fab.flash_attention_bwd(x, x, x, x, x, x[..., 0])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_da.decode_attention(x[:, :1], x[:, :, None], x[:, :, None], 8)
