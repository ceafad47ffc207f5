"""Automatic partitioning of the dense LM against the JAX package on the CPU.

``LM(cfg, params, plan, rules=Rules(mesh, plan))`` places the parameters as
DTensors by ``param_axes``, lets DTensor place the plain ops' collectives
and runs the kernels on each rank's own heads or ``kv_seq`` slice
(``Rules.local``).  With reduced granite in fp32 and the JAX ``Model.init``
weights through ``convert``:

(i) on the (4, 2) and (2, 4) meshes, each parameter's and each moment's
placements entry by entry against the reference's ``Rules.spec``
``PartitionSpec``s (the fake process group: no ranks); (ii)
``make_train_step`` on 8 gloo ranks on (4, 2) at B 8, S 16,
``Plan(vocab_chunk=8)`` (``tests/test_distributed.py:6``) against the JAX
``make_train_step`` on one device: the loss within 1e-5 relative and the
reference test's 1e-3, the updated parameters within 2e-4 of each leaf's
max, the flash forward and backward on each rank's 2 of 4 heads; (iii)
after a prefill into a 64-slot cache, four ``make_serve_step`` decode
steps on (2, 4) against the JAX serve step on one device, logits within
1e-4: once with ``decode_kv_seq_shard`` (``tests/test_distributed.py:129``:
each rank decodes 16 slots, half of them past every row's length) and once
heads-sharded, where the 2 KV heads stay whole and each rank's one query
head reads one of them; (iv) the plain decode's ``lse`` against numpy and
two half slices merged by their ``lse`` against the whole.  The other
families and the int8 cache are held in
``tests/test_torch_dist_families.py``.  The JAX side
runs once in a subprocess, the port's ranks once (8 gloo ranks over a
``FileStore`` under ``tmp_path``, both meshes).
"""
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from helpers import run_multidevice
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.plan import Plan
from repro_torch.dist.sharding import Rules
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_test_mesh, run_ranks
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM, init_params, param_axes
from repro_torch.train import optimizer, train_step as ts

ARCH = "granite-3-2b"
B, S = 8, 16
CACHE, STEPS = 64, 4
LR, EPS = 1e-3, 1e-4       # eps: a first Adam step is g / (|g| + eps)
TRAIN_MESH, SERVE_MESH = (4, 2), (2, 4)
AXES = ("data", "model")
SERVE_PLANS = {"kv_seq": dict(decode_kv_seq_shard=True, remat="none"),
               "heads": dict(remat="none")}


def _inputs(tmp):
    rng = np.random.default_rng(25)
    vocab = get_config(ARCH).reduced().vocab_size
    np.savez(tmp / "in.npz",
             tokens=rng.integers(0, vocab, (B, S)).astype(np.int32),
             labels=rng.integers(0, vocab, (B, S)).astype(np.int32),
             prompt=rng.integers(0, vocab, (B, S)).astype(np.int32),
             steps=rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int32))


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import TrainConfig
from repro.dist.plan import Plan
from repro.models.lm import Model
from repro.train import optimizer, train_step as ts

inp = dict(np.load(TMP + '/in.npz'))
out = {}

def flat(tree, pre):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = '/'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                       for k in path)
        out[pre + key] = np.asarray(leaf)

cfg = get_config('granite-3-2b').reduced()
model = Model(cfg, Plan(vocab_chunk=8))
tcfg = TrainConfig(lr=LR, warmup_steps=1, eps=EPS)
params = model.init(jax.random.PRNGKey(0))
flat(params, 'p0/')
batch = {'tokens': jnp.asarray(inp['tokens']),
         'labels': jnp.asarray(inp['labels'])}
p1, _, m = jax.jit(ts.make_train_step(model, tcfg))(
    params, optimizer.init(params, tcfg), batch, jnp.int32(0))
flat(p1, 'p1/')
out['loss'] = np.asarray(m['loss'])

serve = Model(cfg, Plan(remat='none'))
logits, cache = jax.jit(ts.make_prefill_step(serve, CACHE))(
    params, {'tokens': jnp.asarray(inp['prompt'])})
out['logits/prefill'] = np.asarray(logits)
step = jax.jit(ts.make_serve_step(serve))
for i in range(STEPS):
    logits, cache = step(params, cache, jnp.asarray(inp['steps'][i]),
                         jnp.int32(inp['prompt'].shape[1] + i))
    out[f'logits/{i}'] = np.asarray(logits)
np.savez(TMP + '/jax.npz', **out)
print('ok')
"""


def _nested(flat, prefix):
    tree = {}
    for key, a in flat.items():
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[last] = a
    return tree


def _jax_params(jx, prefix):
    return params_from_numpy(_nested(jx, prefix), get_config(ARCH).reduced(),
                             device="cpu")


def _recording(calls):
    """Wrap the kernel dispatchers so that each call's local shapes are
    kept (the layers reach them through the ``ops`` module)."""
    fa, fab, da = ops.flash_attention, ops.flash_attention_bwd, \
        ops.decode_attention

    def flash(q, k, v, **kw):
        calls.append(("flash", tuple(q.shape), tuple(k.shape),
                      kw["kv_group"]))
        return fa(q, k, v, **kw)

    def flash_bwd(q, k, v, o, do, lse, **kw):
        calls.append(("flash_bwd", tuple(q.shape), tuple(k.shape),
                      kw["kv_group"]))
        return fab(q, k, v, o, do, lse, **kw)

    def decode(q, k, v, cache_len, lse=None):
        calls.append(("decode", tuple(q.shape), tuple(k.shape),
                      lse is not None))
        return da(q, k, v, cache_len, lse=lse)

    ops.flash_attention, ops.flash_attention_bwd = flash, flash_bwd
    ops.decode_attention = decode


def _rank(rank, world, tmp):
    inp = dict(np.load(f"{tmp}/in.npz"))
    jx = dict(np.load(f"{tmp}/jax.npz"))
    cfg = get_config(ARCH).reduced()
    out = {}
    # (ii) the sharded train step
    calls = []
    _recording(calls)
    mesh = make_test_mesh(TRAIN_MESH, AXES, device="cpu")
    plan = Plan(vocab_chunk=8)
    tcfg = TrainConfig(lr=LR, warmup_steps=1, eps=EPS)
    lm = LM(cfg, _jax_params(jx, "p0/"), plan, rules=Rules(mesh, plan))
    batch = {k: torch.from_numpy(inp[k]) for k in ("tokens", "labels")}
    params, opt, m = ts.make_train_step(lm, tcfg)(
        lm.params(), optimizer.init(lm.params(), tcfg), batch, 0)
    out["loss"] = m["loss"]
    out.update({f"p/{n}": p.full_tensor() for n, p in params.items()})
    out["train_calls"] = list(calls)
    # (iii) the serve step, both ways
    mesh = make_test_mesh(SERVE_MESH, AXES, device="cpu")
    prompt = torch.from_numpy(inp["prompt"])
    for name, kw in SERVE_PLANS.items():
        calls.clear()
        plan = Plan(**kw)
        lm = LM(cfg, _jax_params(jx, "p0/"), plan, rules=Rules(mesh, plan))
        logits, cache = ts.make_prefill_step(lm, CACHE)({"tokens": prompt})
        out[f"{name}/prefill"] = logits
        out[f"{name}/cache"] = str(cache["attn"]["k"].placements)
        step = ts.make_serve_step(lm)
        for i in range(STEPS):
            logits, cache = step(cache, torch.from_numpy(inp["steps"][i]),
                                 S + i)
            out[f"{name}/{i}"] = logits
        out[f"{name}/calls"] = list(calls)
    torch.save(out, f"{tmp}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_auto")
    _inputs(tmp)
    run_multidevice(f"TMP = {str(tmp)!r}\nLR, EPS = {LR!r}, {EPS!r}\n"
                    f"CACHE, STEPS = {CACHE!r}, {STEPS!r}\n" + JAX_SIDE,
                    n_devices=1)
    run_ranks(_rank, 8, str(tmp), backend="gloo")
    jx = dict(np.load(tmp / "jax.npz"))
    return jx, {r: torch.load(tmp / f"rank{r}.pt") for r in range(8)}


# ------------------------------------------------------- (i) placements
def _placements(spec, names):
    """The DTensor placements a JAX PartitionSpec asks for, entry by
    entry: dimension ``d`` sharded over each mesh axis its entry names."""
    out = ["R"] * len(names)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[names.index(a)] = f"S({d})"
    return out


@pytest.mark.parametrize("shape", [TRAIN_MESH, SERVE_MESH])
def test_placements_match_the_reference_specs(shape):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro.dist.plan import Plan as JaxPlan
    from repro.dist.sharding import Rules as JaxRules
    cfg = get_config(ARCH).reduced()
    dist.init_process_group("fake", store=FakeStore(), rank=5,
                            world_size=8)
    try:
        mesh = make_test_mesh(shape, AXES, device="cpu")
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        lm = LM(cfg, dict(params), Plan(), rules=Rules(mesh, Plan()))
        assert lm.partitioned
        theirs = JaxRules(types.SimpleNamespace(
            axis_names=AXES, shape=dict(zip(AXES, shape))), JaxPlan())
        state = optimizer.init(lm.params(), TrainConfig())
        for name, p in lm.params().items():
            want = _placements(theirs.spec(param_axes(cfg)[name],
                                           tuple(p.shape)), list(AXES))
            assert [str(x) for x in p.placements] == want, name
            for moment in ("m", "v"):
                assert state[moment][name].placements == p.placements
            assert tuple(p.shape) == tuple(params[name].shape)
        with pytest.raises(ValueError, match="partitioned"):
            from repro_torch.serve.batching import ContinuousBatcher
            ContinuousBatcher(lm, n_slots=2, cache_len=16)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- (ii) the train step
def test_sharded_train_step_matches_jax(runs):
    jx, ranks = runs
    want = float(jx["loss"])
    for r, got in ranks.items():
        loss = float(got["loss"])
        assert abs(loss - want) <= 1e-5 * abs(want), (r, loss, want)
        assert abs(loss - want) < 1e-3


def test_sharded_train_step_updates_match_jax(runs):
    jx, ranks = runs
    want = _jax_params(jx, "p1/")
    for r, got in ranks.items():
        for n, w in want.items():
            err = (got[f"p/{n}"] - w).abs().max().item()
            assert err <= 2e-4 * w.abs().max().item(), (r, n, err)


def test_train_step_runs_flash_on_each_ranks_heads(runs):
    """(4, 2): each rank's 2 of 8 rows and 2 of 4 heads over 1 of 2 KV
    heads, forward twice a layer (block remat) and backward once."""
    _, ranks = runs
    cfg = get_config(ARCH).reduced()
    local = (2 * 2, S, cfg.head_dim), (2 * 1, S, cfg.head_dim)
    for r, got in ranks.items():
        calls = got["train_calls"]
        fwd = [c for c in calls if c[0] == "flash"]
        bwd = [c for c in calls if c[0] == "flash_bwd"]
        assert len(fwd) == 2 * cfg.n_layers and len(bwd) == cfg.n_layers
        assert all(c[1:] == (*local, 2) for c in fwd + bwd), calls


# ------------------------------------------------- (iii) the serve step
@pytest.mark.parametrize("mode", list(SERVE_PLANS))
@pytest.mark.parametrize("what", ["prefill"] + list(range(STEPS)))
def test_serve_step_matches_jax(runs, mode, what):
    jx, ranks = runs
    want = jx[f"logits/{what}"]
    for r, got in ranks.items():
        np.testing.assert_allclose(got[f"{mode}/{what}"].numpy(), want,
                                   rtol=0, atol=1e-4, err_msg=f"rank {r}")


@pytest.mark.parametrize("mode", list(SERVE_PLANS))
def test_serve_runs_the_kernels_on_each_ranks_part(runs, mode):
    """(2, 4), B 8: 4 rows a rank.  kv_seq: the cache [L, B, W, KV, D]
    split on W over "model", each rank decoding 16 of 64 slots over all 4
    heads with the lse; heads: 1 query head a rank over the one KV head of
    the 2 (whole over "model") it reads, the whole 64 slots.  The prefill
    runs the flash kernel on 1 query head a rank in both."""
    _, ranks = runs
    cfg = get_config(ARCH).reduced()
    d, n = cfg.head_dim, cfg.n_layers
    cache, dec_shapes = {
        "kv_seq": ("(Shard(dim=1), Shard(dim=2))",
                   ((4, 4, d), (4, CACHE // 4, 2, d), True)),
        "heads": ("(Shard(dim=1), Replicate())",
                  ((4, 1, d), (4, CACHE, 1, d), False))}[mode]
    # the prefill's heads are split either way: 1 a rank, its one KV head
    prefill = ((4 * 1, S, d), (4 * 1, S, d), 1)
    for r, got in ranks.items():
        assert got[f"{mode}/cache"] == cache
        calls = got[f"{mode}/calls"]
        dec = [c[1:] for c in calls if c[0] == "decode"]
        fwd = [c[1:] for c in calls if c[0] == "flash"]
        assert dec == [dec_shapes] * (n * STEPS), dec
        assert fwd == [prefill] * n, fwd


# ------------------------------------------------- (iv) the decode lse
LENS = [(1, 5, 16, 0), (16, 16, 16, 16), (3, 0, 9, 12)]


def _decode_case(lens, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(4, 8, 32, generator=g)
    kc = torch.randn(4, 16, 2, 32, generator=g)
    vc = torch.randn(4, 16, 2, 32, generator=g)
    return q, kc, vc, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("lens", LENS)
def test_decode_lse_matches_numpy(lens):
    q, kc, vc, ln = _decode_case(lens)
    lse = torch.empty(4, 8)
    out = ops.decode_attention(q, kc, vc, ln, lse=lse)
    qn, kn = q.double().numpy(), kc.double().numpy()
    for b in range(4):
        for h in range(8):
            if lens[b] == 0:
                assert lse[b, h].item() == np.float32(ref.NEG_INF)
                assert not out[b, h].any()
                continue
            s = kn[b, :lens[b], h // 4] @ qn[b, h] / np.sqrt(32)
            want = (np.log(np.exp(s - s.max()).sum()) + s.max()) / np.log(2)
            assert abs(lse[b, h].item() - want) < 1e-5, (b, h)
    np.testing.assert_array_equal(
        out.numpy(), ops.decode_attention(q, kc, vc, ln).numpy())


@pytest.mark.parametrize("lens", LENS)
def test_decode_halves_merge_into_the_whole(lens):
    """Each half [r W/2, (r+1) W/2) with its lengths clamped into it, merged
    by out = sum_r 2^(lse_r - M) out_r / sum_r 2^(lse_r - M): a row whose
    second half holds no valid key (length <= 8) takes its first half."""
    q, kc, vc, ln = _decode_case(lens, seed=1)
    outs, lses = [], []
    for r in range(2):
        lse = torch.empty(4, 8)
        part = slice(8 * r, 8 * r + 8)
        outs.append(ops.decode_attention(
            q, kc[:, part].contiguous(), vc[:, part].contiguous(),
            torch.clamp(ln - 8 * r, 0, 8), lse=lse))
        lses.append(lse)
    top = torch.maximum(*lses)
    wts = [torch.exp2(lse - top) for lse in lses]
    got = sum(w[..., None] * o for w, o in zip(wts, outs))
    got = got / sum(wts)[..., None]
    whole_lse = torch.empty(4, 8)
    want = ops.decode_attention(q, kc, vc, ln, lse=whole_lse)
    live = ln > 0
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-6)
    torch.testing.assert_close(top + torch.log2(sum(wts)), whole_lse,
                               rtol=0, atol=1e-5)
