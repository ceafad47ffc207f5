"""Automatic partitioning of the other LM families and the int8 KV cache
against the JAX package on the CPU.

``LM(cfg, params, plan, rules=Rules(mesh, plan))`` partitions every family:
the grouped MoE (moonshot-v1-16b-a3b: each data rank routes its own groups
and runs its own experts, the combine summed over "model"), the SSM
(mamba2-1.3b: the projection gathered whole, the SSD chunks on each rank's
heads), the hybrid (recurrentgemma-2b, cut to one (recurrent, recurrent,
local attention) group on both sides: the RG-LRU on each rank's "lru"
channels, the local attention under its window), the VLM
(llama-3.2-vision-90b: cross attention over the image embeddings) and the
audio family (seamless-m4t-medium: the non-causal encoder, then cross
attention over its output), and granite-3-2b with the int8 cache.  Reduced
configs in fp32 with the JAX ``Model.init`` weights through ``convert``,
as ``tests/test_torch_dist_auto.py`` holds the dense family:

(i) on the (4, 2) and (2, 4) meshes each parameter's, each moment's and
each cache leaf's placements entry by entry against the reference's
``Rules.spec`` (the fake process group).  Where a reduced width does not
divide by "model" the fallback replicates it: the 2 KV heads on (2, 4)
(and recurrentgemma's one KV head on both meshes), so every rank reads the
KV heads its query heads need; (ii) ``make_train_step`` on 8 gloo ranks on
(4, 2) at B 8, S 16 against the JAX step on one device: the loss within
1e-5 relative, the updated parameters within 2e-4 of each leaf's max, the
MoE's aux within 1e-5 and its drops equal to the unpartitioned LM's
(capacity factor 1.0 drops pairs; 4 groups, one a data rank); (iii) a
prefill into a 64-slot cache and four ``make_serve_step`` decode steps on
(2, 4), heads-sharded and with ``decode_kv_seq_shard`` (the cross caches
and the int8 cache merge their slices by the ``lse``), logits within 1e-4
of the JAX serve step (the MoE in one group there, which the data ranks
do not split: every rank routes it whole; each int8 step from JAX's
cache, its writes within 1 of JAX's); (iv) the kernels' local shapes;
(v) the grouped MoE against ``apply_moe_ep`` on the same mesh at the
reference's limit (``tests/test_distributed.py:192``, 1e-4); (vi) the int8
decode's ``lse`` against numpy and two half slices merged into the whole.
The JAX side runs once in a subprocess, the port's ranks once (8 gloo
ranks over a ``FileStore`` under ``tmp_path``, both meshes, every family).
"""
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.plan import Plan
from repro_torch.dist.sharding import Rules, whole
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_test_mesh, run_ranks
from repro_torch.models import layers, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM, cache_axes, init_params, param_axes
from repro_torch.train import optimizer, train_step as ts

B, S = 8, 16
CACHE, STEPS = 64, 4
LR, EPS = 1e-3, 1e-4       # eps: a first Adam step is g / (|g| + eps)
TRAIN_MESH, SERVE_MESH = (4, 2), (2, 4)
AXES = ("data", "model")
# name -> (arch, layers kept (None: reduced()'s), train plan fields, serve
# plan fields); both sides take the same
FAMILIES = {
    "moonshot": ("moonshot-v1-16b-a3b", None,
                 dict(moe_groups=4, moe_capacity_factor=1.0),
                 dict(moe_capacity_factor=1.0)),
    "mamba2": ("mamba2-1.3b", None, {}, {}),
    "recurrentgemma": ("recurrentgemma-2b", 3, {}, {}),
    "vlm": ("llama-3.2-vision-90b", None, {}, {}),
    "seamless": ("seamless-m4t-medium", None, {}, {}),
    "granite-int8": ("granite-3-2b", None, {}, dict(kv_cache_quant=True)),
}
CONTEXT = {"vlm": "img_embed", "seamless": "frames"}
MODES = ("heads", "kv_seq")


def _cfg(name):
    import dataclasses
    arch, n_layers, _, _ = FAMILIES[name]
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def _inputs(tmp):
    rng = np.random.default_rng(26)
    arrays = {}
    for name in FAMILIES:
        cfg = _cfg(name)
        v = cfg.vocab_size
        arrays.update({
            f"{name}/tokens": rng.integers(0, v, (B, S)).astype(np.int32),
            f"{name}/labels": rng.integers(0, v, (B, S)).astype(np.int32),
            f"{name}/prompt": rng.integers(0, v, (B, S)).astype(np.int32),
            f"{name}/steps": rng.integers(0, v, (STEPS, B, 1))
            .astype(np.int32)})
        if name in CONTEXT:
            n = cfg.n_img_tokens if name == "vlm" else cfg.n_frames
            arrays[f"{name}/ctx"] = rng.standard_normal(
                (B, n, cfg.d_model)).astype(np.float32)
    np.savez(tmp / "in.npz", **arrays)


JAX_SIDE = """
import dataclasses, os
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

def save(out, path):
    np.savez(path + '.part.npz', **out)
    os.replace(path + '.part.npz', path + '.npz')  # whole when it appears

cfgs = {}
for name in ONLY:                   # the weights first: the ranks start
    arch, n_layers, tkw, skw = FAMILIES[name]
    cfg = get_config(arch).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = Model(cfg).init(jax.random.PRNGKey(0))
    flat(params, f'{name}/p0/')
    cfgs[name] = cfg, params
save(out, OUT + '_p0')
out = {}
for name in ONLY:
    arch, n_layers, tkw, skw = FAMILIES[name]
    cfg, params = cfgs[name]
    def batch(key):
        got = {'tokens': jnp.asarray(inp[f'{name}/{key}'])}
        if name in CONTEXT:
            got[CONTEXT[name]] = jnp.asarray(inp[f'{name}/ctx'])
        return got
    model = Model(cfg, Plan(vocab_chunk=8, **tkw))
    tcfg = TrainConfig(lr=LR, warmup_steps=1, eps=EPS)
    tb = dict(batch('tokens'), labels=jnp.asarray(inp[f'{name}/labels']))
    p1, _, m = jax.jit(ts.make_train_step(model, tcfg))(
        params, optimizer.init(params, tcfg), tb, jnp.int32(0))
    flat(p1, f'{name}/p1/')
    out[f'{name}/loss'] = np.asarray(m['loss'])
    out[f'{name}/aux'] = np.asarray(m['aux_loss'])
    serve = Model(cfg, Plan(remat='none', **skw))
    logits, cache = jax.jit(ts.make_prefill_step(serve, CACHE))(
        params, batch('prompt'))
    out[f'{name}/logits/prefill'] = np.asarray(logits)
    step = jax.jit(ts.make_serve_step(serve))
    for i in range(STEPS):
        if serve.plan.kv_cache_quant:
            flat(cache, f'{name}/cache{i}/')
        logits, cache = step(params, cache,
                             jnp.asarray(inp[f'{name}/steps'][i]),
                             jnp.int32(S + i))
        out[f'{name}/logits/{i}'] = np.asarray(logits)
    if serve.plan.kv_cache_quant:
        flat(cache, f'{name}/cache{STEPS}/')
save(out, OUT)
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


def _jax_params(jx, name, which):
    return params_from_numpy(_nested(jx, f"{name}/{which}/"), _cfg(name),
                             device="cpu")


def _batch(inp, name, key, labels=False):
    got = {"tokens": torch.from_numpy(inp[f"{name}/{key}"])}
    if labels:
        got["labels"] = torch.from_numpy(inp[f"{name}/labels"])
    if name in CONTEXT:
        got[CONTEXT[name]] = torch.from_numpy(inp[f"{name}/ctx"])
    return got


def _recording(calls):
    """Wrap the kernel dispatchers so that each call's local shapes (and a
    flash call's causal flag and window) are kept."""
    fa, fab, da = ops.flash_attention, ops.flash_attention_bwd, \
        ops.decode_attention

    def flash(q, k, v, **kw):
        calls.append(("flash", tuple(q.shape), tuple(k.shape),
                      kw["kv_group"], kw.get("causal", True),
                      kw.get("window", 0)))
        return fa(q, k, v, **kw)

    def flash_bwd(q, k, v, o, do, lse, **kw):
        calls.append(("flash_bwd", tuple(q.shape), tuple(k.shape),
                      kw["kv_group"], kw.get("causal", True),
                      kw.get("window", 0)))
        return fab(q, k, v, o, do, lse, **kw)

    def decode(q, k, v, cache_len, lse=None):
        calls.append(("decode", tuple(q.shape), tuple(k.shape),
                      lse is not None))
        return da(q, k, v, cache_len, lse=lse)

    ops.flash_attention, ops.flash_attention_bwd = flash, flash_bwd
    ops.decode_attention = decode


def _jax_cache(jx, name, i):
    """The JAX int8 cache before decode step ``i`` (after the last: STEPS)
    as the port's cache tree of whole tensors."""
    pre = f"{name}/cache{i}/"
    return {"attn": {k[len(pre) + len("attn/"):]: torch.from_numpy(
        np.array(v)) for k, v in jx.items() if k.startswith(pre)}}


def _jax_steps(tmp, name, what="", timeout_s=400.0):
    """The JAX results for ``name`` (``what="_p0"``: its weights), once the
    background process that runs it has written them."""
    import os
    import time
    path = f"{tmp}/{_jax_out(name)}{what}.npz"
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"no {path} after {timeout_s} s")
        time.sleep(0.2)
    return dict(np.load(path))


def _rank(rank, world, tmp):
    inp = dict(np.load(f"{tmp}/in.npz"))
    jx = {}
    out = {}
    calls = []
    _recording(calls)
    train_mesh = make_test_mesh(TRAIN_MESH, AXES, device="cpu")
    serve_mesh = make_test_mesh(SERVE_MESH, AXES, device="cpu")
    tcfg = TrainConfig(lr=LR, warmup_steps=1, eps=EPS)
    for name, (_, _, tkw, skw) in FAMILIES.items():
        cfg = _cfg(name)
        jx.update(_jax_steps(tmp, name, "_p0"))
        # (ii) the sharded train step
        calls.clear()
        plan = Plan(vocab_chunk=8, **tkw)
        lm = LM(cfg, _jax_params(jx, name, "p0"), plan,
                rules=Rules(train_mesh, plan))
        params, opt, m = ts.make_train_step(lm, tcfg)(
            lm.params(), optimizer.init(lm.params(), tcfg),
            _batch(inp, name, "tokens", labels=True), 0)
        out[f"{name}/loss"] = m["loss"]
        out[f"{name}/aux"] = m["aux_loss"]
        out.update({f"{name}/p/{n}": p.full_tensor()
                    for n, p in params.items()})
        out[f"{name}/train_calls"] = list(calls)
        if cfg.moe is not None:
            out[f"{name}/drops"] = _drops(cfg, jx, name, plan, train_mesh,
                                          _batch(inp, name, "tokens",
                                                 labels=True))
        # (iii) the serve step, both ways
        for mode in MODES:
            calls.clear()
            plan = Plan(remat="none", decode_kv_seq_shard=mode == "kv_seq",
                        **skw)
            lm = LM(cfg, _jax_params(jx, name, "p0"), plan,
                    rules=Rules(serve_mesh, plan))
            jax_steps = (_jax_steps(tmp, name) if plan.kv_cache_quant
                         else None)
            with torch.no_grad():
                logits, cache = ts.make_prefill_step(lm, CACHE)(
                    _batch(inp, name, "prompt"))
                out[f"{name}/{mode}/prefill"] = logits
                out[f"{name}/{mode}/cache"] = {
                    k: str(v.placements) for k, v in _flat(cache).items()}
                step = ts.make_serve_step(lm)
                for i in range(STEPS):
                    if plan.kv_cache_quant:     # each step from JAX's cache
                        cache = lm.rules.distribute(
                            _jax_cache(jax_steps, name, i),
                            cache_axes(cfg, True))
                    logits, cache = step(cache, torch.from_numpy(
                        inp[f"{name}/steps"][i]), S + i)
                    out[f"{name}/{mode}/{i}"] = logits
                    if plan.kv_cache_quant:
                        out[f"{name}/{mode}/written{i}"] = {
                            k: v.full_tensor()
                            for k, v in cache["attn"].items()}
            out[f"{name}/{mode}/calls"] = list(calls)
    out["moe_vs_ep"] = _moe_against_ep(jx, serve_mesh)
    torch.save(out, f"{tmp}/rank{rank}.pt")


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _drops(cfg, jx, name, plan, mesh, batch):
    """(pairs, dropped, experts routed to) of one forward pass, the
    partitioned LM's and the unpartitioned one's."""
    got = []
    for rules in (Rules(mesh, plan), None):
        lm = LM(cfg, _jax_params(jx, name, "p0"), plan, rules=rules)
        counts = lm.count_moe_drops()
        with torch.no_grad():
            lm.train_loss(batch)
        got.append(counts[0].clone())
    return got


def _moe_against_ep(jx, mesh):
    """The grouped MoE of moonshot's first layer on the mesh (one group,
    the reference test's x [4, 16, d]) and ``apply_moe_ep`` on the same
    mesh, both gathered whole: (y, aux) each."""
    cfg = _cfg("moonshot")
    params = _jax_params(jx, "moonshot", "p0")
    pre = "blocks.0.ffn."
    flat = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
    tree = {"router": flat["router"]}
    for part in ("experts", "shared"):
        tree[part] = {k.split(".", 1)[1]: v for k, v in flat.items()
                      if k.startswith(part + ".")}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    rules = Rules(mesh, Plan())
    placed = rules.distribute(tree, moe.moe_axes(cfg))
    y, aux = moe.apply_moe(placed, cfg, rules.place(x, ("batch", None, None)),
                           rules=rules)
    y_ep, aux_ep = moe.apply_moe_ep(tree, cfg, x, rules=rules)
    return whole(y), aux, y_ep, aux_ep


# the JAX steps' background processes, each over these families (the int8
# cache's first: its ranks wait for JAX's caches)
JAX_GROUPS = (("granite-int8", "moonshot"), ("mamba2", "recurrentgemma"),
              ("vlm", "seamless"))


def _jax_out(name) -> str:
    return next(f"jax{i}" for i, g in enumerate(JAX_GROUPS) if name in g)


def _jax_code(tmp, names, out: str) -> str:
    return (f"TMP = {str(tmp)!r}\nLR, EPS = {LR!r}, {EPS!r}\n"
            f"CACHE, STEPS, S = {CACHE!r}, {STEPS!r}, {S!r}\n"
            f"FAMILIES = {FAMILIES!r}\nCONTEXT = {CONTEXT!r}\n"
            f"ONLY = {tuple(names)!r}\nOUT = {f'{tmp}/{out}'!r}\n"
            + JAX_SIDE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side in background processes, one a group of families: each
    writes its weights (``jax{i}_p0.npz``), which the port's ranks wait
    for, then its steps (``jax{i}.npz``) while the ranks run."""
    import os
    import subprocess
    import sys
    from helpers import SRC
    tmp = tmp_path_factory.mktemp("dist_families")
    _inputs(tmp)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys\nsys.path.insert(0, {SRC!r})\n"
         + _jax_code(tmp, names, f"jax{i}")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC})
        for i, names in enumerate(JAX_GROUPS)]
    try:
        run_ranks(_rank, 8, str(tmp), backend="gloo")
    finally:
        done = [p.communicate(timeout=420) for p in procs]
    for p, (out, err) in zip(procs, done):
        assert p.returncode == 0, f"{out[-3000:]}\n{err[-3000:]}"
    jx = dict(np.load(tmp / "in.npz"))
    for i in range(len(JAX_GROUPS)):
        jx.update(np.load(tmp / f"jax{i}_p0.npz"))
        jx.update(np.load(tmp / f"jax{i}.npz"))
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


def _jax_leaves(tree):
    """A JAX logical-axes tree's leaves, dicts in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _jax_leaves(t)]
    return [tree]


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("shape,kv_seq", [(TRAIN_MESH, False),
                                          (SERVE_MESH, True)])
def test_placements_match_the_reference_specs(name, shape, kv_seq):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro.dist.plan import Plan as JaxPlan
    from repro.dist.sharding import Rules as JaxRules
    from repro.models.lm import cache_axes as jax_cache_axes
    from repro_torch.models.lm import _leaves
    cfg = _cfg(name)
    quant = FAMILIES[name][3].get("kv_cache_quant", False)
    dist.init_process_group("fake", store=FakeStore(), rank=5,
                            world_size=8)
    try:
        mesh = make_test_mesh(shape, AXES, device="cpu")
        plan = Plan(decode_kv_seq_shard=kv_seq, kv_cache_quant=quant)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        lm = LM(cfg, dict(params), plan, rules=Rules(mesh, plan))
        assert lm.partitioned
        theirs = JaxRules(types.SimpleNamespace(
            axis_names=AXES, shape=dict(zip(AXES, shape))),
            JaxPlan(decode_kv_seq_shard=kv_seq))
        state = optimizer.init(lm.params(), TrainConfig())
        for n, p in lm.params().items():
            want = _placements(theirs.spec(param_axes(cfg)[n],
                                           tuple(p.shape)), list(AXES))
            assert [str(x) for x in p.placements] == want, n
            for moment in ("m", "v"):
                assert state[moment][n].placements == p.placements
            assert tuple(p.shape) == tuple(params[n].shape)
        cache = _leaves(lm.init_cache(2, 16))
        axes = _jax_leaves(jax_cache_axes(cfg, quant=quant))
        assert _leaves(cache_axes(cfg, quant)) == axes
        assert len(cache) == len(axes)
        for leaf, ax in zip(cache, axes):
            want = _placements(theirs.spec(ax, tuple(leaf.shape)),
                               list(AXES))
            assert [str(x) for x in leaf.placements] == want, (ax, leaf.shape)
        with pytest.raises(ValueError, match="partitioned"):
            from repro_torch.serve.batching import ContinuousBatcher
            ContinuousBatcher(lm, n_slots=2, cache_len=16)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- (ii) the train step
@pytest.mark.parametrize("name", list(FAMILIES))
def test_sharded_train_step_matches_jax(runs, name):
    jx, ranks = runs
    want = float(jx[f"{name}/loss"])
    for r, got in ranks.items():
        loss = float(got[f"{name}/loss"])
        assert abs(loss - want) <= 1e-5 * abs(want), (r, loss, want)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_sharded_train_step_updates_match_jax(runs, name):
    """Each leaf's max floored at 1e-4 of the largest, as
    ``tests/test_torch_train.py`` floors it: seamless's key biases take a
    gradient that is 0 but for rounding (a bias on every key of a row
    leaves its softmax as it is), so their update is rounding too."""
    jx, ranks = runs
    want = _jax_params(jx, name, "p1")
    floor = 1e-4 * max(w.abs().max().item() for w in want.values())
    for r, got in ranks.items():
        for n, w in want.items():
            err = (got[f"{name}/p/{n}"] - w).abs().max().item()
            assert err <= 2e-4 * max(w.abs().max().item(), floor), (r, n,
                                                                   err)


def test_grouped_moe_aux_and_drops(runs):
    """The Switch aux term from the global counts within 1e-5 of the JAX
    step's; the partitioned LM's (pairs, dropped, experts routed to) equal
    the unpartitioned LM's, with pairs dropped at capacity factor 1.0."""
    jx, ranks = runs
    want = float(jx["moonshot/aux"])
    for r, got in ranks.items():
        aux = float(got["moonshot/aux"])
        assert abs(aux - want) <= 1e-5 * abs(want), (r, aux, want)
        part, plain = got["moonshot/drops"]
        assert torch.equal(part, plain), (r, part, plain)
        cfg = _cfg("moonshot")
        assert part[0] == cfg.n_layers * B * S * cfg.moe.top_k
        assert part[1] > 0


def test_grouped_moe_matches_expert_parallel(runs):
    """The reference's own limit (``tests/test_distributed.py:192``): the
    grouped MoE and the shard_map MoE on the same (2, 4) mesh within 1e-4
    (capacity factor 8: no pair dropped either way), aux close."""
    _, ranks = runs
    for r, got in ranks.items():
        y, aux, y_ep, aux_ep = got["moe_vs_ep"]
        assert (y - y_ep).abs().max().item() < 1e-4, r
        assert abs(float(aux) - float(aux_ep)) < 0.05, r


# ------------------------------------------------- (iii) the serve step
@pytest.mark.parametrize("name,mode,what", [
    (name, mode, what) for name in FAMILIES for mode in MODES
    for what in ["prefill"] + list(range(STEPS))
    if what == "prefill" or not FAMILIES[name][3].get("kv_cache_quant")])
def test_serve_step_matches_jax(runs, name, mode, what):
    """Logits within 1e-4 of the JAX serve step's (the int8 cache's
    decode steps: :func:`test_int8_decode_step_matches_jax`)."""
    jx, ranks = runs
    want = jx[f"{name}/logits/{what}"]
    for r, got in ranks.items():
        np.testing.assert_allclose(got[f"{name}/{mode}/{what}"].numpy(),
                                   want, rtol=0, atol=1e-4,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("mode", MODES)
def test_serve_caches_are_placed_by_cache_axes(runs, name, mode):
    """Every leaf of the decode cache after the prefill and the steps is
    placed as ``cache_axes`` places it: the int8 scales, the cross pools
    and the recurrent states too."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _, ranks = runs
    cfg = _cfg(name)
    quant = FAMILIES[name][3].get("kv_cache_quant", False)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        mesh = make_test_mesh(SERVE_MESH, AXES, device="cpu")
        plan = Plan(decode_kv_seq_shard=mode == "kv_seq",
                    kv_cache_quant=quant)
        lm = LM(cfg, init_params(cfg, device="cpu"), plan,
                rules=Rules(mesh, plan))
        want = {k: str(v.placements)
                for k, v in _flat(lm.init_cache(B, CACHE)).items()}
    finally:
        dist.destroy_process_group()
    for r, got in ranks.items():
        assert got[f"{name}/{mode}/cache"] == want, r


@pytest.fixture(scope="module")
def int8_plain(runs):
    """The unpartitioned port's int8 decode steps, each from JAX's cache:
    (logits, the cache it writes) a step."""
    jx, _ = runs
    name = "granite-int8"
    lm = LM(_cfg(name), _jax_params(jx, name, "p0"),
            Plan(remat="none", kv_cache_quant=True))
    got = []
    with torch.no_grad():
        for i in range(STEPS):
            logits, cache = lm.decode_step(
                _jax_cache(jx, name, i), torch.from_numpy(
                    jx[f"{name}/steps"][i]), S + i)
            got.append((logits, cache["attn"]))
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("step", range(STEPS))
def test_int8_decode_step_matches_jax(runs, int8_plain, mode, step):
    """Each int8 decode step starts from JAX's cache, as
    ``tests/test_torch_dense_family.py`` holds the int8 cache, and the
    cache it writes (each rank its part, quantized there) is within 1 of
    JAX's.  Where every written value equals JAX's, the logits are within
    1e-4 of JAX's and the scales at 1e-6.  A value one below or above
    JAX's (K/V a last bit apart, rounded on either side of a half) moves
    the later layers' K/V and the logits by a few 1e-4; the unpartitioned
    port, stepped from the same cache, rounds the same values the same
    way, so there the step is held to it: the same int8 values, logits
    within 1e-4, scales at 1e-6."""
    jx, ranks = runs
    name = "granite-int8"
    want = _jax_cache(jx, name, step + 1)["attn"]
    plain_logits, plain_cache = int8_plain[step]
    for r, got in ranks.items():
        written = got[f"{name}/{mode}/written{step}"]
        logits = got[f"{name}/{mode}/{step}"]
        for k in ("k", "v"):
            assert (written[k].int() - want[k].int()).abs().max() <= 1
        if all(torch.equal(written[k], want[k]) for k in ("k", "v")):
            ref_logits = torch.from_numpy(jx[f"{name}/logits/{step}"])
            ref_cache = want
        else:
            for k in ("k", "v"):
                assert torch.equal(written[k], plain_cache[k]), (r, k)
            ref_logits, ref_cache = plain_logits, plain_cache
        torch.testing.assert_close(logits, ref_logits, rtol=0, atol=1e-4)
        for k in ("k_scale", "v_scale"):
            torch.testing.assert_close(written[k], ref_cache[k], rtol=1e-6,
                                       atol=0)


# ------------------------------------------------- (iv) the kernels
def _kernel_calls(got, key, kind):
    return [c[1:] for c in got[key] if c[0] == kind]


def test_vlm_cross_attention_runs_on_each_ranks_heads(runs):
    """(4, 2): 2 of 8 rows and 2 of 4 query heads a rank over 1 of 2 KV
    heads; the cross layer non-causal over the whole 16-token context,
    forward twice a layer (block remat) and the backward once."""
    _, ranks = runs
    cfg = _cfg("vlm")
    d, ctx = cfg.head_dim, cfg.n_img_tokens
    self_attn = ((4, S, d), (2, S, d), 2, True, 0)
    cross = ((4, S, d), (2, ctx, d), 2, False, 0)
    for r, got in ranks.items():
        fwd = _kernel_calls(got, "vlm/train_calls", "flash")
        bwd = _kernel_calls(got, "vlm/train_calls", "flash_bwd")
        assert sorted(fwd) == sorted([self_attn] * 4 + [cross] * 2), fwd
        assert sorted(bwd) == sorted([self_attn] * 2 + [cross]), bwd


def test_audio_encoder_and_cross_attention_run_on_each_ranks_heads(runs):
    """(4, 2): the 2 encoder layers non-causal over the 32 frames, the
    decoder's self (causal) and cross (over the encoder's 32 outputs)
    attention, each on 2 of 4 query heads over 1 of 2 KV heads."""
    _, ranks = runs
    cfg = _cfg("seamless")
    d, f = cfg.head_dim, cfg.n_frames
    enc = ((4, f, d), (2, f, d), 2, False, 0)
    dec = ((4, S, d), (2, S, d), 2, True, 0)
    cross = ((4, S, d), (2, f, d), 2, False, 0)
    for r, got in ranks.items():
        fwd = _kernel_calls(got, "seamless/train_calls", "flash")
        bwd = _kernel_calls(got, "seamless/train_calls", "flash_bwd")
        assert sorted(fwd) == sorted([enc, dec, cross] * 4), fwd
        assert sorted(bwd) == sorted([enc, dec, cross] * 2), bwd


def test_hybrid_local_attention_runs_under_its_window(runs):
    """(4, 2): recurrentgemma's one KV head is whole on "model" (the
    fallback); each rank's 2 of 4 query heads read it, window 64."""
    _, ranks = runs
    cfg = _cfg("recurrentgemma")
    d = cfg.head_dim
    call = ((4, S, d), (2, S, d), 2, True, cfg.window)
    for r, got in ranks.items():
        assert _kernel_calls(got, "recurrentgemma/train_calls",
                             "flash") == [call] * 2
        assert _kernel_calls(got, "recurrentgemma/train_calls",
                             "flash_bwd") == [call]


@pytest.mark.parametrize("mode", MODES)
def test_cross_caches_decode_on_each_ranks_part(runs, mode):
    """(2, 4), 4 rows a rank.  kv_seq: each rank decodes its 16 of 64
    self-attention slots and its 4 of the 16 image tokens over all 4 heads
    with the lse; heads: 1 query head a rank over the one KV head of the 2
    (whole over "model": 2 does not divide by 4) it reads."""
    _, ranks = runs
    cfg = _cfg("vlm")
    d, ctx = cfg.head_dim, cfg.n_img_tokens
    if mode == "kv_seq":
        want = [((4, 4, d), (4, CACHE // 4, 2, d), True),
                ((4, 4, d), (4, ctx // 4, 2, d), True)]
    else:
        want = [((4, 1, d), (4, CACHE, 1, d), False),
                ((4, 1, d), (4, ctx, 1, d), False)]
    per_step = [want[0]] * 2 + [want[1]]            # 2 self, 1 cross
    for r, got in ranks.items():
        assert _kernel_calls(got, f"vlm/{mode}/calls",
                             "decode") == per_step * STEPS


def test_ssm_and_int8_cache_launch_no_attention_kernel(runs):
    """mamba2 has no attention; the int8 cache decodes in plain torch (its
    prefill still runs the flash kernel, one call a layer)."""
    _, ranks = runs
    for r, got in ranks.items():
        for mode in MODES:
            assert not got[f"mamba2/{mode}/calls"]
            calls = got[f"granite-int8/{mode}/calls"]
            assert [c[0] for c in calls] == ["flash"] * 2, calls


# ------------------------------------------------- (vi) the int8 lse
LENS = [(1, 5, 16, 0), (16, 16, 16, 16), (3, 0, 9, 12)]


def _quant_case(lens, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(4, 8, 32, generator=g)
    k, ks = layers.quantize_kv(torch.randn(4, 16, 2, 32, generator=g))
    v, vs = layers.quantize_kv(torch.randn(4, 16, 2, 32, generator=g))
    return q, k, ks, v, vs, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("lens", LENS)
def test_int8_decode_lse_matches_numpy(lens):
    q, k, ks, v, vs, ln = _quant_case(lens)
    lse = torch.empty(4, 8)
    out = layers.decode_quant(q, k, ks, v, vs, ln, lse=lse)
    qn = q.double().numpy()
    kn = (k.double() * ks.double()).numpy()
    for b in range(4):
        for h in range(8):
            if lens[b] == 0:
                assert lse[b, h].item() == np.float32(layers.NEG_INF)
                continue
            s = kn[b, :lens[b], h // 4] @ qn[b, h] / np.sqrt(32)
            want = (np.log(np.exp(s - s.max()).sum()) + s.max()) / np.log(2)
            assert abs(lse[b, h].item() - want) < 1e-5, (b, h)
    np.testing.assert_array_equal(
        out.numpy(), layers.decode_quant(q, k, ks, v, vs, ln).numpy())


@pytest.mark.parametrize("lens", LENS)
def test_int8_decode_halves_merge_into_the_whole(lens):
    """Each half of the 16 slots with its lengths clamped into it, merged
    by its lse as the kv_seq-sharded decode merges them."""
    q, k, ks, v, vs, ln = _quant_case(lens, seed=1)
    outs, lses = [], []
    for r in range(2):
        lse = torch.empty(4, 8)
        part = slice(8 * r, 8 * r + 8)
        outs.append(layers.decode_quant(
            q, k[:, part], ks[:, part], v[:, part], vs[:, part],
            torch.clamp(ln - 8 * r, 0, 8), lse=lse))
        lses.append(lse)
    top = torch.maximum(*lses)
    wts = [torch.exp2(lse - top) for lse in lses]
    got = sum(w[..., None] * o for w, o in zip(wts, outs)) / sum(wts)[..., None]
    whole_lse = torch.empty(4, 8)
    want = layers.decode_quant(q, k, ks, v, vs, ln, lse=whole_lse)
    live = ln > 0
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-6)
    torch.testing.assert_close((top + torch.log2(sum(wts)))[live],
                               whole_lse[live], rtol=0, atol=1e-5)
