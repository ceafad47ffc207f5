"""The port's explicit-collective training pieces against the JAX package
on the CPU.

(4) ``compressed_psum`` / ``plain_psum`` on 8 gloo ranks against the JAX
``shard_map`` on 8 forced host devices, two steps (the second fed the
first's error feedback).  (5) ``make_pod_parallel_train_step`` on 2, 4 and
8 ranks (pod x data, and pod x data x model: the reference's own pod test's
mesh) with reduced granite in fp32 at B 8, S 16: uncompressed, the loss
within 1e-5 and the updated parameters within 2e-4 of each leaf's max of
the JAX ``make_train_step`` on the whole batch, from the JAX ``Model.init``
weights through ``convert``; compressed, every rank's reduced gradient
within the int8 bound of the pods' mean and the error feedback equal to the
pods' gradients less what they sent (the reference's own compressed pod
test fails on this tree, so this one holds the port to the plain step and
the numerics of ``compressed_psum``).  (7) ``apply_moe_ep`` with reduced
moonshot on a (data 2, model 2) mesh against the JAX ``apply_moe_ep``: y
within 1e-5, ``aux`` (the same per-shard estimator) within 1e-6 and the
gradients of ``(y * ct).sum() + aux`` within 1e-4, every rank holding them
whole.

(5') The pod step with reduced moonshot (capacity factor 1.0, so experts
drop tokens) at B 16: grouped MoE on (pod 2, data 2), partitioned on each
pod's "data" sub-mesh, where each pod routes its whole batch (one group,
which the data ranks do not split), against the JAX loss's gradients on
each pod's rows averaged over pods (gathered whole to compare); and expert-parallel MoE from an LM built with ``Rules``
on (pod 2, data 2, model 2), against the JAX expert-parallel loss (over
``model`` 2) on each (pod, data) shard's rows averaged over the shards: the
loss within 1e-5, the gradients within 1e-4 and the updated parameters
within 2e-4 of each leaf's max. The JAX side runs in one subprocess
(``tests/helpers.py``), the port's in one spawn of 8 ranks over a
``FileStore`` under ``tmp_path``; inputs are seeded numpy.
"""
import types

import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.plan import Plan
from repro_torch.dist.sharding import Rules, whole
from repro_torch.launch.mesh import make_test_mesh, run_ranks
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM
from repro_torch.train import grad_compression, optimizer, train_step as ts

B, S = 8, 16
LR, EPS = 1e-3, 1e-4       # eps: a first Adam step is g / (|g| + eps)
POD_MESHES = [((2, 1), ("pod", "data")), ((2, 2), ("pod", "data")),
              ((2, 2, 2), ("pod", "data", "model"))]
MOE_MESH = ((2, 2), ("data", "model"))
MOE_POD_MESHES = {"gspmd": ((2, 2), ("pod", "data")),
                  "shardmap_ep": ((2, 2, 2), ("pod", "data", "model"))}
MOE_CF = 1.0
MOE_B = 16      # 4 rows a (pod, data) shard: the shard's rows divide again


def _inputs(tmp):
    rng = np.random.default_rng(24)
    vocab = get_config("granite-3-2b").reduced().vocab_size
    d = get_config("moonshot-v1-16b-a3b").reduced().d_model
    mvocab = get_config("moonshot-v1-16b-a3b").reduced().vocab_size
    np.savez(tmp / "in.npz",
             g=(rng.standard_normal((8, 256)) * 0.1).astype(np.float32),
             ef=(rng.standard_normal((8, 256)) * 1e-3).astype(np.float32),
             tokens=rng.integers(0, vocab, (B, S)).astype(np.int32),
             labels=rng.integers(0, vocab, (B, S)).astype(np.int32),
             mtokens=rng.integers(0, mvocab, (MOE_B, S)).astype(np.int32),
             mlabels=rng.integers(0, mvocab, (MOE_B, S)).astype(np.int32),
             x=rng.standard_normal((4, 16, d)).astype(np.float32),
             ct=rng.standard_normal((4, 16, d)).astype(np.float32))


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import TrainConfig
from repro.dist.compat import shard_map
from repro.dist.plan import Plan
from repro.dist.sharding import Rules
from repro.launch.mesh import make_test_mesh
from repro.models import moe
from repro.models.lm import Model
from repro.train import optimizer, train_step as ts
from repro.train.grad_compression import compressed_psum, plain_psum

inp = dict(np.load(TMP + '/in.npz'))
out = {}

def flat(tree, pre):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = '/'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                       for k in path)
        out[pre + key] = np.asarray(leaf)

mesh = make_test_mesh((8,), ('pod',))
def body(g, ef):
    o, e = compressed_psum({'g': g}, {'g': ef}, 'pod')
    return o['g'], e['g'], plain_psum({'g': g}, 'pod')['g']
f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P('pod'), P('pod')),
                      out_specs=(P('pod'),) * 3))
o, e, x = f(inp['g'], inp['ef'])
o2, e2, _ = f(inp['g'], e)
out.update(c_out=o, c_ef=e, c_plain=x, c_out2=o2, c_ef2=e2)

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

mcfg = get_config('moonshot-v1-16b-a3b').reduced()
rules = Rules(make_test_mesh((2, 2), ('data', 'model')), Plan())
mp = moe.init_moe(jax.random.PRNGKey(1), mcfg, jnp.float32)
flat(mp, 'moe/')
ct = jnp.asarray(inp['ct'])
def loss(p, x):
    y, a = moe.apply_moe_ep(p, mcfg, x, rules)
    return (y * ct).sum() + a, (y, a)
(_, (y, a)), g = jax.jit(jax.value_and_grad(
    loss, argnums=(0, 1), has_aux=True))(mp, jnp.asarray(inp['x']))
out.update(moe_y=y, moe_aux=a, moe_gx=g[1])
flat(g[0], 'moe_g/')

# the MoE pod step's reference: the mean of the JAX loss's gradients over
# the rows each routes alone (a pod's under grouped MoE, a (pod, data)
# shard's under expert parallelism), then one AdamW step
mp0 = None
for impl, parts in (('gspmd', 2), ('shardmap_ep', 4)):
    plan = Plan(vocab_chunk=8, moe_capacity_factor=MOE_CF, moe_impl=impl)
    rules = (Rules(make_test_mesh((1, 2), ('data', 'model')), plan)
             if impl == 'shardmap_ep' else None)
    lm = Model(mcfg, plan, rules) if rules else Model(mcfg, plan)
    if mp0 is None:
        mp0 = lm.init(jax.random.PRNGKey(2))
        flat(mp0, 'mp0/')
    grad_fn = jax.jit(jax.value_and_grad(ts.make_loss_fn(lm), has_aux=True))
    per = MOE_B // parts
    gs, ls = [], []
    for i in range(parts):
        rows = slice(i * per, (i + 1) * per)
        (_, m), gi = grad_fn(mp0, {
            'tokens': jnp.asarray(inp['mtokens'][rows]),
            'labels': jnp.asarray(inp['mlabels'][rows])})
        gs.append(gi)
        ls.append(m['loss'])
    grads = jax.tree.map(lambda *a: sum(a) / parts, *gs)
    flat(grads, f'{impl}/grad/')
    out[f'{impl}/loss'] = np.asarray(sum(ls) / parts)
    p1, _, _ = optimizer.update(grads, optimizer.init(mp0, tcfg), mp0, tcfg)
    flat(p1, f'{impl}/p1/')
np.savez(TMP + '/jax.npz', **{k: np.asarray(v) for k, v in out.items()})
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


def _jax_params(jx, prefix, arch="granite-3-2b"):
    cfg = get_config(arch).reduced()
    return params_from_numpy(_nested(jx, prefix), cfg, device="cpu")


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _rank(rank, world, tmp):
    inp = dict(np.load(f"{tmp}/in.npz"))
    jx = dict(np.load(f"{tmp}/jax.npz"))
    out = {}
    # (4) compression at 8 ranks
    pod8 = make_test_mesh((8,), ("pod",), device="cpu").get_group("pod")
    g = {"g": torch.from_numpy(inp["g"][rank])}
    o, e = grad_compression.compressed_psum(
        g, {"g": torch.from_numpy(inp["ef"][rank])}, pod8)
    o2, e2 = grad_compression.compressed_psum(g, e, pod8)
    out.update(c_out=o["g"], c_ef=e["g"], c_out2=o2["g"], c_ef2=e2["g"],
               c_plain=grad_compression.plain_psum(g, pod8)["g"])
    # (5) the pod step
    cfg = get_config("granite-3-2b").reduced()
    tcfg = TrainConfig(lr=LR, warmup_steps=1, eps=EPS)
    batch = {"tokens": torch.from_numpy(inp["tokens"]),
             "labels": torch.from_numpy(inp["labels"])}
    for shape, axes in POD_MESHES:
        mesh = make_test_mesh(shape, axes, device="cpu")
        if mesh.get_coordinate() is None:
            continue
        tag = "x".join(map(str, shape))
        for compress in (False, True):
            plan = Plan(vocab_chunk=8, grad_compression=compress)
            lm = LM(cfg, _jax_params(jx, "p0/"), plan)
            step = ts.make_pod_parallel_train_step(lm, tcfg, mesh)
            grads, ef, _, _ = ts.make_pod_gradients(lm, mesh)(
                lm.params(), grad_compression.init_error_feedback(
                    lm.params()), batch)
            params, opt, m = step(lm.params(), optimizer.init(
                lm.params(), tcfg), batch, 0)
            key = f"{tag}/{int(compress)}"
            out[f"{key}/loss"] = m["loss"]
            out.update({f"{key}/grad/{n}": t for n, t in grads.items()})
            out.update({f"{key}/ef/{n}": t for n, t in ef.items()})
            out.update({f"{key}/p/{n}": p.detach().clone()
                        for n, p in params.items()})
            out.update({f"{key}/stepef/{n}": t
                        for n, t in opt["ef"].items()})
    # (5') the pod step with MoE
    mcfg = get_config("moonshot-v1-16b-a3b").reduced()
    mbatch = {"tokens": torch.from_numpy(inp["mtokens"]),
              "labels": torch.from_numpy(inp["mlabels"])}
    for impl, (shape, axes) in MOE_POD_MESHES.items():
        mesh = make_test_mesh(shape, axes, device="cpu")
        if mesh.get_coordinate() is None:
            continue
        plan = Plan(vocab_chunk=8, moe_capacity_factor=MOE_CF, moe_impl=impl)
        lm = LM(mcfg, _jax_params(jx, "mp0/", mcfg.name), plan,
                rules=Rules(mesh, plan))
        grads, _, loss, _ = ts.make_pod_gradients(lm, mesh)(
            lm.params(), None, mbatch)
        params, _, _ = ts.make_pod_parallel_train_step(lm, tcfg, mesh)(
            lm.params(), optimizer.init(lm.params(), tcfg), mbatch, 0)
        out[f"{impl}/loss"] = loss
        out.update({f"{impl}/grad/{n}": whole(t) for n, t in grads.items()})
        out.update({f"{impl}/p/{n}": whole(p.detach()).clone()
                    for n, p in params.items()})
    # (7) expert-parallel MoE
    mesh = make_test_mesh(*MOE_MESH, device="cpu")
    if mesh.get_coordinate() is not None:
        mcfg = get_config("moonshot-v1-16b-a3b").reduced()
        p = _tensors(_nested(jx, "moe/"))
        leaves = [t.requires_grad_() for part in p.values()
                  for t in (part.values() if isinstance(part, dict)
                            else [part])]
        x = torch.from_numpy(inp["x"]).requires_grad_()
        y, a = moe.apply_moe_ep(p, mcfg, x, rules=Rules(mesh, Plan()))
        grads = torch.autograd.grad(
            (y * torch.from_numpy(inp["ct"])).sum() + a, [x, *leaves])
        out.update(moe_y=y.detach(), moe_aux=a.detach(), moe_gx=grads[0])
        names = [f"{k}/{n}" if isinstance(part, dict) else k
                 for k, part in p.items()
                 for n in (part if isinstance(part, dict) else [None])]
        out.update({f"moe_g/{n}": g for n, g in zip(names, grads[1:])})
    torch.save(out, f"{tmp}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    _inputs(tmp)
    run_multidevice(f"TMP = {str(tmp)!r}\nLR, EPS = {LR!r}, {EPS!r}\n"
                    f"MOE_B, MOE_CF = {MOE_B!r}, {MOE_CF!r}\n" + JAX_SIDE,
                    n_devices=8)
    run_ranks(_rank, 8, str(tmp), backend="gloo")
    jx = dict(np.load(tmp / "jax.npz"))
    return jx, {r: torch.load(tmp / f"rank{r}.pt") for r in range(8)}, \
        dict(np.load(tmp / "in.npz"))


# ------------------------------------------------- (4) compression
@pytest.mark.parametrize("key", ["c_out", "c_ef", "c_plain", "c_out2",
                                 "c_ef2"])
def test_compressed_psum_at_8_ranks_matches_jax(runs, key):
    jx, ranks, _ = runs
    for r in range(8):
        np.testing.assert_allclose(ranks[r][key].numpy(), jx[key][r],
                                   rtol=1e-6, atol=1e-6, err_msg=f"{r}")


# ------------------------------------------------- (5) the pod step
def _tag(shape):
    return "x".join(map(str, shape))


def _in_mesh(shape):
    return range(int(np.prod(shape)))


@pytest.mark.parametrize("mesh_i", range(len(POD_MESHES)))
def test_pod_step_matches_the_whole_batch_step(runs, mesh_i):
    jx, ranks, _ = runs
    shape = POD_MESHES[mesh_i][0]
    want = _jax_params(jx, "p1/")
    key = f"{_tag(shape)}/0"
    for r in _in_mesh(shape):
        got = ranks[r]
        assert abs(float(got[f"{key}/loss"]) - float(jx["loss"])) <= \
            1e-5 * abs(float(jx["loss"]))
        for n, w in want.items():
            err = (got[f"{key}/p/{n}"] - w).abs().max().item()
            assert err <= 2e-4 * w.abs().max().item(), (r, n, err)


@pytest.mark.parametrize("mesh_i", range(len(POD_MESHES)))
def test_pod_step_compressed_is_within_the_int8_bound(runs, mesh_i):
    """Every rank's reduced gradient is within max_p max|g_p| / 127 of the
    pods' mean (each pod's int8 error is at most half its scale, and the
    re-rounding to the largest scale half of that one), summed over pods
    it equals what they sent (their gradients less the new error
    feedback), and the step's parameters are finite."""
    jx, ranks, inp = runs
    shape = POD_MESHES[mesh_i][0]
    cfg = get_config("granite-3-2b").reduced()
    n_pods = shape[0]
    per = B // n_pods
    pods = []
    for p in range(n_pods):
        lm = LM(cfg, _jax_params(jx, "p0/"), Plan(vocab_chunk=8))
        lm.requires_grad_(True)
        total, _ = lm.train_loss({
            "tokens": torch.from_numpy(inp["tokens"][p * per:(p + 1) * per]),
            "labels": torch.from_numpy(inp["labels"][p * per:(p + 1) * per])})
        params = lm.params()
        pods.append(dict(zip(params, torch.autograd.grad(
            total, list(params.values())))))
    key = f"{_tag(shape)}/1"
    ranks_per_pod = int(np.prod(shape[1:]))
    for n in pods[0]:
        mean = sum(g[n] for g in pods) / n_pods
        bound = max(g[n].abs().max().item() for g in pods) / 127.0
        sent = sum(pods[p][n] - ranks[p * ranks_per_pod][f"{key}/ef/{n}"]
                   for p in range(n_pods))
        reduced = ranks[0][f"{key}/grad/{n}"]
        for r in _in_mesh(shape):
            got = ranks[r][f"{key}/grad/{n}"]
            assert (got - mean).abs().max().item() <= bound * 1.001 + 1e-7, n
            assert torch.equal(got, reduced), (r, n)
            assert torch.equal(ranks[r][f"{key}/stepef/{n}"],
                               ranks[r][f"{key}/ef/{n}"]), (r, n)
            assert torch.isfinite(ranks[r][f"{key}/p/{n}"]).all(), (r, n)
        np.testing.assert_allclose(sent.numpy(), (reduced * n_pods).numpy(),
                                   atol=1e-6 * max(bound * 127, 1e-6),
                                   err_msg=n)
    assert float(ranks[0][f"{key}/loss"]) == float(
        ranks[0][f"{_tag(shape)}/0/loss"])


# ------------------------------------------------- (5') the pod step, MoE
@pytest.mark.parametrize("impl", list(MOE_POD_MESHES))
def test_pod_step_with_moe_matches_jax_per_routing_group(runs, impl):
    jx, ranks, _ = runs
    shape = MOE_POD_MESHES[impl][0]
    arch = "moonshot-v1-16b-a3b"
    want_g = _jax_params(jx, f"{impl}/grad/", arch)
    want_p = _jax_params(jx, f"{impl}/p1/", arch)
    want_loss = float(jx[f"{impl}/loss"])
    for r in _in_mesh(shape):
        got = ranks[r]
        assert abs(float(got[f"{impl}/loss"]) - want_loss) <= \
            1e-5 * abs(want_loss), r
        for n, w in want_g.items():
            err = (got[f"{impl}/grad/{n}"] - w).abs().max().item()
            assert err <= 1e-4 * w.abs().max().item(), (r, n, err)
        for n, w in want_p.items():
            err = (got[f"{impl}/p/{n}"] - w).abs().max().item()
            assert err <= 2e-4 * w.abs().max().item(), (r, n, err)


# ------------------------------------------------- (7) expert-parallel MoE
@pytest.mark.parametrize("what,tol", [("moe_y", 1e-5), ("moe_aux", 1e-6),
                                      ("moe_gx", 1e-4), ("moe_g", 1e-4)])
def test_moe_ep_matches_jax(runs, what, tol):
    jx, ranks, _ = runs
    keys = [k for k in jx if k == what or k.startswith(what + "/")]
    assert keys
    for r in _in_mesh(MOE_MESH[0]):
        for k in keys:
            got = ranks[r][k].numpy()
            np.testing.assert_allclose(got, jx[k], rtol=0, atol=tol,
                                       err_msg=f"{k} rank {r}")
    if what == "moe_g":
        assert all(np.abs(jx[k]).sum() > 0 for k in keys)


def test_moe_ep_without_a_mesh_is_one_group():
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu",
                     torch.float32)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want = moe.apply_moe(p, cfg, x, groups=1)
    for rules in (None, Rules(types.SimpleNamespace(
            mesh_dim_names=("data", "model"), shape=(2, 1)))):
        got = moe.apply_moe_ep(p, cfg, x, rules=rules)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
