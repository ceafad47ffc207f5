"""The pod-parallel step partitioned inside each pod, against the JAX
package on the CPU.

An LM built with ``Rules`` on a ("pod", "data", "model") mesh is
partitioned on its pod's ("data", "model") sub-mesh, and
``make_pod_parallel_train_step`` sums each rank's own shard of the
gradients across pods: the reference's GSPMD inside its ``shard_map`` over
"pod".  Reduced configs in fp32 at B 8, S 16, the JAX ``Model.init``
weights through ``convert``:

(a) granite-3-2b on (pod 2, data 1, model 2) against the reference's own
pod step on 4 forced host devices (``src/repro/train/train_step.py:75``),
plain and compressed.  Plain: the loss within 1e-5 relative and the
updated parameters within 2e-4 of each leaf's max.  Compressed (a whole
zero error feedback handed in, as the reference's own test hands it): the
new error feedback within two int8 steps and the parameters within
``2 lr`` (what one first Adam step can move at most), and on the layer
that holds its stack's largest gradient, where the port's int8 codes are
the reference's, all but a few elements to float noise
(:func:`test_compressed_pod_step_matches_the_reference_pod_step`).  (b) granite on (2, 2, 2), where the reference's pod step
aborts in XLA's SPMD partitioner, against the JAX ``make_train_step`` on
the whole batch.  (c) every family of phase 15 (d)'s ``PART_FAMILIES`` on
(2, 1, 2) against the JAX step: the dense families and the others'
gradients of the whole batch; the grouped MoE routes each pod's rows as
one group, so its reference is the mean of the JAX gradients of each
pod's rows, then one AdamW step (the same limits).  (d) Each parameter's,
each moment's and each error-feedback leaf's placements against the
reference's ``Rules(mesh, plan, exclude_axes=("pod",)).spec``, and a heads,
ff or vocab leaf's local shape half the whole on "model" 2.

The JAX side runs in background processes (the pod step on 4 forced host
devices, and the single-device steps in three, two families each), each
writing its weights first; the port's side in one spawn of 8 gloo ranks: ranks 0-3 hold (a),
ranks 4-7 (c), all 8 (b).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.plan import Plan
from repro_torch.dist.sharding import Rules, whole
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM, param_axes
from repro_torch.train import optimizer, train_step as ts

B, S = 8, 16
LR, EPS = 1e-3, 1e-4       # eps: a first Adam step is g / (|g| + eps)
AXES = ("pod", "data", "model")
PART, FULL = (2, 1, 2), (2, 2, 2)
N_PODS = 2
# name -> (arch, layers kept (None: reduced()'s), train plan fields), as
# tests/test_torch_dist_families.py cuts them
FAMILIES = {
    "moonshot": ("moonshot-v1-16b-a3b", None, dict(moe_capacity_factor=1.0)),
    "mamba2": ("mamba2-1.3b", None, {}),
    "recurrentgemma": ("recurrentgemma-2b", 3, {}),
    "vlm": ("llama-3.2-vision-90b", None, {}),
    "seamless": ("seamless-m4t-medium", None, {}),
    "granite-int8": ("granite-3-2b", None, dict(kv_cache_quant=True)),
}
CONTEXT = {"vlm": "img_embed", "seamless": "frames"}
PER_POD = ("moonshot",)     # routed per pod: held to the pods' mean
# elements of a compressed leaf allowed past float noise (int8 codes that
# land on the other side of a half): 2 + this share of the leaf
FLIP_SHARE = 1e-3


def _cfg(name):
    if name == "granite":
        return get_config("granite-3-2b").reduced()
    arch, n_layers, _ = FAMILIES[name]
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def _inputs(tmp):
    rng = np.random.default_rng(27)
    arrays = {}
    for name in ("granite", *FAMILIES):
        cfg = _cfg(name)
        v = cfg.vocab_size
        arrays[f"{name}/tokens"] = rng.integers(0, v, (B, S)).astype(np.int32)
        arrays[f"{name}/labels"] = rng.integers(0, v, (B, S)).astype(np.int32)
        if name in CONTEXT:
            n = cfg.n_img_tokens if name == "vlm" else cfg.n_frames
            arrays[f"{name}/ctx"] = rng.standard_normal(
                (B, n, cfg.d_model)).astype(np.float32)
    np.savez(tmp / "in.npz", **arrays)


JAX_COMMON = """
import dataclasses, os
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import TrainConfig
from repro.dist.plan import Plan
from repro.models.lm import Model
from repro.train import optimizer, train_step as ts

inp = dict(np.load(TMP + '/in.npz'))
out = {}
tcfg = TrainConfig(lr=LR, warmup_steps=1, eps=EPS)

def flat(tree, pre):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = '/'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                       for k in path)
        out[pre + key] = np.asarray(leaf)

def save(path):
    global out
    np.savez(path + '.part.npz', **out)
    os.replace(path + '.part.npz', path + '.npz')  # whole when it appears
    out = {}

def batch(name, rows=slice(None)):
    got = {'tokens': jnp.asarray(inp[name + '/tokens'][rows]),
           'labels': jnp.asarray(inp[name + '/labels'][rows])}
    if name in CONTEXT:
        got[CONTEXT[name]] = jnp.asarray(inp[name + '/ctx'][rows])
    return got
"""

# the reference's pod step on (pod 2, data 1, model 2), then the whole-batch
# step of granite for (b)
JAX_POD = JAX_COMMON + """
from repro.dist.compat import AxisType, mesh_from_devices, set_mesh
from repro.dist.sharding import Rules
cfg = get_config('granite-3-2b').reduced()
params = jax.jit(Model(cfg).init)(jax.random.PRNGKey(0))
flat(params, 'granite/p0/')
save(TMP + '/jaxpod_p0')
mesh = mesh_from_devices(jax.devices(), PART, AXES,
                         axis_types=(AxisType.Auto,) * 3)
for compress in (0, 1):
    plan = Plan(vocab_chunk=8, grad_compression=bool(compress))
    model = Model(cfg, plan, Rules(mesh, plan))
    opt = optimizer.init(params, tcfg)
    if compress:
        opt['ef'] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                 params)
    step = ts.make_pod_parallel_train_step(model, tcfg, mesh)
    with set_mesh(mesh):
        p1, o1, m = jax.jit(step)(params, opt, batch('granite'),
                                  jnp.int32(0))
    flat(p1, f'pod{compress}/p1/')
    out[f'pod{compress}/loss'] = np.asarray(m['loss'])
    if compress:
        flat(o1['ef'], 'pod1/ef/')
model = Model(cfg, Plan(vocab_chunk=8))
p1, _, m = jax.jit(ts.make_train_step(model, tcfg))(
    params, optimizer.init(params, tcfg), batch('granite'), jnp.int32(0))
flat(p1, 'whole/p1/')
out['whole/loss'] = np.asarray(m['loss'])
# each pod's gradients, whose largest magnitudes give the int8 steps
grad_fn = jax.jit(jax.value_and_grad(ts.make_loss_fn(model), has_aux=True))
per = B // PART[0]
for p in range(PART[0]):
    _, g = grad_fn(params, batch('granite', slice(p * per, (p + 1) * per)))
    flat(g, f'podgrad{p}/')
save(TMP + '/jaxpod')
print('ok')
"""

# every family's weights, then its step: the whole batch's gradients, or
# (PER_POD) the mean of each pod's
JAX_FAMILIES = JAX_COMMON + """
cfgs = {}
for name in ONLY:
    arch, n_layers, tkw = FAMILIES[name]
    cfg = get_config(arch).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = jax.jit(Model(cfg).init)(jax.random.PRNGKey(0))
    flat(params, f'{name}/p0/')
    cfgs[name] = cfg, params
save(OUT + '_p0')
for name in ONLY:
    cfg, params = cfgs[name]
    model = Model(cfg, Plan(vocab_chunk=8, **FAMILIES[name][2]))
    grad_fn = jax.jit(jax.value_and_grad(ts.make_loss_fn(model),
                                         has_aux=True))
    parts = N_PODS if name in PER_POD else 1
    per = B // parts
    gs, ls = [], []
    for p in range(parts):
        (_, m), g = grad_fn(params, batch(name,
                                          slice(p * per, (p + 1) * per)))
        gs.append(g)
        ls.append(m['loss'])
    grads = jax.tree.map(lambda *a: sum(a) / parts, *gs)
    p1, _, _ = optimizer.update(grads, optimizer.init(params, tcfg), params,
                                tcfg)
    flat(p1, f'{name}/p1/')
    out[f'{name}/loss'] = np.asarray(sum(ls) / parts)
save(OUT)
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


def _jax_params(jx, name, prefix):
    return params_from_numpy(_nested(jx, prefix), _cfg(name), device="cpu")


def _wait(tmp, stem, timeout_s=400.0):
    """A JAX process's ``.npz``, once it has written it whole."""
    import os
    import time
    path = f"{tmp}/{stem}.npz"
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"no {path} after {timeout_s} s")
        time.sleep(0.2)
    return dict(np.load(path))


def _batch(inp, name):
    got = {"tokens": torch.from_numpy(inp[f"{name}/tokens"]),
           "labels": torch.from_numpy(inp[f"{name}/labels"])}
    if name in CONTEXT:
        got[CONTEXT[name]] = torch.from_numpy(inp[f"{name}/ctx"])
    return got


def _mesh(ranks, shape):
    """A ("pod", "data", "model") mesh over ``ranks`` (every rank of the
    group builds it; only its members use it)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=AXES)


def _step(name, p0, mesh, tcfg, batch, compress=False, whole_ef=False):
    """One partitioned pod step: (loss, whole parameters, placements and
    local shapes of every parameter, moment and error-feedback leaf, and
    the whole error feedback under ``compress``)."""
    plan = Plan(vocab_chunk=8, grad_compression=compress,
                **(FAMILIES[name][2] if name in FAMILIES else {}))
    lm = LM(_cfg(name), p0, plan, rules=Rules(mesh, plan))
    assert lm.partitioned and lm.rules.mesh.mesh_dim_names == AXES[1:]
    opt = optimizer.init(lm.params(), tcfg)
    if whole_ef:
        opt["ef"] = {n: torch.zeros(p.shape) for n, p in lm.params().items()}
    params, opt, m = ts.make_pod_parallel_train_step(lm, tcfg, mesh)(
        lm.params(), opt, batch, 0)
    got = {"loss": float(m["loss"]),
           "p": {n: whole(p.detach()).clone() for n, p in params.items()},
           "placed": {n: (str(p.placements), tuple(p.to_local().shape))
                      for n, p in params.items()},
           "moments": {n: (opt["m"][n].placements == p.placements
                           and opt["v"][n].placements == p.placements)
                       for n, p in params.items()}}
    if compress:
        ef = opt["ef"]
        got["ef"] = {n: whole(e) for n, e in ef.items()}
        got["ef_placed"] = {n: (str(e.placements), tuple(e.to_local().shape))
                            for n, e in ef.items()}
    return got


def _rank(rank, world, tmp):
    inp = dict(np.load(f"{tmp}/in.npz"))
    tcfg = TrainConfig(lr=LR, warmup_steps=1, eps=EPS)
    part = [_mesh([0, 1, 2, 3], PART), _mesh([4, 5, 6, 7], PART)]
    full = _mesh(list(range(8)), FULL)
    out = {}
    if rank < 4:                    # (a) against the reference's pod step
        jx = _wait(tmp, "jaxpod_p0")
        p0 = _jax_params(jx, "granite", "granite/p0/")
        for compress in (False, True):
            out[f"pod{int(compress)}"] = _step(
                "granite", dict(p0), part[0], tcfg, _batch(inp, "granite"),
                compress=compress, whole_ef=compress)
    else:                           # (c) the other families
        for name in FAMILIES:
            jx = _wait(tmp, _jax_out(name) + "_p0")
            out[name] = _step(name, _jax_params(jx, name, f"{name}/p0/"),
                              part[1], tcfg, _batch(inp, name))
    # (b) all eight ranks
    jx = _wait(tmp, "jaxpod_p0")
    for compress in (False, True):
        out[f"full{int(compress)}"] = _step(
            "granite", _jax_params(jx, "granite", "granite/p0/"), full,
            tcfg, _batch(inp, "granite"), compress=compress)
    torch.save(out, f"{tmp}/rank{rank}.pt")


# the families' JAX processes, each over these (the slowest to start first)
JAX_GROUPS = (("vlm", "seamless"), ("moonshot", "granite-int8"),
              ("mamba2", "recurrentgemma"))


def _jax_out(name) -> str:
    return next(f"jaxfam{i}" for i, g in enumerate(JAX_GROUPS) if name in g)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import os
    import subprocess
    import sys
    from helpers import SRC
    from repro_torch.launch.mesh import run_ranks
    tmp = tmp_path_factory.mktemp("dist_pod_part")
    _inputs(tmp)
    consts = (f"TMP = {str(tmp)!r}\nLR, EPS, B = {LR!r}, {EPS!r}, {B!r}\n"
              f"PART, AXES, N_PODS = {PART!r}, {AXES!r}, {N_PODS!r}\n"
              f"FAMILIES, CONTEXT = {FAMILIES!r}, {CONTEXT!r}\n"
              f"PER_POD = {PER_POD!r}\n")
    prelude = f"import sys\nsys.path.insert(0, {SRC!r})\n"
    forced = ("import os\nos.environ['XLA_FLAGS'] = "
              "'--xla_force_host_platform_device_count=4'\n")
    jobs = [(forced, JAX_POD)] + [
        ("", f"ONLY = {names!r}\nOUT = {f'{tmp}/jaxfam{i}'!r}\n"
         + JAX_FAMILIES) for i, names in enumerate(JAX_GROUPS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", pre + prelude + consts + code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC}) for pre, code in jobs]
    try:
        run_ranks(_rank, 8, str(tmp), backend="gloo")
    finally:
        done = [p.communicate(timeout=420) for p in procs]
    for p, (out, err) in zip(procs, done):
        assert p.returncode == 0, f"{out[-3000:]}\n{err[-3000:]}"
    jx = {}
    for stem in ("jaxpod", *[f"jaxfam{i}" for i in range(len(JAX_GROUPS))]):
        jx.update(np.load(tmp / f"{stem}_p0.npz"))
        jx.update(np.load(tmp / f"{stem}.npz"))
    return jx, {r: torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(8)}


def _floored(want):
    """Each leaf's max, floored at 1e-4 of the largest (as
    ``tests/test_torch_dist_families.py`` floors it: seamless's key biases
    take a gradient that is 0 but for rounding)."""
    top = max(w.abs().max().item() for w in want.values())
    return {n: max(w.abs().max().item(), 1e-4 * top)
            for n, w in want.items()}


def _held(got, want_loss, want, ranks):
    for r in ranks:
        loss = got[r]["loss"]
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (r, loss)
        for n, top in _floored(want).items():
            err = (got[r]["p"][n] - want[n]).abs().max().item()
            assert err <= 2e-4 * top, (r, n, err)


# ------------------------------------------- (a) the reference's pod step
def test_plain_pod_step_matches_the_reference_pod_step(runs):
    jx, ranks = runs
    _held({r: ranks[r]["pod0"] for r in range(4)}, float(jx["pod0/loss"]),
          _jax_params(jx, "granite", "pod0/p1/"), range(4))


def _stack(name: str) -> str:
    """The JAX leaf a granite parameter is a layer of (the reference
    stacks the layers on a leading axis)."""
    return re.sub(r"^blocks\.\d+\.", "blocks.", name)


@pytest.mark.parametrize("what", ["ef", "p"])
def test_compressed_pod_step_matches_the_reference_pod_step(runs, what):
    """The new error feedback (``what="ef"``) and the updated parameters
    (``"p"``) against the reference's compressed pod step, within what one
    int8 step allows.  The reference's leaf is the stack of every layer's,
    so its scale is the stack's; the port's leaf is one layer, whose scale
    is its own (no coarser).  On the layer that holds its stack's largest
    gradient the codes are the reference's: all but a few elements (a code
    rounded the other way) agree to 1e-3 of a step and to 2e-4 of the
    leaf's max.  On every layer each element is within two of the
    reference's steps (each package's residual is within its own step) and
    each parameter within ``2 lr``.  The reference returns the first pod's
    error feedback (its out-spec says replicated; the pods' differ), so
    that pod's ranks are held to it, and the second pod's to its own
    residual: within one step."""
    jx, ranks = runs
    grads = [_jax_params(jx, "granite", f"podgrad{p}/") for p in range(2)]
    want = _jax_params(jx, "granite", f"pod1/{'ef' if what == 'ef' else 'p1'}/")
    tops = _floored(_jax_params(jx, "granite", "pod0/p1/"))
    own = {n: max(g[n].abs().max().item() for g in grads) / 127.0
           for n in want}
    stack = {}
    for n, step in own.items():
        stack[_stack(n)] = max(stack.get(_stack(n), 0.0), step)
    want_loss = float(jx["pod1/loss"])
    for r in range(4):
        got = ranks[r]["pod1"]
        assert abs(got["loss"] - want_loss) <= 1e-5 * abs(want_loss), r
        for n, w in want.items():
            ref = stack[_stack(n)]
            if what == "ef" and r >= 2:          # the second pod's own
                assert got["ef"][n].abs().max().item() <= own[n] * 1.001
                continue
            if what == "ef":
                bound, close = 2 * ref * 1.001, 1e-3 * ref
            else:
                bound, close = 2 * LR * 1.001, 2e-4 * tops[n]
            err = (got[what][n] - w).abs()
            assert err.max().item() <= bound, (r, n, err.max().item(), bound)
            if own[n] >= ref * (1 - 1e-6):       # the stack's largest
                off = int((err > close).sum())
                assert off <= 2 + FLIP_SHARE * w.numel(), (r, n, off)


# ----------------------------------- (b) (2, 2, 2): the whole-batch step
def test_pod_step_on_2x2x2_matches_the_whole_batch_step(runs):
    jx, ranks = runs
    _held({r: ranks[r]["full0"] for r in range(8)}, float(jx["whole/loss"]),
          _jax_params(jx, "granite", "whole/p1/"), range(8))


# ------------------------------------------------- (c) every family
@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_pod_step_matches_jax(runs, name):
    jx, ranks = runs
    _held({r: ranks[r][name] for r in range(4, 8)},
          float(jx[f"{name}/loss"]),
          _jax_params(jx, name, f"{name}/p1/"), range(4, 8))


# ------------------------------------------------- (d) placements
def _placements(spec):
    """The DTensor placements on the ("data", "model") sub-mesh that a JAX
    PartitionSpec asks for."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(AXES[1:])
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[names.index(a)] = Shard(d)
    return str(tuple(out))


@pytest.mark.parametrize("key,shape,ranks", [
    ("pod1", PART, range(4)), ("full1", FULL, range(8)),
    *[(name, PART, range(4, 8)) for name in FAMILIES]])
def test_placements_match_the_reference_specs(runs, key, shape, ranks):
    """Every parameter (and its moments, and under compression its error
    feedback) is placed as the reference's inner rules, which exclude the
    manual "pod" axis, shard it."""
    import types
    from repro.dist.plan import Plan as JaxPlan
    from repro.dist.sharding import Rules as JaxRules
    _, got = runs
    name = key if key in FAMILIES else "granite"
    cfg = _cfg(name)
    theirs = JaxRules(types.SimpleNamespace(
        axis_names=AXES, shape=dict(zip(AXES, shape))), JaxPlan(),
        exclude_axes=("pod",))
    for r in ranks:
        run = got[r][key]
        for n, (placed, local) in run["placed"].items():
            whole_shape = tuple(run["p"][n].shape)
            want = _placements(theirs.spec(param_axes(cfg)[n], whole_shape))
            assert placed == want, (r, n, placed, want)
            assert run["moments"][n], (r, n)
            if "ef_placed" in run:
                assert run["ef_placed"][n] == (placed, local), (r, n)


@pytest.mark.parametrize("key,shape,ranks", [("pod1", PART, range(4)),
                                             ("full1", FULL, range(8))])
def test_each_rank_holds_its_share(runs, key, shape, ranks):
    """Each parameter, its moments and its error feedback hold this rank's
    share of the leaf: the whole's elements over the devices its spec
    splits it across.  On "model" 2 every heads, ff or vocab leaf is
    split there: on (2, 1, 2) each rank holds half of it."""
    import types
    from repro.dist.plan import Plan as JaxPlan
    from repro.dist.sharding import Rules as JaxRules
    _, got = runs
    cfg = _cfg("granite")
    sizes = dict(zip(AXES, shape))
    theirs = JaxRules(types.SimpleNamespace(axis_names=AXES, shape=sizes),
                      JaxPlan(), exclude_axes=("pod",))
    for r in ranks:
        run = got[r][key]
        for n, (_, local) in run["placed"].items():
            axes = param_axes(cfg)[n]
            whole_n = run["p"][n].numel()
            split = int(np.prod([sizes[a] for e in theirs.spec(
                axes, tuple(run["p"][n].shape))
                for a in ((e,) if isinstance(e, str) else e or ())]))
            assert int(np.prod(local)) * split == whole_n, (r, n, local)
            assert tuple(run["ef_placed"][n][1]) == local, (r, n)
            if {"heads", "ff", "vocab"} & set(axes):
                assert split >= 2, (r, n)
                if key == "pod1":
                    assert 2 * int(np.prod(local)) == whole_n, (r, n)
