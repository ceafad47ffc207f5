"""Logical-axis sharding rules: map model-side axis names to mesh axes; the
port of ``repro.dist.sharding``.

The port's parameters, caches and optimizer state carry *logical* axes
(``"embed"``, ``"heads"``, ``"batch"`` ...: ``models.lm.param_axes``,
``cache_axes``, ``train.optimizer.opt_state_axes``).  :class:`Rules` turns
a logical-axes tuple into a :class:`PartitionSpec` for a concrete mesh,
with the reference's two fallbacks (an invalid plan must still compute):

  * divisibility — a dimension is sharded over the largest prefix of its
    assigned mesh axes whose total size divides it (replicated only when
    not even the first axis divides);
  * duplicate axes — a mesh axis already used earlier in the same spec is
    skipped (with ``Plan.decode_kv_seq_shard`` the ``kv_seq`` axis claims
    "model" and ``kv_heads`` falls back to replicated).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``; :class:`Rules`
reads only its axis names and sizes (:func:`mesh_axes`, which also takes
any object with ``axis_names`` and a ``shape`` mapping, as a JAX mesh
has).  :class:`NamedSharding` turns a spec into DTensor placements, one
``Shard(dim)`` or ``Replicate()`` per mesh dimension.  A tuple entry
shards one dimension over several mesh dimensions major to minor, as JAX
does; DTensor shards over mesh dimensions in the mesh's order, so a tuple
whose axes are not in that order has no placement and raises (the
builders of ``launch.mesh`` and ``BASE_RULES`` keep "pod" before "data").

``constrain`` is the identity on a plain tensor (under ``jit`` the
reference's is a layout hint) and a ``redistribute`` on a DTensor.
:class:`NullRules` is the no-mesh identity.

Automatic partitioning (the reference's GSPMD) is DTensor's sharding
propagation: :meth:`Rules.distribute` places a parameter dict by its
logical axes, plain torch ops on DTensors place their collectives, and
``constrain`` pins an activation where the reference constrains one.
DTensor has no sharding rule for a hand-written kernel, so
:meth:`Rules.local` runs a function on each rank's shards
(``torch.distributed.tensor.experimental.local_map``) with placements
from logical axes; :meth:`Rules.offset` and :meth:`Rules.group` tell such
a function where its shard lies and over which group to reduce.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map
from torch.utils._python_dispatch import _disable_current_modes

Axes = Tuple[Optional[str], ...]

# logical axis -> mesh axes.  A tuple value shards one dimension over
# several mesh axes (and stays a tuple inside the PartitionSpec); a string
# value is a single mesh axis.  "batch"/"embed" ride the data-class axes
# (embed sharding over "data" is the FSDP-style parameter shard); the
# model-class axes carry heads / ff / experts / vocab (tensor parallel).
BASE_RULES = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "lru": "model",
    "vocab": "model",
    "experts": "model",
}


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes that carry the batch dimension, in batch order."""
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name
    or a tuple of names (major to minor); a tuple of one name is that name,
    as ``jax.sharding.PartitionSpec`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """A spec on a DeviceMesh: ``placements`` (one per mesh dimension) and
    ``distribute`` (a tensor every rank holds whole -> the DTensor of this
    rank's shard)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> tuple:
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            idx = [names.index(a) for a in
                   ((entry,) if isinstance(entry, str) else entry)]
            if idx != sorted(idx):
                raise ValueError(
                    f"{self.spec}: dimension {dim} is sharded over "
                    f"{entry} major to minor, against the mesh's order "
                    f"{tuple(names)}; DTensor has no such placement")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)

    def distribute(self, tensor) -> DTensor:
        """The DTensor of ``tensor`` (whole, the same on every rank) under
        this sharding: each rank keeps its own shard, with no
        communication.  The shard is a copy (a dim-0 shard or a replicated
        tensor would otherwise be a view of ``tensor``): the whole tensor
        can be freed or written without touching it."""
        whole = tensor.to(self.mesh.device_type)
        out = distribute_tensor(whole, self.mesh, self.placements,
                                src_data_rank=None)
        local = out.to_local()
        if local.untyped_storage()._cdata \
                == whole.untyped_storage()._cdata:
            out = DTensor.from_local(local.clone(), self.mesh,
                                     out.placements, run_check=False,
                                     shape=out.shape, stride=out.stride())
        return out


class Rules:
    """Sharding rules for one (mesh, plan) pair.

    ``exclude_axes`` removes mesh axes from every rule (the reference uses
    it inside a ``shard_map`` whose manual axes the inner rules must not
    name).
    """

    def __init__(self, mesh, plan=None, exclude_axes: Sequence[str] = ()):
        self.mesh = mesh
        self.plan = plan
        self.exclude_axes = tuple(exclude_axes)
        self.shape = mesh_axes(mesh)
        self.rules = dict(BASE_RULES)
        if plan is not None and getattr(plan, "decode_kv_seq_shard", False):
            self.rules["kv_seq"] = "model"

    def _assign(self, logical: Optional[str], dim: Optional[int],
                used: set):
        """Mesh-axis entry for one dimension (None = replicated)."""
        if logical is None:
            return None
        rule = self.rules.get(logical)
        if rule is None:
            return None
        as_tuple = isinstance(rule, tuple)
        candidates = rule if as_tuple else (rule,)
        axes = tuple(a for a in candidates
                     if a in self.shape
                     and a not in self.exclude_axes
                     and a not in used)
        if not axes:
            return None
        if dim is not None:
            # shard over the largest prefix of the remaining axes whose
            # total size divides the dimension
            size, take = 1, 0
            for a in axes:
                if dim % (size * self.shape[a]) != 0:
                    break
                size *= self.shape[a]
                take += 1
            axes = axes[:take]
            if not axes:
                return None                  # replicate: nothing divides
        used.update(axes)
        return axes if as_tuple else axes[0]

    def spec(self, axes: Optional[Sequence[Optional[str]]],
             dims: Optional[Sequence[int]] = None) -> PartitionSpec:
        """PartitionSpec for a logical-axes tuple (trailing Nones trimmed);
        ``dims`` (the concrete shape) enables the divisibility fallback."""
        entries = []
        used: set = set()
        for i, logical in enumerate(tuple(axes or ())):
            dim = None if dims is None else dims[i]
            entries.append(self._assign(logical, dim, used))
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def sharding(self, axes, shape=None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(axes, dims=shape))

    def constrain(self, x, axes):
        """A DTensor redistributed to its logical axes; a plain tensor
        unchanged."""
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh,
                              self.sharding(axes, tuple(x.shape)).placements)

    @property
    def sharded(self) -> bool:
        """Whether a mesh axis the rules may name spans more than one
        device."""
        return any(n > 1 for a, n in self.shape.items()
                   if a not in self.exclude_axes)

    def without(self, axis: str) -> "Rules":
        """The same rules on this rank's slice of the mesh across ``axis``
        (for "pod", its pod's ``mesh["data", "model"]``): what they place
        never names ``axis``, so DTensor issues no collective across it,
        as the reference's inner rules leave the manual "pod" axis of its
        ``shard_map`` alone."""
        rest = tuple(a for a in self.shape if a != axis)
        return Rules(self.mesh[rest], self.plan, self.exclude_axes)

    def place(self, x: torch.Tensor, axes: Axes) -> DTensor:
        """``x`` as the DTensor of its logical axes: a tensor every rank
        holds whole (the same values) keeps this rank's shard, with no
        communication; a DTensor is constrained."""
        if isinstance(x, DTensor):
            return self.constrain(x, axes)
        return self.sharding(axes, tuple(x.shape)).distribute(x)

    def distribute(self, tree, axes_tree):
        """A dict (or list) of whole tensors placed by a logical-axes tree
        of the same structure (``models.lm.param_axes``), through
        :func:`tree_shardings`: each leaf the DTensor of this rank's shard
        (a DTensor leaf is redistributed)."""
        def put(sh, t):
            if isinstance(t, DTensor):
                return t.redistribute(sh.mesh, sh.placements)
            return sh.distribute(t)

        return _zip_map(put, tree_shardings(self, axes_tree, tree), tree)

    def gathered(self, w, axes: Axes):
        """A weight as its product uses it: the ``"embed"`` dimension's
        data-class shard (FSDP-style) gathered, the model-class shards
        kept.  Its gradient is scattered back by the redistribution's
        backward."""
        return self.constrain(w, tuple(None if a == "embed" else a
                                       for a in axes))

    def offset(self, x, dim: int) -> int:
        """The first index of dimension ``dim`` that this rank's shard of
        ``x`` holds (0 for a plain tensor)."""
        if not isinstance(x, DTensor):
            return 0
        # host arithmetic: with no dispatch mode active, so that a trace's
        # fake mode (core.trace_analysis) neither fakes nor records it
        with _disable_current_modes():
            _, start = compute_local_shape_and_global_offset(
                x.shape, x.device_mesh, x.placements)
        return int(start[dim])

    def group(self, x, dim: int):
        """The process group over which dimension ``dim`` of ``x`` is
        sharded: None for a plain tensor or a whole dimension."""
        if not isinstance(x, DTensor):
            return None
        mesh_dims = [i for i, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim % x.dim() == dim]
        if len(mesh_dims) > 1:
            raise NotImplementedError(
                f"dimension {dim} of {tuple(x.shape)} is sharded over "
                f"{len(mesh_dims)} mesh axes; a local reduction takes one")
        return x.device_mesh.get_group(mesh_dims[0]) if mesh_dims else None

    def local(self, fn: Callable, in_axes: Sequence[Axes],
              out_axes: Union[Axes, List[Axes]],
              partial: Sequence[str] = ()) -> Callable:
        """``fn`` run on each rank's shards: its arguments, tensors, are
        constrained to ``in_axes`` and handed over as plain local tensors,
        its outputs (one, of ``out_axes``, or a list of them, ``[]`` for
        none) wrapped as DTensors whose logical axes take the mesh axes the
        inputs gave the same names.  ``partial`` names logical axes whose
        mesh axes (as the inputs split them) the outputs are partial sums
        over: each rank's own part, summed where the output is
        constrained (the experts' outputs of a rank's own experts).
        Autograd flows through: an input that is whole over a mesh axis
        along which another input is split gets a partial gradient there
        (each rank's own part of the sum).  With no DTensor among the
        arguments ``fn`` runs as it is."""
        def run(*args):
            if not any(isinstance(a, DTensor) for a in args):
                return fn(*args)
            placed, learned = [], {}
            for a, axes in zip(args, in_axes):
                spec = tuple(self.spec(axes, tuple(a.shape)))
                for name, entry in zip(axes, spec + (None,) * len(axes)):
                    if name is not None:
                        learned.setdefault(name, entry)
                placed.append(self.place(a, axes))
            in_pl = [a.placements for a in placed]
            split = [any(isinstance(p[i], Shard) for p in in_pl)
                     for i in range(self.mesh.ndim)]
            grad_pl = [tuple(
                Partial() if isinstance(pi, Replicate) and split[i] else pi
                for i, pi in enumerate(p)) for p in in_pl]
            # local_map reads a tuple as one placement list per output
            outs = out_axes if isinstance(out_axes, list) else [out_axes]
            out_pl = tuple(list(self._out_placements(ax, learned, partial))
                           for ax in outs)
            if not isinstance(out_axes, list):
                out_pl = out_pl[0]
            elif not out_pl:
                out_pl = None           # fn returns None, a leaf of its own
            return local_map(
                fn, out_placements=out_pl,
                in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
                device_mesh=self.mesh, redistribute_inputs=True)(*placed)
        return run

    def _out_placements(self, axes: Axes, learned: dict,
                        partial: Sequence[str] = ()) -> tuple:
        entries, used = [], set()
        for name in axes:
            if name in learned:
                entry = learned[name]
                used.update((entry,) if isinstance(entry, str)
                            else entry or ())
            else:
                entry = self._assign(name, None, used)
            entries.append(entry)
        out = list(NamedSharding(self.mesh,
                                 PartitionSpec(*entries)).placements)
        names = list(self.mesh.mesh_dim_names)
        for name in partial:
            entry = learned.get(name)
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                if isinstance(out[names.index(a)], Replicate):
                    out[names.index(a)] = Partial()
        return tuple(out)


class NullRules:
    """No-mesh rules: every operation is the identity / fully replicated."""

    mesh = None
    plan = None
    sharded = False

    def spec(self, axes, dims=None) -> PartitionSpec:
        return PartitionSpec()

    def sharding(self, axes, shape=None):
        return None

    def constrain(self, x, axes):
        return x

    def gathered(self, w, axes):
        return w

    def offset(self, x, dim: int) -> int:
        return 0

    def group(self, x, dim: int):
        return None

    def local(self, fn, in_axes, out_axes, partial=()):
        return fn


def whole(x):
    """A DTensor gathered whole on every rank as a plain tensor (its
    gradient flows back); anything else unchanged."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in b}
    if isinstance(a, list):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def tree_shardings(rules, axes_tree, tree) -> Any:
    """Shardings mirroring ``tree`` (dicts and lists of tensors, arrays or
    anything with a ``shape``) from a logical-axes tree of the same
    structure whose leaves are tuples of logical axis names (``()`` a
    scalar)."""
    if _is_axes_leaf(axes_tree):
        shape = getattr(tree, "shape", None)
        return rules.sharding(axes_tree,
                              None if shape is None else tuple(shape))
    if isinstance(axes_tree, dict):
        if set(axes_tree) != set(tree):
            raise ValueError(f"axes and tree differ: "
                             f"{sorted(set(axes_tree) ^ set(tree))[:5]}")
        return {k: tree_shardings(rules, axes_tree[k], tree[k])
                for k in tree}
    if isinstance(axes_tree, list):
        return [tree_shardings(rules, a, t) for a, t in zip(axes_tree, tree)]
    raise TypeError(f"not a logical-axes tree: {axes_tree!r}")
