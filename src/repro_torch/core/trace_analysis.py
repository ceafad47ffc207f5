"""Cost analysis of a traced candidate: the port's counterpart of
``repro.core.hlo_analysis``, and its "compiled artifact".

The JAX package lowers and compiles a candidate and walks the HLO text.
PyTorch runs eagerly, so the port traces the candidate instead: ``fn``
runs once under ``FakeTensorMode`` (shapes and dtypes only: no data, no
launch, no device memory) with a dispatch mode that records every aten op
it reaches.  The recorded ops are the :class:`TracedArtifact`; its
:meth:`~TracedArtifact.as_text` listing stands where ``compiled.as_text()``
stood.

Heuristics (the reference's, restated for eager PyTorch):
  * the matmul family (mm, addmm, bmm, baddbmm, convolution, attention):
    ``torch.utils.flop_counter``'s formulas, priced at the result's dtype
    (bf16 / fp16 products run on the tensor cores);
  * every other op: prod(result shape) FLOPs, a reduction its operand's
    elements; priced at fp32 (PyTorch's elementwise kernels compute half
    types in fp32), fp64 at fp64;
  * bytes: operands plus results of every op that allocates or writes.
    Eager PyTorch does not fuse, so every op boundary crosses HBM (the
    reference's "inside a fusion" rule has nothing to do); a Python loop
    is traced op by op, so trip counts come for free (no while-loop
    multipliers).  Views and aliasing ops count 0;
  * a kernel wrapper of ``repro_torch.kernels.ops`` reached by a fake
    tensor is not launched: it reports its own work from the formula kept
    beside its plan (``kernels.ops.recording_work``), priced at its
    operands' dtype (a bf16 flash at the bf16 peak);
  * collectives: each ``c10d`` / functional-collective op the trace
    reaches (DTensor's redistributions run through them) is counted and
    charged its operand bytes by the recording mode; on one device all are
    0, under the reference's keys (``coll_*``, ``count_*``,
    ``collective_bytes``).

On a mesh (``shardings``: a ``dist.sharding.NamedSharding`` for each input
over a ``DeviceMesh``, as ``dist.bridge`` places a candidate's inputs) the
inputs are DTensors of this rank's fake shards, and the trace is one
device's, as the reference's compiled SPMD program is: DTensor's sharding
propagation places the collectives, each op is recorded at its local
shapes, and the global-shape ops DTensor runs to propagate shapes are left
out.  An op that DTensor cannot shard (it has no strategy, its local op
fails, or a result's local shape is not the one its placements give) is
not hidden: what the failed attempt recorded is dropped, its
plain tensor operands join as replicated values and, where that still
fails, its DTensor operands are gathered whole (counted all-gathers) and
it runs on whole tensors, its results replicated.

:func:`analyze_ops` returns the reference's keys plus the FLOPs by dtype
(``flops_fp32``, ``flops_bf16``, ``flops_fp16``, ``flops_fp64``), which
:func:`repro_torch.core.cost_model.roofline_from_analysis` prices each at
its own peak.

The per-device memory account (:attr:`TracedArtifact.memory`, where the
reference reads XLA's ``memory_analysis()``) follows the fake storages
while the trace runs: the inputs' (local shards') storages at the start,
each storage an op allocates when it does, and its release when the
storage dies (a weakref finalizer: a tensor autograd saves for the
backward keeps its storage, and its bytes, alive).  The peak of the live
bytes, the inputs, the results and the results that are inputs written in
place (the optimizer's updates, a decode cache: the port's counterpart of
donated buffers) give the reference's five keys.
"""
from __future__ import annotations

import contextlib
import functools
import sys
import threading
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch import device as _device
from repro_torch.core.cost_model import FLOPS_KEY_PREFIX, PEAK_FLOPS_BY_DTYPE
from repro_torch.kernels import ops as kernel_ops

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# ops that allocate nothing and move no bytes (factories of uninitialised
# memory, aliases)
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.empty_like.default, _aten._unsafe_view.default,
    _aten.alias.default, _aten.detach.default, _aten.lift_fresh.default,
    _aten.resolve_conj.default, _aten.resolve_neg.default,
}
# ops that overwrite their first operand without reading it
_OVERWRITE = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
              _aten.zero_.default}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "any", "all", "norm", "linalg_vector_norm", "var", "std", "var_mean",
    "std_mean", "logsumexp", "nansum", "count_nonzero", "aminmax",
}
# collective op names (c10d and its functional form) -> reference kind
_COLLECTIVE_OF = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_tensor": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_DTYPE_KEY = {torch.float32: "fp32", torch.bfloat16: "bf16",
              torch.float16: "fp16", torch.float64: "fp64",
              torch.complex128: "fp64"}
_DTYPE_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.float64: "f64",
                torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
                torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
                torch.complex64: "c64", torch.complex128: "c128"}


@dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of an input (the port's
    ``jax.ShapeDtypeStruct``); ``device`` None is the card, as for the
    port's entry points."""
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    device: Optional[torch.device] = None


@dataclass
class TracedOp:
    name: str                  # "aten.mm.default", "kernel.matmul", ...
    flops: float
    bytes: float
    dtype: str                 # the peak its FLOPs are priced at
    inputs: Tuple = ()         # (dtype, shape) of each tensor operand
    outputs: Tuple = ()        # (dtype, shape) of each tensor result
    collective: str = ""       # the reference's kind, for a collective
    wire_bytes: float = 0.0    # a collective's operand bytes

    def line(self, i: int) -> str:
        def shapes(ts):
            return ", ".join(f"{d}[{','.join(map(str, s))}]" for d, s in ts)
        kind = f" {self.collective}" if self.collective else ""
        return (f"%{i} = {self.name}({shapes(self.inputs)}) -> "
                f"({shapes(self.outputs)}){kind}  flops={self.flops:.0f} "
                f"{self.dtype}  bytes={self.bytes:.0f}")


def _dtype_key(dtype: torch.dtype) -> str:
    """The peak a product in this dtype runs at."""
    return _DTYPE_KEY.get(dtype, "fp32")


def _scalar_key(dtype: torch.dtype) -> str:
    """The peak any other op runs at: fp32 math (half types included),
    fp64 for double."""
    return "fp64" if _dtype_key(dtype) == "fp64" else "fp32"


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor holds (a broadcast dim counts once)."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _sig(ts) -> Tuple:
    return tuple((_DTYPE_SHORT.get(t.dtype, str(t.dtype)), tuple(t.shape))
                 for t in ts)


def _tensors(tree, out: Optional[list] = None) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (tuples, lists and
    dicts of them), in order: ``tree_leaves`` without its generality,
    which a trace would pay for on every op."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def op_cost(func, args, kwargs, out) -> Optional[TracedOp]:
    """The cost of one dispatched op, or None for ops that are no work at
    all (size and stride queries, ``prim`` ops)."""
    namespace = func.namespace
    if namespace not in ("aten",) + _COLLECTIVE_NAMESPACES:
        return None
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    name = str(func)
    if namespace != "aten":
        kind = _COLLECTIVE_OF.get(func._opname, "")
        if not kind:                            # wait_tensor, barriers, ...
            return TracedOp(name, 0.0, 0.0, "fp32", _sig(ins), _sig(outs))
        # the reference's rule: operand bytes (the result's when there
        # are none) on the wire, operands plus results through HBM
        moved = sum(_distinct_bytes(t) for t in ins) or \
            sum(_distinct_bytes(t) for t in outs)
        return TracedOp(name, 0.0,
                        float(moved + sum(_distinct_bytes(t) for t in outs)),
                        "fp32", _sig(ins), _sig(outs), collective=kind,
                        wire_bytes=float(moved))
    if (func in _FREE or func.is_view
            or torch.Tag.inplace_view in func.tags):
        return TracedOp(name, 0.0, 0.0, "fp32", _sig(ins), _sig(outs))
    formula = flop_registry.get(func._overloadpacket)
    result_dtype = outs[0].dtype if outs else torch.float32
    if formula is not None:
        flops = float(formula(*args, **kwargs, out_val=out))
        dtype = _dtype_key(result_dtype)
    elif func._opname in _REDUCTIONS and ins:
        flops = float(ins[0].numel())
        dtype = _scalar_key(ins[0].dtype)
    else:
        flops = float(sum(t.numel() for t in outs))
        dtype = _scalar_key(result_dtype)
    read = ins[1:] if func in _OVERWRITE else ins
    nbytes = sum(_distinct_bytes(t) for t in read) + \
        sum(_distinct_bytes(t) for t in outs)
    return TracedOp(name, flops, float(nbytes), dtype, _sig(ins), _sig(outs))


def _propagating() -> bool:
    """Whether DTensor's sharding propagation is running the current op on
    global-shape fake tensors (to learn its output's shape): no device
    runs that op."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        frame = frame.f_back
    return False


def _consistent(x) -> bool:
    """Whether a DTensor's local tensor has the shape its placements give
    this rank (a strategy can get it wrong: then the op is not
    sharded)."""
    if not isinstance(x, DTensor):
        return True
    return _local_shape(tuple(x.shape), x.device_mesh,
                        tuple(x.placements)) == tuple(x._local_tensor.shape)


@functools.lru_cache(maxsize=4096)
def _local_shape(shape: Tuple[int, ...], mesh, placements) -> Tuple[int, ...]:
    """This rank's shard shape of a global ``shape`` under ``placements``:
    host arithmetic, run with no dispatch mode active (neither faked nor
    recorded) and memoised (DTensor computes it slowly, and a trace asks
    for it on every op)."""
    with _disable_current_modes():
        local, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                         placements)
    return tuple(local)


class _Memory:
    """Live bytes of the fake storages one trace holds, and their peak.
    A storage is counted once, from the first tensor seen on it, until it
    dies (module docstring)."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}     # id(storage) -> bytes

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) not yet held; returns the bytes of all of them."""
        total = 0
        for st in _storages(tree):
            key = id(st)
            if key not in self._held:
                self._held[key] = st.nbytes()
                self.live += st.nbytes()
                weakref.finalize(st, self._release, key)
            total += self._held[key]
        self.peak = max(self.peak, self.live)
        return total

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)


def _storages(tree) -> list:
    """The distinct storages of a tree's tensors (a DTensor's local
    shard's)."""
    out, seen = [], set()
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            continue
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            out.append(st)
    return out


def memory_account(memory: _Memory, inputs, outputs,
                   argument_bytes: int) -> Dict[str, int]:
    """The reference's five keys (``src/repro/launch/dryrun.py``): the
    arguments, the results, the results that are arguments written in
    place (``alias_bytes``), and the temporaries the peak held beyond
    them; ``peak_estimate_bytes`` = arguments + results + temporaries -
    aliases."""
    held = {id(st) for st in _storages(inputs)}
    outs = _storages(outputs)
    out_bytes = sum(st.nbytes() for st in outs)
    alias = sum(st.nbytes() for st in outs if id(st) in held)
    temp = max(0, memory.peak - argument_bytes - (out_bytes - alias))
    return {"argument_bytes": argument_bytes, "output_bytes": out_bytes,
            "temp_bytes": temp, "alias_bytes": alias,
            "peak_estimate_bytes": argument_bytes + out_bytes + temp - alias}


class _Recorder(TorchDispatchMode):
    """Records the cost of every op that reaches the dispatcher, the work
    the kernel wrappers report for their fake calls, and the storages the
    ops allocate (:class:`_Memory`).  An op on DTensors is handed to
    DTensor with this mode pushed again, so the local ops it runs are
    recorded (module docstring)."""

    def __init__(self):
        super().__init__()
        self.ops: List[TracedOp] = []
        self.memory = _Memory()
        self._dtensor = False       # inside DTensor's handling of an op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._dtensor:
                return NotImplemented
            return self._on_dtensors(func, args, kwargs)
        if self._dtensor and _propagating():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        rec = op_cost(func, args, kwargs, out)
        if rec is not None:
            self.ops.append(rec)
        self.memory.hold(out)
        return out

    def _on_dtensors(self, func, args, kwargs):
        mesh = next(x.device_mesh for x in tree_leaves((args, kwargs))
                    if isinstance(x, DTensor))
        rep = [Replicate()] * mesh.ndim

        def plain(x):
            return (isinstance(x, torch.Tensor)
                    and not isinstance(x, DTensor) and x.dim() > 0)

        def joined(x):
            return (DTensor.from_local(x, mesh, rep, run_check=False)
                    if plain(x) else x)

        attempts = [lambda x: x]
        if any(map(plain, tree_leaves((args, kwargs)))):
            attempts.append(joined)
        self._dtensor = True
        try:
            with self:
                for wrap in attempts:
                    mark = len(self.ops)
                    try:
                        out = func(*tree_map(wrap, args),
                                   **tree_map(wrap, kwargs))
                        if all(map(_consistent, tree_leaves(out))):
                            return out
                    # DTensor's strategies fail in other ways from one torch
                    # release to the next (IndexError in a convolution's);
                    # a genuine fault raises again in the gathered run
                    except Exception:       # noqa: BLE001
                        pass
                    del self.ops[mark:]         # no device ran that attempt
                return self._gathered(func, args, kwargs, mesh, rep)
        finally:
            self._dtensor = False

    @staticmethod
    def _gathered(func, args, kwargs, mesh, rep):
        """``func`` on every operand gathered whole, its results
        replicated."""
        def gathered(x):
            if isinstance(x, DTensor):
                return x.redistribute(mesh, rep).to_local()
            return x

        out = func(*tree_map(gathered, args), **tree_map(gathered, kwargs))
        return tree_map(lambda t: DTensor.from_local(t, mesh, rep,
                                                     run_check=False)
                        if isinstance(t, torch.Tensor) else t, out)

    def kernel(self, name: str, flops: float, nbytes: float,
               dtype: torch.dtype) -> None:
        self.ops.append(TracedOp(f"kernel.{name}", float(flops),
                                 float(nbytes), _dtype_key(dtype)))

    @property
    def work_sink(self):
        """The kernel wrappers' sink on threads that carry this mode but no
        sink of their own (the autograd engine's, ``kernels.ops``)."""
        return self.kernel


def analyze_ops(ops: Sequence[TracedOp],
                comm_counts: Dict[str, float]) -> Dict[str, float]:
    """Whole-trace cost (per device): the reference's keys plus the FLOPs
    by dtype; ``comm_counts`` (kind -> count) gives the ``count_*``
    keys."""
    flops = 0.0
    nbytes = 0.0
    by_dtype = {d: 0.0 for d in PEAK_FLOPS_BY_DTYPE}
    coll = {k: 0.0 for k in COLLECTIVES}
    for op in ops:
        flops += op.flops
        nbytes += op.bytes
        by_dtype[op.dtype] += op.flops
        if op.collective:
            coll[op.collective] += op.wire_bytes
    counts = {k: float(comm_counts.get(k, 0.0)) for k in COLLECTIVES}
    out = {"flops": flops, "bytes": nbytes}
    out.update({f"coll_{k}": v for k, v in coll.items()})
    out.update({f"count_{k}": v for k, v in counts.items()})
    out["collective_bytes"] = sum(coll.values())
    out.update({FLOPS_KEY_PREFIX + d: v for d, v in by_dtype.items()})
    return out


class TracedArtifact:
    """The ops one trace of a candidate reached: the port's compiled
    artifact.  :meth:`analyze` is the cost walk (memoised per artifact by
    ``search_cache.analyze_artifact``); :meth:`as_text` lists the ops;
    ``memory`` is the per-device memory account (:func:`memory_account`,
    None when not taken)."""

    def __init__(self, ops: List[TracedOp], device: torch.device,
                 comm_counts: Dict[str, float],
                 memory: Optional[Dict[str, int]] = None):
        self.ops = ops
        self.device = device
        self.comm_counts = comm_counts
        self.memory = memory

    def analyze(self) -> Dict[str, float]:
        return analyze_ops(self.ops, self.comm_counts)

    def as_text(self) -> str:
        head = f"// traced on {self.device}: {len(self.ops)} ops"
        return "\n".join([head] + [op.line(i)
                                   for i, op in enumerate(self.ops)])


def _leaf_device(x) -> Optional[torch.device]:
    """The device a tensor or spec leaf is faked on (None for others)."""
    if isinstance(x, torch.Tensor):
        dev = x.device
    elif hasattr(x, "shape") and hasattr(x, "dtype"):
        dev = _device.resolve(getattr(x, "device", None))
    else:
        return None
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _placed(x, sharding):
    """The DTensor of this rank's fake shard of ``x`` (a fake tensor of
    the global shape) under ``sharding`` (a NamedSharding)."""
    placements = tuple(sharding.placements)
    local = _local_shape(tuple(x.shape), sharding.mesh, placements)
    return DTensor.from_local(
        torch.empty(local, dtype=x.dtype, device=x.device),
        sharding.mesh, placements, run_check=False, shape=x.shape,
        stride=x.stride())


def trace(fn: Callable, inputs, shardings=None) -> TracedArtifact:
    """Run ``fn(inputs)`` once on fake tensors and record its ops.

    ``inputs`` is a pytree whose tensor leaves are real tensors or
    :class:`TensorSpec` s (or any object with ``shape`` and ``dtype``);
    either way they become fake tensors on the leaf's own device (a spec
    without one: the card), so no data is read and no device memory is
    touched.  Leaves on more than one device raise ``ValueError``.  A
    real tensor the function closes over becomes fake on first use.
    ``shardings`` (a tree of the same structure whose leaves are
    ``NamedSharding`` s over one ``DeviceMesh``) traces one device of that
    mesh instead: each input is the DTensor of this rank's fake shard, on
    the mesh's device type (module docstring).
    """
    devices = {d for d in map(_leaf_device, tree_leaves(inputs))
               if d is not None}
    if shardings is not None:
        mesh = next(sh.mesh for sh in tree_leaves(
            shardings, is_leaf=lambda x: hasattr(x, "placements")))
        devices = {torch.device(mesh.device_type)}
    if len(devices) > 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}; "
                         f"a trace runs on one")
    dev = devices.pop() if devices else _device.resolve(None)
    # traces on a mesh take turns: DTensor runs each op's shape
    # propagation under whichever fake mode it detects, through one
    # process-wide dispatcher, and torch's own threaded tests serialise
    # that (ShardingPropagator._fake_mode_lock); a trace without a mesh
    # holds nothing that another thread's trace could meet
    with _MESH_TRACES if shardings is not None else contextlib.nullcontext():
        return _trace(fn, inputs, shardings, dev)


# held by each trace on a mesh for its whole run (:func:`trace`)
_MESH_TRACES = threading.Lock()


def _trace(fn, inputs, shardings, dev) -> TracedArtifact:
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    recorder = _Recorder()
    with fake_mode:
        def fake(x):
            if isinstance(x, torch.Tensor):
                return torch.empty_strided(tuple(x.shape), x.stride(),
                                           dtype=x.dtype, device=dev)
            if hasattr(x, "shape") and hasattr(x, "dtype"):
                return torch.empty(tuple(x.shape), dtype=x.dtype, device=dev)
            return x

        fake_inputs = tree_map(fake, inputs)
        if shardings is not None:
            fake_inputs = _zip_placed(fake_inputs, shardings)
        arguments = recorder.memory.hold(fake_inputs)
        with recorder, kernel_ops.recording_work(recorder.kernel):
            out = fn(fake_inputs)
        memory = memory_account(recorder.memory, fake_inputs, out, arguments)
    counts = {k: 0.0 for k in COLLECTIVES}
    for op in recorder.ops:
        if op.collective:
            counts[op.collective] += 1.0
    return TracedArtifact(recorder.ops, dev, counts, memory)


def _zip_placed(tree, shardings):
    """``tree``'s tensor leaves placed by the matching ``shardings`` (a
    subtree whose sharding is None stays whole)."""
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: _zip_placed(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_placed(v, sh) for v, sh in zip(tree,
                                                             shardings))
    if isinstance(tree, torch.Tensor):
        return _placed(tree, shardings)
    return tree


class Traceable:
    """A candidate and its inputs (and, on a mesh, their shardings), not yet
    traced: the port's ``Lowered``.  :meth:`trace` is the expensive step
    (the reference's ``compile``)."""

    def __init__(self, fn: Callable, inputs, shardings=None):
        self.fn = fn
        self.inputs = inputs
        self.shardings = shardings

    def trace(self) -> TracedArtifact:
        return trace(self.fn, self.inputs, self.shardings)
