"""Planner <-> mesh bridge (paper §II.C meets the mesh), the port of
``repro.dist.bridge``.

The planner's verification environment times candidates unsharded
(:class:`~repro_torch.core.measure.TimedRunner`).  For the destinations
that are *mesh analogues* — "dp" (many-core CPU: data parallel) and "tp"
(GPU: tensor parallel) — this module traces the winning candidate for the
cost runner's mesh and scores the artifact with
:meth:`CompiledCostRunner.measure`, so destination selection can see the
modeled (roofline) cost beside the host time.

This module is the default ``mesh_verify`` hook of the built-in backends
(:func:`repro_torch.backends.base.bridge_mesh_verify`).  A backend
advertises its mesh analogue via ``Backend.mesh_role`` ("data" | "model" |
""); the logical axes of its inputs follow from it (:func:`state_axes`):

  * data role — leading dimension of every input over the batch axes;
  * model role — trailing dimension over the "model" axis.

Both inherit :class:`Rules`' divisibility fallback, so odd shapes
replicate instead of failing to trace.

The mesh is :class:`LocalMesh`, a one-device stand-in with the reference
test's axes ``("data", "model")`` of sizes (1, 1), on which every input is
whole and the trace runs on the inputs' own device; or a ``DeviceMesh``
(ranks or a fake process group: ``torch.testing._internal.distributed.
fake_pg``), on which the inputs become DTensors placed by
``Rules(mesh, DEST_PLANS[role])`` and the candidate is traced as one
device runs it, DTensor's collectives counted and priced
(``core.trace_analysis``).
"""
from __future__ import annotations

from collections import OrderedDict

from torch.utils._pytree import tree_map

from repro_torch.dist.plan import Plan
from repro_torch.dist.sharding import Rules, mesh_axes, tree_shardings

# Plan templates the dp / tp verifications trace under.
DEST_PLANS = {
    "data": Plan(name="verify-dp", remat="none"),
    "model": Plan(name="verify-tp", remat="none"),
}


class LocalMesh:
    """The mesh of one device: axes ``data`` and ``model``, both of size 1
    (``shape`` and ``size`` as a ``jax.sharding.Mesh`` gives them)."""
    size = 1

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict((("data", 1), ("model", 1)))


def state_axes(state, mesh_role: str):
    """Logical-axes pytree for an offloadable app's input state dict."""

    def axes_for(x):
        ndim = getattr(x, "ndim", 0)
        if ndim == 0:
            return ()
        if mesh_role == "data":
            return ("batch",) + (None,) * (ndim - 1)
        return (None,) * (ndim - 1) + ("ff",)      # "ff" -> model axis

    return tree_map(axes_for, state)


def mesh_verify(cost_runner, dest, fn, inputs):
    """Trace ``fn(inputs)`` for ``cost_runner.mesh`` under the destination's
    role and return the roofline Evaluation, or None without a cost runner,
    without a mesh, or when the destination has no mesh analogue (e.g. the
    FPGA one).  On a mesh with an axis past one device the inputs are
    placed by the role's logical axes and the trace is one device's; a
    correct Evaluation's ``info`` holds the mesh, the inputs' logical axes,
    and the FLOPs and collective bytes per device."""
    if cost_runner is None or getattr(cost_runner, "mesh", None) is None:
        return None
    role = getattr(dest, "mesh_role", "")
    if not role or role not in DEST_PLANS:
        return None
    mesh = cost_runner.mesh
    shape = (dict(mesh.shape) if isinstance(mesh, LocalMesh)
             else mesh_axes(mesh))
    axes = state_axes(inputs, role)
    shardings = None
    if any(n > 1 for n in shape.values()):
        shardings = tree_shardings(Rules(mesh, DEST_PLANS[role]), axes,
                                   inputs)
    ev = cost_runner.measure(fn, inputs, shardings=shardings)
    if ev.correct:
        rl = ev.info["roofline"]
        ev.info.update(mesh=shape, input_axes=axes,
                       flops_per_device=rl["flops_per_device"],
                       collective_bytes_per_device=rl[
                           "collective_bytes_per_device"])
    return ev
