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

The mesh is :class:`LocalMesh`, a one-device stand-in with the reference
test's axes ``("data", "model")`` of sizes (1, 1): every input is whole on
it, and the trace runs on the inputs' own device.  A mesh with an axis
past one device raises, naming ROADMAP item 11c: tracing a sharded
candidate needs its inputs placed as DTensors under ``Rules`` (as the
partitioned LM places its parameters) and a per-device trace that costs
the collectives DTensor places.
"""
from __future__ import annotations

from collections import OrderedDict

from torch.utils._pytree import tree_map

from repro_torch.dist.plan import Plan

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
    FPGA one).  On the one-device mesh every input is whole, so the trace
    takes the inputs as they are, on their own device."""
    if cost_runner is None or getattr(cost_runner, "mesh", None) is None:
        return None
    role = getattr(dest, "mesh_role", "")
    if not role or role not in DEST_PLANS:
        return None
    mesh = cost_runner.mesh
    if any(int(s) != 1 for s in mesh.shape.values()):
        raise NotImplementedError(
            f"mesh {dict(mesh.shape)}: sharded verification needs DTensor "
            f"placements of the inputs and a per-device trace with its "
            f"collectives (ROADMAP queue 1 item 11c)")
    ev = cost_runner.measure(fn, inputs)
    if ev.correct:
        ev.info["mesh"] = dict(mesh.shape)
        ev.info["input_axes"] = state_axes(inputs, role)
    return ev

