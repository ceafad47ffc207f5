"""NAS.BT-style block tridiagonal solver (paper §III.A), the port of
``repro.apps.nasbt``.

Structure follows BT's ADI factorization: RHS stencil computation, then
tridiagonal solves along x, y, z (Thomas algorithm — sequential *along* each
line, parallel *across* lines), a Gauss-Seidel smoother, and the solution
update.

The smoother is the paper's many-core hazard made concrete: its ``dp``/``tp``
implementations parallelize a loop-carried sweep Jacobi-style, which runs
fast but computes a DIFFERENT result — exactly the "OpenMP compiles wrong
parallelizations without error" failure mode.  Only the measured
result-equality check can reject it, so the GA must learn to leave that gene
at 0.  The port keeps the hazard; it is not a bug to fix.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.core.offloadable import LoopNest, OffloadableApp

GRID_FULL = 48
GRID_SMALL = 12


def make_inputs(seed: int = 0, small: bool = False, device=None):
    n = GRID_SMALL if small else GRID_FULL
    dev = _device.resolve(device)
    g = torch.Generator().manual_seed(seed)
    return {"u": torch.randn((n, n, n), generator=g,
                             dtype=torch.float32).to(dev)}


def _stencil_rhs(axis):
    plane_axis = (axis + 1) % 3

    def seq(state):
        u = state["u"]
        planes = []
        for i in range(u.shape[plane_axis]):
            # 1D 3-point stencil applied plane-by-plane (sequential outer
            # loop, like the C triple nest)
            um = torch.roll(u, 1, axis)
            up = torch.roll(u, -1, axis)
            planes.append(0.5 * u.select(plane_axis, i)
                          - 0.25 * um.select(plane_axis, i)
                          - 0.25 * up.select(plane_axis, i))
        rhs = torch.stack(planes).movedim(0, plane_axis)
        return dict(state, **{f"rhs{axis}": rhs})

    def dp(state):
        u = state["u"]
        um = torch.roll(u, 1, axis)
        up = torch.roll(u, -1, axis)
        return dict(state, **{f"rhs{axis}": 0.5 * u - 0.25 * um - 0.25 * up})

    return LoopNest(name=f"compute_rhs_{'xyz'[axis]}",
                    impls={"seq": seq, "dp": dp, "tp": dp},
                    trip_count=3, doc="RHS stencil triple nest")


def _thomas_line(d, rhs):
    """Thomas algorithm for tridiag(-1, d, -1) along the LAST axis."""
    n = rhs.shape[-1]
    zeros = torch.zeros(rhs.shape[:-1], dtype=torch.float32,
                        device=rhs.device)
    cps, dps = [], []
    cp_prev, dp_prev = zeros, zeros
    for i in range(n):
        denom = d - (-1.0) * cp_prev
        cp_prev = -1.0 / denom
        dp_prev = (rhs[..., i] - (-1.0) * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    xs = [zeros] * n
    x_next = zeros
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def _solve_nest(axis):
    diag = 2.5

    def seq(state):
        rhs = state[f"rhs{axis}"].movedim(axis, -1)
        sol = torch.stack([_thomas_line(diag, rhs[i])
                           for i in range(rhs.shape[0])])
        return dict(state, **{f"sol{axis}": sol.movedim(-1, axis)})

    def dp(state):
        rhs = state[f"rhs{axis}"].movedim(axis, -1)
        sol = _thomas_line(diag, rhs)       # vectorized across all lines
        return dict(state, **{f"sol{axis}": sol.movedim(-1, axis)})

    return LoopNest(name=f"{'xyz'[axis]}_solve",
                    impls={"seq": seq, "dp": dp, "tp": dp},
                    trip_count=4,
                    doc="Thomas solve: sequential along line, parallel "
                        "across lines")


def _seidel_nest():
    sweeps = 2

    def seq(state):
        u = state["u"].clone()      # rows are rewritten in place below
        for _ in range(sweeps):
            for i in range(u.shape[0]):
                prev = u[i - 1] if i > 0 else u[0]
                u[i] = 0.5 * u[i] + 0.25 * prev
        return dict(state, u_smooth=u)

    def dp(state):
        # WRONG parallelization: Jacobi instead of Gauss-Seidel — fast,
        # runs fine, different answer (the paper's OpenMP hazard).
        u = state["u"]
        for _ in range(sweeps):
            prev = torch.cat([u[:1], u[:-1]], dim=0)
            u = 0.5 * u + 0.25 * prev
        return dict(state, u_smooth=u)

    return LoopNest(name="seidel_relax", impls={"seq": seq, "dp": dp,
                                                "tp": dp},
                    parallel_safe=False, trip_count=3,
                    doc="Gauss-Seidel sweep (loop-carried!)")


def _update_nest():
    def seq(state):
        out = torch.stack([state["u_smooth"][i] + state["sol0"][i]
                           + state["sol1"][i] + state["sol2"][i]
                           for i in range(state["u"].shape[0])])
        return dict(state, out=out)

    def dp(state):
        return dict(state, out=state["u_smooth"] + state["sol0"]
                    + state["sol1"] + state["sol2"])

    return LoopNest(name="add_update", impls={"seq": seq, "dp": dp,
                                              "tp": dp},
                    trip_count=3, doc="solution update")


def build_app() -> OffloadableApp:
    nests = [
        _stencil_rhs(0), _stencil_rhs(1), _stencil_rhs(2),
        _solve_nest(0), _solve_nest(1), _solve_nest(2),
        _seidel_nest(),
        _update_nest(),
    ]
    return OffloadableApp(name="NAS.BT", nests=nests,
                          make_inputs=make_inputs,
                          doc="block-tridiagonal ADI solver")
