"""HPEC tdFIR: time-domain FIR filter bank (paper §III.A: 64 filters,
4096-length vectors, complex data as planar re/im), the port of
``repro.apps.tdfir_app``.

The FIR nest is the paper's function-block offload target: the registry
entry in ``repro_torch.apps.registry`` matches it by name ("tdfir") and by
op-sequence similarity, and supplies the CUDA kernel (FPGA analogue) plus a
grouped-convolution implementation as replacements.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.core.offloadable import LoopNest, OffloadableApp
from repro_torch.kernels import ops

N_FILTERS = 64
N_LEN_FULL = 4096
N_LEN_SMALL = 256
N_TAPS = 128
N_TAPS_SMALL = 16


def make_inputs(seed: int = 0, small: bool = False, device=None):
    n = N_LEN_SMALL if small else N_LEN_FULL
    taps = N_TAPS_SMALL if small else N_TAPS
    f = 8 if small else N_FILTERS
    dev = _device.resolve(device)
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float32).to(dev)

    return {
        "x_re": normal(f, n),
        "x_im": normal(f, n),
        "h_re": normal(f, taps) * 0.1,
        "h_im": normal(f, taps) * 0.1,
    }


def _fir_seq(x, h):
    """FIR bank as the C loop nest: the output-sample loop, each step a dot
    of the [F, K] input window with the reversed taps."""
    n = x.shape[1]
    k = h.shape[1]
    xp = F.pad(x, (k - 1, 0))
    h_rev = h.flip(-1)
    return torch.stack([(xp[:, i:i + k] * h_rev).sum(-1) for i in range(n)],
                       dim=1)


def _complex_fir(fn):
    def run(state):
        rr = fn(state["x_re"], state["h_re"])
        ii = fn(state["x_im"], state["h_im"])
        ri = fn(state["x_re"], state["h_im"])
        ir = fn(state["x_im"], state["h_re"])
        return dict(state, y_re=rr - ii, y_im=ri + ir)
    return run


def _fir_conv(x, h):
    """Vectorized causal FIR: a grouped convolution with the flipped taps."""
    k = h.shape[1]
    xp = F.pad(x, (k - 1, 0))[None]                  # [1, F, N+K-1]
    w = h.flip(-1)[:, None, :]                       # [F, 1, K]
    return F.conv1d(xp, w, groups=x.shape[0])[0]


def _fir_bank_pallas(state):
    """The complex bank on the CUDA kernel, one launch for all four real
    FIRs and their combine."""
    y_re, y_im = ops.tdfir_complex(state["x_re"], state["x_im"],
                                   state["h_re"], state["h_im"],
                                   block_n=max(128, state["h_re"].shape[1]))
    return dict(state, y_re=y_re, y_im=y_im)


def _fir_nest():
    return LoopNest(
        name="tdfir_filter_bank",
        impls={"seq": _complex_fir(_fir_seq),
               "dp": _complex_fir(_fir_conv),
               "tp": _complex_fir(_fir_conv),
               "pallas": _fir_bank_pallas},
        trip_count=2, doc="time-domain FIR: the FB offload target")


def _scale_nest():
    def seq(state):
        rows = range(state["y_re"].shape[0])
        return dict(state,
                    y_re=torch.stack([state["y_re"][i] * 0.5 for i in rows]),
                    y_im=torch.stack([state["y_im"][i] * 0.5 for i in rows]))

    def dp(state):
        return dict(state, y_re=state["y_re"] * 0.5,
                    y_im=state["y_im"] * 0.5)

    return LoopNest(name="scale_output", impls={"seq": seq, "dp": dp,
                                                "tp": dp},
                    trip_count=2, doc="output scaling loop")


def _with_energy(state, acc):
    y_re = state["y_re"]
    row = acc.reshape(1, 1).expand(1, y_re.shape[1])
    return dict(state, out=torch.cat([y_re, state["y_im"], row]))


def _energy_nest():
    def seq(state):
        acc = torch.zeros((), dtype=torch.float32,
                          device=state["y_re"].device)
        for i in range(state["y_re"].shape[0]):
            acc = acc + torch.sum(state["y_re"][i] ** 2
                                  + state["y_im"][i] ** 2)
        return _with_energy(state, acc)

    def dp(state):
        return _with_energy(state, torch.sum(state["y_re"] ** 2
                                             + state["y_im"] ** 2))

    return LoopNest(name="energy_check", impls={"seq": seq, "dp": dp,
                                                "tp": dp},
                    trip_count=2, doc="verification energy sum")


def build_app() -> OffloadableApp:
    return OffloadableApp(
        name="tdFIR",
        nests=[_fir_nest(), _scale_nest(), _energy_nest()],
        make_inputs=make_inputs,
        doc="HPEC time-domain FIR filter bank")
