"""Function-block registry ("DB") for the paper apps, the port of
``repro.apps.registry``.

Paper-faithful: one FB offload target — tdFIR.  The entry carries
per-destination replacements; the CUDA kernel is the FPGA analogue (Intel
OpenCL sample in the paper).  A second entry (attention) takes part in
similarity detection only: as in the JAX package it has no replacement
impls.
"""
from __future__ import annotations

import torch

from repro_torch.apps import tdfir_app
from repro_torch.core.function_blocks import FunctionBlockEntry, REGISTRY


def _tdfir_ref_example():
    return (tdfir_app.make_inputs(seed=0, small=True, device="cpu"),)


def _tdfir_ref_fn(state):
    return tdfir_app._fir_seq(state["x_re"], state["h_re"])


TDFIR_ENTRY = REGISTRY.register(FunctionBlockEntry(
    name="tdfir",
    match_names=("tdfir", "time_domain_fir"),
    ref_fn=_tdfir_ref_fn,
    example_args=_tdfir_ref_example,
    impls={
        "dp": tdfir_app._complex_fir(tdfir_app._fir_conv),
        "tp": tdfir_app._complex_fir(tdfir_app._fir_conv),
        "pallas": tdfir_app._fir_bank_pallas,
    },
    doc="HPEC time-domain FIR bank (paper's single FB target)",
))


def _attn_example():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 32, 16), generator=g, dtype=torch.float32)
    return (q, q, q)


def _attn_ref(q, k, v):
    from repro_torch.kernels import ref
    return ref.mha_ref(q, k, v, causal=True)


ATTENTION_ENTRY = REGISTRY.register(FunctionBlockEntry(
    name="attention",
    match_names=("attention", "mha", "sdpa"),
    ref_fn=_attn_ref,
    example_args=_attn_example,
    impls={},          # the attention kernels come with the LM slice
    doc="softmax(QK^T)V block; no replacement impl in this slice",
))
