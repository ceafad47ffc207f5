"""Built-in backends, the port of ``repro.backends.builtin``: the paper's
{many-core CPU, GPU, FPGA} mixed destination environment.

Keys, names, prices and verification times are the JAX package's, so choice
dicts and verification orders compare equal between the two packages.  On
the card the ``pallas`` key (the FPGA analogue) runs the hand-written CUDA
kernels; it keeps its name, it does not mean Pallas.

Price ordering follows the paper ("the central price range is the ascending
order of GPU, many core CPU and FPGA") and verification-time ordering too
("many core CPU, GPU and FPGA"); both are declared per backend and consumed
by the registry's derived order + the planner's early-stop logic, not their
absolute values.  Each backend also declares its power envelope
(repro_torch.power): the planner charges every correct record's energy
against it.
"""
from __future__ import annotations

from repro_torch.backends.base import (Backend, METHOD_FUNCTION_BLOCK,
                                       SearchContext, SearchResult)
from repro_torch.backends.registry import BackendRegistry
from repro_torch.power import envelope as power_envelope


def ga_loop_search(backend: Backend, app, ctx: SearchContext) -> SearchResult:
    """Full-GA loop strategy (paper §II.B.1) — many-core CPU / GPU
    analogues."""
    from repro_torch.core import loop_offload
    return loop_offload.ga_search(
        app, backend, ctx.runner, ctx.inputs, ctx.ref_out,
        fixed_choice=ctx.fixed_choice, ga_cfg=ctx.ga_cfg, seed=ctx.seed,
        lint_choice=ctx.lint_choice)


def intensity_loop_search(backend: Backend, app,
                          ctx: SearchContext) -> SearchResult:
    """Narrow-then-measure loop strategy (paper §II.B.3) — FPGA analogue:
    arithmetic-intensity narrowing, <= 4 measured patterns."""
    from repro_torch.core import loop_offload
    return loop_offload.fpga_search(
        app, backend, ctx.runner, ctx.inputs, ctx.ref_out, ctx.small_state,
        fixed_choice=ctx.fixed_choice, penalty_s=ctx.penalty_s,
        lint_choice=ctx.lint_choice)


MANY_CORE = Backend(key="dp", name="xla_dp",
                    paper_analogue="many-core CPU",
                    price=1.2, verify_time=1.0, mesh_role="data",
                    power=power_envelope.MANY_CORE_XEON,
                    search_fn=ga_loop_search)
GPU = Backend(key="tp", name="sharded_tp", paper_analogue="GPU",
              price=1.0, verify_time=1.5, mesh_role="model",
              power=power_envelope.GPU_T4,
              search_fn=ga_loop_search)
FPGA = Backend(key="pallas", name="pallas_kernel",
               paper_analogue="FPGA",
               price=2.0, verify_time=10.0,
               power=power_envelope.FPGA_A10,
               search_fn=intensity_loop_search)

# Function-blocks-only destination of the "offloading to GPU libraries"
# follow-up (arXiv 2004.09883): no loop GA — the verification IS the library
# match, so verify_time sits below the GPU loop analogue's.  search_fn stays
# None: the registry never schedules it for a loop verification, and
# Backend.search raises if someone forces one.  It is not in
# DEFAULT_REGISTRY (the paper's environment has three destinations).
GPU_LIBRARY = Backend(key="fb_gpu_lib", name="gpu_fb_library",
                      paper_analogue="GPU library",
                      price=1.0, verify_time=1.2,
                      methods=(METHOD_FUNCTION_BLOCK,),
                      power=power_envelope.GPU_T4)

DEFAULT_REGISTRY = BackendRegistry([MANY_CORE, GPU, FPGA])

def default_registry() -> BackendRegistry:
    return DEFAULT_REGISTRY


def registry_with_library_backend() -> BackendRegistry:
    """Example registration: the paper's three destinations plus the
    function-blocks-only GPU library backend (a fourth FB verification and
    no new loop verification)."""
    reg = DEFAULT_REGISTRY.copy()
    reg.register(GPU_LIBRARY)
    return reg
