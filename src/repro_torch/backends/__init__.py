"""Pluggable offload-backend API (paper §II.C as configuration), the port of
``repro.backends``.

  * :mod:`repro_torch.backends.base`     — :class:`Backend`,
    :class:`SearchContext`, :class:`SearchResult`.
  * :mod:`repro_torch.backends.registry` — :class:`BackendRegistry`; its
    ``verification_order()`` derives the paper's six-verification order.
  * :mod:`repro_torch.backends.builtin`  — ``MANY_CORE``, ``GPU``, ``FPGA``,
    ``DEFAULT_REGISTRY``, plus the function-blocks-only ``GPU_LIBRARY``
    example backend (arXiv 2004.09883) and
    ``registry_with_library_backend()``.
  * :mod:`repro_torch.backends.policy`   — :class:`SelectionPolicy` and the
    built-in objectives; ``get_policy`` / ``register_policy``.
"""
from repro_torch.backends.base import (Backend, SearchContext, SearchResult,
                                       METHOD_FUNCTION_BLOCK, METHOD_LOOP,
                                       METHOD_ORDER)
from repro_torch.backends.registry import BackendRegistry
from repro_torch.backends.builtin import (DEFAULT_REGISTRY, FPGA, GPU,
                                          GPU_LIBRARY, MANY_CORE,
                                          default_registry,
                                          registry_with_library_backend)
from repro_torch.backends.policy import (DEFAULT_POLICY, POLICIES,
                                         SelectionPolicy, EdpPolicy,
                                         HostTimePolicy, ModeledPolicy,
                                         PowerPolicy, PriceWeightedPolicy,
                                         get_policy, register_policy)

__all__ = [
    "Backend", "SearchContext", "SearchResult",
    "METHOD_FUNCTION_BLOCK", "METHOD_LOOP", "METHOD_ORDER",
    "BackendRegistry", "DEFAULT_REGISTRY", "default_registry",
    "MANY_CORE", "GPU", "FPGA", "GPU_LIBRARY",
    "registry_with_library_backend",
    "SelectionPolicy", "HostTimePolicy", "ModeledPolicy",
    "PriceWeightedPolicy", "PowerPolicy", "EdpPolicy",
    "POLICIES", "DEFAULT_POLICY", "get_policy", "register_policy",
]
