"""Backend registry, the port of ``repro.backends.registry``: derives the
paper's verification order from declared backend metadata instead of a
hardcoded list.

Paper §II.C runs the verifications function-block first, then loops, and
within each method in ascending verification-cost order (many-core CPU, GPU,
FPGA).  The registry reproduces exactly that from each backend's
``verify_time`` and ``methods`` declarations, so registering a new backend
slots it into the order automatically — no planner surgery.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch.backends.base import Backend, METHOD_ORDER


class BackendRegistry:
    def __init__(self, backends: Iterable[Backend] = ()):
        self._backends: List[Backend] = []
        for b in backends:
            self.register(b)

    def register(self, backend: Backend, *, replace: bool = False) -> Backend:
        """Add a backend; ``replace=True`` swaps an existing one by key."""
        existing = {b.key: i for i, b in enumerate(self._backends)}
        if backend.key in existing:
            if not replace:
                raise ValueError(
                    f"backend key {backend.key!r} already registered "
                    f"(pass replace=True to swap it)")
            self._backends[existing[backend.key]] = backend
        else:
            self._backends.append(backend)
        return backend

    def copy(self) -> "BackendRegistry":
        """A shallow copy callers can extend without mutating this one."""
        return BackendRegistry(self._backends)

    def __iter__(self) -> Iterator[Backend]:
        return iter(self._backends)

    def __len__(self) -> int:
        return len(self._backends)

    def get(self, key: str) -> Optional[Backend]:
        return next((b for b in self._backends if b.key == key), None)

    @property
    def by_name(self) -> Dict[str, Backend]:
        return {b.name: b for b in self._backends}

    @property
    def by_analogue(self) -> Dict[str, Backend]:
        return {b.paper_analogue: b for b in self._backends}

    # ---------------------------------------------------------------- order
    def verification_order(self) -> List[Tuple[Backend, str]]:
        """(backend, method) pairs in the order the planner verifies them.

        Methods run in ``METHOD_ORDER`` (FB phase, then loop phase); within a
        phase, backends ascend by ``verify_time`` (stable: registration order
        breaks ties).  For the three built-in backends this reproduces the
        paper's six verifications exactly.
        """
        order: List[Tuple[Backend, str]] = []
        for method in METHOD_ORDER:
            phase = [b for b in self._backends if method in b.methods]
            phase.sort(key=lambda b: b.verify_time)
            order.extend((b, method) for b in phase)
        return order
