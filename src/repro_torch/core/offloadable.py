"""Offloadable-application abstraction: named loop nests with per-destination
implementations.

An app is a chain of :class:`LoopNest` stages over a state dict.  Each nest
carries a ``seq`` implementation (the single-core reference path) and
optional destination implementations:

  * ``dp``     — data-parallel / vectorized (many-core-CPU analogue)
  * ``tp``     — model-axis sharded with explicit transfer discipline (GPU
                 analogue)
  * ``pallas`` — hand-written CUDA kernel (FPGA analogue; the key keeps
                 the JAX package's name so choice dicts compare equal)

``parallel_safe=False`` marks nests whose parallel implementations are
*numerically different* from the sequential semantics (loop-carried
dependence parallelized Jacobi-style).  This reproduces the paper's central
many-core hazard: the OpenMP compiler accepts wrong parallelizations without
error, so only the measured result-equality check can reject them — the GA
has to learn which loops are safe.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

State = Dict[str, object]


@dataclass
class LoopNest:
    name: str
    impls: Dict[str, Callable[[State], State]]
    parallel_safe: bool = True
    trip_count: int = 1          # paper's "number of loops" metadata
    doc: str = ""

    def impl(self, key: str) -> Callable[[State], State]:
        return self.impls.get(key, self.impls["seq"])


@dataclass
class OffloadableApp:
    name: str
    nests: List[LoopNest]
    make_inputs: Callable[..., State]        # (seed, small, device) -> state
    output_key: str = "out"
    doc: str = ""

    @property
    def gene_length(self) -> int:
        return len(self.nests)

    def run(self, choice: Dict[str, str], state: State) -> State:
        state = dict(state)
        for nest in self.nests:
            state = nest.impl(choice.get(nest.name, "seq"))(state)
        return state

    def build(self, choice: Dict[str, str]) -> Callable[[State], object]:
        def fn(state: State):
            return self.run(choice, state)[self.output_key]
        return fn

    def reference_fn(self) -> Callable[[State], object]:
        return self.build({})

    def choice_from_genes(self, genes, dest_key: str) -> Dict[str, str]:
        """The choice a gene string makes: each nest whose gene is set and
        that has a ``dest_key`` implementation runs it, the rest ``seq``."""
        choice = {}
        for nest, g in zip(self.nests, genes):
            if g and dest_key in nest.impls:
                choice[nest.name] = dest_key
            else:
                choice[nest.name] = "seq"
        return choice

