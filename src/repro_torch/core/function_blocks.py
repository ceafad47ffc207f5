"""Function-block offloading: discovery by name matching + Deckard-style
op-sequence similarity, replacement from a per-destination registry (paper
[41]); the port of ``repro.core.function_blocks``.

The registry is the paper's "DB": each entry names a known algorithmic block
(time-domain FIR, attention) together with destination-optimized
implementations — the FPGA-analogue entries are the CUDA kernels in
``repro_torch.kernels``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core import graph_tools
from repro_torch.core.offloadable import LoopNest, OffloadableApp

SIMILARITY_THRESHOLD = 0.55


@dataclass
class FunctionBlockEntry:
    name: str
    match_names: tuple                     # DB name-matching tokens
    ref_fn: Callable                       # canonical implementation
    example_args: Callable[[], tuple]      # small example inputs for ref_fn
    impls: Dict[str, Callable]             # dest.key -> replacement nest impl
    doc: str = ""

    def fingerprint(self):
        if not hasattr(self, "_fp"):
            self._fp = graph_tools.fn_fingerprint(self.ref_fn,
                                                  *self.example_args())
        return self._fp


class Registry:
    def __init__(self):
        self.entries: List[FunctionBlockEntry] = []

    def register(self, entry: FunctionBlockEntry):
        self.entries.append(entry)
        return entry

    def __iter__(self):
        return iter(self.entries)


REGISTRY = Registry()


@dataclass
class FBMatch:
    nest: LoopNest
    entry: FunctionBlockEntry
    method: str            # "name" | "similarity"
    score: float


def detect(app: OffloadableApp, small_state=None,
           registry: Registry = REGISTRY,
           threshold: float = SIMILARITY_THRESHOLD) -> List[FBMatch]:
    """Find registry blocks inside the app's nests.

    Name matching first (paper's DB name match); nests that don't match by
    name are fingerprinted against every registry entry (Deckard analogue).
    """
    matches: List[FBMatch] = []
    for nest in app.nests:
        by_name = None
        for entry in registry:
            if any(tok in nest.name.lower() for tok in entry.match_names):
                by_name = FBMatch(nest, entry, "name", 1.0)
                break
        if by_name is not None:
            matches.append(by_name)
            continue
        if small_state is None:
            continue
        try:
            fp = graph_tools.fn_fingerprint(nest.impls["seq"], small_state)
        except Exception:
            continue
        best: Optional[FBMatch] = None
        for entry in registry:
            s = graph_tools.similarity(fp, entry.fingerprint())
            if s >= threshold and (best is None or s > best.score):
                best = FBMatch(nest, entry, "similarity", s)
        if best is not None:
            matches.append(best)
    return matches


def apply_matches(app: OffloadableApp, matches: List[FBMatch],
                  dest_key: str) -> Optional[Dict[str, str]]:
    """Choice dict running matched nests on the destination's FB impl.

    Returns None if no matched entry provides an implementation for this
    destination (paper: "no offloadable function block").
    """
    choice: Dict[str, str] = {}
    found = False
    for m in matches:
        impl = m.entry.impls.get(dest_key)
        if impl is None:
            continue
        key = f"fb_{m.entry.name}_{dest_key}"
        m.nest.impls[key] = impl
        choice[m.nest.name] = key
        found = True
    return choice if found else None
