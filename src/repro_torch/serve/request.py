"""One generation request: what the router routes and the engine decodes."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class Request:
    """An online generation request.

    ``tokens`` (when given) is the prompt as a ``[prompt_len]`` int array /
    list; the benchmark and the CLI synthesize one when absent.  ``extras``
    carries modality context (``img_embed`` / ``frames``) for vlm / audio
    archs.  ``arrival_s`` is the request's position on the open-loop trace
    timeline (seconds from trace start); the engine admits a request only
    once its arrival tick has passed — that is what makes continuous
    batching beat static batching on staggered traces.
    """
    rid: str
    arch: str
    prompt_len: int
    max_gen: int
    deadline_s: Optional[float] = None      # SLO: max acceptable service time
    arrival_s: float = 0.0
    tokens: Any = None
    extras: Dict[str, Any] = field(default_factory=dict)
    retries: int = 0                        # re-dispatches after a failure

    def __post_init__(self):
        if self.prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1: {self.prompt_len}")
        if self.max_gen < 1:
            raise ValueError(f"max_gen must be >= 1: {self.max_gen}")
