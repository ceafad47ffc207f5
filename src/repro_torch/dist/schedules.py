"""Pipeline-parallel schedules: static tick plans for ``pipeline_apply``; a
copy of the JAX package's ``repro.dist.schedules`` (pure Python).  In the
port ``repro_torch.dist.pipeline.pipeline_apply`` runs them over a mesh's
ranks, and the static plan lint (``repro_torch.analysis.plan_lint``)
builds them to judge a plan's pipeline genes.

A :class:`Schedule` turns (stages, ranks, microbatches, virtual stages) into
a :class:`TickPlan` — a static per-tick script that ``pipeline_apply``
executes (the reference inside one ``shard_map``).  Every schedule
computes the *same* function (numerics match ``sequential_apply``
exactly, forward and grad);
they differ in how microbatches stream through the stage ring and therefore
in the pipeline **bubble** (ticks a rank sits idle) and the per-rank
activation **in-flight** count (the memory a production backward pass keeps
live) — exactly the trade the GA searches via ``Plan.pipeline_schedule`` /
``Plan.virtual_stages`` (paper §II.C: schedule choice is a verified gene,
not a hardcode).

The three built-ins:

  * ``gpipe``        — the reference: all m microbatches flood the ring,
    bubble S-1 ticks, in-flight m (every activation held until backward).
  * ``one_f_one_b``  — identical forward tick order (1F1B reorders the
    *backward* relative to the forward; per-rank forward order is
    unchanged), annotated with warmup/steady/cooldown phases and an
    in-flight cap of min(S, m) instead of m: the schedule a memory-bound
    candidate should report to the cost model.
  * ``interleaved``  — V virtual stages per rank (stage s lives on rank
    s mod R as chunk s // R); microbatches recirculate the ring V times, so
    the bubble shrinks to R-1 = S/V - 1 ticks at the cost of V-1 extra
    in-flight chunk activations.

Tick semantics (see ``pipeline_apply``): at tick ``t`` every rank applies
its stage to the value it holds, then ``ppermute``s the result forward.
Rank 0 feeds ``mb[feed_mb]`` (a fresh microbatch), ``buf[feed_buf]`` (a
recirculated chunk output) or zeros (a bubble — drain ticks must not
recompute real data); rank 0 stashes the incoming carry into
``buf[stash_buf]`` when a chunk output wraps around; the last rank's output
is captured into final slot ``capture_out``.  Which virtual chunk a rank
computes at tick ``t`` follows from its entry tick:
``chunk = clip((t - rank) // entry_stride, 0, V-1)``.

The closed-form bubble/in-flight numbers live in
``repro_torch.core.cost_model.pipeline_bubble_fraction`` /
``pipeline_in_flight`` (the planner's side); tests pin them to the tick
plans built here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Tick:
    """One tick of the static plan (-1 = not this tick)."""

    feed_mb: int = -1       # fresh microbatch index fed at rank 0
    feed_buf: int = -1      # recirculation-buffer slot fed at rank 0
    stash_buf: int = -1     # buffer slot rank 0 stashes the incoming carry to
    capture_out: int = -1   # final output slot captured at the last rank
    phase: str = "steady"   # warmup | steady | cooldown (annotation)


@dataclass(frozen=True)
class TickPlan:
    """A fully static schedule for one (S, R, m, V) pipeline problem."""

    schedule: str
    n_stages: int
    n_ranks: int
    virtual_stages: int
    microbatches: int
    ticks: Tuple[Tick, ...]
    entry_stride: int       # pass-start stride (chunk formula, see module doc)
    in_flight: int          # modeled live microbatch activations per rank

    @property
    def total_ticks(self) -> int:
        return len(self.ticks)

    @property
    def busy_ticks(self) -> int:
        """Per-rank ticks doing useful work: V passes over m microbatches."""
        return self.virtual_stages * self.microbatches

    @property
    def bubble_ticks(self) -> int:
        return self.total_ticks - self.busy_ticks

    @property
    def bubble_fraction(self) -> float:
        return self.bubble_ticks / self.total_ticks


def _ring_ticks(m: int, n_ranks: int, v: int) -> Tuple[Tuple[Tick, ...], int]:
    """Static tick script for m microbatches through an n_ranks ring V times.

    Pass c's entries at rank 0 occupy ticks [c*stride, c*stride + m); item
    (j, c) sits at rank r at tick c*stride + j + r, wraps to rank 0 at
    c*stride + j + n_ranks.  stride = max(m, n_ranks) keeps entries
    conflict-free for every m (wrapped items wait in the buffer, fresh
    passes wait for the previous pass's entries to clear).
    """
    stride = max(m, n_ranks)
    total = (v - 1) * stride + m + n_ranks - 1
    feed_mb: Dict[int, int] = {}
    feed_buf: Dict[int, int] = {}
    stash: Dict[int, int] = {}
    capture: Dict[int, int] = {}
    for c in range(v):
        start = c * stride
        for j in range(m):
            if c == 0:
                feed_mb[start + j] = j
            else:
                feed_buf[start + j] = j
            if c < v - 1:
                stash[start + j + n_ranks] = j
            else:
                capture[start + j + n_ranks - 1] = j
    fill, drain = n_ranks - 1, total - (n_ranks - 1)
    ticks = tuple(
        Tick(feed_mb=feed_mb.get(t, -1), feed_buf=feed_buf.get(t, -1),
             stash_buf=stash.get(t, -1), capture_out=capture.get(t, -1),
             phase=("warmup" if t < fill else
                    "cooldown" if t >= drain else "steady"))
        for t in range(total))
    return ticks, stride


class Schedule:
    """Build a :class:`TickPlan`, or ``None`` when the (stages, ranks, m, V)
    problem does not fit this schedule — ``pipeline_apply`` then falls back
    to the sequential reference, the same discipline as ``Rules``: an
    invalid plan must still compute."""

    name: str = "base"

    def build(self, *, n_stages: int, n_ranks: int, microbatches: int,
              virtual_stages: int = 1) -> Optional[TickPlan]:
        raise NotImplementedError


class GPipeSchedule(Schedule):
    name = "gpipe"

    def build(self, *, n_stages, n_ranks, microbatches, virtual_stages=1):
        # virtual_stages is an interleaved-only gene: ignored here
        if n_stages != n_ranks or microbatches < 1:
            return None
        ticks, stride = _ring_ticks(microbatches, n_ranks, 1)
        return TickPlan(schedule=self.name, n_stages=n_stages,
                        n_ranks=n_ranks, virtual_stages=1,
                        microbatches=microbatches, ticks=ticks,
                        entry_stride=stride, in_flight=microbatches)


class OneFOneBSchedule(Schedule):
    """Same forward tick order as GPipe; the backward interleaving caps the
    per-rank in-flight activations at min(S, m) — the number the cost
    model's memory term sees."""

    name = "one_f_one_b"

    def build(self, *, n_stages, n_ranks, microbatches, virtual_stages=1):
        # virtual_stages is an interleaved-only gene: ignored here
        if n_stages != n_ranks or microbatches < 1:
            return None
        ticks, stride = _ring_ticks(microbatches, n_ranks, 1)
        return TickPlan(schedule=self.name, n_stages=n_stages,
                        n_ranks=n_ranks, virtual_stages=1,
                        microbatches=microbatches, ticks=ticks,
                        entry_stride=stride,
                        in_flight=min(n_ranks, microbatches))


class InterleavedSchedule(Schedule):
    """V virtual stages per rank: stage s = chunk s // R on rank s mod R.
    Bubble shrinks to R-1 = S/V - 1 ticks (for m >= R); each rank holds up
    to V-1 extra chunk activations awaiting recirculation."""

    name = "interleaved"

    def build(self, *, n_stages, n_ranks, microbatches, virtual_stages=1):
        v = virtual_stages
        if (v < 1 or microbatches < 1 or n_ranks < 1
                or n_stages != n_ranks * v):
            return None
        ticks, stride = _ring_ticks(microbatches, n_ranks, v)
        in_flight = min(microbatches * v, min(n_ranks, microbatches) + v - 1)
        return TickPlan(schedule=self.name, n_stages=n_stages,
                        n_ranks=n_ranks, virtual_stages=v,
                        microbatches=microbatches, ticks=ticks,
                        entry_stride=stride, in_flight=in_flight)


SCHEDULES: Dict[str, Schedule] = {
    s.name: s for s in (GPipeSchedule(), OneFOneBSchedule(),
                        InterleavedSchedule())
}


def get_schedule(name) -> Optional[Schedule]:
    """Resolve a schedule name (or pass an instance through); None for an
    unknown name — callers treat that as "cannot pipeline" and fall back."""
    if isinstance(name, Schedule):
        return name
    return SCHEDULES.get(name)


def register_schedule(schedule: Schedule, replace: bool = False) -> Schedule:
    if schedule.name in SCHEDULES and not replace:
        raise ValueError(f"schedule {schedule.name!r} already registered")
    SCHEDULES[schedule.name] = schedule
    return schedule
