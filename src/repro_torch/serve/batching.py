"""Continuous batching: slot-based decode over a fixed-shape pool; the port
of ``repro.serve.batching``.

The engine holds one decode cache for ``n_slots`` requests, allocated once
on the model's device in the LM's layout (:func:`repro_torch.models.lm.
init_cache`): K/V tensors ``[L, n_slots, W, KV, Dh]`` (``W`` is
``cache_len``, or the window's ring under a sliding window and in the
hybrid's local attention; int8 K/V with their scales under
``plan.kv_cache_quant``), the recurrent state of the SSM and hybrid
families (conv windows, SSD states, RG-LRU ``h``), and the VLM's and audio
family's cross K/V over each request's context, each with a slot axis
(:func:`repro_torch.models.lm.slot_leaves`).
It advances every slot with **one** batched ``LM.decode_step`` per tick,
each slot at its own position (its own RoPE angle, cache write index and
``cache_len`` into the decode-attention kernel; every state is written in
place) and, under an MoE, routed as a group of its own
(``route_per_row``: the JAX engine ``vmap``s its step over the slots, so no
slot's routing, drops included, depends on another's).  Requests join and
leave at decode-step granularity without ever changing a shape.

Slot-pool invariants (the JAX engine's contract):

  * a slot's cache is replaced wholesale at admission (every leaf of the
    prefilled cache, K/V, cross K/V and recurrent state alike, is copied
    into the slot in place), so stale state or context from a previous
    occupant can never leak; a request's context (``req.extras``: numpy
    or torch, on the host) goes into its prefill batch, and a VLM or audio
    request without one raises there;
  * inactive slots still run the decode step (fixed shapes beat masked
    compute at this scale); their outputs are discarded host-side and their
    cache garbage is overwritten by the next admission;
  * prefill runs at the **exact** prompt length — a padded prefill is
    *not* token-identical to the sequential reference;
  * at most one prefill is interleaved per tick, so admissions never starve
    running decodes.

The decode step is one program, as the JAX engine's ``jit(vmap(step))``
is: on a CUDA device the engine captures ``LM.decode_step`` over the pool
once, at construction, into a CUDA graph
(:class:`repro_torch.kernels.ops.CountedGraph`), with the step's inputs in
static device buffers (tokens ``[n_slots, 1]``, positions ``[n_slots]``).
Each tick copies the host's slot state into them and replays the graph; the
argmax's copy to the host is the tick's one synchronisation.  Capturing
before any admission is safe: its warm-up step writes only into slots that
admission replaces wholesale, and the pool is zeroed after it, so that the
slots left empty carry the same state (a recurrent state evolves in every
slot) as an engine that never captured; an empty slot's zero cross K/V
give uniform attention over zero values, so finite logits.  A failed
capture or replay raises; the engine never runs the step eagerly on the
card.  On the CPU the step runs eagerly (the same dispatch by device as
the kernels').

Time is a virtual tick clock (``tick_s`` per engine tick): arrivals,
TTFT/TPOT and energy all live on one deterministic timeline, independent of
host load.  ``calls`` counts the engine's prefills, decode steps and slot
inserts (a replay is one decode step).
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import CountedGraph
from repro_torch.models.lm import slot_leaves
from repro_torch.obs import get_tracer
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.request import Request

DEFAULT_TICK_S = 0.01


def synth_tokens(rid: str, prompt_len: int, vocab: int) -> np.ndarray:
    """Deterministic synthetic prompt for a request without one (traces,
    benchmarks): seeded from the request id, stable across runs."""
    rng = np.random.RandomState(zlib.crc32(rid.encode()) & 0x7FFFFFFF)
    return rng.randint(0, vocab, size=(prompt_len,)).astype(np.int32)


class ContinuousBatcher:
    """Slot-pool continuous batching over one model replica.

    ``model`` is a :class:`repro_torch.models.lm.LM` (it holds its weights,
    so no ``params`` argument); ``n_slots`` fixes the pool width and
    ``cache_len`` the per-slot KV length (the SSM's state has none).
    ``envelope`` (:class:`repro_torch.power.PowerEnvelope`) prices each
    tick's energy into the metrics; ``eos_id`` stops a request early on
    that token.
    """

    def __init__(self, model, *, n_slots: int, cache_len: int,
                 metrics: Optional[ServeMetrics] = None,
                 envelope=None, eos_id: Optional[int] = None,
                 tick_s: float = DEFAULT_TICK_S):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1: {n_slots}")
        if getattr(model, "partitioned", False):
            raise ValueError(
                "a partitioned LM (rules over a sharded mesh) steps eagerly: "
                "its collectives cannot be captured into the batcher's CUDA "
                "graph; serve it through train_step.make_serve_step")
        self.model = model
        self.cfg = model.cfg
        self.n_slots = int(n_slots)
        self.cache_len = int(cache_len)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.eos_id = eos_id
        self.tick_s = float(tick_s)
        self.energy_model = None
        if envelope is not None:
            from repro_torch.power import EnergyModel
            self.energy_model = EnergyModel(envelope)

        self.calls = {"decode_step": 0, "insert": 0, "prefill": 0}
        self._pool = model.init_cache(self.n_slots, self.cache_len)
        self._graph: Optional[CountedGraph] = None
        if model.device.type == "cuda":
            self._capture_step()

        # host-side slot state (numpy: mutated at tick granularity)
        self._active = np.zeros(self.n_slots, dtype=bool)
        self._pos = np.zeros(self.n_slots, dtype=np.int64)
        self._last_tok = np.zeros(self.n_slots, dtype=np.int64)
        self._remaining = np.zeros(self.n_slots, dtype=np.int64)
        self._slot_req: List[Optional[Request]] = [None] * self.n_slots
        self._ticks = 0
        self._queue: List[Request] = []       # arrived, awaiting a slot
        self._pending: List[Request] = []     # on the trace, not yet arrived
        self._out: Dict[str, List[int]] = {}

    # ------------------------------------------------------------- intake
    @property
    def now_s(self) -> float:
        return self._ticks * self.tick_s

    @property
    def free_slots(self) -> int:
        return int((~self._active).sum())

    @property
    def live(self) -> int:
        return int(self._active.sum())

    @property
    def pool(self):
        """The slot pool's cache in the LM's layout (``{"attn": {"k",
        "v"}}``, with ``"cross"`` beside it for the VLM and audio families,
        ``{"blocks": {"conv", "state"}}`` or ``{"groups": ..., "tail":
        [...]}``; read-only use)."""
        return self._pool

    @property
    def graph(self) -> Optional[CountedGraph]:
        """The captured decode step (None on the CPU, where it runs
        eagerly)."""
        return self._graph

    def submit(self, req: Request):
        if req.arch and req.arch != self.cfg.name:
            raise ValueError(
                f"request {req.rid} wants arch {req.arch!r}, engine serves "
                f"{self.cfg.name!r} (route first)")
        self.metrics.on_submit(req.rid, req.arrival_s, arch=req.arch)
        self._pending.append(req)
        self._pending.sort(key=lambda r: (r.arrival_s, r.rid))

    # ------------------------------------------------------------ prefill
    def _insert(self, cache, slot: int):
        """Copy every leaf of a batch-1 cache into ``slot`` of the pool, in
        place, paired by name; a leaf missing on either side, or of another
        shape, raises."""
        self.calls["insert"] += 1
        src = {name: t.select(axis, 0)
               for name, t, axis in slot_leaves(cache)}
        pool = list(slot_leaves(self._pool))
        if src.keys() != {name for name, _, _ in pool}:
            raise ValueError(f"a prefill cache of leaves {sorted(src)} does "
                             f"not fit the pool's "
                             f"{sorted(name for name, _, _ in pool)}")
        rows = [(name, buf.select(axis, slot)) for name, buf, axis in pool]
        for name, row in rows:
            if row.shape != src[name].shape:
                raise ValueError(f"cache leaf {name}: a slot of the pool is "
                                 f"{tuple(row.shape)}, the prefill's "
                                 f"{tuple(src[name].shape)}")
        for name, row in rows:
            row.copy_(src[name])

    def _admit(self, req: Request, slot: int, t_done: float):
        toks = req.tokens
        if toks is None:
            toks = synth_tokens(req.rid, req.prompt_len,
                                self.cfg.vocab_size)
        toks = np.asarray(toks, dtype=np.int64).reshape(1, -1)
        if toks.shape[1] != req.prompt_len:
            raise ValueError(f"request {req.rid}: tokens length "
                             f"{toks.shape[1]} != prompt_len "
                             f"{req.prompt_len}")
        batch = {"tokens": torch.from_numpy(toks)}
        batch.update(req.extras)
        self.calls["prefill"] += 1
        logits, cache = self.model.prefill(batch, self.cache_len)
        first = int(logits.argmax(dim=-1)[0])

        self._insert(cache, slot)
        self._active[slot] = True
        self._pos[slot] = req.prompt_len
        self._last_tok[slot] = first
        self._remaining[slot] = req.max_gen - 1
        self._slot_req[slot] = req
        self._out[req.rid] = [first]

        self.metrics.on_admit(req.rid, t_done)
        self.metrics.on_token(req.rid, t_done)
        if self._remaining[slot] <= 0 or \
                (self.eos_id is not None and first == self.eos_id):
            self._retire(slot, t_done)

    def _retire(self, slot: int, t: float):
        req = self._slot_req[slot]
        self._active[slot] = False
        self._slot_req[slot] = None
        self._remaining[slot] = 0
        if req is not None:
            self.metrics.on_finish(req.rid, t)

    # ---------------------------------------------------------- the step
    def _capture_step(self):
        """Capture one decode step over the pool into a CUDA graph: the
        step's inputs (tokens and positions, one row each in a [2,
        n_slots] device buffer filled from a pinned host buffer) and its
        logits become static tensors that every replay reuses."""
        dev = self.model.device
        self._host_in = torch.zeros((2, self.n_slots),
                                    dtype=torch.long).pin_memory()
        self._dev_in = torch.zeros((2, self.n_slots), dtype=torch.long,
                                   device=dev)
        toks, poss = self._dev_in[0][:, None], self._dev_in[1]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        # one eager step on the capture stream first: kernel builds and the
        # GEMM workspaces are made there, outside the capture
        with torch.cuda.stream(stream):
            self.model.decode_step(self._pool, toks, poss,
                                   route_per_row=True)
        stream.synchronize()
        graph = CountedGraph()
        with graph.capture(stream):
            self._logits_out, _ = self.model.decode_step(
                self._pool, toks, poss, route_per_row=True)
        torch.cuda.current_stream(dev).wait_stream(stream)
        for _, buf, _ in slot_leaves(self._pool):   # undo the warm-up step
            buf.zero_()
        self._graph = graph

    def _step(self) -> torch.Tensor:
        """One decode step over every slot at the host's tokens and
        positions; the logits [n_slots, V] on the model's device (on the
        card, the graph's static output: valid until the next step)."""
        self.calls["decode_step"] += 1
        if self._graph is None:
            dev = self.model.device
            toks = torch.from_numpy(self._last_tok).to(dev)[:, None]
            poss = torch.from_numpy(self._pos).to(dev)
            return self.model.decode_step(self._pool, toks, poss,
                                          route_per_row=True)[0]
        self._host_in[0].copy_(torch.from_numpy(self._last_tok))
        self._host_in[1].copy_(torch.from_numpy(self._pos))
        self._dev_in.copy_(self._host_in, non_blocking=True)
        self._graph.replay()
        return self._logits_out

    # --------------------------------------------------------------- tick
    def tick(self) -> bool:
        """One engine tick: admit due arrivals (≤1 prefill), advance every
        active slot one decode step, retire finished requests.  Returns
        True while any work remains (live slots, queue, or future
        arrivals)."""
        now = self.now_s
        t_end = now + self.tick_s
        while self._pending and self._pending[0].arrival_s <= now:
            self._queue.append(self._pending.pop(0))

        # one interleaved prefill per tick: admissions must not starve the
        # decode cadence of the requests already running
        if self._queue and self.free_slots:
            slot = int(np.flatnonzero(~self._active)[0])
            self._admit(self._queue.pop(0), slot, t_end)

        live_before = [r.rid for r in self._slot_req if r is not None]
        if self._active.any():
            nxt = self._step().argmax(dim=-1).cpu().numpy()
            for slot in np.flatnonzero(self._active):
                req = self._slot_req[slot]
                tok = int(nxt[slot])
                self._out[req.rid].append(tok)
                self._last_tok[slot] = tok
                self._pos[slot] += 1
                self._remaining[slot] -= 1
                self.metrics.on_token(req.rid, t_end)
                if self._remaining[slot] <= 0 or \
                        (self.eos_id is not None and tok == self.eos_id):
                    self._retire(slot, t_end)

        self._ticks += 1
        joules = 0.0
        if self.energy_model is not None:
            joules = self.energy_model.tick_joules(
                self.tick_s, len(live_before) / self.n_slots)
        self.metrics.charge_tick(joules, live_before)
        # one complete-span per tick on the virtual clock (no-op unless a
        # tracer is enabled): the engine's swim-lane in a trace
        get_tracer().complete_span(
            "tick", now, t_end, cat="engine",
            track=f"engine:{self.cfg.name}", tick=self._ticks - 1,
            live=len(live_before), queued=len(self._queue),
            joules=joules)
        return bool(self._active.any() or self._queue or self._pending)

    # ---------------------------------------------------------------- run
    def run(self, requests: Optional[List[Request]] = None,
            max_ticks: int = 1_000_000) -> Dict[str, np.ndarray]:
        """Drive ticks until every submitted request completes; returns
        ``{rid: generated tokens [max_gen]}`` (greedy decode)."""
        for req in requests or ():
            self.submit(req)
        # fast-forward to the first arrival: an empty engine burning idle
        # ticks until the trace starts is not useful work
        if not self._active.any() and not self._queue and self._pending:
            first = self._pending[0].arrival_s
            if first > self.now_s:
                self._ticks = int(np.ceil(first / self.tick_s - 1e-9))
        for _ in range(max_ticks):
            if not self.tick():
                break
        else:
            raise RuntimeError(f"engine did not drain in {max_ticks} ticks")
        return {rid: np.asarray(toks, dtype=np.int32)
                for rid, toks in self._out.items()}
