"""The serving window: requests from a traffic mix into the port's
``ContinuousBatcher`` over its ``LM``, on the wall clock.

Open loop (``"loop": "open"``): each request is submitted once its due
time has passed on the schedule, whatever the engine is doing.  Closed
loop (``"loop": "closed"``): ``clients`` callers each submit their next
request as soon as the last one finishes.  The schedule runs from the
start of the lead-in; the measured window starts at the first tick after
``lead_in_s`` and ends with the last tick that started within
``--seconds``.  Set-up ends with one prefill of the mix's longest
prompt, so that a kernel the first prefill would build is built there
and not in the lead-in.  A traced run profiles the window's last
``trace_s`` seconds, so that the slowdown of the host under the profiler
reaches no request due before them, and times each admission and each
decode step before them with CUDA events on the device (the profiler
slows the host's eager launches and a replayed graph).  After the window
the schedule runs on until every request due in it has its first token
(open loop, at most ``WAIT_S`` seconds).

The engine is the port's, subclassed only to stamp wall times, to open
the harness's ranges (``portbench.admit`` around an admission: prefill and
slot insert; ``portbench.tick`` around each tick; a decode step is the
rest of a tick) and to record, for a sample of the requests submitted in
the window (``max_requests`` of them: the first whose output is the mix's
longest, and others each taken with probability 1/2 by a draw from the
seed), the logits that produced each served token: the
prefill's last row and each replayed step's row.  The run waits (at most
``WAIT_S``) until those have finished; then the program's state is freed
and the reference judges them (:mod:`portbench.judge`).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from portbench import judge, traffic, weights
from portbench.harness import Run, model_config

WAIT_S = 60.0   # the longest wait after the window for due first tokens

class Clock:
    """The engine's metrics hooks, stamped on the wall clock: each
    request's token times, its finish, and the order of finishes."""

    def __init__(self):
        self.tokens: Dict[str, List[float]] = {}
        self.finish: Dict[str, float] = {}
        self.finished: List[str] = []

    def on_submit(self, rid, t, arch=None):
        self.tokens[rid] = []

    def on_admit(self, rid, t):
        pass

    def on_token(self, rid, t, n=1):
        self.tokens[rid].append(time.perf_counter())

    def on_finish(self, rid, t):
        self.finish[rid] = time.perf_counter()
        self.finished.append(rid)

    def charge_tick(self, joules, rids):
        pass


def engine_class(base):
    class BenchBatcher(base):
        """The port's batcher, recording the start of each admission, the
        lengths each decode step is handed, the logits of the requests in
        ``rows``, and while ``timing`` each admission and step between two
        CUDA events in ``timed``, in the order they ran."""

        def _timer(self):
            if not self.timing:
                return None
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
            events[0].record()
            return events

        def _admit(self, req, slot, t_done):
            self.admit_start[req.rid] = time.perf_counter()
            self.admitting = (req.rid, slot)
            events = self._timer()
            with record_function("portbench.admit"):
                super()._admit(req, slot, t_done)
            if events:
                events[1].record()
                self.timed.append(("admit", req.prompt_len, events))

        def _step(self):
            events = self._timer()
            logits = super()._step()
            pos, active = self._pos.copy(), self._active.copy()
            if events:
                events[1].record()
                self.timed.append(("step", (pos, active), events))
            self.step_log.append((time.perf_counter(), pos, active))
            for slot, rid in list(self.watched.items()):
                if self._active[slot] and \
                        self._slot_req[slot].rid == rid:
                    self.rows[rid].append(logits[slot, :self.vocab].clone())
                else:
                    del self.watched[slot]
            return logits

    return BenchBatcher


def record_prefill(lm, eng) -> None:
    """The LM's prefill, wrapped on this instance to keep the last row of
    logits of a recorded request."""
    prefill = lm.prefill

    def recorded(batch, cache_len):
        logits, cache = prefill(batch, cache_len)
        rid, slot = eng.admitting
        if rid in eng.rows:
            eng.rows[rid].append(logits[0, :eng.vocab].clone())
            eng.watched[slot] = rid
        return logits, cache

    lm.prefill = recorded


def run(run: Run) -> Run:
    from repro_torch.dist.plan import Plan
    from repro_torch.models.lm import LM
    from repro_torch.serve.batching import ContinuousBatcher
    from repro_torch.serve.request import Request

    cfg, mix, dev = run.cfg, run.mix, run.device
    lm = LM(model_config(cfg), weights.draw(cfg, run.seed, dev), Plan())
    clock = Clock()
    eng = engine_class(ContinuousBatcher)(
        lm, n_slots=mix["n_slots"], cache_len=mix["cache_len"],
        metrics=clock)
    eng.admit_start, eng.step_log, eng.timed, eng.timing = {}, [], [], False
    eng.rows, eng.watched, eng.vocab = {}, {}, cfg["vocab_size"]
    stream = traffic.Stream(mix, run.seed, cfg["vocab_size"])
    warm = torch.zeros((1, stream.longest_prompt), dtype=torch.int64)
    lm.prefill({"tokens": warm}, mix["cache_len"])
    del warm
    record_prefill(lm, eng)
    pick = np.random.default_rng(weights.sub_seed(run.seed, 4))
    sample_n = mix["check"]["max_requests"]
    recording = False
    longest = stream.longest_output
    got_longest = False
    reqs: Dict[str, dict] = {}
    ticks: List[tuple] = []     # (start, end, queued) of each tick
    nxt = 0
    is_open = mix["loop"] == "open"

    def submit(due: float):
        nonlocal nxt, got_longest
        d = stream.request(nxt)
        rid = str(nxt)
        reqs[rid] = {"due": due, "prompt_len": d.prompt_len,
                     "max_gen": d.max_gen, "tokens": d.tokens}
        if recording and d.max_gen == longest and not got_longest:
            eng.rows[rid] = []
            got_longest = True
        elif recording and len(eng.rows) < sample_n - (not got_longest) \
                and pick.random() < 0.5:
            eng.rows[rid] = []
        eng.submit(Request(rid=rid, arch=lm.cfg.name,
                           prompt_len=d.prompt_len, max_gen=d.max_gen,
                           tokens=d.tokens, arrival_s=eng.now_s))
        nxt += 1

    sched0 = time.perf_counter()
    if not is_open:
        for _ in range(mix["clients"]):
            submit(sched0)
    seen = 0

    def feed(now: float):
        nonlocal seen
        if is_open:
            while sched0 + stream.due(nxt) <= now:
                submit(sched0 + stream.due(nxt))
        else:
            while seen < len(clock.finished):
                submit(clock.finish[clock.finished[seen]])
                seen += 1

    def tick():
        t = time.perf_counter()
        with record_function("portbench.tick"):
            eng.tick()
        ticks.append((t, time.perf_counter(), len(eng._queue)))

    def busy() -> bool:
        return bool(eng._active.any() or eng._queue or eng._pending)

    def serve_until(stop) -> None:
        while True:
            now = time.perf_counter()
            if stop(now):
                return
            feed(now)
            if busy():
                tick()
            elif is_open:
                time.sleep(max(0.0, min(sched0 + stream.due(nxt) - now,
                                        1e-3)))
            else:
                raise RuntimeError("a closed loop ran out of work")

    lead_end = sched0 + mix["lead_in_s"]
    serve_until(lambda now: now >= lead_end)
    w0 = time.perf_counter()
    run.setup_s = w0 - run.t_process
    recording = True
    w1 = w0 + run.seconds
    n_ticks0 = len(ticks)
    if run.trace:
        eng.timing = dev.type == "cuda"
        from portbench.trace import Session
        trace_start = w1 - min(run.seconds, run.trace_s)
        serve_until(lambda now: now >= trace_start)
        session = Session(dev)
        n_steps0 = len(eng.step_log)
        eng.timing = False
        session.start()
        serve_until(lambda now: now >= w1)
        run.traced = session.stop()
        run.traced_steps = eng.step_log[n_steps0:]
        run.traced_host = (session.t0, session.t1)
    serve_until(lambda now: now >= w1)
    w_end = ticks[-1][1] if len(ticks) > n_ticks0 else w1
    wait_end = w_end + WAIT_S

    def waited(now):
        """Every request due in the window has its first token (open
        loop) and every recorded one has finished, or the wait is over."""
        firsts = not is_open or all(
            clock.tokens[r] for r, q in reqs.items() if w0 <= q["due"] < w1)
        return now >= wait_end or (firsts and all(
            r in clock.finish for r in eng.rows))
    serve_until(waited)
    run.after_window()
    stop = time.perf_counter()

    run.window = (w0, w_end)
    run.ticks = ticks[n_ticks0:]
    run.timed_steps = [(ev[0].elapsed_time(ev[1]), *what)
                       for kind, what, ev in eng.timed if kind == "step"]
    run.timed_admits = [(ev[0].elapsed_time(ev[1]), n)
                        for kind, n, ev in eng.timed if kind == "admit"]
    run.timed_span_ms = (eng.timed[0][2][0].elapsed_time(eng.timed[-1][2][1])
                         if eng.timed else 0.0)
    for rid, q in reqs.items():
        q["times"] = clock.tokens.get(rid, [])
        q["admit"] = eng.admit_start.get(rid)
        q["finish"] = clock.finish.get(rid)
        q["served"] = eng._out.get(rid, [])
    run.requests = reqs
    run.stop = stop
    due = [q for q in reqs.values() if w0 <= q["due"] < w1]
    if not is_open:
        due = [q for q in reqs.values()
               if q["times"] and w0 <= q["times"][0] <= w_end]
    run.attempted = len(due)
    run.failed = sum(1 for q in due if not q["times"])

    done = []
    for rid, rows in eng.rows.items():
        if rid in clock.finish:
            reqs[rid]["logits"] = torch.stack(rows)
            done.append((rid, reqs[rid]))
    del eng, lm, clock
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    run.checks = judge.serving(run, done)
    run.check_s = time.perf_counter() - t
    return run

