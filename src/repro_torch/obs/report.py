"""Post-mortem report over a JSONL trace: ``python -m repro_torch.obs.report``.

Reads the event log a :class:`repro_torch.obs.Tracer` archived (``to_jsonl``)
and renders the operator's four questions as text tables:

  * **routing refusals** — why were requests refused, and what verdict did
    each endpoint get per routing decision (lint-pruned / cold-lookup /
    quarantined / draining / scored)?
  * **verification times per backend** — the paper's order-derivation
    table: each destination's verification cost, cache-hit rate,
    correctness and energy, from the ``plan/verify`` spans;
  * **health timeline** — every quarantine / probe / recovery transition
    with the observation that triggered it (``health/transition`` events);
  * **trends** — cache hit-rate and joules-per-request over the run,
    quartered on the ``loop/tick`` events' cumulative counters.

Usage::

    python -m repro_torch.obs.report events.jsonl [--section all]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

from repro_torch.obs.export import read_jsonl, text_summary


def _spans(records, cat: str, name: str) -> List[dict]:
    return [r for r in records if r.get("type") == "span"
            and r.get("cat") == cat and r.get("name") == name]


def _events(records, cat: str, name: str) -> List[dict]:
    return [r for r in records if r.get("type") == "event"
            and r.get("cat") == cat and r.get("name") == name]


# ----------------------------------------------------------- section: route
def refusal_report(records) -> str:
    routes = _spans(records, "serve", "route")
    if not routes:
        return "routing: no route spans in this trace"
    refused: Dict[str, int] = {}
    verdicts: Dict[str, Dict[str, int]] = {}
    accepted = 0
    for r in routes:
        attrs = r.get("attrs") or {}
        reason = attrs.get("reason", "")
        if reason == "ok":
            accepted += 1
        else:
            refused[reason] = refused.get(reason, 0) + 1
        for ex in attrs.get("explain") or ():
            per = verdicts.setdefault(ex.get("endpoint", "?"), {})
            v = ex.get("verdict", "?")
            per[v] = per.get(v, 0) + 1
    lines = [f"routing: {len(routes)} decisions, {accepted} accepted, "
             f"{len(routes) - accepted} refused"]
    if refused:
        lines.append("  refusals by reason:")
        for reason, n in sorted(refused.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {reason:<28} {n:>6}")
    if verdicts:
        lines.append("  per-endpoint verdicts (endpoint: verdict xN):")
        for ep, per in sorted(verdicts.items()):
            parts = ", ".join(f"{v} x{n}" for v, n in
                              sorted(per.items(), key=lambda kv: -kv[1]))
            lines.append(f"    {ep:<16} {parts}")
    return "\n".join(lines)


# ---------------------------------------------------------- section: verify
def verification_report(records) -> str:
    """Per-backend verification-time table (the paper's §II.C order is
    derived from exactly these measured verification costs)."""
    verifies = _spans(records, "plan", "verify")
    if not verifies:
        return "verification: no plan/verify spans in this trace"
    rows: Dict[str, dict] = {}
    for sp in verifies:
        a = sp.get("attrs") or {}
        b = a.get("backend", "?")
        row = rows.setdefault(b, {"n": 0, "verify_s": 0.0, "compile_s": 0.0,
                                  "hits": 0, "correct": 0, "energy": [],
                                  "best": []})
        row["n"] += 1
        row["verify_s"] += max(sp["t1"] - sp["t0"], 0.0)
        row["compile_s"] += float(a.get("compile_s") or 0.0)
        row["hits"] += bool(a.get("cache_hit"))
        row["correct"] += bool(a.get("correct"))
        if a.get("energy_j") is not None:
            row["energy"].append(float(a["energy_j"]))
        if a.get("best_time_s") is not None:
            row["best"].append(float(a["best_time_s"]))
    lines = ["verification times per backend (order mirrors the paper's "
             "cheapest-first derivation):",
             f"  {'backend':<14}{'n':>4}{'verify_s':>10}{'compile_s':>11}"
             f"{'hit%':>6}{'ok%':>6}{'best_s':>10}{'energy_j':>10}"]
    for b, row in sorted(rows.items(), key=lambda kv: kv[1]["verify_s"]):
        mean_best = (sum(row["best"]) / len(row["best"])
                     if row["best"] else None)
        mean_e = (sum(row["energy"]) / len(row["energy"])
                  if row["energy"] else None)
        lines.append(
            f"  {b:<14}{row['n']:>4}{row['verify_s']:>10.4f}"
            f"{row['compile_s']:>11.4f}"
            f"{100.0 * row['hits'] / row['n']:>6.0f}"
            f"{100.0 * row['correct'] / row['n']:>6.0f}"
            f"{mean_best if mean_best is not None else float('nan'):>10.4g}"
            f"{mean_e if mean_e is not None else float('nan'):>10.4g}")
    return "\n".join(lines)


# ---------------------------------------------------------- section: health
def health_report(records) -> str:
    transitions = _events(records, "health", "transition")
    if not transitions:
        return "health: no transitions in this trace"
    lines = [f"health timeline ({len(transitions)} transitions):"]
    for ev in sorted(transitions, key=lambda e: (e["t"], e["id"])):
        a = ev.get("attrs") or {}
        obs = a.get("observed") or {}
        obs_s = ", ".join(f"{k}={v}" for k, v in sorted(obs.items()))
        lines.append(
            f"  t={ev['t']:<10.4g} {a.get('endpoint', '?'):<12} "
            f"{a.get('from', '?'):>11} -> {a.get('to', '?'):<11} "
            f"[{a.get('reason', '')}]" + (f" ({obs_s})" if obs_s else ""))
    return "\n".join(lines)


# ---------------------------------------------------------- section: trends
def _quarter(ticks: List[dict], frac: float) -> dict:
    return (ticks[min(int(frac * len(ticks)), len(ticks) - 1)]
            .get("attrs") or {})


def trends_report(records) -> str:
    ticks = sorted(_events(records, "loop", "tick"),
                   key=lambda e: (e["t"], e["id"]))
    if len(ticks) < 2:
        return "trends: no loop/tick events in this trace"
    lines = ["trends over the run (cumulative counters, quartered):",
             f"  {'quarter':<9}{'tick':>7}{'lookup hit%':>13}"
             f"{'J/request':>11}{'draw_w':>9}"]
    prev = {"lookups": 0.0, "lookup_hits": 0.0, "energy_j": 0.0,
            "completed": 0.0}
    for qi, frac in enumerate((0.25, 0.5, 0.75, 1.0)):
        a = _quarter(ticks, frac if frac < 1.0 else 0.999999)
        d_lk = float(a.get("lookups") or 0) - prev["lookups"]
        d_h = float(a.get("lookup_hits") or 0) - prev["lookup_hits"]
        d_e = float(a.get("energy_j") or 0.0) - prev["energy_j"]
        d_c = float(a.get("completed") or 0) - prev["completed"]
        hit = 100.0 * d_h / d_lk if d_lk > 0 else float("nan")
        jpr = d_e / d_c if d_c > 0 else float("nan")
        lines.append(f"  Q{qi + 1:<8}{a.get('tick', '?'):>7}"
                     f"{hit:>13.1f}{jpr:>11.4g}"
                     f"{float(a.get('draw_w') or 0.0):>9.1f}")
        prev = {"lookups": float(a.get("lookups") or 0),
                "lookup_hits": float(a.get("lookup_hits") or 0),
                "energy_j": float(a.get("energy_j") or 0.0),
                "completed": float(a.get("completed") or 0)}
    return "\n".join(lines)


SECTIONS = {
    "summary": text_summary,
    "routing": refusal_report,
    "verification": verification_report,
    "health": health_report,
    "trends": trends_report,
}


def render(records, sections: Optional[List[str]] = None) -> str:
    names = sections or list(SECTIONS)
    return "\n\n".join(SECTIONS[name](records) for name in names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a post-mortem from a repro_torch.obs JSONL trace.")
    ap.add_argument("events", help="path to an events.jsonl written by "
                                   "Tracer.to_jsonl")
    ap.add_argument("--section", action="append", choices=list(SECTIONS),
                    help="render only these sections (repeatable; "
                         "default: all)")
    args = ap.parse_args(argv)
    records = read_jsonl(args.events)
    print(render(records, args.section))
    return 0


if __name__ == "__main__":
    sys.exit(main())
