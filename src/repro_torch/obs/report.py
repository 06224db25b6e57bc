"""``python -m repro_torch.obs report`` — summarize the flight recorder's
output, counterpart of ``repro/obs/report.py``.

Renders the accumulated telemetry as a human summary:

  * the model-accuracy distribution (predicted over measured seconds) per
    (backend, device) from the history ledger — count / mean / min / p50
    / max — so a CPU run of the H100 model never averages with a card's;
  * the slowest spans and the plan-cache hit rate from an event JSONL
    (``--events``, written via ``REPRO_TORCH_OBS_JSONL`` or
    ``profile(jsonl_path=...)``);
  * every counter the recorded process flushed.

``--json`` emits the same structure machine-readably.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.obs.history import DEFAULT_HISTORY_PATH, read_history
from repro_torch.obs.recorder import percentile


def _read_events(path: str) -> List[dict]:
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(ev, dict):
                    out.append(ev)
    except FileNotFoundError:
        pass
    return out


def group_name(sample: dict) -> str:
    """The (backend, device) group of an accuracy sample, as one key."""
    return f"{sample.get('backend', '?')} on {sample.get('device', '?')}"


def _accuracy_by_group(samples: List[dict]) -> dict:
    groups: dict = {}
    for s in samples:
        ratio = s.get("model_accuracy")
        if not isinstance(ratio, (int, float)):
            continue
        groups.setdefault(group_name(s), []).append(float(ratio))
    out = {}
    for name, vals in sorted(groups.items()):
        out[name] = {
            "count": len(vals),
            "mean": sum(vals) / len(vals),
            "min": min(vals),
            "p50": percentile(vals, 50),
            "max": max(vals),
        }
    return out


def summarize(history_path: str, events_path: Optional[str] = None,
              top: int = 10) -> dict:
    samples = read_history(history_path)
    summary = {
        "history": {
            "path": history_path,
            "samples": len(samples),
            "backends": _accuracy_by_group(samples),
        },
    }
    if events_path:
        events = _read_events(events_path)
        spans = [e for e in events if e.get("type") == "span"
                 and isinstance(e.get("dur_s"), (int, float))]
        compiles = [e for e in spans if e.get("name") == "compile"]
        hits = [e for e in compiles if e.get("cache_hit")]
        counters: dict = {}
        for e in events:
            if e.get("type") == "counter":
                for k, v in (e.get("counters") or {}).items():
                    counters[k] = counters.get(k, 0) + v
        summary["events"] = {
            "path": events_path,
            "count": len(events),
            "slowest_spans": [
                {"name": e.get("name"), "dur_s": e["dur_s"],
                 "backend": e.get("backend")}
                for e in sorted(spans, key=lambda e: -e["dur_s"])[:top]],
            "compile": {
                "count": len(compiles),
                "cache_hits": len(hits),
                "cache_hit_rate": len(hits) / len(compiles)
                if compiles else 0.0,
            },
            "counters": counters,
        }
    return summary


def render(summary: dict) -> str:
    lines = ["# repro_torch.obs report", ""]
    hist = summary["history"]
    lines.append(f"history: {hist['path']} ({hist['samples']} accuracy "
                 f"samples)")
    if hist["backends"]:
        lines.append("")
        lines.append("model accuracy (predicted / measured seconds) per "
                     "backend and device:")
        lines.append(f"  {'backend on device':<32} {'n':>5} {'mean':>7} "
                     f"{'min':>7} {'p50':>7} {'max':>7}")
        for name, d in hist["backends"].items():
            lines.append(f"  {name:<32} {d['count']:>5} {d['mean']:>7.3f} "
                         f"{d['min']:>7.3f} {d['p50']:>7.3f} "
                         f"{d['max']:>7.3f}")
    else:
        lines.append("  (no accuracy samples — run with REPRO_TORCH_OBS=1 "
                     "or inside repro_torch.obs.profile(history_path=...))")
    ev = summary.get("events")
    if ev is not None:
        lines.append("")
        lines.append(f"events: {ev['path']} ({ev['count']} events)")
        comp = ev["compile"]
        if comp["count"]:
            lines.append(f"  plan cache: {comp['cache_hits']}/{comp['count']}"
                         f" compile spans hit "
                         f"({comp['cache_hit_rate']:.0%})")
        if ev["slowest_spans"]:
            lines.append("  slowest spans:")
            for s in ev["slowest_spans"]:
                backend = f" [{s['backend']}]" if s.get("backend") else ""
                lines.append(f"    {s['dur_s'] * 1e3:>10.2f} ms  "
                             f"{s['name']}{backend}")
        if ev["counters"]:
            lines.append("  counters:")
            for k, v in sorted(ev["counters"].items()):
                lines.append(f"    {k} = {v}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="summarize recorded telemetry")
    rep.add_argument("--history", default=DEFAULT_HISTORY_PATH,
                     help="accuracy history ledger (default "
                          f"{DEFAULT_HISTORY_PATH})")
    rep.add_argument("--events", default=None,
                     help="event JSONL (REPRO_TORCH_OBS_JSONL output) for "
                          "the span/cache/counter sections")
    rep.add_argument("--top", type=int, default=10,
                     help="slowest spans to list")
    rep.add_argument("--json", action="store_true",
                     help="machine-readable output")
    args = ap.parse_args(argv)

    summary = summarize(args.history, events_path=args.events, top=args.top)
    if args.json:
        json.dump(summary, sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
