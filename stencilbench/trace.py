"""The reduction of a profiler trace to intervals, shares and a breakdown.

A traced run records the window under ``torch.profiler`` (host and CUDA
activities) and exports the Chrome trace.  :func:`load` reads it into a
:class:`Trace`: the device's operations (kernels, copies, fills) and the
host's events (PyTorch operators and the benchmark's own spans), all on
the trace's one clock, in microseconds.  The metric readers and the
breakdown work on those lists; nothing here knows the program.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

#: Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Categories of host events that name what the host was doing.
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: The span the benchmark wraps its measured window in.
WINDOW = "bench.window"


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    cat: str
    start: float    # microseconds on the trace clock
    end: float


@dataclasses.dataclass
class Trace:
    device: List[Op]
    host: List[Op]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def spans(self, name: str) -> List[Op]:
        """The benchmark's host spans of one name, in time order."""
        return sorted((o for o in self.host
                       if o.cat == "user_annotation" and o.name == name),
                      key=lambda o: o.start)


def from_events(events: Iterable[dict]) -> Trace:
    """A :class:`Trace` from Chrome-trace events (``ph == "X"``), the
    device operations clipped to the ``bench.window`` span."""
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        start = float(e["ts"])
        op = Op(str(e.get("name", "")), cat, start, start + float(e["dur"]))
        if cat in DEVICE_CATS:
            device.append(op)
        elif cat in HOST_CATS:
            host.append(op)
    windows = [o for o in host if o.cat == "user_annotation"
               and o.name == WINDOW]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    w = (min(o.start for o in windows), max(o.end for o in windows))
    device = sorted((dataclasses.replace(o, start=max(o.start, w[0]),
                                         end=min(o.end, w[1]))
                     for o in device if o.end > w[0] and o.start < w[1]),
                    key=lambda o: o.start)
    return Trace(device=device, host=host, window=w)


def load(path: str) -> Trace:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return from_events(events)


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Disjoint, sorted intervals covering the same time."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Sequence[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Time in [lo, hi] that the disjoint ``intervals`` cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in intervals)


def busy_us(trace: Trace) -> float:
    """Microseconds in which any device operation ran."""
    return covered(union((o.start, o.end) for o in trace.device),
                   *trace.window)


#: Device-operation categories that are copies and fills.
AUX_CATS = ("gpu_memcpy", "gpu_memset")


def is_aux(op: Op) -> bool:
    """An operation that is not one of the program's own kernels: one of
    PyTorch's (``at::`` in its name: fills, copies, ``cat``/``stack``,
    the coefficient bank), a memcpy or a memset."""
    return op.cat in AUX_CATS or "at::" in op.name \
        or op.name.startswith(("Memcpy", "Memset"))


def kernel_us(trace: Trace) -> float:
    """Microseconds in which any of the program's own kernels ran (the
    operations :func:`is_aux` leaves out)."""
    return covered(union((o.start, o.end) for o in trace.device
                         if not is_aux(o)), *trace.window)


def idle_share(trace: Trace) -> float:
    """The share of the window in which no device operation ran."""
    span = trace.window[1] - trace.window[0]
    return 1.0 - busy_us(trace) / span if span > 0 else 0.0


#: Longest name the breakdown keeps whole; a longer one keeps its head
#: and the start of its template arguments.
NAME_CHARS = 120


def short_name(name: str) -> str:
    """A device operation's name without its return type, its argument
    list and ``(anonymous namespace)::``:
    ``void (anonymous namespace)::queue_kernel<2, 4, 2, 0>(float const*, ...)``
    reads ``queue_kernel<2, 4, 2, 0>``; past :data:`NAME_CHARS` the
    template arguments are cut."""
    head = name
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] not in " :":
            head = name[:i]
            break
    if head.startswith("void "):
        head = head[5:]
    head = head.replace("(anonymous namespace)::", "")
    if len(head) > NAME_CHARS:
        head = head[:NAME_CHARS - 4] + " ...>"
    return head


def top_device_ops(trace: Trace, n: int = 10) -> List[List[object]]:
    """The ``n`` device operations that took most time, summed by name:
    ``[name, seconds]``."""
    total: Dict[str, float] = defaultdict(float)
    for o in trace.device:
        total[short_name(o.name)] += o.end - o.start
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in ranked]


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The device's idle intervals inside the window."""
    busy = union((o.start, o.end) for o in trace.device)
    out, t = [], trace.window[0]
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.window[1] > t:
        out.append((t, trace.window[1]))
    return out


#: Gaps shorter than this (microseconds) are summed under one label
#: rather than each being matched to a host event.
SHORT_GAP_US = 5.0
#: How many host events before a gap's start :meth:`HostIndex.label`
#: scans.
_LOOKBACK = 400


class HostIndex:
    """The host's events sorted by start, for labelling many gaps."""

    def __init__(self, trace: Trace):
        self.events = sorted((o for o in trace.host if o.name != WINDOW),
                             key=lambda o: o.start)
        self.starts = [o.start for o in self.events]
        self.spans = [o for o in self.events if o.cat == "user_annotation"]

    def label(self, t: float) -> str:
        """What the host was doing at ``t``: the shortest host event that
        holds it, inside the shortest benchmark span that holds it."""
        i = bisect.bisect_right(self.starts, t)
        holding = [o for o in self.events[max(0, i - _LOOKBACK):i]
                   if o.end > t]
        spans = [o for o in self.spans if o.start <= t < o.end]
        if not holding and not spans:
            return "host: no traced event"
        inner = min(holding or spans, key=lambda o: o.end - o.start)
        if spans:
            outer = min(spans, key=lambda o: o.end - o.start)
            if outer is not inner:
                return f"{outer.name} > {inner.name}"
        return inner.name


def top_idle_gaps(trace: Trace, n: int = 10) -> List[List[object]]:
    """Idle time summed by what the host was doing in the middle of each
    gap, the ``n`` largest sums: ``[label, seconds]``.  Gaps under
    :data:`SHORT_GAP_US` are summed as one entry."""
    total: Dict[str, float] = defaultdict(float)
    index = HostIndex(trace)
    short = f"gaps under {SHORT_GAP_US:g} us"
    for s, e in gaps(trace):
        key = short if e - s < SHORT_GAP_US else index.label((s + e) / 2)
        total[key] += e - s
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in ranked]
