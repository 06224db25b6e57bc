"""Process-local flight recorder: spans, counters, value streams, JSONL sink
— counterpart of ``repro/obs/recorder.py``, with its names, semantics and
event shapes.

Stdlib only, so every layer of the port (kernels, executor, serving,
tuner) can import it without a cycle or a cold-start cost.

A :class:`Recorder` is an append-only, thread-safe buffer of event dicts:

    span     — a timed region (``{"type": "span", "name", "dur_s", ...}``)
    event    — a point-in-time fact (``{"type": "event", ...}``)
    counter  — monotonic named counts (``{"type": "counter"}`` on close)
    accuracy — a predicted-vs-achieved sample; also appended to the
               schema-versioned history file when the recorder carries a
               ``history_path`` (``history.py``)

Every emit optionally streams a JSON line to ``jsonl_path``, so a crashed
run still leaves its trace on disk.  The module-level helpers of
``repro_torch.obs`` route through the global switch
(``REPRO_TORCH_OBS``); an explicitly constructed ``Recorder`` (the serving
front's) always records.

While a ``torch.profiler`` records, every span also opens
``torch.profiler.record_function(<span name>)`` for its extent, so it
lands in the exported Chrome trace as a ``user_annotation`` on the
profiler's clock, beside the device's kernels.  The profiler's flag is
read through ``sys.modules``: this module never imports torch.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence


#: The module whose flag says a ``torch.profiler`` records, and whose
#: ``record_function`` opens a range in its trace.
_PROFILER = "torch.autograd.profiler"


def profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process: one module
    lookup and one flag read, False where torch was never imported."""
    prof = sys.modules.get(_PROFILER)
    return prof is not None and prof._is_profiler_enabled


def _open_range(name: str):
    """A ``record_function`` range named ``name``, entered, while a
    profiler records; else None."""
    prof = sys.modules.get(_PROFILER)
    if prof is None or not prof._is_profiler_enabled:
        return None
    rng = prof.record_function(name)
    rng.__enter__()
    return rng


class _NullSpan:
    """The disabled-path span: one shared, stateless, reusable no-op, so
    the off switch allocates nothing per site."""

    __slots__ = ()
    #: whether ``set`` keeps attributes (callers skip computing them)
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class ProfilerRange:
    """A span that is only a profiler range: no recorder event, no
    attributes (the recorder-off span while a profiler records)."""

    __slots__ = ("name", "_range")
    recording = False

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "ProfilerRange":
        self._range = _open_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False

    def set(self, **attrs) -> "ProfilerRange":
        return self


def profiler_range(name: str):
    """A :class:`ProfilerRange` while a profiler records, else the shared
    no-op."""
    return ProfilerRange(name) if profiling() else NULL_SPAN


class Span:
    """A timed region; emits one ``span`` event when the context exits,
    and is a profiler range too while a profiler records.

    ``set(**attrs)`` attaches attributes mid-flight (metrics computed after
    the timed work, e.g. achieved GB/s once the wall time is known).
    """

    __slots__ = ("_rec", "name", "attrs", "_t0", "dur_s", "_range")
    recording = True

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self._t0 = None
        self.dur_s = None
        self._range = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._range = _open_range(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur_s = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        ev = {"type": "span", "name": self.name, "dur_s": self.dur_s}
        if exc_type is not None:
            ev["error"] = exc_type.__name__
        ev.update(self.attrs)
        self._rec.emit(ev)
        return False


class Recorder:
    """Thread-safe in-memory event buffer with optional JSONL/history sinks.

    All mutation happens under one lock; reads return copies so callers can
    iterate while other threads keep recording.
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 history_path: Optional[str] = None):
        self._lock = threading.Lock()
        self.events: List[dict] = []
        self.counters: Dict[str, int] = collections.Counter()
        self._samples: Dict[str, List[float]] = {}
        self.jsonl_path = jsonl_path
        self.history_path = history_path
        self._jsonl = None
        self.t_start = time.time()

    # -- emission ------------------------------------------------------------

    def emit(self, event: dict) -> None:
        """Append one event (and stream it to the JSONL sink if any)."""
        event.setdefault("ts", round(time.time(), 6))
        with self._lock:
            self.events.append(event)
            if self.jsonl_path is not None:
                if self._jsonl is None:
                    d = os.path.dirname(self.jsonl_path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    self._jsonl = open(self.jsonl_path, "a")
                self._jsonl.write(json.dumps(event, default=str,
                                             sort_keys=True) + "\n")
                self._jsonl.flush()

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        ev = {"type": "event", "name": name}
        ev.update(attrs)
        self.emit(ev)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def observe(self, name: str, value: float) -> None:
        """Record one sample of a value stream (latency, occupancy, ...)."""
        with self._lock:
            self._samples.setdefault(name, []).append(float(value))

    def record_accuracy(self, **fields) -> dict:
        """Emit one predicted-vs-achieved sample: into the event buffer
        (``type="accuracy"``) and, when this recorder has a
        ``history_path``, onto the history file."""
        from repro_torch.obs import history
        sample = history.make_sample(fields)
        ev = {"type": "accuracy"}
        ev.update(sample)
        self.emit(ev)
        if self.history_path is not None:
            history.append_sample(self.history_path, sample)
        return sample

    # -- views ---------------------------------------------------------------

    def spans(self, name: Optional[str] = None) -> List[dict]:
        with self._lock:
            return [e for e in self.events if e.get("type") == "span"
                    and (name is None or e.get("name") == name)]

    def accuracy_samples(self) -> List[dict]:
        with self._lock:
            return [e for e in self.events if e.get("type") == "accuracy"]

    def counter(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

    def samples(self, name: str) -> List[float]:
        with self._lock:
            return list(self._samples.get(name, ()))

    def sample_sum(self, name: str) -> float:
        with self._lock:
            return float(sum(self._samples.get(name, ())))

    def percentile(self, name: str, q: float) -> float:
        """Nearest-rank percentile of a value stream (0 when empty)."""
        return percentile(self.samples(name), q)

    def percentiles(self, name: str,
                    qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
        vals = self.samples(name)
        return {f"p{q:g}": percentile(vals, q) for q in qs}

    def close(self) -> None:
        """Flush counters as a final event and close the JSONL sink."""
        with self._lock:
            counters = dict(self.counters)
        if counters:
            self.emit({"type": "counter", "counters": counters})
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None

    def __enter__(self) -> "Recorder":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile; 0.0 for an empty stream."""
    if not values:
        return 0.0
    vals = sorted(values)
    k = max(0, min(len(vals) - 1,
                   int(round(q / 100.0 * (len(vals) - 1)))))
    return vals[k]
