"""repro_torch.obs — the port's flight recorder: structured tracing and
run metrics, counterpart of ``repro/obs``.

Every instrumented path — ``compile``/``run`` of the front door, the
kernel build, the serving front — emits structured events; a recorded
``run`` carries its host wall time, its device time (CUDA events), the
model's predicted seconds (``core/blocking.run_seconds``) and their ratio,
and appends one accuracy sample to the port's history ledger.

Off by default.  ``REPRO_TORCH_OBS=1`` (or an active :func:`profile`
scope) turns recording on; when off, every module-level helper returns
the shared no-op after one dict lookup, no recorder is built, and ``run``
stays asynchronous.

One clock with the device trace: while a ``torch.profiler`` records,
every span also opens ``record_function(<span name>)`` for its extent, a
``user_annotation`` in the exported Chrome trace beside the kernels.  So
:func:`span` has three states: recorder off and no profiler, the shared
no-op (after one :func:`active` lookup and one flag read); recorder off
and a profiler recording, a span that is only the profiler range;
recorder on, the recorded span, plus the range while a profiler records.
No span synchronises the device, records an event or copies anything;
attributes go on the recorder's event only.  While ``torch.compile``
traces, the helper records nothing.

The spans, by layer (names fixed; the ones through :func:`span` are
recorded only by the global recorder, never into the serving front's own):

    serving front  ``serve.submit`` (one ``submit``), ``serve.flush`` (one
                   ``flush``, the server's recorder), inside it
                   ``serve.group``, per chunk ``serve.dispatch`` (an
                   identity chunk's ``serve.stack`` instead: its results
                   are its stacked inputs) and ``serve.wait``, then
                   ``serve.route`` (results and latency stamps)
    front door     ``compile``, ``run`` (``CompiledStencil.run``; with the
                   recorder off and a profiler recording, a range around
                   the dispatch that never synchronises)
    run driver     ``run_call.pad_in`` (each grid's copy into the
                   padded carry, the zeroed ring and slack),
                   ``run_call.supersteps``, ``run_call.slice_out``
                   (``kernels/common.run_call``); counter
                   ``run_call.copy_bytes``
    kernel wrappers  ``launch.<key>`` per superstep or ring refresh, the
                   key one of ``kernels/cuda.KERNELS`` (attributes
                   ``dtype``, ``batch``, ``cells``, ``steps``); inside a
                   superstep's, ``superstep.steps.<T>``, T the steps the
                   launch fuses; counter ``superstep.cell_steps`` (cells
                   times steps of every superstep launch)
    build          ``kernels.build``

Usage::

    import repro_torch, repro_torch.obs

    with repro_torch.obs.profile() as rec:
        cs = repro_torch.stencil(program).compile((16384, 16384), steps=9)
        out = cs.run(grid)
    rec.spans("run")[0]["device_s"]           # CUDA-event seconds
    rec.accuracy_samples()[0]["model_accuracy"]   # predicted / wall

Env (the port's own; the reference's ``REPRO_OBS*`` do not apply):
    REPRO_TORCH_OBS          1/true enables the global recorder
    REPRO_TORCH_OBS_JSONL    stream every event to this JSONL file
    REPRO_TORCH_OBS_HISTORY  accuracy ledger (default
                             ``build/repro_torch/history.jsonl``; an empty
                             string disables it)

``python -m repro_torch.obs report`` renders the summary (accuracy per
backend and device, slowest spans, plan-cache hit rate, counters);
``--json`` emits the same machine-readably.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Optional

from repro_torch.obs.history import (DEFAULT_HISTORY_PATH, SCHEMA_VERSION,
                                     append_sample, default_history_path,
                                     read_history)
from repro_torch.obs.recorder import (NULL_SPAN, ProfilerRange, Recorder,
                                     Span, percentile, profiler_range,
                                     profiling)

__all__ = [
    "DEFAULT_HISTORY_PATH",
    "NULL_SPAN",
    "ProfilerRange",
    "Recorder",
    "SCHEMA_VERSION",
    "Span",
    "active",
    "append_sample",
    "count",
    "enabled",
    "event",
    "observe",
    "percentile",
    "profile",
    "profiler_range",
    "profiling",
    "read_history",
    "record_accuracy",
    "reset",
    "span",
]

ENV_SWITCH = "REPRO_TORCH_OBS"
ENV_JSONL = "REPRO_TORCH_OBS_JSONL"
_OFF = frozenset(("", "0", "false", "off", "no"))

# One slot each so toggles are atomic swaps; the lock only guards lazy
# construction of the env-driven recorder.  ``env_off`` caches the switch
# (an environ lookup per call site costs too much); :func:`reset` re-reads.
_state = {"override": None, "env_recorder": None, "env_off": None}
_state_lock = threading.Lock()


def active() -> Optional[Recorder]:
    """The recorder every module-level helper routes to, or None when off.

    A :func:`profile` scope (or :func:`enable`) wins over the environment;
    otherwise ``REPRO_TORCH_OBS`` decides — read once per process
    (:func:`reset` re-reads) — with the env-driven recorder built lazily on
    first use (sinks from ``REPRO_TORCH_OBS_JSONL`` /
    ``REPRO_TORCH_OBS_HISTORY``).
    """
    rec = _state["override"]
    if rec is not None:
        return rec
    off = _state["env_off"]
    if off is None:
        off = os.environ.get(ENV_SWITCH, "0").strip().lower() in _OFF
        _state["env_off"] = off
    if off:
        return None
    rec = _state["env_recorder"]
    if rec is None:
        with _state_lock:
            rec = _state["env_recorder"]
            if rec is None:
                rec = Recorder(
                    jsonl_path=os.environ.get(ENV_JSONL) or None,
                    history_path=default_history_path())
                _state["env_recorder"] = rec
    return rec


def enabled() -> bool:
    return active() is not None


def enable(recorder: Optional[Recorder] = None) -> Recorder:
    """Force recording on for this process (until :func:`disable`)."""
    rec = recorder if recorder is not None else Recorder()
    _state["override"] = rec
    return rec


def disable() -> None:
    """Drop any programmatic override (the env switch still applies)."""
    _state["override"] = None


def reset() -> None:
    """Forget the override, the env-driven recorder and the cached
    ``REPRO_TORCH_OBS`` decision (test isolation, env re-reads)."""
    _state["override"] = None
    _state["env_off"] = None
    rec = _state["env_recorder"]
    _state["env_recorder"] = None
    if rec is not None:
        rec.close()


@contextlib.contextmanager
def profile(jsonl_path: Optional[str] = None,
            history_path: Optional[str] = None):
    """Record everything inside the scope into a fresh :class:`Recorder`.

    The yielded recorder is the process-global target for the scope
    (nesting restores the previous one), whatever ``REPRO_TORCH_OBS``
    says.  Sinks default to in-memory only — pass ``jsonl_path`` /
    ``history_path`` to persist.
    """
    rec = Recorder(jsonl_path=jsonl_path, history_path=history_path)
    prev = _state["override"]
    _state["override"] = rec
    try:
        yield rec
    finally:
        _state["override"] = prev
        rec.close()


# -- module-level instrumentation helpers (no-ops when disabled) -------------

def span(name: str, **attrs):
    """A timed-region context manager: the global recorder's span when it
    is on, else a profiler range while a profiler records, else the shared
    no-op.  Nothing is recorded while ``torch.compile`` traces."""
    rec = active()
    if rec is None:
        return profiler_range(name)
    return NULL_SPAN if _compiling() else rec.span(name, **attrs)


def _compiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.compiler.is_compiling()


def event(name: str, **attrs) -> None:
    rec = active()
    if rec is not None:
        rec.event(name, **attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter of the global recorder when it is on (not
    while ``torch.compile`` traces, as :func:`span`)."""
    rec = active()
    if rec is not None and not _compiling():
        rec.count(name, n)


def observe(name: str, value: float) -> None:
    rec = active()
    if rec is not None:
        rec.observe(name, value)


def record_accuracy(**fields) -> Optional[dict]:
    rec = active()
    return None if rec is None else rec.record_accuracy(**fields)
