"""The general harness: resolve a cell by name, run it once, report.

``run_cell`` is one run of one cell of ``BENCHMARK.json``: the cell's
configuration file and traffic mix are read, the loop the mix names is
loaded from ``loops/<loop>.py`` and driven through set-up, the measured
window and release, the checked answers are judged against the
configuration's plain reference, and each metric of the cell is read by
its own ``metrics/<metric>.py``.  Nothing in this file names a cell, a
configuration, a mix or a metric: adding one is adding its files and its
entries in ``BENCHMARK.json``.

A loop module defines ``Loop(ctx)`` with ``setup()``, ``window(seconds)``
(returning a :class:`Window`), ``answers()`` (the
:class:`stencilbench.check.Answer` list to judge) and ``close()`` (which
frees the program's state).  A metric module defines ``read(run)``,
returning a number or None when the run has nothing for it to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

import torch

from stencilbench import check, trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names the benchmark must never load: JAX, its
#: relatives, the JAX package the port was made from, the old benchmark.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


@dataclasses.dataclass
class Window:
    """What a loop did in its measured window."""

    seconds: float          # first call's start to the last one's end
    cell_steps: int         # cell updates of every finished call/request
    flops: float            # their operations (``work.flops_per_cell``)
    bytes: float            # their least bytes (``work.call_bytes``)
    attempted: int          # calls or requests started
    failed: int             # of those, never answered
    latencies_s: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Run:
    """What a metric reader sees of one run."""

    cell: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    device_name: str
    setup_s: float
    window: Window
    trace: Optional[tracing.Trace] = None


class Context:
    """A loop's view of the run: the cell's data, the seed, the device,
    the port, and the benchmark's spans (no-ops unless traced)."""

    def __init__(self, *, config, mix, seed: int, device: torch.device,
                 port: ModuleType, traced: bool):
        self.config = config
        self.mix = mix
        self.seed = seed
        self.device = device
        self.port = port
        self.traced = traced

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build_kernels(self, dtype: str) -> None:
        """On a card, the port's CUDA libraries of ``dtype``, every source
        in one parallel build where any is missing; each library's
        seconds go to standard error (a first run's build is set-up)."""
        if self.device.type != "cuda":
            return
        build = importlib.import_module("repro_torch.kernels.build")
        built = build.build(build.SOURCES, (dtype,))
        for key in built:
            print(f"stencilbench: built {key[0]} ({key[1]}) in "
                  f"{build.BUILD_SECONDS[key]:.1f} s", file=sys.stderr)


# -- resolving names to files ------------------------------------------------

def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(Path(root) / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def find_cell(bench: Dict[str, Any], workload: str
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The workload entry of a cell and its configuration entry."""
    cells = [w for w in bench["workloads"] if w["name"] == workload]
    if not cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[0]
    configs = [c for c in bench["configs"] if c["name"] == cell["config"]]
    if not configs:
        raise KeyError(f"workload {workload!r} names no known configuration "
                       f"{cell['config']!r}")
    return cell, configs[0]


def read_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def config_file(root: Path, entry: Dict[str, Any]) -> Path:
    return Path(root) / entry["file"]


def mix_file(root: Path, traffic: str) -> Path:
    return Path(root) / "stencilbench" / "traffic" / f"{traffic}.json"


def module_file(root: Path, kind: str, name: str) -> Path:
    """``stencilbench/<kind>/<name>.py``: a loop, a metric or a reference."""
    return Path(root) / "stencilbench" / kind / f"{name}.py"


def load_module(root: Path, kind: str, name: str) -> ModuleType:
    path = module_file(root, kind, name)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    key = f"stencilbench_{kind}_{name}_{abs(hash(str(path)))}"
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metrics_of(bench: Dict[str, Any], workload: str,
               traced: bool) -> List[Dict[str, Any]]:
    """The metrics a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if applies(m, workload)]


# -- the port ----------------------------------------------------------------

def import_port(root: Path) -> ModuleType:
    """``repro_torch`` from the checkout's ``src``, and from nowhere else:
    a checkout without the program has no result."""
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch
    where = Path(repro_torch.__file__).resolve()
    if Path(src).resolve() not in where.parents:
        raise ImportError(f"repro_torch was found at {where}, outside the "
                          f"checkout's src")
    return repro_torch


def forbidden_modules(loaded=None) -> List[str]:
    """Module names in ``loaded`` (default: ``sys.modules``) whose
    top-level name is in :data:`FORBIDDEN_MODULES`, compared whole."""
    names = list(sys.modules if loaded is None else loaded)
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN_MODULES})


# -- one run -----------------------------------------------------------------

def _traced_window(ctx: Context, loop, seconds: float
                   ) -> Tuple[Window, tracing.Trace]:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="stencilbench-") as tmp:
        path = os.path.join(tmp, "trace.json")
        with warnings.catch_warnings():
            # the profiler warns that one cycle's events are all it keeps:
            # the window is that one cycle
            warnings.filterwarnings("ignore", message=".*clears events")
            with torch.profiler.profile(activities=acts) as prof:
                with ctx.span(tracing.WINDOW):
                    win = loop.window(seconds)
                ctx.sync()
            prof.export_chrome_trace(path)
        return win, tracing.load(path)


def run_cell(workload: str, *, seed: int, seconds: float, traced: bool,
             device, t_start: float, root: Path = ROOT,
             overrides: Optional[Dict[str, Any]] = None
             ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, float]]]:
    """One run of ``workload``; returns the result line's object (without
    its ``checks``) and the numbers compared with their limits.

    ``t_start`` is the process's start on ``time.time()``'s clock, from
    which ``setup_s`` counts.  ``overrides`` replaces top-level keys of
    the configuration (the tests shrink the grid with it)."""
    root = Path(root)
    bench = load_benchmark(root)
    cell, cfg_entry = find_cell(bench, workload)
    config = {**read_json(config_file(root, cfg_entry)), **(overrides or {})}
    mix = read_json(mix_file(root, cell["traffic"]))
    entries = metrics_of(bench, workload, traced)
    readers = {m["name"]: load_module(root, "metrics", m["name"])
               for m in entries}
    reference = load_module(root, "references", config["reference"])
    loop_module = load_module(root, "loops", mix["loop"])

    device = torch.device(device)
    port = import_port(root)
    ctx = Context(config=config, mix=mix, seed=seed, device=device,
                  port=port, traced=traced)
    loop = loop_module.Loop(ctx)
    loop.setup()
    ctx.sync()
    setup_s = time.time() - t_start
    if traced:
        win, trace = _traced_window(ctx, loop, seconds)
    else:
        win, trace = loop.window(seconds), None
    ctx.sync()
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    name = torch.cuda.get_device_name(device) if cuda else "cpu"

    t_check = time.perf_counter()
    answers = loop.answers()
    loop.close()
    del loop
    if cuda:
        torch.cuda.empty_cache()
    judged = check.judge(answers, config["program"], reference,
                         check.precision(config, "reference_dtype"))
    del answers
    print(f"stencilbench: setup {setup_s:.3f} s, window {win.seconds:.3f} s, "
          f"{len(judged['answers'])} answers judged in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {
        "max_rel_err": {"value": judged["max_rel_err"],
                        "limit": float(config["check"]["max_rel_err"])},
        "missing": {"value": win.failed, "limit": 0},
    }
    correct = check.verdict({k: v["value"] for k, v in checks.items()},
                            {k: v["limit"] for k, v in checks.items()})

    run = Run(cell=cell, config=config, mix=mix, device_name=name,
              setup_s=setup_s, window=win, trace=trace)
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": name,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": bool(correct),
                              "attempted": win.attempted,
                              "failed": win.failed, "metrics": metrics,
                              "device": dev}
    if trace is not None:
        dev["busy_s"] = tracing.busy_us(trace) / 1e6
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": tracing.top_device_ops(trace),
                               "idle_gaps": tracing.top_idle_gaps(trace)}
    return result, checks
