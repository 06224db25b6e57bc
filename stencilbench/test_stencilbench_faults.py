"""The comparison fails what it must, on the CPU at a size a test can hold.

Each cell runs through the harness with its own mix and configuration,
the grid shrunk, on the port's plain versions (``device="cpu"``): the
harness's look for a card is the only step skipped.  A sound run is
``correct``; the control (the reference in bfloat16 in the program's
place) and each fault the cell can have, planted under the timed path,
are not:

* a step that returns its state unchanged;
* an answer altered where it is produced (one cell of every output);
* half of each batch left out (served cells): its rows returned
  unadvanced, or its results dropped from the flush;
* results handed to the wrong request (served cells).

The cells run on one card, so no exchange between chips can be left out.
"""

import time

import pytest
import torch

from stencilbench import control, harness

ROOT = harness.ROOT
BENCH = harness.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVED = [c for c in CELLS if harness.read_json(harness.mix_file(
    ROOT, harness.find_cell(BENCH, c)[0]["traffic"]))["loop"] == "serve"]
SMALL = {2: [24, 40], 3: [10, 12, 20]}
SEED = 2**31 + 17


@pytest.fixture(autouse=True)
def plan_cache(tmp_path, monkeypatch):
    """The port's plan cache in the test's own directory, and one torch
    thread: the harness's CPU runs are many small operations, which
    several threads only slow when the suite runs in parallel."""
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE",
                       str(tmp_path / "plans.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small(cell):
    _, cfg_entry = harness.find_cell(BENCH, cell)
    cfg = harness.read_json(harness.config_file(ROOT, cfg_entry))
    return {"grid": SMALL[cfg["program"]["ndim"]]}


def _run(cell, seconds=0.05):
    result, checks = harness.run_cell(
        cell, seed=SEED, seconds=seconds, traced=False, device="cpu",
        t_start=time.time(), overrides=_small(cell))
    return result, checks


@pytest.fixture
def port():
    return harness.import_port(ROOT)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, checks = _run(cell)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert checks["max_rel_err"]["value"] < 1e-5
    assert set(result["metrics"]) == {
        m["name"] for m in harness.metrics_of(BENCH, cell, False)}


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    reading = control.control_reading(cell, SEED, "cpu",
                                      overrides=_small(cell))
    assert reading["max_rel_err"] > 10 * reading["limit"], reading


def _patch_run(monkeypatch, port, fault):
    cls = port.executor.CompiledStencil
    original = cls.run

    def run(self, grid, steps=None):
        return fault(grid, original(self, grid, steps))

    monkeypatch.setattr(cls, "run", run)


def _unchanged(grid, out):
    return grid.clone()


def _altered(grid, out):
    out = out.clone()
    out.view(-1)[out.numel() // 3] += 0.5
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_fault_under_the_timed_path_is_not_correct(cell, fault, port,
                                                   monkeypatch):
    _patch_run(monkeypatch, port,
               {"unchanged": _unchanged, "altered": _altered}[fault])
    result, checks = _run(cell)
    assert not result["correct"], checks


def _batched_rows_left(monkeypatch, port):
    cls = port.executor.CompiledStencil
    original = cls.run

    def run(self, grid, steps=None):
        out = original(self, grid, steps)
        if self.batch is not None and self.batch > 1:
            out = out.clone()
            out[self.batch // 2:] = grid[self.batch // 2:]
        return out

    monkeypatch.setattr(cls, "run", run)


def _patch_flush(monkeypatch, port, fault):
    serve = port.launch.stencil_serve
    original = serve.StencilServer.flush

    def flush(self):
        return fault(original(self))

    monkeypatch.setattr(serve.StencilServer, "flush", flush)


def _dropped(results):
    rids = sorted(results)
    return {r: results[r] for r in rids[:len(rids) // 2]}


def _swapped(results):
    rids = sorted(results)
    out = dict(results)
    out[rids[0]], out[rids[-1]] = results[rids[-1]], results[rids[0]]
    return out


@pytest.mark.parametrize("cell", SERVED)
@pytest.mark.parametrize("fault", ["rows_unadvanced", "results_dropped",
                                   "results_swapped"])
def test_served_fault_is_not_correct(cell, fault, port, monkeypatch):
    import repro_torch.launch.stencil_serve  # noqa: F401
    if fault == "rows_unadvanced":
        _batched_rows_left(monkeypatch, port)
    else:
        _patch_flush(monkeypatch, port, {"results_dropped": _dropped,
                                         "results_swapped": _swapped}[fault])
    result, checks = _run(cell)
    assert not result["correct"], checks
    if fault == "results_dropped":
        assert result["failed"] > 0
        assert checks["missing"]["value"] == result["failed"]


@pytest.mark.parametrize("cell", CELLS)
def test_fault_after_the_first_call_or_flush_is_caught(cell, port,
                                                      monkeypatch):
    """A fault that starts after the window's first call or flush is
    caught by the later answers: a simulation's call drawn from the seed,
    a served mix's last flush."""
    import repro_torch.launch.stencil_serve  # noqa: F401
    served = cell in SERVED
    cls = port.executor.CompiledStencil
    original = cls.run
    serve = port.launch.stencil_serve
    original_flush = serve.StencilServer.flush
    count = {"run": 0, "flush": 0}

    def run(self, grid, steps=None):
        count["run"] += 1
        out = original(self, grid, steps)
        # the set-up's warm-up and the window's first call or flush stay
        # sound
        sound = count["flush"] <= 2 if served else count["run"] <= 2
        return out if sound else _altered(grid, out)

    def flush(self):
        count["flush"] += 1
        return original_flush(self)

    monkeypatch.setattr(cls, "run", run)
    monkeypatch.setattr(serve.StencilServer, "flush", flush)
    # a clock that advances a second a reading, so the window makes the
    # same calls however loaded the host is
    ticks = iter(range(10**6))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    result, checks = _run(cell, seconds=60 if served else 4)
    assert count["flush" if served else "run"] >= 4
    assert not result["correct"], checks
