"""The harness on the card at small grids: each cell's loop drives the
port's CUDA kernels and its answers pass the comparison, traced and not.
Card-only: skips where no CUDA card is visible.

    python -m pytest -q -m gpu stencilbench/test_stencilbench_card.py
"""

import time

import pytest
import torch

from stencilbench import harness

pytestmark = pytest.mark.gpu

ROOT = harness.ROOT
BENCH = harness.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {2: [256, 512], 3: [32, 64, 128]}


@pytest.fixture
def card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE",
                       str(tmp_path / "plans.json"))
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_is_correct_on_the_card_at_a_small_grid(cell, traced, card):
    _, cfg_entry = harness.find_cell(BENCH, cell)
    ndim = harness.read_json(harness.config_file(
        ROOT, cfg_entry))["program"]["ndim"]
    result, checks = harness.run_cell(
        cell, seed=2**32 + 3, seconds=0.5, traced=traced, device=card,
        t_start=time.time(), overrides={"grid": SMALL[ndim]})
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
    wanted = {m["name"] for m in harness.metrics_of(BENCH, cell, traced)}
    assert set(result["metrics"]) == wanted
    if traced:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
