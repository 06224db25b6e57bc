"""BENCHMARK.json and the folder on the CPU: every cell resolves to its
files, names and units keep to their characters, each per-layer metric's
``moves`` is reported where it is listed, nothing imports jax, the JAX
package or the old benchmark, and a configuration, a mix and a metric
added as new files are found without editing a file that exists."""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from stencilbench import harness

ROOT = harness.ROOT
BENCH = harness.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
#: The old JAX benchmark's folder, which nothing here may read.
OLD = "benchmarks" + "/"


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


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "stencilbench/run.py"]
    assert BENCH["paths"] == ["stencilbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"][1:]:
        assert any(word.startswith(p + "/") for p in BENCH["paths"])
        assert (ROOT / word).is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in BENCH["configs"]:
        assert 1 <= len(e["source"]) <= 200 and e["reduced"] == []
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    entry, cfg_entry = harness.find_cell(BENCH, cell)
    cfg_path = harness.config_file(ROOT, cfg_entry)
    assert cfg_path.is_file() and cfg_path.is_relative_to(ROOT /
                                                          "stencilbench")
    config = harness.read_json(cfg_path)
    assert config["name"] == cfg_entry["name"]
    assert harness.module_file(ROOT, "references",
                               config["reference"]).is_file()
    mix = harness.read_json(harness.mix_file(ROOT, entry["traffic"]))
    assert harness.module_file(ROOT, "loops", mix["loop"]).is_file()
    for traced in (False, True):
        for m in harness.metrics_of(BENCH, cell, traced):
            assert harness.module_file(ROOT, "metrics", m["name"]).is_file()
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, cell, True)


def test_config_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_moves_is_reported_by_each_listed_cell(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m.get("workloads", CELLS):
        e2e = {x["name"] for x in harness.metrics_of(BENCH, cell, False)}
        assert m["moves"] in e2e


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path",
                         sorted((ROOT / "stencilbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_repro_or_benchmarks(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in harness.FORBIDDEN_MODULES, (path, name)
    assert OLD not in path.read_text(encoding="utf-8")


def test_forbidden_module_names_are_compared_whole(monkeypatch):
    clean = ["torch", "repro_torch", "repro_torch.kernels", "jaxlike.sub",
             "benchmarks_old", "stencilbench.harness"]
    assert harness.forbidden_modules(clean) == []
    assert harness.forbidden_modules(clean + ["repro.core", "jax.numpy",
                                              "benchmarks"]) == [
        "benchmarks", "jax", "repro"]
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax" in harness.forbidden_modules()


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """A later PR's addition, in a copy: new files and new entries in
    BENCHMARK.json, no existing file of the folder edited."""
    shutil.copytree(ROOT / "stencilbench", tmp_path / "stencilbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    before = _digest(tmp_path / "stencilbench")
    bench = json.loads(json.dumps(BENCH))
    sb = tmp_path / "stencilbench"
    cfg = harness.read_json(sb / "configs" / "2d_r4_paper.json")
    cfg.update(name="2d_r2_small", grid=[24, 40],
               program={**cfg["program"], "radius": 2})
    (sb / "configs" / "2d_r2_small.json").write_text(json.dumps(cfg))
    (sb / "traffic" / "sim_8steps.json").write_text(json.dumps(
        {"loop": "simulate", "why": "a test mix", "steps_per_call": 8}))
    (sb / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return float(run.window.attempted)\n")
    bench["configs"].append({"name": "2d_r2_small", "source": "a test",
                             "file": "stencilbench/configs/2d_r2_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "2d_r2_small.sim",
                               "config": "2d_r2_small",
                               "traffic": "sim_8steps", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "front door",
                               "moves": "gcell_steps_per_s",
                               "workloads": ["2d_r2_small.sim"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(sb)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        "configs/2d_r2_small.json", "traffic/sim_8steps.json",
        "metrics/calls_in_window.py"}
    result, checks = harness.run_cell(
        "2d_r2_small.sim", seed=2**33 + 1, seconds=0.01, traced=True,
        device="cpu", t_start=time.time(), root=tmp_path)
    assert result["correct"], checks
    assert result["metrics"]["calls_in_window"]["value"] >= 1.0
    assert result["metrics"]["calls_in_window"]["unit"] == "calls"


@pytest.mark.parametrize("loop", ["sim", "served"])
def test_precisions_come_from_the_configuration(loop, tmp_path,
                                                monkeypatch):
    """A bfloat16 configuration added as a new file: its grids are drawn
    in bfloat16, the program runs in it, and the reference and the
    control take the precisions its ``check`` names."""
    from stencilbench import check, control
    shutil.copytree(ROOT / "stencilbench", tmp_path / "stencilbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    sb = tmp_path / "stencilbench"
    cfg = harness.read_json(sb / "configs" / "2d_r4_paper.json")
    cfg.update(name="2d_r4_bf16", grid=[24, 40],
               program={**cfg["program"], "dtype": "bfloat16"},
               check={"max_rel_err": 0.05, "reference_dtype": "bfloat16",
                      "control_dtype": "float16"})
    (sb / "configs" / "2d_r4_bf16.json").write_text(json.dumps(cfg))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "2d_r4_bf16", "source": "a test",
                             "file": "stencilbench/configs/2d_r4_bf16.json",
                             "reduced": [], "why": "a test"})
    mix = {"sim": "sim_128steps", "served": "served_3x3steps"}[loop]
    bench["workloads"].append({"name": "2d_r4_bf16.x", "config": "2d_r4_bf16",
                               "traffic": mix, "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    seen = []
    judge = check.judge

    def spy(answers, desc, reference, dtype=torch.float32,
            program_dtype=None):
        seen.append((dtype, program_dtype,
                     {a.source().dtype for a in answers},
                     {a.output.dtype for a in answers
                      if a.output is not None}))
        return judge(answers, desc, reference, dtype, program_dtype)

    monkeypatch.setattr(check, "judge", spy)
    result, checks = harness.run_cell(
        "2d_r4_bf16.x", seed=2**33 + 5, seconds=0.01, traced=False,
        device="cpu", t_start=time.time(), root=tmp_path)
    assert result["correct"], checks
    control.control_reading("2d_r4_bf16.x", 2**33 + 5, "cpu", root=tmp_path)
    bf16 = torch.bfloat16
    assert seen[0] == (bf16, None, {bf16}, {bf16})
    assert seen[1] == (bf16, torch.float16, {bf16}, set())


def test_command_prints_no_result_without_a_card(tmp_path):
    """On a host with no CUDA card the command exits non-zero and prints
    nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command would run the cell")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "stencilbench" / "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr
