"""The port's codebase rules (RP3xx) and launch audit (RP2xx), against the
reference's where a rule is shared, and each rule on planted snippets
(``tests/test_lint.py`` and ``tests/test_variant_api.py`` of the
reference, carried over to torch).

The RP2xx cases run the kernels' plain versions on the CPU
(``device="cpu"``); ``tests/test_torch_cuda.py`` holds the audit to real
launches on a card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.lint.rules import lint_source as ref_lint_source

import repro_torch
from repro_torch import obs
from repro_torch.kernels import common, cuda, ops
from repro_torch.lint import rules
from repro_torch.lint.__main__ import main as lint_main
from repro_torch.lint.artifact import (Launch, LaunchLog, analyze_launches,
                                       audit_run, check_trace_budget,
                                       record_launches)
from repro_torch.lint.diagnostics import CODES
from repro_torch.lint.engine import lint_paths, to_json
from repro_torch.lint.rules import audit, lint_source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = os.path.join("src", "repro_torch", "kernels", "k.py")
GRID = (20, 140)


@pytest.fixture(autouse=True)
def one_thread():
    """Intra-op threads: one.  These CPU tensors are small, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(diags):
    return [d.code for d in diags]


def _errors(diags):
    return [d.code for d in diags if d.is_error]


def _program(boundary="clamp"):
    prog = repro_torch.StencilProgram(ndim=2, radius=2, boundary=boundary)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(16, 128),
                                 par_time=2)
    return prog, plan


def _grid(seed=0, dtype=np.float32):
    return torch.from_numpy(
        np.random.RandomState(seed).uniform(-1, 1, GRID).astype(dtype))


# ---- rules shared with the reference: the same findings ------------------------

@pytest.mark.parametrize("path,source", [
    ("broken.py", "def f(:\n"),
    ("x.py", "f(grid, pipelined=True)\n"),
    ("x.py", "f(grid, pipelined=True)  # legacy-ok\n"),
    ("x.py", "f(grid,\n  pipelined=True,  # legacy-ok\n)\n"),
    ("x.py", "f(grid,\n  pipelined=True,\n)\n"),
    ("x.py", "def f(grid, pipelined=False):\n    return grid\n"),
    ("x.py", "f(grid, pipelined=True)  # lint-ok: RP305\n"),
])
def test_shared_rules_match_the_reference(path, source):
    """RP300 and RP305 read the same on both linters: codes and lines."""
    got = [(d.code, d.line) for d in lint_source(path, source)]
    want = [(d.code, d.line) for d in ref_lint_source(path, source)]
    assert got == want


def test_rp300_and_a_missing_tree():
    assert _errors(lint_source("broken.py", "def f(:\n")) == ["RP300"]
    diags = lint_paths([os.path.join(ROOT, "no-such-tree")])
    assert _errors(diags) == ["RP300"]
    payload = json.loads(to_json(diags))
    assert payload["errors"] == 1 and payload["total"] == 1
    assert payload["diagnostics"][0]["path"].endswith("no-such-tree")


def test_rp301_legacy_entry_point_scoped():
    configs = os.path.join("src", "repro_torch", "configs", "demo.py")
    for src in ("eng = StencilEngine(prog)\n",
                "out = ops.stencil_run(g, spec, c, plan, 5)\n",
                "from repro_torch.core.temporal import StencilEngine\n"):
        assert _errors(lint_source(configs, src)) == ["RP301"]
        # out of the scanned trees the rule stays silent (the shims)
        assert lint_source(os.path.join("src", "repro_torch", "core",
                                        "t.py"), src) == []
        assert lint_source(configs, src.rstrip() + "  # legacy-ok\n") == []
    serve = os.path.join("src", "repro_torch", "launch", "stencil_serve.py")
    assert _errors(lint_source(serve, "d = DistributedStencil(p)\n")) \
        == ["RP301"]


def test_audit_contract():
    assert audit(ROOT) == []
    bad = audit(os.path.join(ROOT, "does-not-exist"))
    assert bad and all("does not exist" in line for line in bad)


_TIMED = ("import time\n"
          "def bench(cs, g):\n"
          "    t0 = time.perf_counter()\n"
          "    out = cs.run(g)\n"
          "{sync}"
          "    return time.perf_counter() - t0\n")


@pytest.mark.parametrize("sync,flagged", [
    ("", True),
    ("    torch.cuda.synchronize()\n", False),
    ("    end.synchronize()\n", False),
    ("    ms = start.elapsed_time(end)\n", False),
    ("    jax.block_until_ready(out)\n", True),
])
def test_rp302_timing_without_a_device_sync(sync, flagged):
    diags = lint_source("bench.py", _TIMED.format(sync=sync))
    assert _errors(diags) == (["RP302"] if flagged else [])
    if flagged:
        assert diags[0].line == 4
        opted = _TIMED.format(sync=sync).replace(
            "out = cs.run(g)", "out = cs.run(g)  # lint-ok: RP302")
        assert lint_source("bench.py", opted) == []


@pytest.mark.parametrize("call", [
    "lib = ctypes.CDLL('x.so')",
    "lib = ctypes.cdll.LoadLibrary('x.so')",
    "lib = build.load('wrap_halo.cu')",
    "cuda.WRAP_HALO(0, dtype='float32')",
    "cuda.PADDED_SUPERSTEP(0, dtype='float32')",
    "cuda.KERNELS['superstep'](0, dtype='float32')",
    "k = cuda.Kernel('a.cu', 'a_launch', [])",
])
def test_rp303_launches_outside_kernels(call):
    src = f"def f():\n    {call}\n"
    for where in (os.path.join("src", "repro_torch", "models", "x.py"),
                  os.path.join("tests", "test_x.py"), "chip_smoke.py"):
        diags = lint_source(where, src)
        assert _errors(diags) == ["RP303"] and diags[0].line == 2
    # the kernels package is the sanctioned home
    assert lint_source(KERNELS, src) == []
    assert lint_source("x.py", src.replace(
        f"{call}\n", f"{call}  # lint-ok: RP303\n")) == []


def test_rp303_launchers_are_the_kernel_objects():
    objects = {name for name, v in vars(cuda).items()
               if isinstance(v, cuda.Kernel)}
    assert set(rules.LAUNCHERS) == objects


#: the header of the RP304 snippets: a parameter holds a tensor when it is
#: annotated ``torch.Tensor`` (the launch path annotates every one)
TENSOR = "import torch\nfrom torch import Tensor\n"


@pytest.mark.parametrize("body,line", [
    ("def f(grid: Tensor):\n    if grid.sum() > 0:\n        return 1\n", 2),
    ("def f(grid: Tensor):\n    y = grid * 2\n    while (y > 1).any():\n"
     "        y = y / 2\n", 3),
    ("def f(grid: Tensor):\n    return 1 if grid.max() else 2\n", 2),
    ("def f(src: Tensor, dst: Tensor):\n    v = src + dst\n"
     "    return v.item()\n", 3),
    ("def f(taps: Tensor):\n    return taps.tolist()\n", 2),
    ("def f(x: torch.Tensor):\n    return bool(x)\n", 2),
    ("def f(center: Optional[Tensor]):\n    return float(center)\n", 2),
    ("def f(*ops: Tensor):\n    return ops[0].item()\n", 2),
    ("def f(n):\n    z = torch.zeros(n, device='cuda')\n"
     "    return z.tolist()\n", 3),
    ("def f(src: Tensor, dst: Tensor):\n    if torch.equal(src, dst):\n"
     "        return 1\n", 2),
])
def test_rp304_device_sync_in_the_launch_path(body, line):
    body, line = TENSOR + body, line + 2
    diags = lint_source(KERNELS, body)
    assert _errors(diags) == ["RP304"] and diags[0].line == line
    # outside the launch path the rule stays silent
    assert lint_source(os.path.join("src", "repro_torch", "launch", "x.py"),
                       body) == []
    lines = body.splitlines()
    lines[line - 1] += "  # lint-ok: RP304"
    assert lint_source(KERNELS, "\n".join(lines) + "\n") == []


@pytest.mark.parametrize("body", [
    "def f(grid: Tensor):\n"
    "    if grid.shape[0] > 1 and grid.device.type == 'cuda':\n"
    "        return grid.numel()\n",
    "def f(grid: Tensor, n):\n    if grid is None or len(grid) > n:\n"
    "        return 0\n",
    "def f(src: Tensor, v):\n"
    "    return torch.tensor(v, dtype=src.dtype).item()\n",
    "def f(grid: Tensor):\n    if _on_cuda(grid):\n        return 1\n",
    "def f(src: Tensor):\n"
    "    if src.is_contiguous() and src.data_ptr() % 16 == 0:\n"
    "        return 1\n",
    # an unannotated parameter is a host value (the geometry's ints and
    # tuples share the tensors' names)
    "def f(src, steps):\n    if src > 0 and steps:\n        return 1\n",
])
def test_rp304_metadata_and_host_values_are_not_syncs(body):
    assert lint_source(KERNELS, TENSOR + body) == []


def test_rp304_reaches_compiled_run_and_skips_the_host_modules():
    src = ("class CompiledStencil:\n"
           "    def run(self, grid: torch.Tensor, steps=None):\n"
           "        if grid.isnan().any():\n"
           "            raise ValueError('nan')\n")
    path = os.path.join("src", "repro_torch", "executor.py")
    assert _errors(lint_source(path, src)) == ["RP304"]
    body = TENSOR + "def f(src: Tensor):\n    if src > 0:\n        return 1\n"
    host = os.path.join("src", "repro_torch", "kernels", "queued.py")
    assert lint_source(host, body) == []
    assert _errors(lint_source(KERNELS, body)) == ["RP304"]


def test_rp305_honours_legacy_ok_and_signatures():
    diags = lint_source("x.py", "f(grid, pipelined=True)\n")
    assert _codes(diags) == ["RP305"] and diags[0].line == 1
    assert lint_source("x.py", "f(grid, pipelined=True)  # legacy-ok\n") \
        == []
    assert lint_source(
        "x.py", "def f(grid, pipelined=False):\n    return grid\n") == []


def test_lint_paths_counts_through_the_recorder(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("f(g, pipelined=True)\nf(g, pipelined=False)\n")
    with obs.profile() as rec:
        diags = lint_paths([str(tmp_path)])
    assert [(d.code, d.line) for d in diags] == [("RP305", 1), ("RP305", 2)]
    assert rec.counter("lint.code.RP305") == 2
    assert rec.counter("lint.rules.error") == 2


def test_the_port_lints_clean_without_jax(tmp_path):
    """``python -m repro_torch.lint src/repro_torch tests/test_torch_*.py
    chip_smoke.py`` exits 0 in a process where ``import jax`` fails."""
    files = sorted(os.path.join("tests", f)
                   for f in os.listdir(os.path.join(ROOT, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    out = tmp_path / "lint.json"
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "from repro_torch.lint.__main__ import main; "
            "sys.exit(main(sys.argv[1:]))")
    proc = subprocess.run(
        [sys.executable, "-c", code, os.path.join("src", "repro_torch"),
         *files, "chip_smoke.py", "--json", str(out)],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(out.read_text())["errors"] == 0
    assert "OK: 0 errors" in proc.stdout


def test_cli_lists_the_new_codes(capsys):
    assert lint_main(["codes"]) == 0
    listed = {line.split()[0] for line in capsys.readouterr().out.splitlines()}
    assert {"RP114", "RP200", "RP201", "RP202", "RP203", "RP204", "RP300",
            "RP301", "RP302", "RP303", "RP304", "RP305"} <= listed
    assert listed == set(CODES)


# ---- RP2xx: the launch audit on the plain versions --------------------------------

@pytest.mark.parametrize("boundary,kernels", [
    ("clamp", {"padded_superstep"}),
    ("periodic", {"padded_superstep", "wrap_halo"}),
])
def test_audit_of_a_clean_run(boundary, kernels):
    prog, plan = _program(boundary)
    cs = repro_torch.stencil(prog).compile(GRID, steps=5, plan=plan,
                                           device="cpu")
    g = _grid()
    with record_launches() as log:
        out = cs.run(g)
    assert {la.kernel for la in log.launches} == kernels
    assert {la.route for la in log.launches} == {"plain"}
    assert analyze_launches(log.launches, expect_dtype="float32",
                            inputs=(g,), results=(out,)) == []
    # a recording inside another passes its launches on
    with record_launches() as outer:
        _, diags = audit_run(cs.run, g, expect_dtype="float32")
    assert diags == [] and len(outer.launches) == len(log.launches)
    # off again: nothing records
    cs.run(g)
    assert cuda.AUDIT is None


def test_audit_refuses_a_planted_alias():
    """dst = src (RP204) and a dst that overlaps src (RP201)."""
    prog, plan = _program()
    layout = common.ring_schedule(prog, plan, GRID, 2).layout
    P = layout.padded_shape
    n = int(np.prod(P))
    c = prog.default_coeffs()
    src = torch.rand(P)
    with record_launches() as log:
        common.padded_superstep(src, src, c.center, c.taps, program=prog,
                                plan=plan, layout=layout)
    assert _errors(analyze_launches(log.launches)) == ["RP204"]
    big = torch.rand(n + 128)
    a, b = big[:n].view(P), big[128:].view(P)
    with record_launches() as log:
        common.padded_superstep(a, b, c.center, c.taps, program=prog,
                                plan=plan, layout=layout)
    assert _errors(analyze_launches(log.launches)) == ["RP201"]


def test_audit_refuses_a_result_that_is_the_callers_grid():
    prog, plan = _program()
    g = _grid()
    c = prog.default_coeffs()
    out, diags = audit_run(lambda x: x[1:], g)
    assert _errors(diags) == ["RP200", "RP204"]
    # the legacy steps=0 identity hands the caller's grid back, launching
    # nothing: the audit says both
    with pytest.warns(DeprecationWarning):
        out, diags = audit_run(
            lambda x: ops.stencil_run(x, prog, c, plan, 0), g)
    assert out is g and _errors(diags) == ["RP200", "RP204"]


def test_audit_pairs_shapes_dtypes_and_the_callers_grid():
    log = LaunchLog()
    x = torch.zeros(2, 20, 132)
    log.launch("superstep", src=x, dst=torch.zeros(2, 16, 128),
               route="plain")                          # pre-padded: clean
    log.launch("padded_superstep", src=x, dst=torch.zeros(2, 20, 132),
               route="plain")                          # the carry: clean
    log.launch("wrap_halo", src=x, dst=None, route="plain")  # in place
    assert analyze_launches(log.launches) == []
    bad = LaunchLog()
    bad.launch("padded_superstep", src=x, dst=torch.zeros(2, 20, 131))
    bad.launch("padded_superstep", src=x,
               dst=torch.zeros(2, 20, 132, dtype=torch.float16))
    bad.launch("superstep", src=x, dst=torch.zeros(2, 17, 128))
    assert _errors(analyze_launches(bad.launches)) == ["RP201"] * 3
    # a launch that writes the caller's grid
    g = torch.zeros(20, 132)
    writes = LaunchLog()
    writes.launch("padded_superstep", src=torch.zeros(20, 132), dst=g)
    assert _errors(analyze_launches(writes.launches, inputs=(g,))) \
        == ["RP204"]
    assert isinstance(writes.launches[0], Launch)


def test_audit_rp202_float64():
    """A float64 grid through the legacy shim runs the plain versions in
    float64: an error under a float32 expectation, a warning without."""
    prog, plan = _program()
    c = prog.default_coeffs()
    g = _grid(dtype=np.float64)
    with record_launches() as log:
        out = ops._stencil_run(g, prog, c, plan, 3)
    assert out.dtype == torch.float64
    hard = analyze_launches(log.launches, expect_dtype="float32",
                            inputs=(g,), results=(out,))
    assert _errors(hard) == ["RP202"]
    soft = analyze_launches(log.launches, inputs=(g,), results=(out,))
    assert _codes(soft) == ["RP202"] and not _errors(soft)
    assert analyze_launches(log.launches, expect_dtype="float64",
                            inputs=(g,), results=(out,)) == []


def test_trace_budget():
    assert check_trace_budget(0, 0) == []
    diags = check_trace_budget(3, 1, context="steady-state run")
    assert _errors(diags) == ["RP203"]
    assert "steady-state run" in diags[0].message
    # a mapping sums the families only
    assert check_trace_budget({"plan_resolutions": 0, "other": 9}, 0) == []
    assert _errors(check_trace_budget({"library_loads": 1}, 0)) == ["RP203"]
    assert set(common.trace_counts()) >= {
        "library_builds", "library_loads", "wrap_geometry",
        "queued_geometry", "streamed_geometry", "plan_resolutions"}


def test_warm_loop_reads_zero_and_a_compile_per_run_does_not():
    prog, plan = _program("periodic")
    g = _grid()
    cs = repro_torch.stencil(prog).compile(GRID, steps=5, plan=plan,
                                           device="cpu")
    cs.run(g)
    before = common.trace_counts()
    for _ in range(5):
        cs.run(g)
    assert common.trace_delta(before) == {}
    assert check_trace_budget(common.trace_delta(before), 0) == []
    before = common.trace_counts()
    for _ in range(5):
        repro_torch.stencil(prog).compile(GRID, steps=5, plan=plan,
                                          device="cpu").run(g)
    delta = common.trace_delta(before)
    assert delta == {"plan_resolutions": 5}
    assert _errors(check_trace_budget(delta, 0, context="a loop")) \
        == ["RP203"]


def test_cli_audit_on_the_plain_versions(capsys, tmp_path):
    out = tmp_path / "audit.json"
    args = ["audit", "--device", "cpu", "--grid", "20,140", "--block",
            "16,128", "--par-time", "2", "--steps", "5", "--json", str(out)]
    assert lint_main(args) == 0
    assert json.loads(out.read_text()) == []
    text = capsys.readouterr().out
    assert "trace delta {}" in text and "audit of 2D r=1" in text
