"""The port's RP1xx verifier (``repro_torch.lint.verify``) against the
reference's (``repro.lint.verify``), the card's analogues of RP105, RP106
and RP113, the front door's pre-flight (``compile(...).preflight``) and
the ``codes`` command.

Everything here is arithmetic on plans, or a ``device="cpu"`` compile.
"""

import dataclasses

import pytest
import torch

import repro
from repro.analysis.hw import V5E
from repro.core.blocking import BlockPlan as RefPlan
from repro.core.program import StencilProgram as RefProgram
from repro.lint import verify as ref_verify
from repro.lint.diagnostics import DiagnosticError as RefDiagnosticError

import repro_torch
from repro_torch import convert, obs
from repro_torch.analysis.hw import H100_SXM
from repro_torch.core.blocking import (MIN_USEFUL_FRACTION, VARIANTS,
                                       candidate_plans, launch_work)
from repro_torch.kernels import common
from repro_torch.lint import CODES, check, verify
from repro_torch.lint.__main__ import main as lint_main
from repro_torch.lint.diagnostics import DiagnosticError

GRID = (64, 256)


def _both(ndim=2, radius=1, boundary="clamp", block=(16, 128), par_time=2,
          dtype="float32", shape="star"):
    """The same program and plan in both packages."""
    rp = RefProgram(ndim=ndim, radius=radius, shape=shape,
                    boundary=boundary, dtype=dtype)
    rplan = RefPlan(spec=rp, block_shape=block, par_time=par_time)
    tp = convert.program_from_fields(**dataclasses.asdict(rp))
    tplan = convert.plan_from_fields(**dataclasses.asdict(rplan))
    return rp, rplan, tp, tplan


def _errors(diags):
    return [d.code for d in diags if d.is_error]


def _codes(diags):
    return [d.code for d in diags]


# ---- every planner candidate is legal ---------------------------------------


@pytest.mark.parametrize("ndim,grid", [(2, (64, 256)), (3, (16, 32, 256))])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_verify_accepts_every_candidate_plan(ndim, grid, radius):
    """No error for any plan the planner offers: for any step count, and
    for a run of 9 steps among the plans it offers for that run."""
    checked = 0
    for boundary in ("clamp", "periodic"):
        prog = repro_torch.StencilProgram(ndim=ndim, radius=radius,
                                          boundary=boundary)
        for v in VARIANTS:
            for steps in (None, 9):
                for plan in candidate_plans(prog, H100_SXM, max_par_time=8,
                                            variant=v, grid_shape=grid,
                                            steps=steps):
                    diags = verify(prog, plan, grid, H100_SXM, variant=v,
                                   steps=steps)
                    assert not _errors(diags), \
                        [d.describe() for d in diags]
                    checked += 1
    assert checked >= 8


# ---- the error codes agree with the reference's -----------------------------


@pytest.mark.parametrize("case", [
    dict(grid=(64,)),                                   # RP101: rank
    dict(grid=(64, 0)),                                 # RP101: extent
    dict(grid=(64.5, 256)),                             # RP101: not ints
    dict(steps=0),                                      # RP102
    dict(steps=2.5),                                    # RP102
    dict(batch=0),                                      # RP103
    dict(batch=True),                                   # RP103
    dict(block=(0, 128)),                               # RP104
    dict(block=(8, 0)),                                 # RP104
    dict(block=(-4, 128)),                              # RP104
    dict(block=(0, 0), par_time=3),                     # RP104 x2
    dict(dtype="float64"),                              # RP109
    dict(block=(16,)),                                  # RP111
    dict(block=(16, 128, 8)),                           # RP111
    dict(dtype="float64", grid=(64,), steps=0),         # three at once
    dict(),                                             # none
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()) or "clean")
def test_error_codes_match_the_reference(case):
    kw = dict(case)
    grid = kw.pop("grid", GRID)
    steps = kw.pop("steps", None)
    batch = kw.pop("batch", None)
    rp, rplan, tp, tplan = _both(**kw)
    want = ref_verify(rp, rplan, grid, V5E, steps=steps, batch=batch)
    got = verify(tp, tplan, grid, H100_SXM, steps=steps, batch=batch)
    assert _errors(got) == _errors(want)
    if case:
        assert _errors(got)
    for g, w in zip(got, want):
        if g.code == w.code == "RP104":
            assert g.message == w.message     # the reference's message
            assert "lane" not in g.hint and "sublane" not in g.hint


@pytest.mark.parametrize("block", [(0, 128), (8, 0), (-4, 128)])
def test_rp104_at_compile_like_the_reference(block):
    """Before any planning arithmetic: on the CPU, with ``chip=``, with
    every variant; no ``ZeroDivisionError`` is left on the path."""
    rp, rplan, tp, tplan = _both(par_time=1, block=block)
    with pytest.raises(RefDiagnosticError) as want:
        repro.stencil(rp).compile((16, 128), steps=3, plan=rplan,
                                  interpret=True)
    for kw in (dict(), dict(chip=H100_SXM), dict(variant="temporal"),
               dict(variant="pipelined", chip=H100_SXM)):
        with pytest.raises(DiagnosticError) as got:
            repro_torch.stencil(tp).compile((16, 128), steps=3, plan=tplan,
                                            device="cpu", **kw)
        assert [d.code for d in got.value.diagnostics] == \
            [d.code for d in want.value.diagnostics] == ["RP104"]
        assert got.value.diagnostics[0].message == \
            want.value.diagnostics[0].message


# ---- the card's analogues ---------------------------------------------------


def test_rp105_holds_the_kernels_to_the_cards_figures():
    """3D diamond r4 at par_time 8 fits no CTA tile of the H100's
    232448 bytes per block; at 4 it does, and not on a card of a quarter
    of that.  ``chip=None`` skips the check (the plain versions)."""
    prog = repro_torch.StencilProgram(ndim=3, radius=4, shape="diamond")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(32, 64, 704),
                                 par_time=8)
    grid = (6, 8, 40)
    assert "RP105" in _errors(verify(prog, plan, grid, H100_SXM, steps=9))
    assert "RP105" not in _codes(verify(prog, plan, grid, None, steps=9))
    assert "RP105" not in _codes(verify(prog, plan, grid, H100_SXM,
                                        steps=4))
    small = dataclasses.replace(H100_SXM, name="quarter card",
                                smem_optin=H100_SXM.smem_optin // 4)
    found = verify(prog, plan, grid, small, steps=4)
    assert _errors(found) == ["RP105"]
    assert "quarter card" in found[0].message
    with pytest.raises(DiagnosticError, match="RP105"):
        check(prog, plan, grid, small, steps=4)


#: The statement each body's 16-byte rule is, in its source.
_RULES = {"queue": ("queued_superstep.cu", "g.bulk = g.s2 % kVecCells"),
          "streamed": ("streamed_superstep.cu",
                       "if (vec) vec = (reinterpret_cast<size_t>(srow + px)"
                       " & 15) == 0;")}


def _rule_line(body):
    """The line of ``body``'s 16-byte rule in its source, as it stands."""
    from repro_torch.kernels import build
    source, needle = _RULES[body]
    lines = (build.CSRC / source).read_text().splitlines()
    (line,) = [i + 1 for i, text in enumerate(lines) if needle in text]
    return line


def test_rp106_names_the_lines_of_the_rules():
    """RP106's message points at each body's rule as the sources stand."""
    from repro_torch.lint.verify import _PITCH_RULES
    for body, (source, _) in _RULES.items():
        assert f"{source}:{_rule_line(body)} " in _PITCH_RULES[body]


@pytest.mark.parametrize("dtype,pitch,fires", [
    ("bfloat16", 8, False), ("bfloat16", 4, True), ("float16", 16, False),
    ("float16", 12, True), ("float32", 4, False), ("float32", 6, True)])
def test_rp106_is_a_16_byte_rule(dtype, pitch, fires):
    """A pitch of 8 cells is clean in 16 bits and 4 warns; in float32 4
    is clean.  Rounded minor extent 256 at radius 1: the pitch past it is
    2H = 2*par_time, so ``pitch`` picks par_time."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1, boundary="clamp",
                                      dtype=dtype)
    plan = repro_torch.BlockPlan(spec=prog, block_shape=GRID,
                                 par_time=pitch // 2)
    found = [d for d in verify(prog, plan, GRID, H100_SXM,
                               steps=2 * plan.par_time) if d.code == "RP106"]
    assert bool(found) == fires
    if fires:
        size = 4 if dtype == "float32" else 2
        assert f"pitch {256 + pitch} cells, {(256 + pitch) * size} bytes" \
            in found[0].message and "16 bytes" in found[0].message


@pytest.mark.parametrize("radius,par_time,fires", [
    (1, 1, True), (1, 2, False), (1, 3, True), (3, 1, True), (2, 1, False),
    (1, 4, False),
])
def test_rp106_at_an_odd_halo_on_the_queue_body(radius, par_time, fires):
    """Rounded minor extent 256: the carry's pitch 256 + 2H is a multiple
    of 4 floats exactly when ``H = par_time * radius`` is even."""
    prog = repro_torch.StencilProgram(ndim=2, radius=radius,
                                      boundary="clamp")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=GRID,
                                 par_time=par_time)
    assert plan.body("padded_superstep") == "queue"
    found = [d for d in verify(prog, plan, GRID, H100_SXM,
                               steps=2 * par_time) if d.code == "RP106"]
    H = par_time * radius
    assert bool(found) == fires == bool(H % 2)
    if fires:
        (d,) = found
        assert not d.is_error
        assert f"pitch {256 + 2 * H}" in d.message and f"H={H}" in d.message
        assert f"queued_superstep.cu:{_rule_line('queue')}" in d.message
        assert "even" in d.hint


def test_rp106_names_the_streamed_bodys_rule_and_reads_the_pitch():
    """The streamed body (a box) has its own rule; an even H with a
    rounded minor extent that is not a multiple of 4 fires too."""
    prog = repro_torch.StencilProgram(ndim=2, radius=1, shape="box",
                                      boundary="clamp")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=GRID, par_time=1)
    (d,) = [d for d in verify(prog, plan, GRID, H100_SXM, steps=2)
            if d.code == "RP106"]
    assert f"streamed_superstep.cu:{_rule_line('streamed')}" in d.message
    star = repro_torch.StencilProgram(ndim=2, radius=1, boundary="clamp")
    odd = repro_torch.BlockPlan(spec=star, block_shape=(64, 150),
                                par_time=2)
    assert "RP106" in _codes(verify(star, odd, (64, 150), H100_SXM,
                                    steps=4))


@pytest.mark.parametrize("ndim,grid,block,par_time,variant", [
    (3, (9, 18, 140), (8, 16, 128), 2, "plain"),
    (3, (9, 18, 140), (8, 16, 128), 2, "pipelined"),
    (3, (20, 18, 140), (8, 16, 128), 2, "plain"),
    (3, (20, 18, 140), (8, 16, 128), 1, "temporal"),
    (3, (40, 40, 140), (8, 16, 128), 1, "temporal"),
    (2, (16, 128), (16, 128), 17, "plain"),
    (2, (16, 128), (8, 128), 2, "plain"),
    (2, (16, 128), (8, 128), 2, "temporal"),
    (2, (37, 150), (16, 128), 2, "pipelined"),
])
def test_rp108_exactly_when_the_schedule_falls_back(ndim, grid, block,
                                                    par_time, variant):
    rp, rplan, tp, tplan = _both(ndim=ndim, radius=2, boundary="periodic",
                                 block=block, par_time=par_time)
    fallback = common.ring_schedule(tp, tplan, grid, 5,
                                    variant=variant).fallback
    got = "RP108" in _codes(verify(tp, tplan, grid, None, variant=variant,
                                   steps=5))
    want = "RP108" in _codes(ref_verify(rp, rplan, grid, V5E,
                                        variant=variant, steps=5))
    assert got == fallback == want
    if got:
        (d,) = [d for d in verify(tp, tplan, grid, None, variant=variant)
                if d.code == "RP108"]
        kernel = "B6" if variant == "pipelined" else "B5"
        assert kernel in d.hint and not d.is_error


def test_rp113_at_a_cta_tile_that_keeps_a_quarter_or_less():
    prog = repro_torch.StencilProgram(ndim=3, radius=4, shape="diamond")
    plan = repro_torch.BlockPlan(spec=prog, block_shape=(32, 64, 704),
                                 par_time=4)
    grid = (6, 8, 40)
    tile, _, _, useful = launch_work(plan, "padded_superstep", H100_SXM)
    assert useful <= MIN_USEFUL_FRACTION
    (d,) = [d for d in verify(prog, plan, grid, H100_SXM, steps=4)
            if d.code == "RP113"]
    assert not d.is_error and str(tile) in d.message
    # the paper's 2D plan keeps most of its work: no warning
    star = repro_torch.StencilProgram(ndim=2, radius=4)
    paper = repro_torch.BlockPlan(spec=star, block_shape=(1024, 1024),
                                  par_time=2)
    assert launch_work(paper, "padded_superstep", H100_SXM)[3] > 0.25
    assert "RP113" not in _codes(verify(star, paper, (2048, 2048),
                                        H100_SXM, steps=9))


# ---- the front door ---------------------------------------------------------


def test_compile_carries_warnings_and_raises_errors():
    prog = repro_torch.StencilProgram(ndim=2, radius=1, boundary="clamp")
    odd = repro_torch.BlockPlan(spec=prog, block_shape=GRID, par_time=1)
    cs = repro_torch.stencil(prog).compile(GRID, steps=3, plan=odd,
                                           device="cpu")
    assert _codes(cs.preflight) == ["RP106"]
    assert cs.sanitize_report is None
    even = dataclasses.replace(odd, par_time=2)
    assert repro_torch.stencil(prog).compile(
        GRID, steps=3, plan=even, device="cpu").preflight == []
    per = repro_torch.StencilProgram(ndim=3, radius=2, boundary="periodic")
    degenerate = repro_torch.BlockPlan(spec=per, block_shape=(8, 16, 128),
                                       par_time=2)
    cs = repro_torch.stencil(per).compile((9, 18, 140), steps=5,
                                          plan=degenerate, device="cpu")
    assert "RP108" in _codes(cs.preflight)
    g = torch.rand((9, 18, 140))
    assert torch.isfinite(cs.run(g)).all()
    p64 = dataclasses.replace(prog, dtype="float64")
    with pytest.raises(DiagnosticError, match="RP109"):
        repro_torch.stencil(p64).compile(
            GRID, steps=3, plan=dataclasses.replace(odd, spec=p64),
            device="cpu")
    with pytest.raises(DiagnosticError, match="RP111"):
        repro_torch.stencil(prog).compile(
            GRID, steps=3, plan=dataclasses.replace(odd, block_shape=(8,)),
            device="cpu")


def test_check_counts_codes_through_the_recorder():
    prog = repro_torch.StencilProgram(ndim=2, radius=1, boundary="clamp")
    odd = repro_torch.BlockPlan(spec=prog, block_shape=GRID, par_time=1)
    bad = dataclasses.replace(odd, block_shape=(0, 128))
    with obs.profile() as rec:
        assert _codes(check(prog, odd, GRID, steps=3)) == ["RP106"]
        with pytest.raises(DiagnosticError, match="RP104"):
            check(prog, bad, GRID, steps=3)
        repro_torch.stencil(prog).compile(GRID, steps=3, plan=odd,
                                          device="cpu")
    assert rec.counter("lint.code.RP106") == 2
    assert rec.counter("lint.code.RP104") == 1
    assert rec.counter("lint.verify.warning") == 2
    assert rec.counter("lint.verify.error") == 1
    assert rec.counter("lint.diagnostics") == 3


def test_codes_command_lists_every_code(capsys):
    assert lint_main(["codes"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == sorted(CODES)
    for line in lines:
        code, severity = line.split()[:2]
        want = "warning" if code in ("RP106", "RP108", "RP113") else "error"
        assert severity == want, line
        assert "fix: " in line
    assert {"RP104", "RP106", "RP107", "RP108", "RP113", "RP401", "RP402",
            "RP403", "RP404", "RP405"} <= set(CODES)
    # the legacy pipelined= bool, the launch audit and the codebase rules
    assert {"RP114", "RP200", "RP201", "RP202", "RP203", "RP204", "RP300",
            "RP301", "RP302", "RP303", "RP304", "RP305"} <= set(CODES)
