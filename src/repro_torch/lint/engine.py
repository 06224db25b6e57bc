"""Drive the RP3xx rules over files and trees; render and count results —
counterpart of ``repro/lint/engine.py``.

:func:`lint_paths` is the library entry the CLI and the tests share: walk
the given files and directories, run :func:`repro_torch.lint.rules.
lint_source` on each ``.py`` file (a file that does not parse yields RP300
and nothing else), count the findings through the flight recorder
(``lint.diagnostics``, ``lint.rules.<severity>``, ``lint.code.<code>``)
and return them sorted by location.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Sequence

from repro_torch.lint.diagnostics import Diagnostic, emit
from repro_torch.lint.rules import lint_source

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", ".ruff_cache",
              "build", "dist"}


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    """Expand files and directories into a deterministic ``.py`` file
    sequence."""
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_paths(paths: Sequence[str]) -> List[Diagnostic]:
    """Every codebase rule over the given files and trees.  A missing path
    is RP300 against the path itself: a renamed tree must not pass
    vacuously."""
    out: List[Diagnostic] = []
    for path in paths:
        if not os.path.exists(path):
            out.append(Diagnostic(
                code="RP300",
                message="path does not exist — a renamed tree must fail "
                        "loudly, not pass vacuously",
                hint="fix the lint invocation", path=path))
    for path in iter_python_files([p for p in paths if os.path.exists(p)]):
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        out.extend(lint_source(path, source))
    out.sort(key=lambda d: (d.path or "", d.line or 0, d.code))
    emit(out, source="rules")
    return out


def to_json(diagnostics: Sequence[Diagnostic]) -> str:
    """A stable JSON document of the findings, errors counted."""
    return json.dumps({
        "diagnostics": [d.to_json() for d in diagnostics],
        "errors": sum(1 for d in diagnostics if d.is_error),
        "total": len(diagnostics),
    }, indent=1)
