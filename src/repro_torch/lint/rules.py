"""The RP3xx codebase rules on the port: AST checks for its hot-path
foot-guns — counterpart of ``repro/lint/rules.py``, each rule's intent
carried over from JAX to torch and CUDA.

RP300 — a file that does not parse (every other rule needs its AST).
RP301 — the legacy entry points (``StencilEngine``/``ops.stencil_run``/
        ``DistributedStencil`` and their import spellings) in the port's
        user-facing trees (:data:`SCAN`); :func:`audit` is the
        reference's deprecation audit over them.
RP302 — wall-clock timing (two ``time.perf_counter``/``time.time``
        reads) around a ``.run(...)`` with no device synchronisation in
        the same scope: no ``torch.cuda.synchronize``, no event or stream
        ``.synchronize()`` and no ``elapsed_time``.  Kernel launches are
        asynchronous, so such a timer measures the enqueue, not the
        kernels.
RP303 — a library load or a C launcher call outside
        ``src/repro_torch/kernels/``: ``ctypes.CDLL``/``cdll.
        LoadLibrary``, ``build.load(...)``, a ``Kernel(...)`` built, or
        one of ``kernels/cuda.py``'s launchers (:data:`LAUNCHERS`) or a
        ``KERNELS[...]`` entry called.  Every launch goes through the
        wrappers of ``kernels/cuda.py``, so that launch counts, the
        dtype, device and shape checks and the build stay in one place
        (the counterpart of ``pl.pallas_call`` outside ``kernels/``).
RP304 — a hidden device sync per launch in the launch path (every
        function of ``src/repro_torch/kernels/`` but the host geometry
        and build modules (:data:`HOST_MODULES`), and
        ``CompiledStencil.run``/``_dispatch`` of ``executor.py``): a
        Python ``if``/``while``/conditional expression on a tensor's
        value, or ``.item()``/``.tolist()``/``bool()``/``float()``/
        ``int()`` of a tensor.  The static test: a name holds a tensor
        when it is a parameter whose annotation names ``Tensor`` (the
        launch path annotates every tensor parameter so; an
        unannotated one is a host value), or is assigned from an
        expression that uses one's value or from a
        ``torch.<factory>(..., device=...)`` call; a use of its value is
        any use but as the base of a metadata attribute
        (:data:`METADATA`: shape, dtype, device, ``numel()``,
        ``data_ptr()`` ...), an identity test (``is``) or
        ``isinstance``/``len``; in a branch's test, a call of a function
        that is neither a torch op nor a tensor method is checked where
        it is defined.  On the port's own tree this flags nothing and
        misses nothing (``tests/test_torch_lint_rules.py`` plants each
        form).
RP305 — a ``pipelined=`` keyword at a call site (unchanged).

Per-line opt-outs: ``# lint-ok: RP30x`` (or a bare trailing
``# lint-ok``); RP301 and RP305 also honour ``# legacy-ok``.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional, Sequence, Set

from repro_torch.lint.diagnostics import Diagnostic, error

# ---- RP301: legacy entry points ------------------------------------------------

#: call-site patterns of the deprecated entry points, plus the direct-import
#: spellings that would dodge the attribute-call patterns.
LEGACY = (
    "StencilEngine(",
    "ops.stencil_run(",
    "DistributedStencil(",
    "import stencil_run",
    "from repro_torch.core.temporal import",
    "from repro_torch.core.distributed import",
)

#: the port's user-facing trees, which must stay on the front door
#: (relative to the repo root; the shims themselves live elsewhere in
#: ``src/repro_torch``).
SCAN = (
    ("src", "repro_torch", "configs"),
    ("src", "repro_torch", "launch", "stencil_serve.py"),
)

#: per-line opt-out for deliberate shim exercises; must sit on the line.
OPT_OUT = "# legacy-ok"

LINT_OK = "# lint-ok"

#: timing reads whose difference is a wall-clock duration.
_CLOCKS = {"perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns",
           "time"}
#: calls in a scope that make its timing read the device's work.
_SYNCS = {"synchronize", "elapsed_time"}
#: the one tree allowed to load the libraries and call the C launchers.
_KERNELS_TREE = ("src", "repro_torch", "kernels")
#: ``kernels/cuda.py``'s ``Kernel`` objects (a test holds this to them).
LAUNCHERS = ("PADDED_SUPERSTEP", "TEMPORAL_SUPERSTEP", "SUPERSTEP",
             "PADDED_PIPELINED", "PIPELINED_SUPERSTEP",
             "PADDED_SUPERSTEP_SHARDED", "PADDED_PIPELINED_SHARDED",
             "WRAP_HALO")
#: the modules of ``kernels/`` that take no tensor: the launch geometry
#: and the build, host arithmetic on ints and tuples whose parameters
#: share the launchers' names (``src``, ``dst``).
HOST_MODULES = frozenset({"queued.py", "streamed.py", "build.py"})
#: the launch path outside ``kernels/``: (file name, class, methods).
_LAUNCH_METHODS = (("executor.py", "CompiledStencil", ("run", "_dispatch")),)
#: tensor attributes and methods that read metadata, not values.
METADATA = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                      "layout", "numel", "dim", "size", "stride",
                      "is_contiguous", "data_ptr", "element_size",
                      "storage_offset", "untyped_storage", "nbytes",
                      "itemsize"})
#: conversions that copy a tensor's value to the host.
_SYNC_METHODS = {"item", "tolist"}
_SYNC_BUILTINS = {"bool", "float", "int"}
#: builtins whose answer never reads a tensor's values.
_STATIC_BUILTINS = {"isinstance", "len", "type", "id", "hasattr",
                    "callable"}


def audit(root: str) -> List[str]:
    """-> ["path:line: offending source", ...]: the deprecation audit of
    the reference's ``audit`` over the port's :data:`SCAN` trees, with the
    per-line ``# legacy-ok`` opt-out; a missing tree is reported, never
    passed."""
    bad: List[str] = []
    for entry in SCAN:
        top = os.path.join(root, *entry)
        if not os.path.exists(top):
            bad.append(f"{os.path.join(*entry)}: scanned tree does not "
                       f"exist — update SCAN in repro_torch.lint.rules")
            continue
        files = [top] if os.path.isfile(top) else [
            os.path.join(dirpath, fn)
            for dirpath, _, fns in os.walk(top)
            for fn in fns if fn.endswith(".py")]
        for path in sorted(files):
            with open(path, encoding="utf-8") as fh:
                for lineno, line in enumerate(fh, 1):
                    if (any(pat in line for pat in LEGACY)
                            and OPT_OUT not in line):
                        bad.append(f"{os.path.relpath(path, root)}:"
                                   f"{lineno}: {line.strip()}")
    return bad


# ---- shared AST helpers -----------------------------------------------------------

def _attr_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _mentions(node: ast.AST, name: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id == name:
            return True
        if isinstance(n, ast.Attribute) and n.attr == name:
            return True
    return False


def _opted_out(source_lines: Sequence[str], lineno: int, code: str) -> bool:
    if not 1 <= lineno <= len(source_lines):
        return False
    line = source_lines[lineno - 1]
    if f"{LINT_OK}: {code}" in line or line.rstrip().endswith(LINT_OK):
        return True
    return code in ("RP301", "RP305") and OPT_OUT in line


def _is_clock_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _attr_name(node.func) in _CLOCKS
            and (isinstance(node.func, ast.Name)
                 or _mentions(node.func, "time")))


def _in_tree(path: str, tree: Sequence[str]) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return any(tuple(parts[i:i + len(tree)]) == tuple(tree)
               for i in range(len(parts) - len(tree) + 1))


# ---- RP302: timing without a device synchronisation ----------------------------

def _timing_scopes(tree: ast.Module) -> List[tuple]:
    """(clock reads, ``.run(...)`` calls, synchronised) of each function,
    its nested functions included, and of the module body with function
    and class bodies masked (module-level timing is seen, but reads in
    two functions never pair up); one pass over the tree."""
    scopes: List[tuple] = []

    def visit(node: ast.AST) -> tuple:
        clocks, runs, synced = 0, [], False
        for child in ast.iter_child_nodes(node):
            c, r, s = visit(child)
            clocks, runs, synced = clocks + c, runs + r, synced or s
        if isinstance(node, ast.Call):
            clocks += _is_clock_call(node)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "run":
                runs.append(node)
        synced = synced or _attr_name(node) in _SYNCS
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append((clocks, runs, synced))
        return clocks, runs, synced

    body = [visit(stmt) for stmt in tree.body]
    masked = [b for stmt, b in zip(tree.body, body)
              if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                       ast.ClassDef))]
    scopes.append((sum(b[0] for b in masked),
                   [r for b in masked for r in b[1]],
                   any(b[2] for b in masked)))
    return scopes


def _rule_timing(tree: ast.Module, path: str,
                 lines: Sequence[str]) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    seen: Set[int] = set()
    for clocks, runs, synced in _timing_scopes(tree):
        if clocks < 2 or not runs or synced:
            continue
        lineno = min(n.lineno for n in runs)
        if lineno in seen or _opted_out(lines, lineno, "RP302"):
            continue
        seen.add(lineno)
        out.append(error(
            "RP302",
            "wall-clock timing around .run(...) with no device "
            "synchronisation — kernel launches are asynchronous, so this "
            "measures the enqueue, not the kernels",
            hint="torch.cuda.synchronize() (or an event's .synchronize()) "
                 "inside the timed region before the second clock read, "
                 "or time with CUDA events (elapsed_time)",
            path=path, line=lineno))
    return out


# ---- RP303: launches and loads outside kernels/ ----------------------------------

def _launch_call(node: ast.Call) -> Optional[str]:
    """What a call loads or launches directly, or None."""
    f = node.func
    name = _attr_name(f)
    if name == "CDLL" or name == "LoadLibrary":
        return f"{name}(...)"
    if name == "load" and isinstance(f, ast.Attribute) \
            and isinstance(f.value, ast.Name) and f.value.id == "build":
        return "build.load(...)"
    if name == "Kernel":
        return "Kernel(...)"
    if name in LAUNCHERS:
        return f"{name}(...)"
    if isinstance(f, ast.Subscript) and _attr_name(f.value) == "KERNELS":
        return "KERNELS[...](...)"
    return None


def _rule_launches(calls: Sequence[ast.Call], path: str,
                   lines: Sequence[str]) -> List[Diagnostic]:
    if _in_tree(path, _KERNELS_TREE):
        return []
    out: List[Diagnostic] = []
    for node in calls:
        what = _launch_call(node)
        if what is None or _opted_out(lines, node.lineno, "RP303"):
            continue
        out.append(error(
            "RP303",
            f"direct {what} outside src/repro_torch/kernels/ — every "
            f"launch goes through kernels/cuda.py's wrappers, so launch "
            f"counts, the dtype, device and shape checks and the build "
            f"stay in one place",
            hint="call (or add) a wrapper in kernels/cuda.py; mark a "
                 "deliberate exception with # lint-ok: RP303",
            path=path, line=node.lineno))
    return out


# ---- RP304: device syncs in the launch path --------------------------------------

def _torch_call(f: ast.AST) -> bool:
    """``torch.<op>``, ``torch.<module>.<op>`` or ``F.<op>``."""
    while isinstance(f, ast.Attribute):
        f = f.value
    return isinstance(f, ast.Name) and f.id in ("torch", "F")


def _uses_value(node: ast.AST, tensors: Set[str],
                through_calls: bool = True) -> bool:
    """Whether evaluating ``node`` uses the value of a tensor name.  With
    ``through_calls=False`` (the tests of branches) a call of a function
    that is neither a torch op nor a tensor method is opaque: it is
    checked where it is defined."""
    if isinstance(node, ast.Name):
        return node.id in tensors
    if isinstance(node, ast.Attribute):
        if node.attr in METADATA:
            return False
        return _uses_value(node.value, tensors, through_calls)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in _STATIC_BUILTINS:
            return False
        if not through_calls and isinstance(f, ast.Name) \
                and f.id not in _SYNC_BUILTINS:
            return False
        if isinstance(f, ast.Attribute) and f.attr in METADATA:
            func_reads = False
        elif isinstance(f, ast.Attribute) and not through_calls \
                and not _torch_call(f):
            # a method: reads a value only when called on a tensor
            return _uses_value(f.value, tensors, through_calls)
        else:
            func_reads = _uses_value(f, tensors, through_calls)
        return func_reads or any(
            _uses_value(a, tensors, through_calls)
            for a in list(node.args) + [k.value for k in node.keywords])
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return False
    if isinstance(node, (ast.Lambda, ast.FunctionDef)):
        return False
    return any(_uses_value(c, tensors, through_calls)
               for c in ast.iter_child_nodes(node))


def _bound_names(target: ast.AST) -> Iterable[str]:
    """The names an assignment target binds (not those it subscripts)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for t in target.elts:
            yield from _bound_names(t)
    elif isinstance(target, ast.Starred):
        yield from _bound_names(target.value)


def _makes_device_tensor(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "torch"
            and any(k.arg == "device" for k in node.keywords))


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    """``torch.Tensor``, ``Tensor`` or a type made of one
    (``Optional[torch.Tensor]``)."""
    return ann is not None and _mentions(ann, "Tensor")


def _tensor_names(fn: ast.AST) -> Set[str]:
    """The names of ``fn`` that hold tensors (module docstring), to a
    fixpoint over its assignments."""
    args = fn.args
    params = args.posonlyargs + args.args + args.kwonlyargs + [
        a for a in (args.vararg, args.kwarg) if a is not None]
    names = {a.arg for a in params if _is_tensor_annotation(a.annotation)}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                    and node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, (ast.For, ast.comprehension)):
                targets, value = [node.target], node.iter
            else:
                continue
            if not (_makes_device_tensor(value)
                    or _uses_value(value, names)):
                continue
            for t in targets:
                for n in _bound_names(t):
                    if n not in names:
                        names.add(n)
                        changed = True
    return names


def _launch_functions(tree: ast.Module, path: str) -> List[ast.AST]:
    """The functions of the launch path in this file."""
    if _in_tree(path, _KERNELS_TREE):
        if os.path.basename(path) in HOST_MODULES:
            return []
        return [n for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    base = os.path.basename(path)
    out = []
    for fname, cls, methods in _LAUNCH_METHODS:
        if base != fname or not _in_tree(path, ("repro_torch",)):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name == cls:
                out += [m for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and m.name in methods]
    return out


def _syncs(fn: ast.AST, tensors: Set[str]) -> Iterable[ast.AST]:
    """The nodes of ``fn`` that copy a tensor's value to the host."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if _uses_value(node.test, tensors, through_calls=False):
                yield node
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                    and _uses_value(f.value, tensors):
                yield node
            elif isinstance(f, ast.Name) and f.id in _SYNC_BUILTINS \
                    and any(_uses_value(a, tensors) for a in node.args):
                yield node


def _rule_device_sync(tree: ast.Module, path: str,
                      lines: Sequence[str]) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    seen: Set[int] = set()
    for fn in _launch_functions(tree, path):
        for node in _syncs(fn, _tensor_names(fn)):
            if node.lineno in seen \
                    or _opted_out(lines, node.lineno, "RP304"):
                continue
            seen.add(node.lineno)
            out.append(error(
                "RP304",
                f"a tensor's value read on the host in the launch path "
                f"({fn.name}): "
                f"{ast.get_source_segment(chr(10).join(lines), node) or ''}"
                .split(chr(10))[0][:120],
                hint="the host waits for the device at every launch; "
                     "branch on shapes and Python values, keep tensor "
                     "values on the device",
                path=path, line=node.lineno))
    return out


# ---- RP305: pipelined= at call sites --------------------------------------------

def _rule_pipelined_kw(calls: Sequence[ast.Call], path: str,
                       lines: Sequence[str]) -> List[Diagnostic]:
    """``pipelined=`` keywords at call sites; ``def f(..., pipelined=None)``
    shim signatures stay unflagged."""
    out: List[Diagnostic] = []
    for node in calls:
        for kw in node.keywords:
            if kw.arg != "pipelined":
                continue
            lineno = getattr(kw.value, "lineno", node.lineno)
            if _opted_out(lines, lineno, "RP305") \
                    or _opted_out(lines, node.lineno, "RP305"):
                continue
            out.append(error(
                "RP305",
                "deprecated pipelined= keyword at a call site — the "
                "stencil API takes variant='plain'|'pipelined'|'temporal' "
                "now, and the bool survives only as a DeprecationWarning "
                "shim",
                hint="pass variant='pipelined' (or drop the argument for "
                     "the plain kernel); shim-pinning tests mark the "
                     "line # legacy-ok",
                path=path, line=node.lineno))
    return out


def _rule_legacy(path: str, lines: Sequence[str]) -> List[Diagnostic]:
    if not any(_in_tree(path, entry) for entry in SCAN):
        return []
    out: List[Diagnostic] = []
    for lineno, line in enumerate(lines, 1):
        if any(pat in line for pat in LEGACY) \
                and not _opted_out(lines, lineno, "RP301"):
            out.append(error(
                "RP301",
                f"legacy stencil entry point outside the shims: "
                f"{line.strip()}",
                hint="migrate to repro_torch.stencil(...).compile(...); "
                     "deliberate shim exercises mark the line "
                     "# legacy-ok",
                path=path, line=lineno))
    return out


def lint_source(path: str, source: str) -> List[Diagnostic]:
    """Every RP3xx rule over one file's source text; RP300 alone when it
    does not parse.  ``path`` is reported as it is and decides the
    path-scoped rules (RP301's trees, RP303's and RP304's kernels
    tree)."""
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [error("RP300", f"file cannot be parsed: {e.msg}",
                      hint="fix the syntax error; no other rule can run "
                           "until the file parses",
                      path=path, line=e.lineno)]
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    out = _rule_legacy(path, lines)
    out += _rule_timing(tree, path, lines)
    out += _rule_launches(calls, path, lines)
    out += _rule_device_sync(tree, path, lines)
    out += _rule_pipelined_kw(calls, path, lines)
    return out
