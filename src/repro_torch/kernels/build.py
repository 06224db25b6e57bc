"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
with ``nvcc``, once per grid dtype of :data:`DTYPES` (the element type is
``-DREPRO_DTYPE=<code>``, ``csrc/elem.cuh``), into
``build/repro_torch/<name>-<dtype>-<hash>.so`` under the repo root; the
hash covers the source, every ``csrc`` header it includes, and the flags,
so an edited source or header rebuilds and an unchanged one loads.  The
compiler's output (the ``-Xptxas=-v`` register, shared-memory and stack
report) is kept beside the library as ``<name>-<dtype>-<hash>.log``, so
:func:`build_log` reads it whether or not this process built the library.
:func:`build` starts one ``nvcc`` per missing library, all at once.
Nothing but the sources in the repo and the CUDA toolkit is used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

from repro_torch import obs
from repro_torch.core.program import DTYPES as GRID_DTYPES

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("queued_superstep.cu", "streamed_superstep.cu", "wrap_halo.cu")
#: The grid dtypes (``core/program.DTYPES``): each source builds one
#: library per dtype, its element type ``-DREPRO_DTYPE=<code>``, the code
#: being the dtype's place in that table (``csrc/elem.cuh``).
DTYPES = {name: code for code, name in enumerate(GRID_DTYPES)}
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[Tuple[str, str], ctypes.CDLL] = {}
#: Seconds from the start of this process's last parallel build to the
#: end of each library's ``nvcc``, by ``(source, dtype)``.
BUILD_SECONDS: Dict[Tuple[str, str], float] = {}
#: Libraries built (one ``nvcc`` each) and loaded in this process: what a
#: warm run must never add to (``kernels/common.trace_counts``, RP203).
COUNTS: Dict[str, int] = {"builds": 0, "loads": 0}


def _toolkit(name: str) -> str:
    """Path of the CUDA toolkit's program ``name``: ``$CUDA_HOME/bin``,
    ``PATH``, or the toolkit's default install; "" where there is none."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", name),
                 shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    return ""


def nvcc() -> str:
    """Path of the CUDA compiler (:func:`_toolkit`)."""
    path = _toolkit("nvcc")
    if not path:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def includes(source: str) -> Tuple[str, ...]:
    """The ``csrc`` files that ``source`` includes by ``#include "…"``,
    directly or through another included file, in first-seen order."""
    seen = []
    todo = [source]
    while todo:
        text = (CSRC / todo.pop()).read_text(encoding="utf-8")
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            if name not in seen and (CSRC / name).exists():
                seen.append(name)
                todo.append(name)
    return tuple(seen)


def _flags(dtype: str) -> Tuple[str, ...]:
    if dtype not in DTYPES:
        raise ValueError(f"no kernel library for dtype {dtype!r}: the "
                         f"kernels take {tuple(DTYPES)}")
    return FLAGS + (f"-DREPRO_DTYPE={DTYPES[dtype]}",)


def library_path(source: str, dtype: str = "float32") -> Path:
    h = hashlib.sha256()
    for name in (source,) + includes(source):
        h.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    h.update(" ".join(_flags(dtype)).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{dtype}-{digest}.so"


def log_path(source: str, dtype: str = "float32") -> Path:
    return library_path(source, dtype).with_suffix(".log")


def build_log(source: str, dtype: str = "float32") -> str:
    """The compiler's output for the ``dtype`` library of ``source`` as it
    stands, built first if missing."""
    if not log_path(source, dtype).exists():
        build([source], (dtype,))
    return log_path(source, dtype).read_text(encoding="utf-8")


def build(sources: Iterable[str] = SOURCES,
          dtypes: Iterable[str] = ("float32",)
          ) -> Dict[Tuple[str, str], str]:
    """Compile every (source, dtype) library whose file or log is missing,
    one ``nvcc`` each, all in parallel.  Returns the compiler's output
    (also kept in :func:`log_path`) per ``(source, dtype)`` it built;
    raises on a failure.  With the flight recorder on, a build runs inside
    a ``kernels.build`` span naming the sources and dtypes built (its
    ``dur_s`` is the build's seconds)."""
    missing = [(s, d) for s in sources for d in dtypes
               if not (library_path(s, d).exists()
                       and log_path(s, d).exists())]
    if not missing:
        return {}
    with obs.span("kernels.build",
                  sources=list(dict.fromkeys(s for s, _ in missing)),
                  dtypes=list(dict.fromkeys(d for _, d in missing))):
        return _build(missing)


def _build(libraries) -> Dict[Tuple[str, str], str]:
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    try:
        for source, dtype in libraries:
            out = library_path(source, dtype)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = out.with_name(f"{tmp.name}.log")
            with open(log, "w", encoding="utf-8") as f:
                proc = subprocess.Popen(
                    [compiler, *_flags(dtype), "-o", str(tmp),
                     str(CSRC / source)],
                    stdout=f, stderr=subprocess.STDOUT)
            jobs[source, dtype] = (proc, tmp, out, log)
            COUNTS["builds"] += 1
        waiting = dict(jobs)
        while waiting:
            for key, (proc, _, _, _) in list(waiting.items()):
                if proc.poll() is not None:
                    BUILD_SECONDS[key] = time.perf_counter() - t0
                    del waiting[key]
            if waiting:
                time.sleep(0.05)
        logs, failed = {}, []
        for key, (proc, tmp, out, log) in jobs.items():
            logs[key] = log.read_text(encoding="utf-8")
            if proc.returncode == 0:
                os.replace(tmp, out)
                os.replace(log, out.with_suffix(".log"))
            else:
                log.unlink()
                failed.append(f"{key[0]} ({key[1]}):\n{logs[key]}")
    finally:
        for proc, _, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def cuobjdump() -> str:
    """Path of the toolkit's ``cuobjdump`` (:func:`_toolkit`), or "" where
    the toolkit has none."""
    return _toolkit("cuobjdump")


def sass(path) -> str:
    """The SASS of every kernel in the library at ``path``
    (``cuobjdump -sass``)."""
    tool = cuobjdump()
    if not tool:
        raise RuntimeError("cuobjdump not found beside nvcc")
    return subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout


_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(
    r"^\s*/\*[0-9a-f]+\*/\s+((?:@!?U?P[T0-9]+\s+)?[A-Z][A-Z0-9_.]*.*?);")


def sass_functions(text: str) -> Dict[str, Tuple[str, ...]]:
    """Each kernel's instructions in ``cuobjdump -sass`` output ``text``,
    by mangled name: opcode and operands, without addresses or encodings
    (so two builds compare line by line)."""
    out: Dict[str, list] = {}
    name = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSTRUCTION.match(line)
        if m and name is not None:
            out[name].append(" ".join(m.group(1).split()))
    return {k: tuple(v) for k, v in out.items()}


def kernel_label(mangled: str) -> str:
    """A kernel instantiation's short name from its mangled one, template
    arguments in order: ``queue_kernel<2,4,2,0>`` (its namespace, which
    for an anonymous one carries a hash of the file, left out); a name it
    does not parse comes back as it is."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    ident = rest[m.end():m.end() + int(m.group(1))]
    rest = rest[m.end() + int(m.group(1)):]
    args = re.match(r"I((?:L[a-z]n?\d+E)+)E", rest)
    if not args:
        return ident
    vals = re.findall(r"L[a-z](n?\d+)E", args.group(1))
    return f"{ident}<{','.join(v.replace('n', '-') for v in vals)}>"


#: SASS opcode classes :func:`sass_counts` counts: conversions between
#: float and 16 bits (one cell, or two packed by ``F2FP``), a half widened
#: to float by ``HADD2.F32``, packed 16-bit pair arithmetic (``HFMA2.MMA``
#: too, the pair FMA issued on the other pipe, but not as a move of a
#: constant, ``-RZ, RZ`` sources) and float32 arithmetic.
SASS_CLASSES = ("cvt", "widen", "packed", "fp32")


def sass_class(instruction: str) -> str:
    """The :data:`SASS_CLASSES` entry of one :func:`sass_functions`
    instruction, or "" for none."""
    words = instruction.replace(",", " ").split()
    if words[0].startswith("@"):
        words = words[1:]
    opcode = words[0]
    base = opcode.split(".")[0]
    if opcode.startswith("HADD2.F32"):
        return "widen"
    if base in ("F2F", "F2FP"):
        return "cvt"
    if base in ("HMUL2", "HADD2", "HFMA2"):
        return "" if words[2:4] == ["-RZ", "RZ"] else "packed"
    if base in ("FMUL", "FADD", "FFMA"):
        return "fp32"
    return ""


def sass_counts(instructions) -> Dict[str, int]:
    """Instructions of each :data:`SASS_CLASSES` class in one kernel's
    :func:`sass_functions` entry."""
    counts = dict.fromkeys(SASS_CLASSES, 0)
    for ins in instructions:
        cls = sass_class(ins)
        if cls:
            counts[cls] += 1
    return counts


def load(source: str, dtype: str = "float32") -> ctypes.CDLL:
    """The loaded ``dtype`` library of ``source``, built first if
    missing."""
    lib = _LIBS.get((source, dtype))
    if lib is None:
        path = library_path(source, dtype)
        if not (path.exists() and log_path(source, dtype).exists()):
            build([source], (dtype,))
        lib = _LIBS[source, dtype] = ctypes.CDLL(str(path))
        COUNTS["loads"] += 1
    return lib
