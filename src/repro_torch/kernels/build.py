"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
with ``nvcc`` into ``build/repro_torch/<name>-<hash>.so`` under the repo
root; the hash covers the source, every ``csrc`` header it includes, and
the flags, so an edited source or header rebuilds and an unchanged one
loads.  The compiler's output (the ``-Xptxas=-v`` register, shared-memory
and stack report) is kept beside the library as ``<name>-<hash>.log``, so
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
from pathlib import Path
from typing import Dict, Iterable, Tuple

from repro_torch import obs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("queued_superstep.cu", "streamed_superstep.cu", "wrap_halo.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin``, ``PATH``, or the
    toolkit's default install."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


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


def library_path(source: str) -> Path:
    h = hashlib.sha256()
    for name in (source,) + includes(source):
        h.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def log_path(source: str) -> Path:
    return library_path(source).with_suffix(".log")


def build_log(source: str) -> str:
    """The compiler's output for the library of ``source`` as it stands,
    built first if missing."""
    if not log_path(source).exists():
        build([source])
    return log_path(source).read_text(encoding="utf-8")


def build(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library or log is missing, one ``nvcc``
    each, in parallel.  Returns the compiler's output (also kept in
    :func:`log_path`) per source it built; raises on a failure.  With the
    flight recorder on, a build runs inside a ``kernels.build`` span naming
    the sources built (its ``dur_s`` is the build's seconds)."""
    missing = [s for s in sources
               if not (library_path(s).exists() and log_path(s).exists())]
    if not missing:
        return {}
    with obs.span("kernels.build", sources=missing):
        return _build(missing)


def _build(sources) -> Dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for source in sources:
            out = library_path(source)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[source] = (proc, tmp, out)
        logs, failed = {}, []
        for source, (proc, tmp, out) in jobs.items():
            logs[source] = proc.communicate()[0]
            if proc.returncode == 0:
                log = out.with_name(f"{tmp.name}.log")
                log.write_text(logs[source], encoding="utf-8")
                os.replace(tmp, out)
                os.replace(log, out.with_suffix(".log"))
            else:
                failed.append(f"{source}:\n{logs[source]}")
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if missing."""
    lib = _LIBS.get(source)
    if lib is None:
        path = library_path(source)
        if not (path.exists() and log_path(source).exists()):
            build([source])
        lib = _LIBS[source] = ctypes.CDLL(str(path))
    return lib
