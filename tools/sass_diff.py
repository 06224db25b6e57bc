"""Whether this tree's CUDA kernels compile to the same SASS as another
checkout's, instantiation by instantiation, on a machine with the CUDA
toolkit (``nvcc``, ``cuobjdump``).

Builds this tree's libraries (``repro_torch.kernels.build``) in the dtypes
asked for, compiles the other checkout's sources with the same flags, and
prints for each library how many instantiations have the same SASS
instruction for instruction (``build.sass_functions``, keyed by
``build.kernel_label``) and which differ.  Exits 1 when one differs or is
in one tree only:

    python3 tools/sass_diff.py build/parent            # float32
    python3 tools/sass_diff.py build/parent --dtypes float32,bfloat16

Run from the repo root; ROOT is a checkout (``git archive`` of another
commit) whose libraries go under ``build/sass_diff/``.  The SASS counts
of the 16-bit instantiations are ``chip_smoke.py``'s (``ptxas_report``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402


def build_other(csrc: Path, out_dir: Path, dtypes) -> dict:
    """The libraries of another ``csrc`` directory, with this build's
    flags, one ``nvcc`` each in parallel: path by (source, dtype)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in build.SOURCES:
        for dtype in dtypes:
            out = out_dir / f"{Path(source).stem}-{dtype}.so"
            jobs[source, dtype] = (subprocess.Popen(
                [build.nvcc(), *build._flags(dtype), "-o", str(out),
                 str(csrc / source)],
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT), out)
    failed = [f"{s} ({d})" for (s, d), (proc, _) in jobs.items()
              if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed for {csrc}: {', '.join(failed)}")
    return {key: out for key, (_, out) in jobs.items()}


def by_label(path) -> dict:
    """:func:`build.sass_functions` of a library, by kernel label."""
    return {build.kernel_label(k): v
            for k, v in build.sass_functions(build.sass(path)).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another checkout whose sources to "
                                  "compare with")
    ap.add_argument("--dtypes", default="float32")
    args = ap.parse_args(argv)
    dtypes = tuple(args.dtypes.split(","))
    build.build(dtypes=dtypes)
    other = build_other(
        Path(args.other) / "src" / "repro_torch" / "kernels" / "csrc",
        ROOT / "build" / "sass_diff", dtypes)
    same_everywhere = True
    for (source, dtype), path in other.items():
        mine = by_label(build.library_path(source, dtype))
        theirs = by_label(path)
        differ = sorted(k for k in mine
                        if k in theirs and theirs[k] != mine[k])
        only = sorted(set(mine) ^ set(theirs))
        same_everywhere &= not differ and not only
        n_same = len(set(mine) & set(theirs)) - len(differ)
        print(f"{source} ({dtype}): {n_same} "
              f"of {len(mine)} instantiations the same SASS; differ: "
              f"{differ or 'none'}; in one tree only: {only or 'none'}")
    print(f"all compared instantiations the same: {same_everywhere}")
    return 0 if same_everywhere else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
