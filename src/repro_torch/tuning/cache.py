"""Persistent plan cache — counterpart of ``repro/tuning/cache.py``.

A JSON file of tuned plans, so the front door's ``plan="auto"`` and the
configs get the winning (block_shape, par_time, backend) with no search.
A record is addressed by the sha1 of:

* the program fingerprint (every ``StencilProgram`` field);
* the grid shape;
* the GPU's name (``GpuChip.name``: the visible card's, e.g. ``NVIDIA
  H100 80GB HBM3``, or ``H100_SXM``'s when planning on the CPU) and the
  device type the plan was tuned on, so that a CPU measurement never
  serves a card;
* the backend name and registry version, and the variant request;
* the decomposition request, on a mesh only: shards per axis, or
  ``"ndev=N"`` for a search over N devices (a plan tuned for one mesh
  never serves another, nor one device);
* :data:`SCHEMA_VERSION` of this tuner.

The file, its environment variable and its schema are the port's own:
TPU plans and plan caches never serve the port.  Writes are atomic (a
temporary file and ``os.replace``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.core.program import StencilProgram

# 1: the H100 model (par_time, variant and body priced by the bodies'
#    own costs), plans from the port's space.
SCHEMA_VERSION = 1

ENV_CACHE_PATH = "REPRO_TORCH_TUNING_CACHE"
#: Beside the built kernels, under the repo's ``build/`` (not committed).
DEFAULT_PATH = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch" / "plans.json"


def default_cache_path() -> str:
    return os.path.expanduser(os.environ.get(ENV_CACHE_PATH,
                                             str(DEFAULT_PATH)))


def program_fingerprint(program: StencilProgram) -> str:
    """Canonical digest of every program field (order-independent)."""
    payload = json.dumps(dataclasses.asdict(program), sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()


def cache_key(program: StencilProgram, grid_shape: Tuple[int, ...],
              chip_name: str, backend: str, backend_version: int,
              variant: Optional[str] = None, device: str = "cuda",
              decomp: Optional[object] = None) -> str:
    """``variant`` is the request (None: the backend as named, "auto":
    every sibling searched, or a variant name); ``device`` the device
    type the tuner measured on ("cuda" or "cpu"); ``decomp`` the mesh
    request (None: one device, whose keys it leaves as they were)."""
    fields = {
        "program": program_fingerprint(program),
        "grid_shape": list(grid_shape),
        "chip": chip_name,
        "device": device,
        "backend": backend,
        "backend_version": backend_version,
        "variant": variant,
        "schema": SCHEMA_VERSION,
    }
    if decomp is not None:
        fields["decomp"] = list(decomp) \
            if isinstance(decomp, (tuple, list)) else decomp
    payload = json.dumps(fields, sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()


class PlanCache:
    """``{key: [record, ...]}`` in one JSON file; records are the plain
    dicts of ``TunedPlan.to_record``, one per search bounds."""

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.expanduser(path) if path else default_cache_path()

    def _load(self) -> Dict[str, list]:
        try:
            with open(self.path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _store(self, data: Dict[str, list]) -> None:
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".plans-", suffix=".json", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key: str) -> Optional[dict]:
        """The most recently added record under ``key``, or None."""
        records = self.get_all(key)
        return records[-1] if records else None

    def get_all(self, key: str) -> list:
        """Every record under ``key``."""
        v = self._load().get(key)
        if v is None:
            return []
        return list(v) if isinstance(v, list) else [v]

    def put(self, key: str, record: dict) -> None:
        """Replace every record under ``key`` with ``record``."""
        data = self._load()
        data[key] = [record]
        self._store(data)

    def add(self, key: str, record: dict) -> None:
        """Append a record under ``key``, replacing one with the same
        ``search`` bounds."""
        data = self._load()
        records = [r for r in self.get_all(key)
                   if r.get("search") != record.get("search")]
        records.append(record)
        data[key] = records
        self._store(data)

    def entries(self) -> Dict[str, list]:
        return self._load()

    def clear(self) -> int:
        """Delete the cache file; returns how many records it held."""
        n = len(self)
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        return n

    def __len__(self) -> int:
        return sum(len(v) if isinstance(v, list) else 1
                   for v in self._load().values())
