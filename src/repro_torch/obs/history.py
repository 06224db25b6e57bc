"""Accuracy history: a schema-versioned JSONL ledger of model-accuracy
samples — counterpart of ``repro/obs/history.py``.

Every recorded front-door run appends one sample, keyed by the plan
cache's key (``tuning/cache.cache_key``), so samples aggregate per
(program, grid, GPU name, device type, backend@version) as tuned plans
do.  One JSON object per line::

    {"schema": 1, "unix_time": ..., "key": <plan cache key>,
     "backend": ..., "backend_version": ..., "device": "cuda" | "cpu",
     "chip": <GPU name>, "grid_shape": [...], "block_shape": [...],
     "par_time": ..., "predicted_s": ..., "wall_s": ..., "device_s": ...,
     "model_accuracy": ..., "source": "executor.run"}

The file and its environment variable are the port's own, so no TPU
sample lands here and no H100 sample in the reference's ledger.  Appends
are one ``write`` of one line in append mode, so concurrent writers
interleave lines but never corrupt them; readers skip lines that fail to
parse or carry another schema.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import List, Optional

#: Bump when the sample fields change meaning; readers skip other schemas.
SCHEMA_VERSION = 1

ENV_HISTORY_PATH = "REPRO_TORCH_OBS_HISTORY"
#: Beside the built kernels and the plan cache, under the repo's ``build/``
#: (not committed).
DEFAULT_HISTORY_PATH = str(Path(__file__).resolve().parents[3] / "build" /
                           "repro_torch" / "history.jsonl")


def default_history_path() -> Optional[str]:
    """History file the env-driven recorder appends to (None = disabled)."""
    return os.environ.get(ENV_HISTORY_PATH, DEFAULT_HISTORY_PATH) or None


def make_sample(fields: dict) -> dict:
    """Stamp one accuracy sample with schema + wall time."""
    sample = {"schema": SCHEMA_VERSION, "unix_time": int(time.time())}
    sample.update(fields)
    return sample


def append_sample(path: str, sample: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    line = json.dumps(sample, default=str, sort_keys=True) + "\n"
    with open(path, "a") as f:
        f.write(line)


def read_history(path: str, schema: int = SCHEMA_VERSION) -> List[dict]:
    """Every parseable sample of the given schema (missing file -> [])."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    sample = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(sample, dict) and \
                        sample.get("schema") == schema:
                    out.append(sample)
    except FileNotFoundError:
        pass
    return out
