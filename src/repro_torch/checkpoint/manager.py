"""Checkpointing: atomic step directories, async save, retention, restore —
counterpart of ``repro/checkpoint/manager.py``.

Layout (the reference's):
    <dir>/step_00001234/
        tree.npz         # flattened leaves, keys = joined tree paths
        meta.json        # step, leaf count, each leaf's dtype
    <dir>/step_00001234.tmp  (renamed into place -> atomicity)

A tree is nested mappings, named tuples (``AdamWState``), lists and
tuples over tensors or numpy arrays; a path joins mapping keys, field
names and indices with ``/``.  ``save`` copies every leaf to host memory
before it returns (a CPU tensor is copied too, so a later in-place
update cannot reach a pending write); an async write runs on a thread
and its error surfaces at the next ``wait``.

bfloat16 has no numpy dtype: such a leaf is stored as its ``uint16``
bits, ``meta.json`` names its dtype, and ``restore`` gives it back bit
for bit.  ``restore`` returns the example tree's structure with CPU
tensors (or on ``device``), or with ``shardings`` (a tree of
``reshard.NamedSharding``) each leaf as a ``reshard.ShardedTensor`` on
its mesh: a checkpoint saved from one mesh restores onto another.  A
``ShardedTensor`` leaf is saved whole.  It reads the reference's
checkpoints too (the same layout, without the dtypes).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) of a tree node, None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, prefix: str = ""):
    """(path, leaf) in the tree's order."""
    kids = _children(tree)
    if kids is None:
        yield prefix[:-1], tree
        return
    for name, child in kids:
        yield from _leaves(child, f"{prefix}{name}/")


def _rebuild(tree, leaves):
    """The structure of ``tree`` with its leaves taken from the iterator
    ``leaves`` in order."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    values = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(tree, dict):
        return type(tree)(zip(tree.keys(), values))
    if hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of a leaf as numpy (bfloat16 as its uint16 bits) and
    the leaf's dtype name."""
    if hasattr(leaf, "full"):                  # a reshard.ShardedTensor
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.array(leaf)
    return a, a.dtype.name


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, blocking: bool = True):
        """Snapshot to host memory synchronously, write asynchronously unless
        blocking=True.  Any in-flight async write is drained first (two
        writers racing on the same step's tmp dir would corrupt it)."""
        self.wait()
        flat, dtypes = {}, {}
        for key, leaf in _leaves(tree):    # device->host copy happens here
            flat[key], dtypes[key] = _host(leaf)
        if blocking:
            self._write(step, flat, dtypes)
        else:
            self._thread = threading.Thread(
                target=self._write_safe, args=(step, flat, dtypes),
                daemon=True)
            self._thread.start()

    def _write_safe(self, step: int, flat, dtypes):
        try:
            self._write(step, flat, dtypes)
        except BaseException as e:   # noqa: BLE001  surfaced on next wait()
            self._last_error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               dtypes: Dict[str, str]):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "tree.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "num_leaves": len(flat),
                       "dtypes": dtypes}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, example_tree: Any, device=None,
                shardings: Any = None) -> Any:
        """The tree saved at ``step``, shaped as ``example_tree`` (whose
        leaves are only read for their paths), each leaf a CPU tensor in
        its saved dtype, or on ``device``; with ``shardings`` (a tree of
        ``NamedSharding`` of the same structure) each leaf placed on its
        mesh as a ``ShardedTensor``."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            dtypes = json.load(f).get("dtypes", {})  # none: the reference's
        with np.load(os.path.join(path, "tree.npz")) as data:
            leaves = [_from_host(data[key], dtypes.get(key, ""))
                      for key, _ in _leaves(example_tree)]
        if device is not None:
            leaves = [t.to(device) for t in leaves]
        tree = _rebuild(example_tree, iter(leaves))
        if shardings is not None:
            from repro_torch.checkpoint.reshard import reshard_tree
            tree = reshard_tree(tree, shardings)
        return tree
