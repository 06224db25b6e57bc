"""Data pipeline: deterministic synthetic LM streams and a prefetching
feed — counterpart of ``repro/data/pipeline.py``.

The numpy code is the reference's, so a batch is bit-equal to its batch
of the same (seed, step): a pure function of both, which is what lets a
run resumed from a checkpoint at step N see the stream an uninterrupted
run saw.  A background thread keeps ``depth`` batches ahead of the
training loop (straggler absorption on the input side).

``MemmapCorpus`` serves fixed-length windows from a flat int32 token file
(``np.memmap``; no copies).  ``Prefetcher``'s batches stay numpy (the
reference's ``sharding=`` has no counterpart): the training loop copies
them to the card, as the reference's loop does with ``jnp.asarray``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Markov-ish synthetic tokens with a learnable structure (next token is
    a deterministic mix of the previous ones), so tiny models show loss
    decreasing — used by examples/train_lm.py."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_codebooks: int = 1
    frontend: Optional[tuple] = None   # (img_tokens, frontend_dim) for VLM

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 100003 + step) % (2**31 - 1))
        shape = (self.global_batch, self.seq_len + 1)
        if self.num_codebooks > 1:
            shape = shape + (self.num_codebooks,)
        toks = rng.randint(0, self.vocab, size=shape).astype(np.int32)
        # inject structure: token[t] depends on token[t-1]
        mix = (toks[:, :-1] * 31 + 7) % self.vocab
        keep = rng.rand(*mix.shape) < 0.15
        toks[:, 1:] = np.where(keep, toks[:, 1:], mix)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend is not None:
            t, d = self.frontend
            out["frontend_embeds"] = rng.randn(
                self.global_batch, t, d).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class MemmapCorpus:
    path: str
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 99991 + step) % (2**31 - 1))
        n = len(self._data) - self.seq_len - 1
        starts = rng.randint(0, n, size=self.global_batch)
        toks = np.stack([self._data[s: s + self.seq_len + 1] for s in starts])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class Prefetcher:
    """Background thread filling a bounded queue of upcoming batches,
    ``(step, batch)`` in step order from ``start_step``."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch(step)
            try:
                self._q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
