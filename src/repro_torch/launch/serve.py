"""Serving launcher: slot-based continuous batching with greedy decode —
counterpart of ``repro/launch/serve.py``.

The engine keeps a fixed pool of ``batch`` decode slots; finished
requests free their slot and the next queued request is prefilled into
it, token by token through the one decode step (every slot advances on
each call, as in the reference).  The slot semantics are the
reference's, exactly, two of its behaviours included (ROADMAP C):

* a refilled slot starts again at position 0 in the same cache, and
  decode attends up to the largest position in the cache, so the
  previous request's entries at later positions stay visible;
* the prefill never sets the slot's token, so each request's first
  decode feeds the slot's previous token (0 at start) at position
  ``len(prompt)``, and the prefill's last logits are dropped.

The same holds for recurrent state (RWKV, Mamba): every slot advances on
each prompt token of another slot's prefill, re-reading its current
token, and a refilled slot starts from the previous request's state,
which nothing resets.  Every architecture serves but musicgen's
``num_codebooks > 1``: the reference's engine feeds (B, 1) tokens where
its ``decode_step`` needs (B, 1, K) and fails in ``decode_attention``
(ROADMAP C), so this engine refuses such a model before any step.

Where this differs from the reference: the engine takes a port model (it
holds its weights) on ``device`` (None: the card, RP110 without one;
``"cpu"`` runs there) and decodes into its caches in place.

Usage (on the card; ``--device cpu --reduced`` runs anywhere; ``--arch``
takes any name of ``repro_torch.configs.ARCHS``):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --requests 8 --batch 4 --prompt-len 16 --gen-len 16
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.executor import _resolve_device
from repro_torch.models import transformer
from repro_torch.runtime.trainer import make_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Slot-based batched decoder over ``model``."""

    def __init__(self, model: transformer.LMModel, batch: int,
                 cache_len: int, device=None):
        self.device = _resolve_device(device)
        if model.cfg.num_codebooks > 1:
            raise ValueError(
                f"{model.cfg.name}: the slot engine feeds (batch, 1) tokens "
                f"and num_codebooks = {model.cfg.num_codebooks} needs "
                f"(batch, 1, {model.cfg.num_codebooks}); the reference's "
                f"engine fails there too (TypeError: cannot reshape in "
                f"decode_attention), so codebooks are not served (drive "
                f"LMModel.decode_step with (batch, 1, K) tokens)")
        if model.device != self.device:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"on {self.device}")
        self.cfg = model.cfg
        self.model = model
        self.batch = batch
        self.cache_len = cache_len
        self.caches = model.init_caches(batch, cache_len)
        self.decode = make_decode_step(model)
        self.slot_req: List[Optional[Request]] = [None] * batch
        self.slot_pos = np.zeros((batch,), np.int32)
        self.tokens = np.zeros((batch,), np.int32)

    def _column(self, values: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(values.reshape(self.batch, 1)).to(
            self.device)

    def _prefill_slot(self, slot: int, req: Request):
        """Feed the prompt token by token through the decode step."""
        for t, tok in enumerate(req.prompt):
            self._step_slot(slot, int(tok), t)
        self.slot_pos[slot] = len(req.prompt)
        self.slot_req[slot] = req

    def _step_slot(self, slot: int, token: int, pos: int):
        toks = self.tokens.copy()
        toks[slot] = token
        poss = self.slot_pos.copy()
        poss[slot] = pos
        logits, self.caches = self.decode(self.caches, self._column(toks),
                                          self._column(poss))
        return logits

    def run(self, requests: List[Request]):
        pending = list(requests)
        active = 0
        t0 = time.monotonic()
        decoded_tokens = 0

        # fill slots
        for slot in range(self.batch):
            if pending:
                self._prefill_slot(slot, pending.pop(0))
                active += 1

        while active > 0:
            logits, self.caches = self.decode(
                self.caches, self._column(self.tokens),
                self._column(self.slot_pos))
            nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()      # (B,)
            for slot in range(self.batch):
                req = self.slot_req[slot]
                if req is None or req.done:
                    continue
                tok = int(nxt[slot])
                req.generated.append(tok)
                decoded_tokens += 1
                self.tokens[slot] = tok
                self.slot_pos[slot] += 1
                if (len(req.generated) >= req.max_new
                        or self.slot_pos[slot] >= self.cache_len - 1):
                    req.done = True
                    active -= 1
                    if pending:
                        self.slot_pos[slot] = 0
                        self._prefill_slot(slot, pending.pop(0))
                        active += 1
        dt = time.monotonic() - t0
        return {"tokens": decoded_tokens, "seconds": dt,
                "tokens_per_s": decoded_tokens / max(dt, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (RP110 without one) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the prompts")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = transformer.build(cfg, device=args.device, seed=args.seed)
    engine = ServeEngine(model, args.batch, args.cache_len,
                         device=model.device)
    rng = np.random.RandomState(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab, size=(args.prompt_len,)),
                    max_new=args.gen_len)
            for i in range(args.requests)]
    stats = engine.run(reqs)
    print(f"[serve] arch={cfg.name} device={model.device} {stats}")
    for r in reqs[:2]:
        print(f"[serve] rid={r.rid} generated={r.generated[:8]}...")
    return stats


if __name__ == "__main__":
    main()
