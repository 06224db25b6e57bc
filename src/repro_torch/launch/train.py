"""Training launcher — counterpart of ``repro/launch/train.py``.

Gradient accumulation, compression, async checkpointing with
auto-resume and the straggler watchdog, on one CUDA card (RP110 without
one) or, when asked, on the CPU.  A mesh (``mesh=``/``rules=``, the
reference's logical-axis shardings) is refused (:data:`MESH_REFUSAL`):
sharded SPMD training needs a partitioner that one process does not
have.  Placing a tree on a mesh is ported (``checkpoint.reshard``).

Usage (reduced run on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
        --reduced --steps 50 --batch 8 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.models import common, transformer
from repro_torch.optim import AdamW, GradCompression, WarmupCosine
from repro_torch.runtime.fault import StepWatchdog
from repro_torch.runtime.trainer import make_train_step


@dataclasses.dataclass
class TrainRun:
    """Bundles everything a (re)startable training run needs.  ``params``
    are the model's own parameters by name, which ``train_step`` updates
    in place."""

    model: transformer.LMModel
    optimizer: AdamW
    compression: GradCompression
    train_step: Any
    params: Dict[str, torch.Tensor]
    opt_state: Any
    comp_error: Any
    ckpt: Optional[CheckpointManager]
    watchdog: StepWatchdog
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.model.device

    def state_tree(self):
        tree = {"params": self.params, "opt": self.opt_state}
        if self.comp_error is not None:
            tree["comp_error"] = self.comp_error
        return tree

    def load_state_tree(self, tree):
        """Copy a restored tree (``CheckpointManager.restore``) into the
        run's parameters, step, moments and error, in place."""
        with torch.no_grad():
            _copy_into(self.state_tree(), tree)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            _copy_into(v, src[k])
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


#: why ``mesh=``/``rules=`` are refused, and what exists instead
MESH_REFUSAL = (
    "repro_torch trains on one device: sharded SPMD training (mesh=, "
    "rules=) needs a partitioner that one process does not have; to lay "
    "a tree on a mesh use checkpoint.shardings_from_specs and "
    "reshard_tree, or CheckpointManager.restore(shardings=)")


def build_run(cfg, *, steps: int, lr: float = 3e-4, accum: int = 1,
              compression: str = "none", ckpt_dir: Optional[str] = None,
              seed: int = 0, mesh=None, rules=None, device=None) -> TrainRun:
    """A training run of ``cfg`` on ``device`` (None: the card), its
    weights drawn there from ``seed``."""
    if mesh is not None or rules is not None:
        raise ValueError(MESH_REFUSAL)
    model = transformer.build(cfg, device=device, seed=seed, train=True)
    optimizer = AdamW(schedule=WarmupCosine(peak_lr=lr, warmup_steps=min(
        100, steps // 10 + 1), total_steps=steps),
        moment_dtype=cfg.moment_dtype)
    comp = GradCompression(compression)

    params = dict(model.named_parameters())
    opt_state = optimizer.init(params)
    comp_error = comp.init_error(params) if compression != "none" else None
    step_fn = make_train_step(model, optimizer, accum=accum, compression=comp)

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    return TrainRun(model=model, optimizer=optimizer, compression=comp,
                    train_step=step_fn, params=params, opt_state=opt_state,
                    comp_error=comp_error, ckpt=ckpt,
                    watchdog=StepWatchdog())


def train_loop(run: TrainRun, data, steps: int, *, checkpoint_every: int = 100,
               log_every: int = 10, resume: bool = True, mesh=None,
               rules=None, quiet: bool = False) -> Dict[str, float]:
    if mesh is not None or rules is not None:
        raise ValueError(MESH_REFUSAL)
    start = 0
    if run.ckpt is not None and resume:
        latest = run.ckpt.latest_step()
        if latest is not None:
            tree = run.ckpt.restore(latest, run.state_tree())
            run.load_state_tree(tree)
            start = latest
            if not quiet:
                print(f"[train] resumed from step {start}")

    prefetch = Prefetcher(data, start_step=start)
    last_metrics: Dict[str, float] = {}
    try:
        for step in range(start, steps):
            t0 = time.monotonic()
            _, batch = prefetch.next()
            batch = {k: torch.as_tensor(v).to(run.device)
                     for k, v in batch.items()}
            run.opt_state, run.comp_error, metrics = run.train_step(
                run.opt_state, run.comp_error, batch)
            if step % log_every == 0 or step == steps - 1:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                if not quiet:
                    print(f"[train] step={step} "
                          + " ".join(f"{k}={v:.4f}"
                                     for k, v in last_metrics.items()))
            dt = time.monotonic() - t0
            if run.watchdog.observe(step, dt) and run.ckpt is not None:
                run.ckpt.save(step + 1, run.state_tree(), blocking=False)
            if run.ckpt is not None and (step + 1) % checkpoint_every == 0:
                run.ckpt.save(step + 1, run.state_tree(), blocking=False)
        if run.ckpt is not None:
            run.ckpt.save(steps, run.state_tree(), blocking=True)
    finally:
        prefetch.close()
    run.step = steps
    return last_metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (RP110 without one) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    run = build_run(cfg, steps=args.steps, lr=args.lr, accum=args.accum,
                    compression=args.compression, ckpt_dir=args.ckpt_dir,
                    seed=args.seed, device=args.device)
    n = common.param_count(run.model)
    print(f"[train] arch={cfg.name} device={run.device} params={n:,}")
    data = SyntheticLM(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        num_codebooks=cfg.num_codebooks,
        frontend=(cfg.img_tokens, cfg.frontend_dim) if cfg.frontend_dim
        else None,
        seed=args.seed)
    metrics = train_loop(run, data, args.steps)
    print(f"[train] done: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
