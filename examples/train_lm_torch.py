"""End-to-end driver on the H100: train a ~100M-parameter starcoder2-family
model for a few hundred steps with checkpoints, the watchdog and the full
training substrate.

The PyTorch port's counterpart of ``examples/train_lm.py``, through the
port's ``build_run``/``train_loop``.  It imports only torch, numpy and
``repro_torch``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]   # the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""

import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import build_run, train_loop
from repro_torch.models.common import param_count


def config():
    """~100M parameters: the starcoder2 family at width 512, 8 layers."""
    base = get_arch("starcoder2-7b")
    return dataclasses.replace(
        base.reduced(d_model=512, vocab=32768), n_layers=8, d_ff=2048,
        compute_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (the default; RP110 without one) "
                         "or 'cpu'")
    args = ap.parse_args(argv)

    cfg = config()
    with tempfile.TemporaryDirectory(prefix="train_lm_ckpt_") as ckpt_dir:
        run = build_run(cfg, steps=args.steps, lr=6e-4, ckpt_dir=ckpt_dir,
                        device=args.device)
        n = param_count(run.model)
        print(f"[train_lm] {cfg.name}-reduced: {n / 1e6:.1f}M params, "
              f"{cfg.n_layers}L x {cfg.d_model}d, vocab {cfg.vocab}, on "
              f"{run.device}")

        data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=0)
        batch0 = {k: torch.as_tensor(v).to(run.device)
                  for k, v in data.batch(0).items()}
        run.opt_state, run.comp_error, first = run.train_step(
            run.opt_state, run.comp_error, batch0)
        first_ce = float(first["ce"])
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        t0 = time.perf_counter()
        metrics = train_loop(run, data, args.steps, checkpoint_every=50,
                             log_every=20)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        seconds = time.perf_counter() - t0
        kept = run.ckpt.steps()
    print(f"[train_lm] ce: {first_ce:.2f} -> {metrics['ce']:.2f} "
          f"over {args.steps} steps")
    assert metrics["ce"] < first_ce * 0.7, "loss must decrease"
    # the config, the parameter count, the first step's ce, the loop's
    # last metrics and seconds, and the checkpoints kept
    return {"config": cfg, "params": n, "first_ce": first_ce,
            "ce": metrics["ce"], "metrics": metrics, "seconds": seconds,
            "checkpoints": kept}


if __name__ == "__main__":
    main()
