"""Serving example on the H100: batched decode with slot-based continuous
batching on a reduced rwkv6 (O(1)-state) model, the architecture class
that makes long-context serving cheap.

The PyTorch port's counterpart of ``examples/serve_lm.py``, through the
port's ``ServeEngine``.  It imports only torch, numpy and
``repro_torch``.

    PYTHONPATH=src python examples/serve_lm_torch.py               # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import transformer

BATCH, CACHE_LEN = 4, 128


def config():
    return get_arch("rwkv6-7b").reduced(d_model=128, vocab=1024)


def requests(cfg):
    """10 requests of a 12-token prompt and 24 new tokens."""
    rng = np.random.RandomState(0)
    return [Request(rid=i, prompt=rng.randint(0, cfg.vocab, size=(12,)),
                    max_new=24)
            for i in range(10)]


def engine(model):
    """The example's engine: 4 slots, a cache of 128, on the model's
    device."""
    return ServeEngine(model, batch=BATCH, cache_len=CACHE_LEN,
                       device=model.device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (the default; RP110 without one) "
                         "or 'cpu'")
    args = ap.parse_args(argv)

    cfg = config()
    model = transformer.build(cfg, device=args.device, seed=0)
    reqs = requests(cfg)
    stats = engine(model).run(reqs)
    print(f"[serve_lm] {len(reqs)} requests, {BATCH} slots (continuous "
          f"batching): {stats['tokens']} tokens in {stats['seconds']:.1f}s "
          f"({stats['tokens_per_s']:.1f} tok/s on {model.device})")
    for r in reqs[:3]:
        print(f"  rid={r.rid}: {r.generated[:10]}…")
    assert all(r.done for r in reqs)
    return {"stats": stats, "requests": reqs}


if __name__ == "__main__":
    main()
