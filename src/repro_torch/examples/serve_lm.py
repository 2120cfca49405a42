"""Serving example: the continuous-batching engine over a hybrid model
(RG-LRU + local attention), whose recurrent state and KV caches ride the
same cache; counterpart of ``examples/serve_lm.py``.

  python -m repro_torch.examples.serve_lm [--device cuda|cpu]

The reduced recurrentgemma-9b config on seeded random weights, 4 slots,
10 requests of 4..19 prompt tokens, 12 new each. It runs on the GPU
unless ``--device cpu`` is given, and exits 2 without one.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..api import LMRequest, ServeEngine
from ..configs import get_config
from ..device import resolve_device
from ..models import init_params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve_lm: {e}", file=sys.stderr)
        return 2
    cfg = get_config("recurrentgemma_9b", reduced=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    engine = ServeEngine(init_params(gen, cfg), cfg, n_slots=4, max_len=96,
                         device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for rid in range(10):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 20)))
        engine.submit(LMRequest(rid=rid, prompt=prompt, max_new_tokens=12))
    done = engine.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in done.values())
    print(f"{len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s on {dev})")
    for rid in sorted(done)[:4]:
        print(f"  req {rid}: {done[rid].output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
