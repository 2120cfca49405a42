"""Serving launcher: batched decode with continuous batching; counterpart
of ``repro/launch/serve.py``, with the same flags plus ``--device``.

  python -m repro_torch.launch.serve --arch qwen3_4b --reduced \
      --requests 8 --max-new 16 [--device cuda|cpu]

It runs on the GPU unless ``--device cpu`` is given, and exits 2 without
one. Parameters come from the port's own seeded init on the device.
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
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    cfg = get_config(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(gen, cfg)
    engine = ServeEngine(params, cfg, n_slots=args.slots,
                         max_len=args.max_len, device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        engine.submit(LMRequest(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, plen,
                                       dtype=np.int64),
            max_new_tokens=args.max_new))
    done = engine.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done.values())
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s) on {dev}")
    for rid in sorted(done):
        print(f"  req {rid}: {done[rid].output[:8]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
