"""End-to-end training launcher; counterpart of ``repro/launch/train.py``,
with the same flags plus ``--device``.

  python -m repro_torch.launch.train --arch qwen3_4b --reduced --steps 200 \
      --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cuda|cpu]

It runs on the GPU unless ``--device cpu`` is given, and exits 2 without
one. Parameters come from the port's own seeded init on the device.
Fault tolerance: checkpoint/restore and bit-exact resume through
``train/loop.py`` (kill and rerun the same command to resume). One
process on one device: ``--model-shards`` above 1 (training over the
mesh's model axis) is ROADMAP Queue 1 item 13h, part 3.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional, Tuple

import torch

from ..configs import get_config
from ..data import SyntheticTokenPipeline
from ..device import resolve_device
from ..models import ArchConfig, init_params
from ..train.loop import (TrainState, init_train_state, make_train_step,
                          train_loop)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, device: torch.device,
          cfg: Optional[ArchConfig] = None
          ) -> Tuple[ArchConfig, TrainState, Callable,
                     SyntheticTokenPipeline]:
    """The config, the seeded train state on ``device``, the train step
    and the token pipeline of a parsed command line; ``cfg`` replaces
    the one ``--arch`` and ``--reduced`` name (a depth cut of it, say)."""
    if args.model_shards > 1:
        raise NotImplementedError(
            f"--model-shards {args.model_shards}: training over a model "
            "axis (the parameters placed by parallel.sharding on "
            "launch.mesh's mesh) is not ported yet: ROADMAP Queue 1 item "
            "13h, part 3")
    if cfg is None:
        cfg = get_config(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = init_train_state(init_params(gen, cfg))
    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps,
                              warmup=max(args.steps // 20, 5),
                              accum=args.accum)
    pipe = SyntheticTokenPipeline(cfg, args.batch, args.seq, seed=args.seed)
    return cfg, state, step_fn, pipe


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"train: {e}", file=sys.stderr)
        return 2
    cfg, state, step_fn, pipe = setup(args, dev)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={dev}")
    state = train_loop(state, step_fn, pipe, args.steps,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    print(f"done at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
