"""Train a small qwen3-family model (4 layers, d 256, float32) for a few
hundred steps on the synthetic pipeline, with checkpointing: kill it
mid-run and rerun to see a bit-exact resume. The port's counterpart of
the reference's ``examples/train_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \
      [--ckpt-dir DIR] [--device cuda|cpu]

It runs on the GPU unless ``--device cpu`` is given, and exits 2 without
one. The same code path trains qwen3-4b at full width:
``python -m repro_torch.launch.train --arch qwen3_4b``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from typing import List, Optional

import torch

from ..configs import get_config
from ..data import SyntheticTokenPipeline
from ..device import resolve_device
from ..models import init_params
from ..train.loop import init_train_state, make_train_step, train_loop


def mini_config():
    """The reference example's qwen3-family miniature."""
    return dataclasses.replace(
        get_config("qwen3_4b"), n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=768, vocab_size=32000,
        dtype="float32")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"train_lm: {e}", file=sys.stderr)
        return 2
    cfg = mini_config()
    print(f"{cfg.name}-mini: {cfg.param_count()/1e6:.1f}M params on {dev}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(init_params(gen, cfg))
    step = make_train_step(cfg, peak_lr=3e-4, warmup=20,
                           total_steps=args.steps)
    pipe = SyntheticTokenPipeline(cfg, global_batch=8, seq_len=128,
                                  process_index=0, process_count=1)
    state = train_loop(state, step, pipe, args.steps,
                       ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=20)
    print(f"finished at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
