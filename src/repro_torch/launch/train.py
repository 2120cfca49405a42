"""End-to-end training launcher; counterpart of ``repro/launch/train.py``,
with the same flags plus ``--device``.

  python -m repro_torch.launch.train --arch qwen3_4b --reduced --steps 200 \
      --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cuda|cpu]

It runs on the GPU unless ``--device cpu`` is given, and exits 2 without
one. Parameters come from the port's own seeded init on the device.
Fault tolerance: checkpoint/restore and bit-exact resume through
``train/loop.py`` (kill and rerun the same command to resume).

The state is placed on ``make_host_mesh(model=--model-shards)`` and
trained by ``train.loop``'s step over that mesh: on one process the
mesh is 1 x 1 and every leaf stays a plain tensor. Over more ranks each
rank holds its shards and the moments' parts only (nothing whole is
made beside the seeded init), and the step's compute is split over
"model" (``models/split.py``). Under torchrun
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the
environment) the launcher starts the process group itself, gloo with
``--device cpu`` and nccl on the card (``LOCAL_RANK``'s device), and
the mesh is (world / model, model):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
      --model-shards 2 --device cpu

Each data rank draws its own part of the batch
(``SyntheticTokenPipeline(process_index=data rank, process_count=data
size)``). Without a process group ``--model-shards 2`` fails as the
reference's does: one rank is not divisible by 2.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, List, Optional, Tuple

import torch

from ..configs import get_config
from ..data import SyntheticTokenPipeline
from ..device import resolve_device
from ..models import ArchConfig, init_params
from ..train.loop import (TrainState, init_train_state, make_train_step,
                          train_loop, train_state_shardings)
from .mesh import Mesh, make_host_mesh, mesh_context


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


def start_process_group(device: torch.device) -> bool:
    """Joins the process group torchrun's environment describes (gloo on
    the CPU, nccl on the card), unless one is up or there is none to
    join. Returns whether it started one."""
    dist = torch.distributed
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return True


def setup(args: argparse.Namespace, device: torch.device,
          cfg: Optional[ArchConfig] = None, mesh: Optional[Mesh] = None
          ) -> Tuple[ArchConfig, TrainState, Callable,
                     SyntheticTokenPipeline]:
    """The config, the seeded train state placed on ``mesh`` (by default
    ``make_host_mesh(model=args.model_shards)``: 1 x 1 without a process
    group, plain tensors on ``device``), the train step over that mesh
    and this data rank's token pipeline of a parsed command line;
    ``cfg`` replaces the one ``--arch`` and ``--reduced`` name (a depth
    cut of it, say)."""
    if mesh is None:
        mesh = make_host_mesh(model=args.model_shards)
    if cfg is None:
        cfg = get_config(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(gen, cfg)
    state = init_train_state(params, train_state_shardings(cfg, mesh,
                                                           params))
    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps,
                              warmup=max(args.steps // 20, 5),
                              accum=args.accum, mesh=mesh)
    pipe = SyntheticTokenPipeline(cfg, args.batch, args.seq, seed=args.seed,
                                  process_index=mesh.coordinate("data"),
                                  process_count=mesh.shape["data"])
    return cfg, state, step_fn, pipe


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"train: {e}", file=sys.stderr)
        return 2
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    started = start_process_group(dev)
    try:
        mesh = make_host_mesh(model=args.model_shards)
        cfg, state, step_fn, pipe = setup(args, dev, mesh=mesh)
        print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
              f"device={dev} mesh={mesh.shape}")
        with mesh_context(mesh):
            state = train_loop(state, step_fn, pipe, args.steps,
                               ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every)
        print(f"done at step {int(state.step)}")
    finally:
        if started:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
