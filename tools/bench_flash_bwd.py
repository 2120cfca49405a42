"""Time the attention gradient kernel, and a long-sequence train step,
against another checkout's on one GPU.

    python3 tools/bench_flash_bwd.py [--parent DIR] [--dtype bfloat16]
                                     [--train-seq N] [--train-batch 1]
                                     [--steps 3]
                                     [--arch qwen3_4b [--layers L]] ...

Each measurement runs in a child process that imports one checkout's
``repro_torch`` (this one, or the one at DIR, for example a parent
commit unpacked by ``git archive`` into the gitignored ``build/parent/``,
whose kernels its own ``kernels/build.py`` builds) and prints one JSON
line:
- the gradient (``flash_attention_bwd``, one call: every kernel it
  launches) at each shape of the ``--dtype``'s list: in bfloat16
  (SHAPES) S = T = 4096, 32 heads of 128, causal, qwen3-4b's training
  shape (batch 8 x 128), and recurrentgemma-9b's local attention
  (S = T = 4096, 16 heads of 256, causal, window 2048); in float32
  (SHAPES_F32) S = T = 2048, 32 heads of 128, causal, and
  hubert-xlarge's training shape (4 x 1024, 16 heads of 80, not
  causal). Timed by CUDA events (``chip_smoke.time_ms``), with the
  log-sum-exp of the forward passed where the checkout's forward stores
  one for that type (as training passes it); each kernel's device time
  in one call under the profiler; a hash of the forward's output on
  those inputs, the same in both checkouts when the forward kernel's
  output is bit for bit unchanged; the forward's time a call, without
  the log-sum-exp store and, where the checkout has it, with it; in
  float32 also SDPA's forward and backward on its memory-efficient
  backend (``sdpa_ms``);
- with ``--train-seq N``: each ``--arch`` (qwen3-4b by default; the
  flag repeats) at full width, its depth cut to the ``--layers`` given
  beside it (0: the config's), through ``launch.train``'s code path at
  batch ``--train-batch`` x N for ``--steps`` steps: the median step
  time over steps 2.., tokens/s, peak memory, and the device time by
  kernel kind in one more step under the profiler
  (``chip_smoke.profile_step``'s groups, "attention gradient" among
  them), with its idle share. hubert-xlarge's pipeline feeds float32
  frames, so it trains on the float32 routes whatever ``--dtype`` says.
The children run in turns, parent, this, this, parent: first the
kernel ones, then the train ones. Prints the card's name and power
limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (batch, S = T, heads, head dim, window, causal) by type
SHAPES = [(1, 4096, 32, 128, 0, True), (8, 128, 32, 128, 0, True),
          (1, 4096, 16, 256, 2048, True)]
SHAPES_F32 = [(1, 2048, 32, 128, 0, True), (4, 1024, 16, 80, 0, False)]


def kernel_times(torch, cs, fa, dev, dtype: str) -> list:
    """The gradient's time a call and its kernels' device times at each
    shape of ``dtype``'s list."""
    takes_lse = "lse" in inspect.signature(fa.flash_attention_bwd).parameters
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    out = []
    for B, S, H, hd, win, causal in (SHAPES if dtype == "bfloat16"
                                     else SHAPES_F32):
        q, k, v, do = cs.flash_bwd_inputs(torch, gen, B, S, S, H, hd, dtype,
                                          dev)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        mask = {"window": win, "causal": causal}
        o, kw, stores_lse = fa.flash_attention(qt, kt, vt, **mask), mask, False
        if takes_lse:
            try:  # an older checkout stores no float32 lse
                o, lse = fa.flash_attention(qt, kt, vt, return_lse=True,
                                            **mask)
                kw, stores_lse = {"lse": lse, **mask}, True
            except ValueError:
                pass

        def call():
            return fa.flash_attention_bwd(qt, kt, vt, o, dot, **kw)
        # a CUDA-core route (a checkout before the saved lse, or before
        # the tensor cores took this type or head dim) takes tens of ms
        slow = S >= 2048 and not (stores_lse and fa.bwd_route(
            getattr(torch, dtype), hd) in ("wgmma", "tf32x3"))
        ms = cs.time_ms(torch, call, reps=2 if slow else 20,
                        windows=3 if slow else 5)
        kernels, _, _ = cs.profiled_kernels(torch, call)
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
        digest = hashlib.sha256(o.contiguous().view(torch.uint8).cpu()
                                .numpy().tobytes()).hexdigest()[:16]
        fwd = {"fwd_ms": cs.time_ms(torch, lambda: fa.flash_attention(
            qt, kt, vt, **mask), reps=20, windows=5)}
        if stores_lse:
            fwd["fwd_lse_ms"] = cs.time_ms(torch, lambda: fa.flash_attention(
                qt, kt, vt, return_lse=True, **mask), reps=20, windows=5)
        if dtype == "float32":
            from torch.nn.attention import SDPBackend
            fwd["sdpa_ms"] = cs.sdpa_f32_ms(torch, qt, kt, vt, dot, causal,
                                            SDPBackend.EFFICIENT_ATTENTION)
        out.append({"batch": B, "S": S, "heads": H, "hd": hd, "window": win,
                    "causal": causal, "dtype": dtype, "ms": ms,
                    "saved_lse": stores_lse, "forward_sha256": digest,
                    **fwd,
                    "kernels_ms": {n[:90]: t for n, t in by_name.items()}})
    return out


def train_long(torch, cs, fa, dev, arch: str, layers: int, batch: int,
               seq: int, steps: int) -> dict:
    """``arch`` at full width (``layers`` deep when not 0), ``batch`` x
    ``seq``, through launch.train's code path; then one profiled step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention_bwd.launches = 0
    cfg = (dataclasses.replace(get_config(arch), n_layers=layers)
           if layers else None)
    argv = ["--arch", arch, "--steps", str(steps), "--batch",
            str(batch), "--seq", str(seq), "--device", "cuda"]
    state, step_fn, pipe, hist = cs.train_run(torch, launch_train, dev, argv,
                                              steps, cfg=cfg)
    times = [m["step_time_s"] for m in hist]
    med = statistics.median(times[1:])
    launches = fa.flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    prof = cs.profile_step(torch, step_fn, state, pipe,
                           f"{arch} batch {batch} x {seq}")
    return {"arch": arch, "layers": layers, "batch": batch, "seq": seq,
            "step_times_s": times,
            "median_step_s": med, "tokens_per_s": batch * seq / med,
            "losses": [m["loss"] for m in hist], "peak_gib": peak,
            "bwd_launches": launches, "idle_share": prof["idle"],
            "grad_kernel_ms": prof["groups"].get("attention gradient", 0.0),
            "device_ms_by_kind": prof["groups"]}


def child(args) -> int:
    src = os.path.join(os.path.abspath(args.checkout), "src")
    sys.path.insert(0, src)
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda:0")
    torch.cuda.init()
    res = {"checkout": args.checkout}
    if args.train_seq:
        res["train"] = train_long(torch, cs, fa, dev, args.arch[0],
                                  args.layers[0], args.train_batch,
                                  args.train_seq, args.steps)
    else:
        res["kernel"] = kernel_times(torch, cs, fa, dev, args.dtype)
    print(json.dumps(res), flush=True)
    return 0


def run_child(checkout: str, extra: list) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--checkout",
           checkout, *extra]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in done.stdout.splitlines() if ln.startswith("{")]
    if done.returncode != 0 or not lines:
        raise RuntimeError(f"{checkout}: exit {done.returncode}\n"
                           f"{done.stderr[-3000:]}")
    print(lines[-1], flush=True)
    return json.loads(lines[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout root of the other kernel")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="the kernel shapes' type")
    ap.add_argument("--train-seq", type=int, default=0)
    ap.add_argument("--train-batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--arch", action="append",
                    help="an arch to train (repeatable; qwen3_4b if none)")
    ap.add_argument("--layers", type=int, action="append",
                    help="the depth of the --arch at the same place (0: "
                         "the config's)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--checkout", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.arch = args.arch or ["qwen3_4b"]
    args.layers = args.layers or [0] * len(args.arch)
    if len(args.layers) != len(args.arch):
        ap.error("give --layers once for every --arch, or not at all")
    if args.child:
        return child(args)
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("bench_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    this = ROOT
    order = [args.parent, this, this, args.parent] if args.parent \
        else [this, this]
    shas = {}
    for checkout in order:
        res = run_child(os.path.abspath(checkout), ["--dtype", args.dtype])
        shas.setdefault(json.dumps([r["forward_sha256"]
                                    for r in res["kernel"]]), []).append(
            checkout)
    # the same seeded inputs in every child: one hash set means the
    # forward's output is bit for bit the same in both checkouts
    print(json.dumps({"forward_outputs_bitwise_equal": len(shas) == 1,
                      "forward_sha256": shas}), flush=True)
    if args.train_seq:
        for arch, layers in zip(args.arch, args.layers):
            for checkout in order:
                run_child(os.path.abspath(checkout),
                          ["--train-seq", str(args.train_seq),
                           "--train-batch", str(args.train_batch),
                           "--steps", str(args.steps), "--arch", arch,
                           "--layers", str(layers)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
