"""Where the decode-attention and RG-LRU scan kernels spend their time, on
the GPU.

    python3 tools/bench_decode_scan.py [--src DIR]

Prints the card's name and power limit, then:

- the two kernels as the main path calls them, through their wrappers,
  at chip_smoke.py phase 25's qwen3-4b (bf16, int8) and recurrentgemma
  ring shapes and phase 26's (1, 4096, 4096) bf16 and float32 and
  (2, 37, 4096) bf16 shapes, device time a launch from a CUDA graph;
  with ``--src DIR`` from another checkout's package (``DIR`` its
  ``src``, e.g. the parent commit unpacked by ``git archive`` into the
  gitignored ``build/parent``, its kernels built by its own
  ``kernels/build.py``), and then nothing else, so that parent and
  change can be timed in turns in one call;

- the scan kernel (``csrc/rglru_scan.cu``) at (1, 4096, 4096) bf16 and
  float32 and (1, 1024, 4096) bf16 beside three diagnostic builds of the
  same source, each timed in turns with the shipped kernel (CUDA events
  around 20 back-to-back launches, the median of 5 windows): ``no_wait``
  skips the wait for the predecessor tile's carry (so its h is wrong: it
  times the chain), ``cheap_coeffs`` replaces the coefficients' special
  functions by a product and a sum (it times the arithmetic), and
  ``no_wait_cheap`` does both (what is left: loads, stores, the tile's
  barriers and fences);
- the decode kernel (``csrc/decode_attention.cu``) at chip_smoke.py
  phase 25's qwen3-4b (bf16, int8) and recurrentgemma ring shapes with
  the split length chosen for 132, 264 (``SPLIT_BLOCKS``), 396, 528 and
  792 blocks, device time a launch from a CUDA graph, each output held
  to the shipped split's within phase 25's limit.

The diagnostic builds are edited copies of the source under the
gitignored ``build/bench_decode_scan/``. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# name -> [(text in csrc/rglru_scan.cu, its replacement)]
SCAN_VARIANTS = {
    "no_wait": [
        ("while (load_acquire(flags + pred) == 0) __nanosleep(32);", ""),
        ("if (has_succ) store_release(flags + tile, 1);", ""),
        ("if (tt > 0) flags[pred] = 0;", "")],
    "cheap_coeffs": [(None, None)],
}
SCAN_VARIANTS["no_wait_cheap"] = SCAN_VARIANTS["no_wait"] + [(None, None)]
SCAN_SHAPES = [(1, 4096, 4096, "bfloat16"), (1, 4096, 4096, "float32"),
               (1, 1024, 4096, "bfloat16")]
DECODE_BLOCKS = (132, 264, 396, 528, 792)


def _cheap(src: str) -> str:
    """The coefficients' special functions replaced by a product and a
    sum of the same inputs."""
    a0 = src.index("const float i_t = sigmoid(")
    a1 = src.index("__fmul_rn(i_t, xf));") + len("__fmul_rn(i_t, xf));")
    return src[:a0] + "a_t = __fmul_rn(xf, ai) * 0.01f + 0.5f; b_t = xf;" \
        + src[a1:]


def build_scan_variants(build) -> dict:
    """Each variant's library, built in parallel (one nvcc each)."""
    src = (build.CSRC / "rglru_scan.cu").read_text()
    out = os.path.join(ROOT, "build", "bench_decode_scan")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, edits in SCAN_VARIANTS.items():
        text = src
        for old, new in edits:
            if old is None:
                text = _cheap(text)
            else:
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} not in the source")
                text = text.replace(old, new)
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so",
               path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        fn = lib.rglru_scan_launch
        fn.argtypes = list(build.SIGNATURES["rglru_scan"]["rglru_scan_launch"])
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def events_ms(torch, fn, reps: int = 20, windows: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[len(times) // 2]


def wrapper_times(torch, cs, dk, rs, dev) -> None:
    """Each kernel through its wrapper at the main path's shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    for name, B, T, KV, G, hd, cache, win, rows in cs.DECODE_TESTS[:3]:
        q, k, v, ks, vs, pos, q_pos = cs.decode_inputs(
            torch, gen, B, T, KV, G, hd, cache, win, rows, dev)
        ms = cs.graph_ms(torch, lambda: dk.decode_attention_kernel(
            q, k, v, pos, q_pos, win, ks, vs))
        print(f"decode_attention {name}: {ms:.4f} ms a launch (CUDA graph)",
              flush=True)
    with torch.no_grad():
        for B, S, W, dt in cs.SCAN_TESTS[:3]:
            x, p = cs.scan_inputs(torch, gen, B, S, W, getattr(torch, dt),
                                  dev)
            ms = cs.graph_ms(torch, lambda: rs.rglru_scan(x, *p),
                             launches=5)
            print(f"rglru_scan ({B}, {S}, {W}) {dt}: {ms:.4f} ms a launch "
                  f"(CUDA graph)", flush=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="time another checkout's package (its src)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_decode_scan: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src or os.path.join(ROOT, "src")))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import rglru_scan as rs
    dev = torch.device("cuda:0")
    print(cs.card_line(), flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(dk.__file__))}",
          flush=True)
    wrapper_times(torch, cs, dk, rs, dev)
    if args.src:
        return 0
    libs = {"shipped": build.load("rglru_scan"), **build_scan_variants(build)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    with torch.no_grad():
        for B, S, W, dt in SCAN_SHAPES:
            x, p = cs.scan_inputs(torch, gen, B, S, W, getattr(torch, dt),
                                  dev)
            tiles = B * -(-W // rs.SCAN_CHANNELS) * -(-S // rs.SCAN_STEPS)
            work = torch.zeros((2 + tiles,), dtype=torch.int32, device=dev)
            carry = torch.empty((tiles * rs.SCAN_CHANNELS,),
                                dtype=torch.float32, device=dev)
            h = torch.empty_like(x)

            def run(lib):
                err = lib.rglru_scan_launch(
                    x.data_ptr(), *(t.data_ptr() for t in p), h.data_ptr(),
                    work.data_ptr(), carry.data_ptr(), B, S, W,
                    int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            times = {n: [] for n in libs}
            order = list(libs) + list(reversed(list(libs)))
            for name in order:
                times[name].append(events_ms(torch, lambda: run(libs[name])))
                work.zero_()   # the no-wait builds leave flags set
            print(f"scan ({B}, {S}, {W}) {dt}: " + ", ".join(
                f"{n} {min(t):.4f}-{max(t):.4f} ms" for n, t in
                times.items()), flush=True)
    kern = dk.decode_attention_kernel
    shipped = dk.split_len
    for name, B, T, KV, G, hd, cache, win, rows in cs.DECODE_TESTS[:3]:
        q, k, v, ks, vs, pos, q_pos = cs.decode_inputs(
            torch, gen, B, T, KV, G, hd, cache, win, rows, dev)
        want = kern(q, k, v, pos, q_pos, win, ks, vs)
        cells = []
        for blocks in DECODE_BLOCKS:
            def split_for(B_, KV_, G_, T_, nb=blocks):
                units = B_ * KV_ * -(-G_ // dk.HEADS_PER_BLOCK)
                chunks = -(-T_ // dk.CHUNK)
                want_ = max(1, min(chunks, nb // max(1, units)))
                per = min(-(-chunks // want_), dk.MAX_SPLIT_LEN // dk.CHUNK)
                return per * dk.CHUNK
            dk.split_len = split_for
            try:
                got = kern(q, k, v, pos, q_pos, win, ks, vs)
                torch.cuda.synchronize()
                ok = cs.bf16_over(torch, got, want) == 0
                ms = cs.graph_ms(torch, lambda: kern(q, k, v, pos, q_pos,
                                                     win, ks, vs))
            finally:
                dk.split_len = shipped
            cells.append(f"{blocks} blocks (L={split_for(B, KV, G, T)}) "
                         f"{ms:.4f} ms{'' if ok else ' OUT OF LIMIT'}")
        print(f"decode {name}: " + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
