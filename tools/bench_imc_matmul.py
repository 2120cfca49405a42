"""Time the ``imc_matmul`` kernel against another checkout's on one GPU.

    python3 tools/bench_imc_matmul.py [--parent DIR]

Builds this checkout's ``csrc/imc_matmul.cu`` and, with ``--parent``,
the one of the checkout at DIR (for example a parent commit unpacked by
``git archive`` into the gitignored ``build/parent/``), each with its
own checkout's ``kernels/build.py``, and times both launch functions on
the same inputs in turns (parent, this, this, parent) at the host
oracle's shape (32, 256, 32), the qwen3-4b QKV projection (16, 2560,
12288) and a whole seq=256 prefill of it (256, 2560, 12288), at every
registry row count, ``w_scale=1`` and 8 ADC bits: the device time per
launch from a CUDA graph (``chip_smoke.graph_ms``) and the time per call
by CUDA events around back-to-back calls (``chip_smoke.time_ms``; the
call allocates the output and makes the ctypes call, as the wrapper
does). The two kernels' outputs must be equal bit for bit. Prints the
card's name and power limit, then one JSON line per shape with the
cluster size and columns a thread this checkout's kernel picks and the
bound of ``chip_smoke.matmul_bound_ms``. It also prints, for each
instantiation of this checkout's kernel, the instruction mix of its
hottest loop (the innermost loop whose body holds the most FADDs) from
``cuobjdump -sass`` of the built library, and samples the SM clock and
the power draw (``nvidia-smi``, every 200 ms) while the kernel runs the
prefill shape at R=512 for 3 s. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(32, 256, 32), (16, 2560, 12288), (256, 2560, 12288)]
ROWS = (64, 128, 256, 512)


def load_build(checkout: str):
    """The ``kernels/build.py`` module of a checkout (it imports only the
    standard library and builds into that checkout's build/kernels)."""
    path = os.path.join(checkout, "src", "repro_torch", "kernels",
                        "build.py")
    spec = importlib.util.spec_from_file_location(
        f"build_{abs(hash(checkout))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_loops(library: str) -> list:
    """(kernel, instructions of its hottest loop, opcode counts) for each
    kernel of ``library``, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library], check=True,
                          capture_output=True, text=True).stdout
    out = []
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        code = []  # (address, opcode)
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)([^;]*);", part):
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
        loops = []  # (first, last address) of each backward branch
        for addr, op, args in code:
            target = re.match(r"\s*(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", args)
            if op == "BRA" and target and int(target.group(1), 16) < addr:
                loops.append((int(target.group(1), 16), addr))
        best = []
        for lo, hi in loops:
            if any(lo <= a and b <= hi and (a, b) != (lo, hi)
                   for a, b in loops):
                continue  # not innermost
            body = [o for a, o, _ in code if lo <= a <= hi]
            if sum(o.startswith("FADD") for o in body) > \
                    sum(o.startswith("FADD") for o in best):
                best = body
        counts = {}
        for o in best:
            counts[o.split(".")[0]] = counts.get(o.split(".")[0], 0) + 1
        out.append((name, len(best), dict(sorted(
            counts.items(), key=lambda kv: -kv[1]))))
    return out


def clocks(torch, call, seconds: float = 3.0) -> list:
    """nvidia-smi samples of the SM clock and power draw while ``call``
    runs back to back."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "200"], stdout=subprocess.PIPE,
        text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
    return [ln.strip() for ln in smi.communicate()[0].splitlines()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout root of the other kernel")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_imc_matmul: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    this_build = load_build(ROOT)
    libs = {"this": this_build.load("imc_matmul")}
    if args.parent:
        libs["parent"] = load_build(os.path.abspath(args.parent)).load(
            "imc_matmul")
    print(cs.card_line(), flush=True)
    for name, n, counts in sass_loops(
            str(this_build._library_path("imc_matmul"))):
        print(json.dumps({"kernel": name, "loop_instructions": n,
                          "opcodes": counts}), flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for m, k, n in SHAPES:
        for r in ROWS:
            x_q = torch.randint(0, 256, (m, k), generator=gen,
                                dtype=torch.int32, device=dev)
            w = torch.randn((k, n), generator=gen, device=dev) * 0.25
            x_q = torch.nn.functional.pad(x_q, (0, (-k) % r))
            w = torch.nn.functional.pad(w, (0, 0, 0, (-k) % r))
            fs = r / 4.0

            def call(lib, x_q=x_q, w=w, r=r, fs=fs):
                out = torch.empty((m, n), dtype=torch.float32, device=dev)
                err = lib.imc_matmul_launch(
                    x_q.data_ptr(), w.data_ptr(), out.data_ptr(), m,
                    x_q.shape[1], n, r, 8, fs,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return out
            outs = {name: call(lib) for name, lib in libs.items()}
            torch.cuda.synchronize()
            if len(outs) == 2 and not torch.equal(outs["this"],
                                                  outs["parent"]):
                raise RuntimeError(f"({m}, {k}, {n}) R={r}: the kernels "
                                   "differ")
            big = m == 256
            order = ["parent", "this", "this", "parent"] if \
                args.parent else ["this", "this"]
            res = {name: {"graph_ms": [], "call_ms": []} for name in libs}
            for name in order:
                fn = (lambda lib=libs[name]: call(lib))
                res[name]["graph_ms"].append(cs.graph_ms(
                    torch, fn, launches=5 if big else 20,
                    reps=3 if big else 10))
                res[name]["call_ms"].append(cs.time_ms(
                    torch, fn, reps=5 if big else 200 if m == 32 else 20))
            cluster, cols = ctypes.c_int(), ctypes.c_int()
            libs["this"].imc_matmul_plan(m, x_q.shape[1], n, r,
                                         ctypes.addressof(cluster),
                                         ctypes.addressof(cols))
            print(json.dumps({"shape": [m, k, n], "R": r,
                              "cluster": cluster.value,
                              "columns_per_thread": cols.value, **res,
                              **cs.matmul_bound_ms(x_q, k, n)}), flush=True)
            if (m, r) == (256, 512):
                print(json.dumps({"clocks_while_running": [m, k, n, r],
                                  "samples": clocks(
                                      torch, lambda: call(libs["this"]))}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
