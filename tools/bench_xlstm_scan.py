"""Where the mLSTM and sLSTM scan kernels and their backward kernels spend
their time, on the GPU.

    python3 tools/bench_xlstm_scan.py [--src DIR] [--bwd-only]

Prints the card's name and power limit, then:

- the backward kernels (``csrc/mlstm_scan_bwd.cu``,
  ``csrc/slstm_scan_bwd.cu``) through their wrappers at xlstm-350m's
  training shapes (chip_smoke.py phase 38's): the mLSTM's at
  (1, 4096, 4, 512) and (8, 128, 4, 512) from the zero state, the
  sLSTM's at (1, 4096, 1024) and (8, 128, 1024) with bfloat16 gates, at
  (1, 4096, 1024) with float32 gates and its reverse chain alone, one
  warp of channels (1, 4096, 32); device time a call from a CUDA graph
  (with ``--src``, another checkout's, when it has them: the sLSTM's
  backward as that package's wrapper takes it, from the forward's hs
  alone or with the states its saving launch stores); then the sLSTM
  forward at (1, 4096, 1024) bf16, and its saving launch beside it where
  the package has one; without ``--src`` also the mLSTM backward's
  device time by kernel (``chip_smoke.kernel_split``, the profiler)
  at the first shape, then the same for its diagnostic builds, each an
  edited copy of ``csrc/mlstm_scan_bwd.cu`` called through the wrapper
  in its place (its results are wrong: it times what is left):
  ``no_tree`` (a chunk's row sums not added: each lane keeps its own
  partial), ``no_loads`` (the ring filled once, never again),
  ``one_op_update`` (every update one FMA, X = X + u w^T, as where the
  decay is exactly 1) and ``one_block`` (registers for one block an SM,
  not two); the sLSTM backward's diagnostic builds the same way, timed
  at its two bf16 training shapes, each build's outputs at every shape
  compared with the shipped build's bitwise: ``no_producers`` (the
  coefficients' ring filled twice, never again), ``no_epilogue`` (no
  dgates stores, no dr products), ``chain_only`` (both: the chain warp's
  update alone), ``no_chain`` (the producers and the epilogue alone),
  ``ieee_div`` (the chain's divisions by n as IEEE divisions, with
  their branch: the same bits on this data), ``k32`` and ``k8`` (32 and
  8 channels a block, not 16, with 8 producer warps) and ``pairs4`` (4
  producer warps of 4 (step, channel) pairs a thread, not 8 of 2); and
  each backward source's and the sLSTM forward's registers and spills
  as ``nvcc -Xptxas -v`` prints them (a fresh build under
  ``build/bench_xlstm_scan/``); ``--bwd-only`` stops there;

- both scans as the main path calls them, through their wrappers, at
  chip_smoke.py phase 28's xlstm-350m shapes: the mLSTM at
  (1, 4096, 4, 512) (a prefill) and (4, 1, 4, 512) (a 4-slot decode
  step), the sLSTM at (1, 4096, 1024) and (4, 1, 1024) with bfloat16
  gates and its chain alone, one warp of channels (1, 4096, 32); device
  time a launch from a CUDA graph. With ``--src DIR`` from another
  checkout's package (``DIR`` its ``src``, e.g. the parent commit
  unpacked by ``git archive`` into the gitignored ``build/parent``, its
  kernels built by its own ``kernels/build.py``), and then nothing
  else, so that parent and change can be timed in turns in one call;

- without ``--src``, diagnostic builds of each source, each timed in
  turns with the shipped kernel (CUDA events around back-to-back
  launches through the C entry, the median of 5 windows) at the
  prefill shape, each an edited copy that leaves out one part of a step
  (its results are wrong: it times what is left):
  the mLSTM's ``no_gates`` (the producer warp computes no gates: every
  step has i_g = f_g = 1), ``no_sums`` (no sums after a chunk: no
  n' . q, no trees, division or h), ``no_loads`` (the ring filled once,
  never waited for again), ``update_only`` (all three: the C and n
  update and its partial sums alone) and ``no_n`` (no n or n' . q in the
  C warps); the sLSTM's ``no_loads`` (no gate copies, constant gates),
  ``no_z_o`` (z = o = 0.5: no tanh or sigmoid, the most a split of them
  onto other threads could save), ``no_softplus`` (log_f =
  min(-pre_f, 0)), ``no_div`` (the fast approximate division for the
  IEEE c' / n'), ``no_store`` (h stored at the last step only) and
  ``chain_only`` (no loads, no z, o, no store: the chain of the f gate,
  the exp, c', n' and the division). The state is restored before every
  timed window (an edited kernel leaves other values).

The diagnostic builds are edited copies of the sources under the
gitignored ``build/bench_xlstm_scan/``. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# kernel -> name -> [(text in csrc/<kernel>.cu, its replacement)]
_M_GATES = [("if ((t0 & (GSTEPS - 1)) == 0) {", "if (false) {")]
_M_SUMS = [("if (u < steps) {\n      float d[CHUNK];",
            "if (false) {\n      float d[CHUNK];"),
           ("if (u < steps)\n      h[", "if (false)\n      h[")]
_M_LOADS = [("mbar_wait(bars + 8 * stage, (uint32_t)((cc / STAGES) & 1));",
             "if (cc < STAGES) mbar_wait(bars + 8 * stage, 0);"),
            ("mbar_expect_tx(full, (uint32_t)(steps * (2 * HD + ROWS) * 4));",
             "mbar_expect_tx(full, cc < STAGES ? (uint32_t)(steps * (2 * HD "
             "+ ROWS) * 4) : 0u);"),
            ("if (lane < steps) {\n        const size_t g",
             "if (lane < steps && cc < STAGES) {\n        const size_t g")]
_S_LOADS = [("const Gates x = Raw<T>::get(nx);",
             "const Gates x = {0.5f, 0.25f * (u & 3), 1.f, -0.5f};"),
            ("issue(0);\n  issue(1);", ""), ("issue(k + STAGES);", ""),
            ("cp_async_wait_all_but_one();", "")]
_S_ZO = [("const float z = tanhf(pz);", "const float z = 0.5f;"),
         ("const float o = sigmoid(po);", "const float o = 0.5f;")]
_S_STORE = [("out[(size_t)(t0 + u) * W] = hh;",
             "if (t0 + u == S - 1) out[(size_t)(t0 + u) * W] = hh;")]

_B_LOADS = [("if (lane < CHUNK) {\n        const int tu",
             "if (lane < CHUNK && kk < STAGES) {\n        const int tu"),
            ("mbar_expect_tx(full, (uint32_t)(CHUNK * (2 * HD + ROWS) * 4));",
             "mbar_expect_tx(full, kk < STAGES ? (uint32_t)(CHUNK * (2 * HD "
             "+ ROWS) * 4) : 0u);")]

_SB_PRODUCERS = [("      if (pc < chunks) {",
                  "      if (pc < chunks && j < 2) {")]
_SB_EPILOGUE = [("      if (ec >= 0 && lane < CHANNELS) {",
                 "      if (false) {")]

VARIANTS = {
    "slstm_scan_bwd": {
        "no_producers": _SB_PRODUCERS,
        "no_epilogue": _SB_EPILOGUE,
        "chain_only": _SB_PRODUCERS + _SB_EPILOGUE,
        "no_chain": [("      if (cc >= 0 && cc < chunks && lane < CHANNELS) {",
                      "      if (false) {")],
        "ieee_div": [("__fadd_rn(k.dc, div_by(dcn, x.nt, x.rn))",
                      "__fadd_rn(k.dc, dcn / x.nt)"),
                     ("div_by(__fmul_rn(dcn, x.cn), x.nt, x.rn)",
                      "__fmul_rn(dcn, x.cn) / x.nt")],
        "k32": [("constexpr int CHANNELS = 16;",
                 "constexpr int CHANNELS = 32;"),
                ("constexpr int PAIRS = 2;", "constexpr int PAIRS = 4;")],
        "k8": [("constexpr int CHANNELS = 16;", "constexpr int CHANNELS = 8;"),
               ("constexpr int PAIRS = 2;", "constexpr int PAIRS = 1;")],
        "pairs4": [("constexpr int PAIRS = 2;", "constexpr int PAIRS = 4;")],
    },
    "mlstm_scan_bwd": {
        "no_tree": [("tree<16>(s);\n    float o = s[0];", "float o = s[0];")],
        "no_loads": _B_LOADS,
        "one_op_update": [("x[r][c] = fmaf(a, x[r][c], __fmul_rn(ur[r], "
                           "wv[c]));", "x[r][c] = fmaf(ur[r], wv[c], "
                           "x[r][c]);")],
        "one_block": [("__launch_bounds__((Cfg<HD>::NW + 1) * 32, 2)",
                       "__launch_bounds__((Cfg<HD>::NW + 1) * 32, 1)")],
    },
    "mlstm_scan": {
        "no_gates": _M_GATES,
        "no_sums": _M_SUMS,
        "no_loads": _M_LOADS,
        "update_only": _M_GATES + _M_SUMS + _M_LOADS,
        "no_n": [("n_reg[c] = __fadd_rn(__fmul_rn(f_g, n_reg[c]), "
                  "__fmul_rn(i_g, kc));", ""),
                 ("dn = __fadd_rn(dn, __fmul_rn(n_reg[c], qc));", "")],
    },
    "slstm_scan": {
        "no_loads": _S_LOADS,
        "no_z_o": _S_ZO,
        "no_softplus": [("const float log_f = -softplus(-pf);",
                         "const float log_f = fminf(-pf, 0.f);")],
        "no_div": [("hh = __fmul_rn(o, __fdiv_rn(cc, nn));",
                    "hh = __fmul_rn(o, __fdividef(cc, nn));")],
        "no_store": _S_STORE,
        "chain_only": _S_LOADS + _S_ZO + _S_STORE,
    },
}
MLSTM_SHAPE = (1, 4096, 4, 512)
SLSTM_SHAPES = [(1, 4096, 1024), (1, 4096, 32)]


def build_variants(build, which=None) -> dict:
    """(kernel, variant) -> library, each an edited copy of the shipped
    source (of ``which``, a part of VARIANTS, or all of them), built in
    parallel (one nvcc each)."""
    out = os.path.join(ROOT, "build", "bench_xlstm_scan")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for kernel, variants in (which or VARIANTS).items():
        src = (build.CSRC / f"{kernel}.cu").read_text()
        for name, edits in variants.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{kernel} {name}: {old!r} not in "
                                       "the source")
                text = text.replace(old, new)
            path = os.path.join(out, f"{kernel}_{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so",
                   path]
            procs[kernel, name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    for (kernel, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"{kernel}_{name}.so"))
        fn = getattr(lib, f"{kernel}_launch")
        fn.argtypes = list(build.SIGNATURES[kernel][f"{kernel}_launch"])
        fn.restype = ctypes.c_int
        libs[kernel, name] = lib
    return libs


def events_ms(torch, fn, reset, reps: int = 5, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` launches by
    CUDA events, ``reset()`` (the state restored) before each window."""
    reset()
    for _ in range(2):
        fn()
    times = []
    for _ in range(windows):
        reset()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[len(times) // 2]


def mlstm_inputs(torch, gen, B, S, H, hd, dev):
    """Phase 28's inputs: q, k, v, gates and a random state."""
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev)
               for _ in range(3))
    k = k * (1.0 / hd ** 0.5)
    i_pre, f_pre = (torch.randn((B, S, H), generator=gen, device=dev) * 2
                    for _ in range(2))
    C = torch.randn((B, H, hd, hd), generator=gen, device=dev) * 0.3
    n = torch.randn((B, H, hd), generator=gen, device=dev)
    m = torch.randn((B, H), generator=gen, device=dev)
    return (q, k, v, i_pre, f_pre), (C, n, m)


def slstm_inputs(torch, gen, B, S, w, dev, dt="bfloat16"):
    gates = (torch.randn((B, S, w, 4), generator=gen, device=dev)
             * 2).to(getattr(torch, dt))
    r = torch.randn((w, 4), generator=gen, device=dev) * 0.5
    c, m, h = (torch.randn((B, w), generator=gen, device=dev)
               for _ in range(3))
    n = torch.randn((B, w), generator=gen, device=dev).abs() + 0.5
    return (gates, r), (c, n, m, h)


def wrapper_times(torch, cs, ms, ss, dev) -> None:
    """Each scan through its wrapper at the main path's shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(28)
    with torch.no_grad():
        for B, S, H, hd in cs.MLSTM_TESTS[:2]:
            args, state = mlstm_inputs(torch, gen, B, S, H, hd, dev)
            t = cs.graph_ms(torch, lambda: ms.mlstm_scan(*args, *state),
                            launches=5 if S > 1 else 20)
            print(f"mlstm_scan ({B}, {S}, {H}, {hd}): {t:.4f} ms a launch "
                  f"(CUDA graph)", flush=True)
        for B, S, w in ((1, 4096, 1024), (4, 1, 1024), (1, 4096, 32)):
            args, state = slstm_inputs(torch, gen, B, S, w, dev)
            t = cs.graph_ms(torch, lambda: ss.slstm_scan(*args, *state),
                            launches=5 if S > 1 else 20)
            print(f"slstm_scan ({B}, {S}, {w}) bfloat16: {t:.4f} ms a "
                  f"launch (CUDA graph)", flush=True)


MLSTM_BWD_SHAPES = [(1, 4096, 4, 512), (8, 128, 4, 512)]
SLSTM_BWD_SHAPES = [(1, 4096, 1024, "bfloat16"), (8, 128, 1024, "bfloat16"),
                    (1, 4096, 1024, "float32"), (1, 4096, 32, "bfloat16")]


def slstm_bwd_call(torch, ss, gates, r, state, dhs):
    """The sLSTM backward as this package's ``SLSTMScan.backward`` calls
    it: on the forward's hs, and on the states its saving launch stores
    where the package has one (the wrapper's ``saved`` argument)."""
    import inspect
    start = [t.clone() for t in state]
    with torch.no_grad():
        if "saved" in inspect.signature(ss.slstm_scan_backward).parameters:
            hs, saved = ss._forward_kernel(gates, r, *start, save=True)
            return lambda: ss.slstm_scan_backward(gates, r, *state, dhs, hs,
                                                  saved)
        hs = ss.slstm_scan(gates, r, *start)
    return lambda: ss.slstm_scan_backward(gates, r, *state, dhs, hs)


def bwd_times(torch, cs, ms, ss, dev, detail: bool) -> None:
    """The backward kernels through their wrappers at the training shapes
    (device time a call from a CUDA graph), the sLSTM forward with and
    without saving; with ``detail`` the mLSTM backward's kernels by the
    profiler, the sLSTM backward's diagnostic builds and each source's
    ptxas report."""
    import inspect
    if not hasattr(ms, "mlstm_scan_backward"):
        print("this package has no xLSTM backward kernels", flush=True)
        return
    gen = torch.Generator(device=dev)
    gen.manual_seed(38)
    calls = []
    for B, S, H, hd in MLSTM_BWD_SHAPES:
        (q, k, v, i_pre, f_pre), _ = mlstm_inputs(torch, gen, B, S, H, hd,
                                                  dev)
        state = ms.init_state(B, H, hd, dev)
        dh = torch.randn((B, S, H, hd), generator=gen, device=dev)
        args = (q, k, v, i_pre, f_pre, *state, dh)
        t = cs.graph_ms(torch, lambda a=args: ms.mlstm_scan_backward(*a),
                        launches=3, reps=3)
        calls.append(args)
        print(f"mlstm_scan_backward ({B}, {S}, {H}, {hd}): {t:.4f} ms a call"
              f" (CUDA graph, {ms.BACKWARD_KERNELS} kernels)", flush=True)
    s_calls = {}
    for B, S, w, dt in SLSTM_BWD_SHAPES:
        (gates, r), _ = slstm_inputs(torch, gen, B, S, w, dev, dt)
        state = ss.init_state(B, w, dev)
        dhs = torch.randn((B, S, w), generator=gen, device=dev)
        call = slstm_bwd_call(torch, ss, gates, r, state, dhs)
        s_calls[B, S, w, dt] = call
        t = cs.graph_ms(torch, call, launches=3, reps=3)
        print(f"slstm_scan_backward ({B}, {S}, {w}) {dt}: {t:.4f} ms a "
              f"call (CUDA graph)", flush=True)
    # the forward, and its saving launch where the package has one
    (gates, r), state = slstm_inputs(torch, gen, 1, 4096, 1024, dev)
    with torch.no_grad():
        t = cs.graph_ms(torch, lambda: ss.slstm_scan(gates, r, *state),
                        launches=5)
        line = f"slstm_scan (1, 4096, 1024) bfloat16: {t:.4f} ms a launch"
        if "save" in inspect.signature(ss._forward_kernel).parameters:
            t_save = cs.graph_ms(torch, lambda: ss._forward_kernel(
                gates, r, *state, save=True), launches=5)
            line += (f", its saving launch {t_save:.4f} ms "
                     f"({t_save / t:.3f}x)")
    print(line + " (CUDA graph)", flush=True)
    if not detail:
        return
    from repro_torch.kernels import build

    def split_line(label):
        split = cs.kernel_split(torch, lambda: ms.mlstm_scan_backward(
            *calls[0]), 16, cs.MLSTM_BWD_KERNELS)
        other = cs.kernel_split(torch, lambda: ms.mlstm_scan_backward(
            *calls[1]), 64, cs.MLSTM_BWD_KERNELS)
        print(f"mlstm_scan_backward {MLSTM_BWD_SHAPES[0]} {label} by kernel "
              f"(profiler, ms a call): {cs.split_text(split, 16)}; "
              f"{MLSTM_BWD_SHAPES[1]} {cs.split_text(other, 64)}", flush=True)
    s_want = {}

    def s_line(label):
        # the outputs at every shape, against the shipped build's
        same = []
        for shape, call in s_calls.items():
            got = call()
            want = s_want.setdefault(shape, got)
            same.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        print(f"slstm_scan_backward {label}: " + ", ".join(
            f"{shape} {cs.graph_ms(torch, s_calls[shape], 3, 3):.4f} ms"
            for shape in SLSTM_BWD_SHAPES[:2]) + " a call (CUDA graph); "
            f"bitwise the shipped build's at {sum(same)} of {len(same)} "
            f"shapes", flush=True)
    split_line("shipped")
    s_line("shipped")
    # the diagnostic builds, each through the wrapper in place of the
    # shipped library
    built = build_variants(build, {k: VARIANTS[k] for k in
                                   ("mlstm_scan_bwd", "slstm_scan_bwd")})
    for kernel, line_of in (("mlstm_scan_bwd", split_line),
                            ("slstm_scan_bwd", s_line)):
        shipped = build.load(kernel)
        try:
            for (kern, name), lib in built.items():
                if kern == kernel:
                    build._LOADED[kernel] = lib
                    line_of(name)
        finally:
            build._LOADED[kernel] = shipped
    out = os.path.join(ROOT, "build", "bench_xlstm_scan")
    os.makedirs(out, exist_ok=True)
    for kernel in ("mlstm_scan_bwd", "slstm_scan_bwd", "slstm_scan"):
        path = os.path.join(out, f"{kernel}_shipped.so")
        log = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", path,
             str(build.CSRC / f"{kernel}.cu")], capture_output=True,
            text=True)
        for ln in (log.stdout + log.stderr).splitlines():
            if any(w in ln for w in ("Compiling entry", "registers",
                                     "spill")):
                print(f"  {kernel}: {ln.strip()}", flush=True)


def in_turns(torch, libs, run, state) -> dict:
    """Each library timed twice, in the order given and back, from the
    same ``state`` (the tensors the launches update)."""
    saved = [t.clone() for t in state]

    def reset():
        for t, s in zip(state, saved):
            t.copy_(s)
    times = {n: [] for n in libs}
    for name in list(libs) + list(reversed(list(libs))):
        times[name].append(events_ms(torch, lambda: run(libs[name]), reset))
    return times


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="time another checkout's package (its src)")
    ap.add_argument("--bwd-only", action="store_true",
                    help="time the backward kernels only")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_xlstm_scan: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src or os.path.join(ROOT, "src")))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import slstm_scan as ss
    dev = torch.device("cuda:0")
    print(cs.card_line(), flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(ms.__file__))}",
          flush=True)
    bwd_times(torch, cs, ms, ss, dev, detail=not args.src)
    if args.bwd_only:
        return 0
    wrapper_times(torch, cs, ms, ss, dev)
    if args.src:
        return 0
    built = build_variants(build, {k: VARIANTS[k] for k in
                                   ("mlstm_scan", "slstm_scan")})
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    with torch.no_grad():
        B, S, H, hd = MLSTM_SHAPE
        (q, k, v, i_pre, f_pre), (C, n, m) = mlstm_inputs(
            torch, gen, B, S, H, hd, dev)
        h = torch.empty_like(q)
        arrivals = build.workspace("mlstm_scan", dev, B * H)
        libs = {"shipped": build.load("mlstm_scan"),
                **{name: lib for (kern, name), lib in built.items()
                   if kern == "mlstm_scan"}}

        def run_m(lib):
            err = lib.mlstm_scan_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
                f_pre.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
                h.data_ptr(), arrivals.data_ptr(), B, S, H, hd, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        times = in_turns(torch, libs, run_m, (C, n, m))
        print(f"mlstm ({B}, {S}, {H}, {hd}): " + ", ".join(
            f"{name} {min(t):.4f}-{max(t):.4f} ms ({min(t) * 1e6 / S:.0f}"
            f" ns a step)" for name, t in times.items()), flush=True)
        for B, S, w in SLSTM_SHAPES:
            (gates, r), (c, n_, m_, h_) = slstm_inputs(torch, gen, B, S, w,
                                                       dev)
            hs = torch.empty((B, S, w), dtype=torch.float32, device=dev)
            libs = {"shipped": build.load("slstm_scan"),
                    **{name: lib for (kern, name), lib in built.items()
                       if kern == "slstm_scan"}}

            def run_s(lib):
                err = lib.slstm_scan_launch(
                    gates.data_ptr(), r.data_ptr(), c.data_ptr(),
                    n_.data_ptr(), m_.data_ptr(), h_.data_ptr(),
                    hs.data_ptr(), None, None, None, B, S, w, 1, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            times = in_turns(torch, libs, run_s, (c, n_, m_, h_))
            print(f"slstm ({B}, {S}, {w}) bfloat16: " + ", ".join(
                f"{name} {min(t):.4f}-{max(t):.4f} ms "
                f"({min(t) * 1e6 / S:.0f} ns a step)"
                for name, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
