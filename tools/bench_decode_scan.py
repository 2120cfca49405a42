"""Where the decode-attention and RG-LRU scan kernels spend their time, on
the GPU.

    python3 tools/bench_decode_scan.py [--src DIR] [--save FILE]
                                       [--compare FILE]
    python3 tools/bench_decode_scan.py --bwd-only [--bwd-src FILE]

Prints the card's name and power limit, then:

- the three kernels as the main path calls them, through their wrappers,
  at chip_smoke.py phase 25's qwen3-4b (bf16, int8) and recurrentgemma
  ring shapes, phase 41's GQA groups (qwen2.5-3b's 8, glm4-9b's 16,
  phi4-mini's 3, bf16 and int8), phase 36's mixtral ring (G 6), phase
  30's cross shape (the decode kernel's cross route), phase 26's
  (1, 4096, 4096) bf16 and float32 and (2, 37, 4096) bf16 shapes and
  phase 33's same three shapes for the scan's gradient
  (``rglru_scan_backward`` on the forward launch's carry buffer), device
  time a launch from a CUDA graph, and SDPA (``enable_gqa``) in a graph
  beside each bf16 decode shape; with ``--src DIR`` from another
  checkout's package (``DIR`` its ``src``, e.g. the parent commit
  unpacked by ``git archive`` into the gitignored ``build/parent``, its
  kernels built by its own ``kernels/build.py``), and then nothing else,
  so that parent and change can be timed in turns in one call. Each
  decode shape's inputs come from a generator seeded by the shape alone,
  so two runs see the same inputs: ``--save FILE`` keeps the outputs,
  ``--compare FILE`` holds them to a saved run's (bitwise where G <= 4
  and the call is not the cross route: the split route, which both
  checkouts share; else the max abs difference);

- the scan kernel (``csrc/rglru_scan.cu``) at (1, 4096, 4096) bf16 and
  float32 and (1, 1024, 4096) bf16 beside three diagnostic builds of the
  same source, each timed in turns with the shipped kernel (CUDA events
  around 20 back-to-back launches, the median of 5 windows): ``no_wait``
  skips the wait for the predecessor tile's carry (so its h is wrong: it
  times the chain), ``cheap_coeffs`` replaces the coefficients' special
  functions by a product and a sum (it times the arithmetic), and
  ``no_wait_cheap`` does both (what is left: loads, stores, the tile's
  barriers and fences);
- the scan's gradient kernel (``csrc/rglru_scan_bwd.cu``, or ``--bwd-src
  FILE``, e.g. the parent's) at (1, 4096, 4096) bf16 and float32 beside
  the same three diagnostic builds (``no_wait`` skips the wait for the
  successor tile's g carry; ``cheap_coeffs`` also replaces the MUFU
  approximations of ``csrc/rglru_coeffs.cuh``'s fast paths) and, where
  the source has them, ``no_loads`` (x and dh copied in for the first
  two tiles only), ``no_stores`` (dx not copied out), ``no_coef``,
  ``no_scan`` and ``no_chain`` (the coefficients', the scans' rounds' or
  the chain rule's arithmetic left out) and ``skeleton`` (neither the
  coefficients' nor the chain rule's arithmetic), alone and without each
  of the scan rounds, the loads and the stores, each build's registers
  and spills from ``-Xptxas -v``; ``--bwd-only`` runs only this;
- the decode kernel (``csrc/decode_attention.cu``) at chip_smoke.py
  phase 25's qwen3-4b (bf16, int8) and recurrentgemma ring shapes with
  the split length chosen for 132, 264 (``SPLIT_BLOCKS``), 396, 528 and
  792 blocks, device time a launch from a CUDA graph, each output held
  to the shipped split's within phase 25's limit;
- with ``--decode-diag`` only: the decode kernel's grouped and cross
  routes beside diagnostic builds (``DECODE_VARIANTS``: a pass without
  its K or V loads, without the last block's fold, without the scores'
  copy, without the int8 cache's scale loads), each timed from a CUDA
  graph in turns with the shipped build at the recurrentgemma ring,
  phase 41's G 8 and G 16 shapes (bf16 and int8), mixtral's ring and
  phase 30's cross shape (their outputs are wrong by design); then the
  grouped route and the split route (``launch_plan`` asked for a
  float32 call's route, which has the split route's split) against ``decode_attention_plain`` at many seeded inputs of
  the ring, glm4-9b's G 16 (bf16, int8) and mixtral's ring: elements
  and inputs over phase 25's limit, and the max abs error.

The diagnostic builds are edited copies of the sources under the
gitignored ``build/bench_decode_scan/``, compiled with the package's
``csrc`` on the include path. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the special functions as a product and a sum each, defined after the
# CUDA headers and before the sources' own (csrc/rglru_coeffs.cuh)
CHEAP_MACROS = """
#define expf(v) __fadd_rn(__fmul_rn((v), 0.01f), 1.0f)
#define log1pf(v) __fadd_rn(__fmul_rn((v), 0.5f), 0.5f)
#define sqrtf(v) __fadd_rn(__fmul_rn((v), 0.5f), 0.5f)
#define __fdiv_rn(a, b) __fadd_rn(__fmul_rn((a), (b)), 0.5f)
#define __frcp_rn(b) __fadd_rn(__fmul_rn((b), 0.5f), 0.5f)
"""


def _replace(*alternatives, new=""):
    """An edit: the first of ``alternatives`` found in the source becomes
    ``new``."""
    def edit(src):
        for old in alternatives:
            if old in src:
                return src.replace(old, new)
        raise KeyError(alternatives[0])
    return edit


# the MUFU approximations of csrc/rglru_coeffs.cuh's fast paths, each as a
# product and a sum
CHEAP_ASM = [('asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));',
              "r = __fadd_rn(__fmul_rn(y, 0.5f), 0.5f);"),
             ('asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));',
              "r = __fadd_rn(__fmul_rn(v, 0.5f), 0.5f);")]


def _cut(start, end, new=""):
    """An edit: the text from ``start`` up to ``end`` becomes ``new``."""
    def edit(src):
        a = src.index(start) if start in src else -1
        b = src.index(end, a) if a >= 0 and end in src[a:] else -1
        if a < 0 or b < 0:
            raise KeyError(start)
        return src[:a] + new + src[b:]
    return edit


def _cheap(src: str) -> str:
    """The special functions replaced by a product and a sum of the same
    inputs: CHEAP_MACROS after ``#include <cuda_runtime.h>``, and the
    shared header put in place of its include with CHEAP_ASM."""
    anchor = "#include <cuda_runtime.h>\n"
    if anchor not in src:
        raise KeyError(anchor)
    src = src.replace(anchor, anchor + CHEAP_MACROS, 1)
    include = '#include "rglru_coeffs.cuh"\n'
    if include in src:
        header = open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                                   "rglru_coeffs.cuh")).read()
        for old, new in CHEAP_ASM:
            if old not in header:
                raise KeyError(old)
            header = header.replace(old, new)
        src = src.replace(include, header)
    return src


# name -> the edits of csrc/rglru_scan.cu
SCAN_VARIANTS = {
    "no_wait": [
        _replace("while (load_acquire(flags + pred) == 0) __nanosleep(32);"),
        _replace("if (has_succ) store_release(flags + tile, 1);"),
        _replace("if (tt > 0) flags[pred] = 0;")],
    "cheap_coeffs": [_cheap],
}
SCAN_VARIANTS["no_wait_cheap"] = SCAN_VARIANTS["no_wait"] + [_cheap]
SCAN_SHAPES = [(1, 4096, 4096, "bfloat16"), (1, 4096, 4096, "float32"),
               (1, 1024, 4096, "bfloat16")]
# the same for csrc/rglru_scan_bwd.cu (the wait is for the successor's
# carry; the text of this source, or of PR 28's, whose carry had a flag
# of its own)
BWD_VARIANTS = {
    "shipped": [],
    "no_wait": [
        _replace("while (!(word >> 32)) word = load_word(succ_word);",
                 "while (load_acquire(flags + succ) == 0) __nanosleep(32);"),
        _replace("if (has_succ) store_word(succ_word, 0ull);",
                 "if (has_succ) flags[succ] = 0;")],
    "cheap_coeffs": [_cheap],
    # x and dh copied in for the first two tiles only (later tiles reuse
    # their buffers), dx not copied out (the 16-byte rows)
    "no_loads": [_replace("if (nt.taken < n_tiles) stage(nt, (it + 1) & 1);",
                          new="if (it == 1 && nt.taken < n_tiles) "
                              "stage(nt, 0);")],
    "no_stores": [_replace(
        "          if (r < steps)\n            *reinterpret_cast<uint4",
        new="          if (n_tiles < 0)\n            *reinterpret_cast<uint4")],
    # a phase's arithmetic left out: the coefficients (fixed values), the
    # Kogge-Stone rounds of the scans, the chain rule (dx = g, no sums)
    "no_coef": [_cut("    if (nvalid == 0) {  // past the end or past W",
                     "    // 2. the sub-chunk's aggregates",
                     "#pragma unroll\n    for (int j = 0; j < SUB; ++j) {\n"
                     "      iv[j] = 0.5f; rv[j] = 0.25f; av[j] = 0.9f;\n"
                     "      ev[j] = 0.81f; sv[j] = 0.4f;\n    }\n")],
    "no_scan": [_cut("#pragma unroll\n      for (int d = 1; d < 32; d *= 2) {",
                     "      float ea = ")],
    "no_chain": [_cut("    float du[SUB];",
                      "    // 5. a warp's four sub-chunks",
                      "    float acc[NP] = "
                      "{gv[0], gv[1], gv[2], gv[3], gv[4]};\n"
                      "#pragma unroll\n    for (int j = 0; j < SUB; ++j)\n"
                      "      store(os + row_of(s0 + j) * CW + c, gv[j]);\n")],
}
BWD_VARIANTS["no_wait_cheap"] = BWD_VARIANTS["no_wait"] + [_cheap]
# neither the coefficients' nor the chain rule's arithmetic: what the
# copies, barriers, scans and per-tile steps cost alone
BWD_VARIANTS["skeleton"] = BWD_VARIANTS["no_coef"] + BWD_VARIANTS["no_chain"]
for _part in ("no_scan", "no_loads", "no_stores"):
    BWD_VARIANTS[f"skeleton_{_part}"] = BWD_VARIANTS["skeleton"] + \
        BWD_VARIANTS[_part]
BWD_SHAPES = [(1, 4096, 4096, "bfloat16"), (1, 4096, 4096, "float32")]
# the edits of csrc/decode_attention.cu for --decode-diag: the grouped
# route's pass 1 without its K copies and products (p1_no_k), without the
# products but with the copies (p1_no_mma), without the scores' stores to
# device memory (p1_no_store), its pass 2
# without V (p2_no_v), without the scores' copy (p2_no_scores) or without
# the fold (p2_no_fold; the last block returns after resetting its
# counter); the cross route without its K loop, its V copy or its fold
DECODE_VARIANTS = {
    "shipped": [],
    "p1_no_k": [_replace("  const int nst = (nv + KSL - 1) / KSL;",
                         new="  const int nst = 0;")],
    "p1_no_mma": [_replace("    const int j0 = s * KSL + warp * 8;\n"
                           "    if (j0 >= nv) continue;",
                           new="    const int j0 = s * KSL + warp * 8;\n"
                               "    if (j0 >= 0) continue;")],
    "p1_no_store": [_replace("      ss[gi * sh.L + jc] = sv;\n"
                             "      sc[gi * sh.L + jc] = sv;",
                             new="      ss[gi * sh.L + jc] = sv;")],
    "p1_no_kscale": [_replace(
        "      kss[j] = k_scale[((size_t)b * sh.T + idx[j]) * sh.KV + kv];",
        new="      kss[j] = 1.f;")],
    "p2_no_v": [_replace("  prologue(nv);\n  scales(nv);\n  // 3. the row's m",
                         new="  scales(nv);\n  // 3. the row's m"),
                _replace("  const int n0 = warp * 8;\n"
                         "  const int nst = (nv + VSL - 1) / VSL;",
                         new="  const int n0 = warp * 8;\n"
                             "  const int nst = 0;")],
    "p2_no_vscale": [_replace(
        "        vss[j] = v_scale[((size_t)b * sh.T + idx[j]) * sh.KV + kv];",
        new="        vss[j] = 1.f;")],
    "p2_no_scores": [_replace(
        "    cp_async16(ssc + 4 * c, sc + 4 * c, true);", new="    ;")],
    "p2_no_fold": [_replace(
        "  if (!last) return;\n  __threadfence();\n  // heads past G",
        new="  return;\n  __threadfence();\n  // heads past G")],
    "cross_no_k": [_replace(
        "  for (int base = 0; base < n_in; base += NSTR * U) {",
        new="  for (int base = 0; base < 0; base += NSTR * U) {")],
    "cross_no_v": [
        _replace("in flight while the scores are formed\n  if (full_v) {",
                 new="in flight while the scores are formed\n  if (false) {"),
        _replace("    for (int e = threadIdx.x; e < n_in * HD; e += THREADS) {",
                 new="    for (int e = threadIdx.x; e < 0; e += THREADS) {")],
    "cross_no_fold": [_replace(
        "  if (!last) return;\n  __threadfence();\n  // the heads' (m_s",
        new="  return;\n  __threadfence();\n  // the heads' (m_s")],
}
DECODE_BLOCKS = (132, 264, 396, 528, 792)


def _ptxas(log: str) -> str:
    """Each kernel's registers and spills from nvcc's -Xptxas -v log."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            kind = "bf16" if "bfloat" in fn else "float32"
            out.append(f"{kind} {m.group(1)} registers")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out.append(f"spills {m.group(1)}/{m.group(2)} B")
    return ", ".join(out)


def build_variants(build, src_path, variants, entry, out_name,
                   extra=()) -> dict:
    """Each variant of ``src_path`` built in parallel (one nvcc each, the
    package's csrc on the include path); {name: (library, ptxas line)}.
    ``extra``: (position, ctypes type) arguments the source's entry takes
    beyond this package's signature."""
    src = open(src_path).read()
    out = os.path.join(ROOT, "build", "bench_decode_scan")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        try:
            for edit in edits:
                text = edit(text)
        except KeyError as e:
            print(f"  {name}: not built ({e} not in the source)",
                  flush=True)
            continue
        path = os.path.join(out, f"{out_name}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", path[:-3] + ".so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"{out_name}_{name}.so"))
        fn = getattr(lib, entry)
        argtypes = list(build.SIGNATURES[out_name][entry])
        for pos, kind in extra:
            argtypes.insert(pos, kind)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[name] = (lib, _ptxas(log))
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


def in_turns(torch, libs, run, reset) -> dict:
    """Each library timed twice, in the order given and then reversed."""
    times = {n: [] for n in libs}
    for name in list(libs) + list(reversed(list(libs))):
        times[name].append(events_ms(torch, lambda: run(libs[name])))
        reset()   # the no-wait builds leave flags set
    return times


def decode_shapes(cs) -> list:
    """The decode kernel's timed shapes: (name, G, window, make inputs),
    the window None on the cross route."""
    shapes = []
    for name, B, T, KV, G, hd, cache, win, rows in (
            cs.DECODE_TESTS[:3] + cs.GQA_DECODE_TESTS + [cs.MIXTRAL_RING]):
        def make(torch, gen, dev, a=(B, T, KV, G, hd, cache, win, rows)):
            return cs.decode_inputs(torch, gen, *a, dev)
        shapes.append((name, G, win, make))
    name, B, T, KV, G, hd, dt = cs.CROSS_DECODE_TESTS[0]

    def make_cross(torch, gen, dev):
        tdt = getattr(torch, dt)
        q = torch.randn((B, 1, KV * G, hd), generator=gen, device=dev)
        k, v = (torch.randn((B, T, KV, hd), generator=gen, device=dev)
                for _ in range(2))
        return q.to(tdt), k.to(tdt), v.to(tdt)
    shapes.append((name, G, None, make_cross))
    return shapes


def decode_times(torch, cs, dk, dev, save=None, compare=None) -> None:
    """The decode kernel through its wrappers at ``decode_shapes``, SDPA
    beside the bf16 ones; outputs saved to ``save`` or held to those in
    ``compare``."""
    import torch.nn.functional as F
    outs, theirs = {}, torch.load(compare) if compare else None
    for i, (name, G, win, make) in enumerate(decode_shapes(cs)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(2500 + i)
        cross = win is None
        if cross:
            q, k, v = make(torch, gen, dev)

            def call():
                return dk.cross_decode_attention_kernel(q, k, v)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None
        else:
            q, k, v, ks, vs, pos, q_pos = make(torch, gen, dev)

            def call():
                return dk.decode_attention_kernel(q, k, v, pos, q_pos, win,
                                                  ks, vs)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = dk.visible_slots(pos, q_pos, win)[:, None, None, :]
        outs[name] = call().cpu()
        ms = cs.graph_ms(torch, call)
        line = f"decode_attention {name}: {ms:.4f} ms a launch (CUDA graph)"
        if k.dtype == torch.bfloat16:
            sdpa = cs.graph_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
            line += f", sdpa(enable_gqa) {sdpa:.4f} ms (CUDA graph)"
        if theirs is not None and name in theirs:
            if G <= 4 and not cross:
                line += (f"; output bitwise the saved run's: "
                         f"{torch.equal(outs[name], theirs[name])}")
            else:
                diff = (outs[name].float() - theirs[name].float()).abs()
                line += (f"; max abs difference from the saved run's "
                         f"{float(diff.max()):.3g}")
        print(line, flush=True)
    if save:
        torch.save(outs, save)


def wrapper_times(torch, cs, dk, rs, dev, save=None, compare=None) -> None:
    """Each kernel through its wrapper at the main path's shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    decode_times(torch, cs, dk, dev, save, compare)
    with torch.no_grad():
        for B, S, W, dt in cs.SCAN_TESTS[:3]:
            x, p = cs.scan_inputs(torch, gen, B, S, W, getattr(torch, dt),
                                  dev)
            ms = cs.graph_ms(torch, lambda: rs.rglru_scan(x, *p),
                             launches=5)
            print(f"rglru_scan ({B}, {S}, {W}) {dt}: {ms:.4f} ms a launch "
                  f"(CUDA graph)", flush=True)
        for B, S, W, dt in cs.SCAN_BWD_TESTS[:3]:
            x, p = cs.scan_inputs(torch, gen, B, S, W, getattr(torch, dt),
                                  dev)
            dh = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
            _, carry = rs._forward_kernel(x, p)
            ms = cs.graph_ms(torch, lambda: rs.rglru_scan_backward(
                x, *p, dh, carry), launches=5)
            print(f"rglru_scan_backward ({B}, {S}, {W}) {dt}: {ms:.4f} ms "
                  f"a launch (CUDA graph)", flush=True)


def scan_split(torch, cs, build, rs, dev, gen) -> None:
    """The forward scan beside its diagnostic builds, in turns."""
    libs = {"shipped": build.load("rglru_scan")}
    libs.update({n: lib for n, (lib, _) in build_variants(
        build, build.CSRC / "rglru_scan.cu", SCAN_VARIANTS,
        "rglru_scan_launch", "rglru_scan").items()})
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
            times = in_turns(torch, libs, run, work.zero_)
            print(f"scan ({B}, {S}, {W}) {dt}: " + ", ".join(
                f"{n} {min(t):.4f}-{max(t):.4f} ms" for n, t in
                times.items()), flush=True)


def scan_bwd_split(torch, cs, build, rs, dev, gen, src_path) -> None:
    """The scan's gradient kernel (``src_path``) beside its diagnostic
    builds, in turns. Scratch is sized for this source's layout and for
    PR 28's (tiles of 32 channels; its g carries and partial sums in float
    buffers of their own, two arguments after ``work``), so either runs
    on it."""
    old_iface = "void* gcarry" in open(src_path).read()
    extra = [(11, ctypes.c_void_p), (12, ctypes.c_void_p)] if old_iface \
        else ()
    libs = build_variants(build, src_path, BWD_VARIANTS,
                          "rglru_scan_bwd_launch", "rglru_scan_bwd",
                          extra=extra)
    print(f"rglru_scan_bwd diagnostic builds of {src_path}:", flush=True)
    for name, (_, regs) in libs.items():
        print(f"  {name}: {regs}", flush=True)
    libs = {n: lib for n, (lib, _) in libs.items()}
    for B, S, W, dt in BWD_SHAPES:
        x, p = cs.scan_inputs(torch, gen, B, S, W, getattr(torch, dt), dev)
        dh = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        _, hcarry = rs._forward_kernel(x, p)
        old_tiles = B * -(-W // 32) * -(-S // 256)
        work = torch.zeros((max(rs.backward_tiles(B, S, W)[1],
                                2 + old_tiles + -(-W // 32)),),
                           dtype=torch.int32, device=dev)
        scratch = [torch.empty((old_tiles * 32 * k,), dtype=torch.float32,
                               device=dev) for k in (1, 5)]
        args = tuple(t.data_ptr() for t in scratch) if old_iface else ()
        dx = torch.empty_like(x)
        grads = torch.empty((5, W), dtype=torch.float32, device=dev)

        def run(lib):
            err = lib.rglru_scan_bwd_launch(
                x.data_ptr(), *(t.data_ptr() for t in p), dh.data_ptr(),
                hcarry.data_ptr(), dx.data_ptr(), grads.data_ptr(),
                work.data_ptr(), *args, B, S, W,
                int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        times = in_turns(torch, libs, run, work.zero_)
        print(f"scan_bwd ({B}, {S}, {W}) {dt}: " + ", ".join(
            f"{n} {min(t):.4f}-{max(t):.4f} ms" for n, t in times.items()),
            flush=True)


def decode_split(torch, cs, dk, dev, gen) -> None:
    """The decode kernel at other split lengths: ``SPLIT_BLOCKS``, the
    wave ``launch_plan`` fills, set to each of ``DECODE_BLOCKS``."""
    kern = dk.decode_attention_kernel
    shipped = dk.SPLIT_BLOCKS
    for name, B, T, KV, G, hd, cache, win, rows in cs.DECODE_TESTS[:3]:
        q, k, v, ks, vs, pos, q_pos = cs.decode_inputs(
            torch, gen, B, T, KV, G, hd, cache, win, rows, dev)
        want = kern(q, k, v, pos, q_pos, win, ks, vs)
        cells = []
        for blocks in DECODE_BLOCKS:
            dk.SPLIT_BLOCKS = blocks
            try:
                L = dk.launch_plan(B, T, KV, G, hd, q.dtype, k.dtype)[2]
                got = kern(q, k, v, pos, q_pos, win, ks, vs)
                torch.cuda.synchronize()
                ok = cs.bf16_over(torch, got, want) == 0
                ms = cs.graph_ms(torch, lambda: kern(q, k, v, pos, q_pos,
                                                     win, ks, vs))
            finally:
                dk.SPLIT_BLOCKS = shipped
            cells.append(f"{blocks} blocks (L={L}) "
                         f"{ms:.4f} ms{'' if ok else ' OUT OF LIMIT'}")
        print(f"decode {name}: " + "; ".join(cells), flush=True)


def decode_diag(torch, cs, build, dk, dev) -> None:
    """The grouped and cross routes beside DECODE_VARIANTS, in turns."""
    libs = {n: lib for n, (lib, _) in build_variants(
        build, build.CSRC / "decode_attention.cu", DECODE_VARIANTS,
        "decode_attention_launch", "decode_attention").items()}
    shipped = build.load("decode_attention")
    shapes = [cs.DECODE_TESTS[2], *cs.GQA_DECODE_TESTS[:4], cs.MIXTRAL_RING,
              None]
    for shape in shapes:
        gen = torch.Generator(device=dev)
        gen.manual_seed(36)
        if shape is None:
            name, B, T, KV, G, hd, dt = cs.CROSS_DECODE_TESTS[0]
            q = torch.randn((B, 1, KV * G, hd), generator=gen, device=dev)
            k, v = (torch.randn((B, T, KV, hd), generator=gen, device=dev)
                    for _ in range(2))
            q, k, v = (x.to(getattr(torch, dt)) for x in (q, k, v))

            def call():
                return dk.cross_decode_attention_kernel(q, k, v)
            names = [n for n in libs if n == "shipped" or "cross" in n]
        else:
            name, B, T, KV, G, hd, cache, win, rows = shape
            q, k, v, ks, vs, pos, q_pos = cs.decode_inputs(
                torch, gen, B, T, KV, G, hd, cache, win, rows, dev)

            def call():
                return dk.decode_attention_kernel(q, k, v, pos, q_pos, win,
                                                  ks, vs)
            names = [n for n in libs if "cross" not in n]
        times = {n: [] for n in names}
        try:
            for n in names + names[::-1]:
                build._LOADED["decode_attention"] = libs[n]
                times[n].append(cs.graph_ms(torch, call))
        finally:
            build._LOADED["decode_attention"] = shipped
        print(f"decode diagnostic builds, {name}: " + ", ".join(
            f"{n} {min(t):.4f}-{max(t):.4f} ms" for n, t in times.items()),
            flush=True)


def decode_accuracy(torch, cs, dk, dev) -> None:
    """Over-limit counts of the grouped and split routes at many inputs."""
    kern = dk.decode_attention_kernel
    shipped = dk.launch_plan

    def split_plan(B, T, KV, G, hd, q_dtype, cache_dtype, cross=False):
        if cross:
            return shipped(B, T, KV, G, hd, q_dtype, cache_dtype, cross)
        return shipped(B, T, KV, G, hd, torch.float32, torch.float32)
    for shape, n in ((cs.DECODE_TESTS[2], 40), (cs.GQA_DECODE_TESTS[2], 12),
                     (cs.GQA_DECODE_TESTS[3], 12), (cs.MIXTRAL_RING, 12)):
        name, B, T, KV, G, hd, cache, win, rows = shape
        tally = {"grouped": [0, 0, 0.0], "split": [0, 0, 0.0]}
        for seed in range(n):
            gen = torch.Generator(device=dev)
            gen.manual_seed(1000 + seed)
            q, k, v, ks, vs, pos, q_pos = cs.decode_inputs(
                torch, gen, B, T, KV, G, hd, cache, win, rows, dev)
            want = dk.decode_attention_plain(q, k, v, pos, q_pos, win, ks, vs)
            for label in tally:
                dk.launch_plan = shipped if label == "grouped" else split_plan
                try:
                    got = kern(q, k, v, pos, q_pos, win, ks, vs)
                finally:
                    dk.launch_plan = shipped
                over = cs.bf16_over(torch, got, want)
                err = float((got.float() - want.float()).abs().max())
                t = tally[label]
                t[0], t[1], t[2] = t[0] + over, t[1] + int(over > 0), \
                    max(t[2], err)
        print(f"decode accuracy, {name}, {n} inputs: " + "; ".join(
            f"{label} route {t[0]} elements over the limit in {t[1]} "
            f"inputs, max abs err {t[2]:.3g}" for label, t in tally.items()),
            flush=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="time another checkout's package (its src)")
    ap.add_argument("--bwd-src", default=None,
                    help="the gradient kernel's source for its diagnostic "
                         "builds (default: this checkout's)")
    ap.add_argument("--bwd-only", action="store_true",
                    help="only the gradient kernel's diagnostic builds")
    ap.add_argument("--decode-diag", action="store_true",
                    help="only the decode kernel's diagnostic builds")
    ap.add_argument("--save", default=None,
                    help="keep the decode shapes' outputs in this file")
    ap.add_argument("--compare", default=None,
                    help="hold the decode shapes' outputs to this file's")
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    bwd_src = os.path.abspath(args.bwd_src) if args.bwd_src else \
        str(build.CSRC / "rglru_scan_bwd.cu")
    if args.bwd_only:
        scan_bwd_split(torch, cs, build, rs, dev, gen, bwd_src)
        return 0
    if args.decode_diag:
        decode_diag(torch, cs, build, dk, dev)
        decode_accuracy(torch, cs, dk, dev)
        return 0
    wrapper_times(torch, cs, dk, rs, dev, args.save, args.compare)
    if args.src:
        return 0
    scan_split(torch, cs, build, rs, dev, gen)
    scan_bwd_split(torch, cs, build, rs, dev, gen, bwd_src)
    decode_split(torch, cs, dk, dev, gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
