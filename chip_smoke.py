#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, on cuda:0

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, and drives the
port's paths on the card: the ``rram_accuracy`` scenario (§IV-H,
Eq. 4) and the joint and NSGA-II scenarios at their registry budget
through
``repro_torch.experiments.runner.run_scenario`` (the ``imc_fused``
kernel, keyed: it draws each design's noise itself), the Table 3
algorithm comparison (the GA and five baseline optimizers, no kernel),
every registry scenario through the campaign engine (``run --all``) and
a burst of requests through the co-design service, and the LM
co-design example
``repro_torch.examples.codesign_lm_archs`` — ``sram_lm_archs`` at its
registry budget, then the full-width qwen3-4b QKV projection through
the winning crossbar geometry (the ``imc_matmul`` kernel); and the LM
serving engine ``repro_torch.serve.ServeEngine`` on qwen3-4b at full
width (the ``flash_attention`` kernel in every prefill). Phases:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build time (one nvcc per source, started together), with
     each kernel's registers and spills as ptxas prints them;
  3. the device normal draw (``csrc/threefry.cuh``) on all 2^23
     uniforms it can make vs ``random.normal_of_bits``, bitwise; then
     ``imc_fused`` at the main-path shapes (P = 24, 96, 120, 480), the
     four shape families of tests/test_kernels.py and one with several
     cluster rounds, row groups and column tiles, bitwise: the
     keyed kernel's raw and z_out vs ``imc_fused_keyed_plain``, the
     eps-taking kernel vs ``imc_fused_plain``, the old route (host
     draws + eps kernel) vs the keyed kernel; at the main shapes the
     keyed kernel and the old route timed in turns (old, keyed, keyed,
     old) by CUDA events around back-to-back calls (the host side of
     each call included), each kernel's device time per launch from a
     CUDA graph of 20 launches, beside the plain version and the bound;
  4. the accuracy model, backend 'cuda' vs 'ref', on 120 sampled RRAM
     genomes, bitwise;
  5. ``rram_accuracy`` end to end on the card through backend 'cuda':
     the keyed kernel's launch count must rise on that run, the
     eps-taking kernel's must not, and no ``random.normal`` call may
     come from the accuracy model; then again through backend 'ref'
     (whose host draws the same probe must see): the same best design
     and a bitwise-equal best score;
  6. the run's best genome re-scored on the CPU (backend 'jnp'), rtol 1e-4;
  7. ``rram_smoke`` (EDAP only, no kernel) end to end on the card;
  8. ``imc_matmul`` kernel vs ``imc_matmul_plain``, bitwise, at the
     tests/test_kernels.py shapes and ADC widths, the host oracle's shape,
     the full-width projection and a whole seq=256 prefill of it at every
     registry row count, and at ``w_scale=0.7`` (an ADC step that is not
     a power of two) with 40, 20, 11, 10 and 5 crossbar tiles, 8- and
     12-bit ADCs, M and N off the kernel's tiles; at each ``w_scale=0.7``
     shape the per-tile plain outputs summed in tile order must equal the
     plain version and the kernel, and at the projection and (4, 2560,
     64) summed in reverse order they must not (the check's power to see
     a kernel that combines tiles out of order); at the oracle,
     projection and prefill shapes the cluster size and columns a thread
     the launch picks, the device
     time per launch from a CUDA graph and the time per call by CUDA
     events, beside the plain version and the bound (the adds of the set
     bits of these codes, and the dense 8 M K N beside it);
  9. ``accuracy_proxy_host(use_kernel=True)`` (one ``imc_matmul`` launch
     per genome) vs the ``imc_fused`` accuracy model on 24 RRAM genomes,
     atol 5e-3;
 10. the LM co-design example end to end on the card; ``imc_matmul``'s
     launch count must rise on that run, the projection must equal the
     plain version's, and the best genome is re-scored on the CPU,
     rtol 1e-5;
 11. ``flash_attention`` kernel vs ``flash_attention_plain`` at the
     tests/test_kernels.py shapes plus the non-causal ragged (1, 40, 40,
     2, 16) case and bfloat16 edge shapes of the tensor-core route
     (head dims 8-256, S and T off the tiles, a window, a query offset,
     B and H above 1) (atol 2e-5 float32, 2e-2 bfloat16; in bfloat16
     also every element within two bf16 steps of the plain value plus
     1e-4); the float32 CUDA-core route timed once at S = T = 2048; and
     at the serving shapes (B=1, 32 heads expanded from 8 KV heads,
     hd 128, bf16, causal, S = T in {512, 2048, 4096}, and S=4096 with a
     1024 window), with CUDA-event timings beside the plain version,
     PyTorch's ``scaled_dot_product_attention`` and the bound; then the
     bf16 limit's power: one 32-key tile dropped from the late rows at
     S=4096 (a dense masked softmax) must fail it;
 12. qwen3-4b at full width (36 layers, bf16, seeded random weights)
     served by ``ServeEngine(n_slots=4, max_len=4352)``: 8 requests with
     prompt lengths drawn in 256..4096 by ``numpy.random.default_rng(0)``,
     16 new tokens each; every request must finish with 16 in-vocabulary
     tokens and the flash kernel must launch 36 x 8 = 288 times; wall,
     prefill and decode tokens/s, peak memory; then the kernel vs the
     plain version at each of the 8 ragged prompt lengths (the shapes
     the prefills gave it, limits as in phase 11), timed alone there for
     its share of the prefill time;
 13. qwen3-4b's widths cut to 2 layers, float32, the same seeded weights
     on the CPU and the card: one 512-token prefill's last-token logits
     through the kernel (card) and the plain version (CPU) must agree to
     1e-3 x max|logits|;
 14. ``joint_rram_resnet_family`` (joint hardware x ResNet-architecture
     co-search under a 60% accuracy floor) at its registry budget
     through backend 'cuda' (the keyed kernel's launch count must rise,
     no host noise draw) and then 'ref': the same best design, the same
     ``joint`` block (chosen architecture) and a bitwise-equal best
     score; the best genome, arch columns included, re-scored on the CPU
     (rtol 1e-4);
 15. the keyed kernel at joint-space flat indices: P=120 designs drawn in
     the RRAM x resnet_family space (2,150,400 x 48 designs), every index
     above 2^24, on the accuracy model's calibration operands, bitwise
     against ``imc_fused_keyed_plain``; its device time a launch from a
     CUDA graph beside phase 3's;
 16. ``rram_tech_cost_mo`` (EDAP x cost) and ``joint_rram_mo`` (EDAP x
     accuracy loss) through the NSGA-II engine at their registry budget:
     the searched front's size and hypervolume, and every front design
     re-scored on the CPU (EDAP and cost rtol 1e-5, accuracy loss 1e-4);
 17. ``rram_tech_cost`` (single objective, node in the genome): its
     post-hoc front, hypervolume and generalization gap table, and the
     best genome re-scored on the CPU (rtol 1e-5);
 18. ``table3_reduced_rram`` (paper Table 3, §III-C1) at its registry
     budget (24 designs, 40 iterations, 5 seeds as lanes): the GA, PSO,
     ES, SRES, CMA-ES and G3PCX on the reduced 240-design RRAM space;
     the card's exhaustive ground truth against the CPU's (the same
     global design, the minimum within rtol 1e-6), every algorithm's
     per-seed best genome re-scored on the CPU (rtol 1e-5) with the hits
     recomputed from those scores, no kernel launch (EDAP only); then
     the same study through the port on the CPU at the same budget and
     seeds, each algorithm's per-seed best genome equal to the card's
     (a fork is named by algorithm and seed), its score within rtol
     1e-5, the same hits, feasible counts and best algorithm; each
     algorithm's hit rate on the card and the CPU, wall time and
     evaluations, and the host time of SRES's stochastic ranking;
 19. ``alg_compare_rram``, the same study on the full RRAM space under
     the constrained objective (SRES ranks by the graded penalty
     channel), with the same checks against the best design found;
 20. ``run --all``: ``campaign.run_campaign`` over all 31 registry
     scenarios at their registry budgets with a fresh output directory
     and kernel-build cache; every bucket-kind scenario's result.json
     equal, timing fields aside, to the sequential ``run_scenario`` of it
     on the card (phases 5, 7, 10, 14, 16 and 17's runs reused); the
     buckets, lanes, padding, scenarios/s, cache counters and the keyed
     kernel's launches; then the bucket-kind scenarios again with
     ``force=True`` and the same cache: every bucket signature a hit and
     no kernel library built;
 21. the co-design service: 8 ``rram_accuracy`` requests (seeds 0..7)
     submitted before its worker starts, so one window makes one bucket
     of 8 main + 32 specific-baseline lanes through the keyed kernel;
     every response equal to its seed's sequential run on the card; the
     bucket's wall against the 8 sequential walls, the keyed launches of
     each, then each side under the profiler for its device launches
     and idle share; with time left, ``joint_rram_resnet_family`` with
     seeds 0..3;
 22. the co-design launchers and the analysis suite, each in a
     subprocess as a user runs it: ``python -m
     repro_torch.launch.search --scenario rram_accuracy`` into a fresh
     ``--out`` (its best score and design equal to phase 5's bit for
     bit); the ad-hoc flag run ``--mem sram --workloads alexnet
     --generations 1 --pga 8 --ph 40 --pe 16`` (its best genome
     re-scored on the CPU, rtol 1e-5); ``python -m
     repro_torch.launch.codesign_serve --scenario rram_smoke --requests
     4 --smoke`` (exit 0, the cached replay verified, its stats block);
     ``python -m repro_torch.analysis --all --device cuda`` (exit 0, the
     66 kernel ids of analysis/baseline.json, each within the ``cuda``
     block of analysis/torch_baseline.json, the host-sync sites it found
     under ``set_sync_debug_mode("warn")`` with their frames); then each
     audited call again in this process under the profiler: its
     dispatched ATen ops beside its device kernel launches, the keyed
     kernel's launches, the five most dispatched ops of
     ``rram_accuracy::kernel`` and the phase's wall.

Every phase raises on failure and the script then exits non-zero. The
line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository beside it, it exits 1 and prints
no result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# instruction rates of the H100 SXM's pipes at its 1.98 GHz boost clock,
# 132 SMs: per SM and clock 64 INT32 lanes, 128 FP32 lanes (the 67 TFLOP/s
# counts an FMA as 2), 64 FP64 lanes (the data sheet's 34 TFLOP/s FP64,
# FMA as 2); conversions to or from 64-bit types 16 per SM and clock (CUDA
# C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0)
SM_CLOCKS = 132 * 1.98e9
RATE_INT32 = 64 * SM_CLOCKS
RATE_FP32 = 128 * SM_CLOCKS
RATE_FP64 = 64 * SM_CLOCKS
RATE_CVT64 = 16 * SM_CLOCKS
# per normal draw (csrc/threefry.cuh): threefry2x32 is 2 key adds, 20
# rounds of add / rotate / xor and 5 key injections of 2 adds, then the
# xor of its two words (73 INT32 operations), and the uniform's shift and
# or (2); erf_inv's 8 Horner steps are a float64 multiply and add each
# (16 FP64) with 17 conversions (p and w to float64, each sum back); the
# uniform (4) and erf_inv outside log1pf (6) are 10 float32 operations
# (log1pf's own are not counted); noisy_weight is 40 float32 operations
# per weight element
INT_PER_HASH, INT_PER_UNIFORM = 73, 2
FP64_PER_NORMAL, CVT_PER_NORMAL = 16, 17
FP32_PER_NORMAL, FP32_PER_WEIGHT = 10, 40

# main-path shape of the accuracy model (Calib defaults, RRAM rows table)
B, K, N, SUB = 32, 256, 32, 64
ROWS = (64.0, 128.0, 256.0, 512.0)
# tests/test_kernels.py shape families: (P, B, K, N, sub, row values)
FAMILIES = [
    (3, 4, 256, 8, 64, (64.0, 128.0, 256.0)),
    (2, 2, 96, 4, 32, (32.0, 64.0, 96.0)),      # odd tiling
    (2, 3, 200, 5, 64, (64.0, 128.0)),          # ragged K
    (1, 2, 48, 4, 16, (48.0,)),                 # single group
    # beyond them: 19 sub-tiles (3 rounds of a cluster of 8), 3 groups of
    # 32 batch rows, 2 column tiles
    (3, 70, 300, 40, 16, (16.0, 48.0, 96.0)),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fused_inputs(torch, gen, P, b, k, n, rows, dev):
    x_q = torch.randint(0, 256, (b, k), generator=gen, dtype=torch.int32,
                        device=dev)
    w = torch.rand((k, n), generator=gen, device=dev) * 2.0 - 1.0
    ep = torch.randn((P, k, n), generator=gen, device=dev)
    en = torch.randn((P, k, n), generator=gen, device=dev)
    ri = torch.randint(0, len(rows), (P,), generator=gen, dtype=torch.int32,
                       device=dev)
    rt = torch.tensor(rows, dtype=torch.float32, device=dev)
    return x_q, w, ep, en, ri, rt


def time_ms(torch, fn, reps: int, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` calls,
    by CUDA events after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(torch, fn, launches: int = 20, reps: int = 10) -> float:
    """Device time of one ``fn()`` call: ``launches`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so no host
    work (the wrapper's checks, allocations and ctypes call) sits
    between two launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * launches)


def keyed_bound_ms(x_q, P, n, n_rows) -> dict:
    """Least time for the keyed kernel's work on an H100 SXM: per design
    the fold_in and split hashes (4) and the 2 * K * N + B * N normal
    draws, the noise arithmetic per weight element, the adds of the SET
    bits of these codes only (their count read from ``x_q``), each pipe
    at its instruction rate; against x_q, w, the key, flat, rows and
    table read once and raw and z_out written once. The slowest pipe or
    the bytes bound it; ``pipe`` says which."""
    b, k = x_q.shape
    normals = P * (2 * k * n + b * n)
    hashes = P * 4 + normals
    set_bits = int(sum(int(((x_q >> q) & 1).sum()) for q in range(8)))
    pipes = {
        "INT32": (hashes * INT_PER_HASH + normals * INT_PER_UNIFORM)
        / RATE_INT32,
        "FP64": normals * FP64_PER_NORMAL / RATE_FP64,
        "CVT64": normals * CVT_PER_NORMAL / RATE_CVT64,
        "FP32": (normals * FP32_PER_NORMAL + P * k * n * FP32_PER_WEIGHT
                 + P * n * set_bits) / RATE_FP32,
    }
    nbytes = 4 * (b * k + k * n + P + n_rows + 2 * P * b * n) + 8 * (2 + P)
    t_bytes = nbytes / PEAK_HBM_BYTES
    pipe = max(pipes, key=pipes.get)
    t_ops = pipes[pipe]
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pipe": pipe if t_ops >= t_bytes else "HBM",
            "pipes_ms": {kk: v * 1e3 for kk, v in pipes.items()},
            "bytes_ms": t_bytes * 1e3, "normals": normals,
            "set_bits": set_bits, "bytes": nbytes}


def keyed_inputs(torch, jr, gen, P, b, k, n, rows, dev):
    """x_q, w, k_noise, flat (below 2^31), rows_idx, row_table."""
    x_q = torch.randint(0, 256, (b, k), generator=gen, dtype=torch.int32,
                        device=dev)
    w = torch.rand((k, n), generator=gen, device=dev) * 2.0 - 1.0
    seed, *flat = torch.randint(0, 2 ** 31, (P + 1,), generator=gen,
                                device=dev).tolist()
    ri = torch.randint(0, len(rows), (P,), generator=gen, dtype=torch.int32,
                       device=dev)
    rt = torch.tensor(rows, dtype=torch.float32, device=dev)
    return (x_q, w, jr.PRNGKey(seed, dev),
            torch.tensor(flat, dtype=torch.int64, device=dev), ri, rt)


def old_route(jr, fused, x_q, w, key, flat, ri, rt, sub):
    """The accuracy call's work before the keyed kernel: the host draws
    (int64 threefry ops), then the eps-taking kernel."""
    kk = jr.split(jr.fold_in(key, flat), 3)
    ep, en = jr.normal(kk[:, 0], w.shape), jr.normal(kk[:, 1], w.shape)
    z = jr.normal(kk[:, 2], (x_q.shape[0], w.shape[1]))
    return fused.imc_fused_gemm(x_q, w, ep, en, ri, rt, sub=sub), z


def check_normal_of_bits(torch, jr, fused, dev) -> None:
    """The device draw's transform on all 2^23 uniforms it can make,
    bit for bit against random.py's on the card."""
    bits = torch.arange(1 << 23, dtype=torch.int64, device=dev) << 9
    got = fused.normal_of_bits(bits)
    want = jr.normal_of_bits(bits)
    torch.cuda.synchronize()
    ulp = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    n_off = int((ulp != 0).sum())
    if n_off or not torch.isfinite(got).all():
        raise RuntimeError(f"normal_of_bits: {n_off} of {bits.numel()} "
                           f"uniforms differ, max {int(ulp.max())} ULP")
    log(f"threefry.cuh normal on all {bits.numel()} uniforms: bitwise equal "
        f"to random.normal_of_bits on the card")


def phase_kernel(torch, fused, dev) -> dict:
    """Phase 3: both imc_fused routes vs their plain versions, bit for
    bit, at the main-path and test shapes; the keyed kernel timed in
    turns with the old route, beside its plain version and bound."""
    from repro_torch import random as jr
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    check_normal_of_bits(torch, jr, fused, dev)
    shapes = [(P, B, K, N, SUB, ROWS) for P in (24, 96, 120, 480)]
    shapes += FAMILIES
    main = None
    for P, b, k, n, sub, rows in shapes:
        args = fused_inputs(torch, gen, P, b, k, n, rows, dev)
        got = fused.imc_fused_gemm(*args, sub=sub)
        want = fused.imc_fused_plain(*args, sub=sub)
        kargs = keyed_inputs(torch, jr, gen, P, b, k, n, rows, dev)
        raw, z = fused.imc_fused_gemm_keyed(*kargs, sub=sub)
        want_raw, want_z = fused.imc_fused_keyed_plain(*kargs, sub=sub)
        old_raw, old_z = old_route(jr, fused, *kargs, sub)
        torch.cuda.synchronize()
        err = max(float((got - want).abs().max()),
                  float((raw - want_raw).abs().max()))
        if not (torch.equal(got, want) and torch.equal(raw, want_raw)
                and torch.equal(z, want_z) and torch.equal(old_raw, raw)
                and torch.equal(old_z, z)):
            raise RuntimeError(
                f"imc_fused P={P} B={b} K={k} N={n} sub={sub}: not bitwise "
                f"equal (eps route {torch.equal(got, want)}, keyed raw "
                f"{torch.equal(raw, want_raw)}, z_out "
                f"{torch.equal(z, want_z)}, old route "
                f"{torch.equal(old_raw, raw)}), max abs err {err:.3g}")
        line = (f"imc_fused P={P} B={b} K={k} N={n} sub={sub}: keyed raw and "
                f"z_out, eps route and old route bitwise equal")
        if (b, k, n) == (B, K, N):
            # device time per launch (CUDA graph), then the time per call
            # with the host side included, keyed and old route in turns
            ms = graph_ms(torch, lambda: fused.imc_fused_gemm_keyed(
                *kargs, sub=sub))
            eps_ms = graph_ms(torch, lambda: fused.imc_fused_gemm(
                *args, sub=sub))
            turns = []
            for fn in ("old", "keyed", "keyed", "old"):
                call = ((lambda: old_route(jr, fused, *kargs, sub))
                        if fn == "old" else
                        (lambda: fused.imc_fused_gemm_keyed(*kargs,
                                                            sub=sub)))
                turns.append(time_ms(torch, call,
                                     reps=10 if fn == "old" else 50))
            call_ms, old_ms = min(turns[1:3]), min(turns[0], turns[3])
            plain_ms = time_ms(torch, lambda: fused.imc_fused_keyed_plain(
                *kargs, sub=sub), reps=3, windows=3)
            bound = keyed_bound_ms(kargs[0], P, n, len(rows))
            line += (f"; device time per launch: keyed kernel {ms:.4f} ms, "
                     f"eps kernel {eps_ms:.4f} ms; per call (host side "
                     f"included), in turns: keyed {turns[1]:.4f}/"
                     f"{turns[2]:.4f} ms, old route (host draws + eps kernel)"
                     f" {turns[0]:.4f}/{turns[3]:.4f} ms; keyed plain "
                     f"{plain_ms:.4f} ms; bound "
                     f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
                     f"{bound['pipe']}; pipes ms "
                     + ", ".join(f"{kk} {v:.4f}" for kk, v in
                                 bound["pipes_ms"].items())
                     + f", HBM {bound['bytes_ms']:.4f}; {bound['normals']} "
                     f"normals, {bound['set_bits']} set bits of x_q, "
                     f"{bound['bytes'] / 1e6:.3f} MB)")
            if P == 120:
                main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "call_ms": call_ms, "old_ms": old_ms,
                        "eps_ms": eps_ms, **bound}
        log(line)
    return main


# phase 8 shapes (M, K, N, R, adc_bits, w_scale): tests/test_kernels.py's
# five shapes and four ADC widths; the host oracle's calibration GEMM; the
# full-width qwen3-4b QKV projection (d_model 2560, 3 * 32 * 128 columns)
# and one whole seq=256 prefill of it, at every registry row count
REGISTRY_ROWS = (64, 128, 256, 512)
MATMUL_TESTS = [(8, 128, 16, 128, 8, 1.0), (16, 256, 32, 128, 8, 1.0),
                (32, 512, 64, 256, 8, 1.0), (8, 384, 8, 128, 8, 1.0),
                (8, 512, 8, 512, 8, 1.0)]
MATMUL_TESTS += [(8, 256, 16, 128, b, 1.0) for b in (4, 6, 8, 12)]
ORACLE = (32, 256, 32)
PROJ = (16, 2560, 12288)
PREFILL = (256, 2560, 12288)
# w_scale=0.7: the ADC step is not a power of two and the tile values
# round when added, so only the plain version's tile order gives its bits.
# 40 and 5 tiles at the projection and at (4, 2560, 64) with 8- and
# 12-bit ADCs (where reversing the order must show), 11 tiles in rounds
# of 6 and 5, M and N off the 16 x 128 tiles and off whole float4s, and
# M=256 with 20 tiles
MATMUL_ORDER = [(*PROJ, r, b, 0.7) for r in (64, 512) for b in (8, 12)]
MATMUL_ORDER += [(4, 2560, 64, 64, 8, 0.7), (4, 2560, 64, 64, 12, 0.7),
                 (4, 2560, 64, 512, 12, 0.7), (20, 704, 70, 64, 8, 0.7),
                 (21, 2560, 12290, 256, 12, 0.7),
                 (256, 2560, 12288, 128, 12, 0.7)]
ORDER_MUST_SHOW = {PROJ, (4, 2560, 64)}


def matmul_bound_ms(x_q, k, n) -> dict:
    """Least time for the bit-serial GEMM on an H100 SXM: the adds of the
    set bits of these codes (each a float32 add at half the 67 TFLOP/s
    FMA rate; an unset bit adds an exact zero, so it is not work), against
    each operand read once and the output written once. ``k`` is the
    unpadded depth: the zero rows that pad K to whole crossbars add
    nothing. ``dense_ms`` is the same bound for all 8 M K N adds."""
    m = x_q.shape[0]
    set_bits = int(sum(int(((x_q >> q) & 1).sum()) for q in range(8)))
    adds = set_bits * n
    nbytes = 4 * (m * k + k * n + m * n)
    t_ops = 2 * adds / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "adds": adds, "dense_ms": 2 * 8 * m * k * n / PEAK_FP32_FLOPS
            * 1e3, "bytes": nbytes}


def tile_order_check(torch, mm, x_q, w, r, bits, ws, want, got) -> int:
    """The per-tile plain outputs summed in tile order must equal the
    plain version and the kernel; returns how many outputs differ from
    the plain version when they are summed in reverse order."""
    tiles = [mm.imc_matmul_plain(x_q[:, t:t + r], w[t:t + r], xbar_rows=r,
                                 adc_bits=bits, w_scale=ws)
             for t in range(0, x_q.shape[1], r)]
    fwd, rev = torch.zeros_like(want), torch.zeros_like(want)
    for a, b in zip(tiles, tiles[::-1]):
        fwd += a
        rev += b
    if not (torch.equal(fwd, want) and torch.equal(got, fwd)):
        raise RuntimeError(f"imc_matmul R={r} adc_bits={bits} w_scale={ws}: "
                           "the tiles summed in order differ from the "
                           "plain version or the kernel")
    return int((rev != want).sum())


def phase_matmul(torch, mm, dev) -> dict:
    """Phase 8: imc_matmul kernel vs plain, bitwise (any w_scale); the
    tile-order power check; times by shape."""
    from repro_torch.kernels import build
    lib = build.load("imc_matmul")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    shapes = list(MATMUL_TESTS)
    shapes += [(*ORACLE, r, 8, 1.0) for r in REGISTRY_ROWS]
    shapes += [(*PROJ, r, 8, 1.0) for r in REGISTRY_ROWS]
    shapes += [(*PREFILL, r, 8, 1.0) for r in REGISTRY_ROWS]
    shapes += MATMUL_ORDER
    worst, timed = 0.0, {}
    for m, k, n, r, bits, ws in shapes:
        x_q = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.int32,
                            device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * 0.25
        # K zero-padded to whole crossbars, as kernels/ops.imc_gemm does
        x_q = torch.nn.functional.pad(x_q, (0, (-k) % r))
        w = torch.nn.functional.pad(w, (0, 0, 0, (-k) % r))
        before = mm.imc_matmul.launches
        got = mm.imc_matmul(x_q, w, xbar_rows=r, adc_bits=bits, w_scale=ws)
        want = mm.imc_matmul_plain(x_q, w, xbar_rows=r, adc_bits=bits,
                                   w_scale=ws)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err != 0.0 or not torch.equal(got, want) or \
                mm.imc_matmul.launches != before + 1:
            raise RuntimeError(f"imc_matmul M={m} K={k} N={n} R={r} "
                               f"adc_bits={bits} w_scale={ws}: kernel != "
                               f"plain (max abs err {err})")
        worst = max(worst, err)
        line = (f"imc_matmul M={m} K={k} N={n} R={r} adc_bits={bits} "
                f"w_scale={ws}: bitwise equal")
        if ws != 1.0:
            off = tile_order_check(torch, mm, x_q, w, r, bits, ws, want, got)
            if (m, k, n) in ORDER_MUST_SHOW and off == 0:
                raise RuntimeError(f"imc_matmul M={m} K={k} N={n} R={r}: "
                                   "the reversed tile order gives the plain "
                                   "version's bits; the check has no power")
            line += (f"; tiles summed in order equal it, in reverse order "
                     f"{off} of {m * n} outputs differ")
        if (m, k, n) in (ORACLE, PROJ, PREFILL) and ws == 1.0:
            def call():
                return mm.imc_matmul(x_q, w, xbar_rows=r, adc_bits=bits)
            big = (m, k, n) == PREFILL
            dev_ms = graph_ms(torch, call, launches=5 if big else 20,
                              reps=3 if big else 10)
            ms = time_ms(torch, call, reps=200 if (m, k, n) == ORACLE else
                         5 if big else 20)
            plain_ms = time_ms(torch, lambda: mm.imc_matmul_plain(
                x_q, w, xbar_rows=r, adc_bits=bits), reps=1,
                windows=1 if big else 3)
            bound = matmul_bound_ms(x_q, k, n)
            timed[(m, k, n, r)] = {"ms": dev_ms, "call_ms": ms,
                                   "plain_ms": plain_ms, **bound}
            cluster, cols = ctypes.c_int(), ctypes.c_int()
            lib.imc_matmul_plan(m, x_q.shape[1], n, r,
                                ctypes.addressof(cluster),
                                ctypes.addressof(cols))
            line += (f", clusters of {cluster.value} CTAs, {cols.value} "
                     f"columns a thread, kernel {dev_ms:.4f} ms a "
                     f"launch (CUDA graph), "
                     f"{ms:.4f} ms a call, plain {plain_ms:.4f} ms, bound "
                     f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
                     f"{bound['adds'] / 1e9:.3f} G adds of set bits, "
                     f"{bound['bytes'] / 1e6:.2f} MB; all 8 M K N adds "
                     f"{bound['dense_ms']:.4f} ms)")
        log(line)
    return {"max_abs_err": worst, "timed": timed}


def phase_host_oracle(torch, mm, dev) -> None:
    """Phase 9: the host oracle through imc_matmul vs the imc_fused
    accuracy model on the same 24 RRAM genomes."""
    from repro_torch import random as jr
    from repro_torch.core import get_space, get_workload_set, pack
    from repro_torch.core.nonideal import (accuracy_proxy_host,
                                           make_accuracy_model)
    from repro_torch.core.sampling import uniform_genomes
    space = get_space("rram")
    wa = pack(get_workload_set(("resnet18", "vgg16", "alexnet",
                                "mobilenetv3")))
    cards = torch.as_tensor(space.cardinalities, dtype=torch.float32,
                            device=dev)
    g = uniform_genomes(jr.PRNGKey(11, dev)[None], cards, 24)[0]
    before = mm.imc_matmul.launches
    t0 = time.perf_counter()
    host = accuracy_proxy_host(space, g.cpu().numpy(), wa, use_kernel=True,
                               device=dev)
    wall = time.perf_counter() - t0
    launches = mm.imc_matmul.launches - before
    model = make_accuracy_model(space, wa, backend="cuda", device=dev)(g)
    model = model.cpu().numpy()
    err = float(abs(host - model).max())
    if launches != 24 or host.shape != (24, 4) or not math.isfinite(err) \
            or err > 5e-3:
        raise RuntimeError(f"host oracle: {launches} imc_matmul launches, "
                           f"shape {host.shape}, max abs err {err} vs the "
                           "imc_fused model")
    log(f"accuracy_proxy_host(use_kernel=True) on 24 genomes: {launches} "
        f"imc_matmul launches, {wall:.3f} s, max abs err {err:.3g} vs the "
        f"imc_fused model")


def phase_lm_example(torch, mm, dev) -> dict:
    """Phase 10: the LM co-design example at its registry budget."""
    from repro_torch.examples import codesign_lm_archs as example
    mm.imc_matmul.launches = 0
    t0 = time.perf_counter()
    out = example.run(full=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mm.imc_matmul.launches
    res, proj = out["result"], out["projection"]
    if launches <= 0:
        raise RuntimeError("the LM example did not launch imc_matmul")
    if not (math.isfinite(res["best_score"]) and res["best_score"] < 1e29):
        raise RuntimeError(f"sram_lm_archs: best score {res['best_score']}")
    if sorted(res.get("specific", {})) != sorted(res["workloads"]) or \
            len(res["workloads"]) != 5:
        raise RuntimeError("sram_lm_archs: specific baselines missing")
    y, r = proj["y"], proj["xbar_rows"]
    pad = (-proj["x"].shape[1]) % r
    want = mm.imc_matmul_plain(
        torch.nn.functional.pad(proj["x"], (0, pad)),
        torch.nn.functional.pad(proj["w"], (0, 0, 0, pad)), xbar_rows=r)
    if proj["shape"] != PROJ or tuple(y.shape) != (PROJ[0], PROJ[2]) or \
            not torch.isfinite(y).all() or not torch.equal(y, want) or \
            not proj["rel_err"] < 0.5:  # correlated with the exact product
        raise RuntimeError(f"projection: shape {proj['shape']}, rel err "
                           f"{proj['rel_err']}, equal to plain "
                           f"{torch.equal(y, want)}")
    log(f"sram_lm_archs on {res['device']['name']}: wall "
        f"{out['scenario_wall_s']:.2f} s (example {wall:.2f} s), best "
        f"{res['objective']} {res['best_score']:.6g}, budget {res['budget']}")
    log(f"sram_lm_archs best design: "
        f"{json.dumps(res['generalized']['design'])}")
    log(f"qwen3-4b QKV projection {proj['shape']} on Xbar_rows="
        f"{proj['xbar_rows']}: rel err {proj['rel_err']:.4f} vs the exact "
        f"product, equal to imc_matmul_plain; imc_matmul launches "
        f"{launches}")
    return {"res": res, "launches": launches, "rows": proj["xbar_rows"]}


def phase_accuracy(torch, dev) -> None:
    """Phase 4: accuracy model 'cuda' vs 'ref' on 120 RRAM genomes."""
    from repro_torch import random as jr
    from repro_torch.core import get_space, get_workload_set, pack
    from repro_torch.core.nonideal import make_accuracy_model
    from repro_torch.core.sampling import uniform_genomes
    space = get_space("rram")
    wa = pack(get_workload_set(("resnet18", "vgg16", "alexnet",
                                "mobilenetv3")))
    cards = torch.as_tensor(space.cardinalities, dtype=torch.float32,
                            device=dev)
    g = uniform_genomes(jr.PRNGKey(7, dev)[None], cards, 120)[0]
    acc_k = make_accuracy_model(space, wa, backend="cuda", device=dev)(g)
    acc_r = make_accuracy_model(space, wa, backend="ref", device=dev)(g)
    torch.cuda.synchronize()
    if acc_k.shape != (120, 4) or not torch.isfinite(acc_k).all():
        raise RuntimeError(f"accuracy model: bad output {acc_k.shape}")
    if not torch.equal(acc_k, acc_r):
        raise RuntimeError(f"accuracy model cuda != ref: max abs err "
                           f"{float((acc_k - acc_r).abs().max())}")
    log(f"accuracy model cuda vs ref on 120 genomes: bitwise equal, mean "
        f"accuracy {float(acc_k.mean()):.4f}")


class HostDraws:
    """Counts ``repro_torch.random.normal`` calls made inside the
    accuracy model's calls (a frame of ``accuracy`` in core/nonideal.py
    on the stack): the host's noise draws."""

    def __init__(self):
        from repro_torch import random as jr
        self.jr, self.real, self.calls = jr, jr.normal, 0

    def __enter__(self):
        def normal(key, shape):
            f = sys._getframe(1)
            while f is not None:
                code = f.f_code
                if code.co_name == "accuracy" and code.co_filename.endswith(
                        os.path.join("core", "nonideal.py")):
                    self.calls += 1
                    break
                f = f.f_back
            return self.real(key, shape)
        self.jr.normal = normal
        return self

    def __exit__(self, *exc):
        self.jr.normal = self.real


def phase_scenario(torch, name, dev, out_dir) -> dict:
    """Phases 5 and 7: one registry scenario end to end on the card."""
    from repro_torch.experiments import get_scenario
    from repro_torch.experiments.runner import run_scenario
    sc = get_scenario(name)
    t0 = time.perf_counter()
    res = run_scenario(sc, out_dir=out_dir, force=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (math.isfinite(res["best_score"]) and res["best_score"] < 1e29):
        raise RuntimeError(f"{name}: best score {res['best_score']}")
    log(f"{name} on {res['device']['name']}: wall {wall:.2f} s, backend "
        f"{res['backend']}, best {res['objective']} {res['best_score']:.6g}, "
        f"budget {res['budget']}")
    log(f"{name} best design: {json.dumps(res['generalized']['design'])}")
    return res


def phase_scenario_ref(torch, dev, res) -> dict:
    """Phase 5, second half: ``rram_accuracy`` again on the card through
    backend 'ref' (host draws + the plain fused dataflow); the same best
    genome and a bitwise-equal best score as the 'cuda' run ``res``."""
    import dataclasses
    from repro_torch.experiments import get_scenario
    from repro_torch.experiments.runner import run_scenario
    sc = dataclasses.replace(get_scenario("rram_accuracy"), backend="ref")
    with HostDraws() as draws:
        t0 = time.perf_counter()
        ref = run_scenario(sc, write=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    same = (ref["generalized"]["design"] == res["generalized"]["design"]
            and ref["best_score"] == res["best_score"])
    if not same or ref["backend"] != "ref" or draws.calls <= 0:
        raise RuntimeError(
            f"rram_accuracy ref vs cuda: best {ref['best_score']!r} vs "
            f"{res['best_score']!r}, designs equal "
            f"{ref['generalized']['design'] == res['generalized']['design']},"
            f" host draws seen {draws.calls}")
    log(f"rram_accuracy backend ref on the card: wall {wall:.2f} s, "
        f"{draws.calls} host normal draws in the accuracy model; same best "
        f"design, best {ref['objective']} {ref['best_score']!r} == cuda "
        f"{res['best_score']!r}")
    return ref


def phase_rescore_cpu(res, rtol: float = 1e-4) -> None:
    """Phases 6, 10 and 14: the card's best genome re-scored by the port
    on the CPU; the genome is decoded over every column of the
    scenario's space, the architecture columns of a joint space too."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.experiments import get_scenario
    from repro_torch.experiments.runner import (build_scenario_scorer,
                                                setup_scenario)
    sc = get_scenario(res["scenario"])
    st = setup_scenario(sc)
    sc_cpu = dataclasses.replace(sc, backend="jnp")
    scorer = build_scenario_scorer(sc_cpu, st, device="cpu")
    d = res["generalized"]["design"]
    genome = [int(np.flatnonzero(st.space.values[i] == np.float32(d[n]))[0])
              for i, n in enumerate(st.space.names)]
    cpu = float(scorer.score(torch.tensor([genome]))[0])
    card = res["generalized"]["objective_score"]
    if not math.isclose(cpu, card, rel_tol=rtol):
        raise RuntimeError(f"CPU re-score {cpu} != card score {card}")
    log(f"best genome re-scored on the CPU (jnp): {cpu:.6g} vs card "
        f"{card:.6g} (rel {abs(cpu - card) / abs(card):.2e})")


def _genome_of(space, design) -> list:
    """Value indices of a decoded design over every column of the space
    (hardware and architecture)."""
    import numpy as np
    return [int(np.flatnonzero(space.values[i] == np.float32(design[n]))[0])
            for i, n in enumerate(space.names)]


def phase_joint(torch, fused, dev, out_dir) -> dict:
    """Phase 14: ``joint_rram_resnet_family`` on the card through backend
    'cuda' (no host draw; the keyed kernel's launches counted) and then
    'ref': the same best design and chosen architecture, a bitwise-equal
    best score; then the best genome re-scored on the CPU."""
    import dataclasses
    from repro_torch.experiments import get_scenario
    from repro_torch.experiments.runner import run_scenario
    name = "joint_rram_resnet_family"
    with HostDraws() as draws:
        fused.imc_fused_gemm_keyed.launches = 0
        fused.imc_fused_gemm.launches = 0
        res = phase_scenario(torch, name, dev, out_dir)
        launches = fused.imc_fused_gemm_keyed.launches
        eps_launches = fused.imc_fused_gemm.launches
    if launches <= 0 or eps_launches or draws.calls or \
            res["backend"] != "cuda":
        raise RuntimeError(
            f"{name} did not run the keyed kernel alone: keyed launches "
            f"{launches}, eps kernel launches {eps_launches}, host normal "
            f"draws {draws.calls}, backend {res['backend']}")
    log(f"{name}: imc_fused keyed launches {launches}, host noise draws in "
        f"the accuracy model 0; chosen models "
        f"{res['joint']['chosen_models']}, arch "
        f"{json.dumps(res['joint']['arch_params'])}")
    sc = dataclasses.replace(get_scenario(name), backend="ref")
    with HostDraws() as draws:
        t0 = time.perf_counter()
        ref = run_scenario(sc, write=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    same = (ref["generalized"]["design"] == res["generalized"]["design"]
            and ref["joint"] == res["joint"]
            and ref["best_score"] == res["best_score"])
    if not same or ref["backend"] != "ref" or draws.calls <= 0:
        raise RuntimeError(
            f"{name} ref vs cuda: best {ref['best_score']!r} vs "
            f"{res['best_score']!r}, designs equal "
            f"{ref['generalized']['design'] == res['generalized']['design']},"
            f" joint blocks equal {ref['joint'] == res['joint']}, host "
            f"draws seen {draws.calls}")
    log(f"{name} backend ref on the card: wall {wall:.2f} s, {draws.calls} "
        f"host normal draws in the accuracy model; same best design and "
        f"chosen models, best {ref['best_score']!r} == cuda "
        f"{res['best_score']!r}")
    phase_rescore_cpu(res)
    return {"res": res, "launches": launches}


def phase_keyed_joint(torch, fused, dev) -> dict:
    """Phase 15: the keyed kernel at the joint RRAM x resnet_family
    space's flat indices (P=120 designs drawn in that space, bits_cell
    index at least 1 so every index is above 2^24), bitwise against
    ``imc_fused_keyed_plain`` on the accuracy model's calibration
    operands; its device time a launch from a CUDA graph."""
    import numpy as np
    from repro_torch import random as jr
    from repro_torch.core import get_family, get_space, joint_space
    from repro_torch.core.nonideal import (CALIB_SEED, calibration_data,
                                           flat_index_strides,
                                           quantize_activations)
    from repro_torch.core.sampling import uniform_genomes
    space = joint_space(get_space("rram"), [get_family("resnet_family")])
    cards = torch.as_tensor(space.cardinalities, dtype=torch.float32,
                            device=dev)
    g = uniform_genomes(jr.PRNGKey(15, dev)[None], cards, 120)[0]
    bi = space.index("bits_cell")
    g[:, bi] = torch.clamp(g[:, bi], min=1)
    strides = torch.as_tensor(flat_index_strides(space), device=dev)
    flat = (g * strides).sum(dim=1).contiguous()
    ks = jr.split(jr.PRNGKey(CALIB_SEED, dev))
    x, w = calibration_data(ks[0], B, K, N)
    x_q = quantize_activations(x).contiguous()
    rows_i = space.index("xbar_rows")
    rows_idx = g[:, rows_i].to(torch.int32).contiguous()
    row_table = torch.as_tensor(space.values[rows_i], device=dev)
    args = (x_q, w.contiguous(), ks[1].contiguous(), flat, rows_idx,
            row_table)
    raw, z = fused.imc_fused_gemm_keyed(*args, sub=SUB)
    want_raw, want_z = fused.imc_fused_keyed_plain(*args, sub=SUB)
    torch.cuda.synchronize()
    lo, hi = int(flat.min()), int(flat.max())
    # the flat indices a float32 step would change
    lossy = int((flat.float().long() != flat).sum())
    err = float((raw - want_raw).abs().max())
    if lo <= 2 ** 24 or hi >= 2 ** 31 or space.size != 2150400 * 48 or \
            not (torch.equal(raw, want_raw) and torch.equal(z, want_z)):
        raise RuntimeError(
            f"keyed kernel at joint indices {lo}..{hi}: raw equal "
            f"{torch.equal(raw, want_raw)}, z_out equal "
            f"{torch.equal(z, want_z)}, max abs err {err:.3g}")
    ms = graph_ms(torch, lambda: fused.imc_fused_gemm_keyed(*args, sub=SUB))
    log(f"imc_fused keyed kernel at P=120 joint RRAM x resnet_family "
        f"designs (space size {space.size}), flat indices {lo}..{hi} "
        f"({lossy} of 120 not exact in float32): raw and z_out bitwise "
        f"equal to imc_fused_keyed_plain; {ms:.4f} ms a launch on the "
        f"device (CUDA graph); {len(np.unique(flat.cpu().numpy()))} "
        f"distinct designs")
    return {"ms": ms, "max_abs_err": err}


def _front_rescore(res, label_rtol) -> None:
    """Every front design of a multi-objective run re-scored on the CPU
    (backend 'jnp'); each score column within its rtol."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.experiments import get_scenario
    from repro_torch.experiments.runner import (build_scenario_scorer,
                                                setup_scenario)
    sc = dataclasses.replace(get_scenario(res["scenario"]), backend="jnp")
    st = setup_scenario(sc)
    scorer = build_scenario_scorer(sc, st, device="cpu")
    front = res["pareto"]["front"]
    axes = res["pareto"]["axes"]
    g = torch.tensor([_genome_of(st.space, p["design"]) for p in front])
    cpu = scorer.score_vec(g).numpy()
    card = np.asarray([[p[a] for a in axes] for p in front])
    worst = {}
    for j, a in enumerate(axes):
        rel = np.abs(cpu[:, j] - card[:, j]) / np.abs(card[:, j])
        worst[a] = float(rel.max())
        if not (np.isfinite(cpu[:, j]).all() and worst[a] <= label_rtol[a]):
            raise RuntimeError(f"{res['scenario']}: front {a} re-scored on "
                               f"the CPU off by rel {worst[a]:.3g} (limit "
                               f"{label_rtol[a]:g})")
    log(f"{res['scenario']}: all {len(front)} front designs re-scored on the "
        f"CPU (jnp): max rel err "
        + ", ".join(f"{a} {v:.2e} (limit {label_rtol[a]:g})"
                    for a, v in worst.items()))


def phase_mo(torch, fused, dev, out_dir) -> dict:
    """Phase 16: ``rram_tech_cost_mo`` and ``joint_rram_mo`` (NSGA-II)
    on the card; front size and hypervolume; every front design re-scored
    on the CPU."""
    out = {}
    for name, rtol in (("rram_tech_cost_mo", {"edap": 1e-5, "cost": 1e-5}),
                       ("joint_rram_mo", {"edap": 1e-5, "acc_loss": 1e-4})):
        fused.imc_fused_gemm_keyed.launches = 0
        res = phase_scenario(torch, name, dev, out_dir)
        pb = res["pareto"]
        if not pb["searched"] or not pb["front"] or \
                not math.isfinite(pb["hypervolume"]):
            raise RuntimeError(f"{name}: pareto block {pb['searched']}, "
                               f"front {len(pb['front'])}, hypervolume "
                               f"{pb['hypervolume']}")
        launches = fused.imc_fused_gemm_keyed.launches
        if ("acc_loss" in pb["axes"]) != (launches > 0):
            raise RuntimeError(f"{name}: keyed kernel launches {launches}")
        log(f"{name}: searched front of {len(pb['front'])} designs "
            f"({pb['axes'][0]} x {pb['axes'][1]}) out of "
            f"{pb['n_candidates']} feasible candidates, hypervolume "
            f"{pb['hypervolume']:.6g} at {pb['ref_point']}; per-seed front "
            f"sizes {pb['front_sizes_per_seed']}; imc_fused keyed launches "
            f"{launches}")
        if "joint" in res:
            log(f"{name}: front architectures "
                f"{sorted({p['design']['resnet_family.depth'] for p in pb['front']})}"
                f" (depths), chosen at the best-EDAP end "
                f"{res['joint']['chosen_models']}")
        _front_rescore(res, rtol)
        out[name] = res
    return out


def phase_tech_cost(torch, fused, dev, out_dir) -> dict:
    """Phase 17: ``rram_tech_cost`` (single-objective EDAP x cost, the
    node in the genome) on the card: its post-hoc front, hypervolume and
    the generalization gap table."""
    fused.imc_fused_gemm_keyed.launches = 0
    res = phase_scenario(torch, "rram_tech_cost", dev, out_dir)
    launches = fused.imc_fused_gemm_keyed.launches
    pb = res["pareto"]
    if pb["searched"] or not pb["front"] or launches or \
            sorted(res["gap"]["per_workload_pct"]) != sorted(res["workloads"]):
        raise RuntimeError(f"rram_tech_cost: pareto block searched "
                           f"{pb['searched']}, front {len(pb['front'])}, gap "
                           f"{res.get('gap')}, keyed launches {launches}")
    log(f"rram_tech_cost: post-hoc front of {len(pb['front'])} designs out "
        f"of {pb['n_candidates']} feasible candidates, hypervolume "
        f"{pb['hypervolume']:.6g}, nodes "
        f"{sorted({p['tech_nm'] for p in pb['front']})} nm; imc_fused keyed "
        f"launches {launches} (EDAP x cost only)")
    log("rram_tech_cost gap (%): "
        + ", ".join(f"{w} {v:.3f}" for w, v in
                    sorted(res["gap"]["per_workload_pct"].items()))
        + f"; mean {res['gap']['mean_pct']:.3f}")
    phase_rescore_cpu(res, rtol=1e-5)
    return res


def compare_alg_compare_cpu(torch, sc, st, card_probe, res):
    """Runs the study of ``sc`` through the port on the CPU (the same
    runner, budget and seeds as the card's run) and holds the card's
    per-seed results to it. Returns (CPU result, forks) where forks maps
    each algorithm to the seed offsets whose best genome differs, all of
    them listed in ALG_COMPARE_FORKS; an unlisted fork, or a listed one
    that no longer forks, raises."""
    import dataclasses

    import numpy as np
    runner = card_probe.runner
    seeds = [sc.seed + i for i in range(sc.budget.n_seeds)]
    with AlgCompareProbe(torch, cuda=False) as probe:
        cpu_res = runner.run_alg_compare(dataclasses.replace(
            sc, backend="jnp"), st.space, st.wa, st.objective, seeds,
            device="cpu")
    forks, unexpected = {}, []
    for disp, alg in runner.TABLE3_ALGORITHMS:
        card, cpu = card_probe.results[alg], probe.results[alg]
        same = np.all(np.asarray(card.best_genomes)
                      == np.asarray(cpu.best_genomes), axis=1)
        forked = [i for i in range(len(seeds)) if not same[i]]
        if forked:
            forks[disp] = forked
        if forked != sorted(ALG_COMPARE_FORKS.get((sc.name, disp), ())):
            unexpected.append(f"{disp} seeds {[seeds[i] for i in forked]}")
        cs, ps = np.asarray(card.best_scores), np.asarray(cpu.best_scores)
        if not np.allclose(cs[same], ps[same], rtol=1e-5, atol=0):
            raise RuntimeError(f"{sc.name} {disp}: same genomes, card scores"
                               f" {cs} vs CPU {ps}")
        a, c = res["algorithms"][disp], cpu_res["algorithms"][disp]
        if not forked and (a["hits"], a["n_feasible"], a["evaluations"]) \
                != (c["hits"], c["n_feasible"], c["evaluations"]):
            raise RuntimeError(
                f"{sc.name} {disp}: hits/feasible/evaluations "
                f"{a['hits']}/{a['n_feasible']}/{a['evaluations']} on the "
                f"card, {c['hits']}/{c['n_feasible']}/{c['evaluations']} on "
                "the CPU")
    if unexpected:
        raise RuntimeError(f"{sc.name}: the card's search took another path "
                           f"than the CPU's for {'; '.join(unexpected)} "
                           f"(listed forks: {ALG_COMPARE_FORKS})")
    if not forks and cpu_res["best_algorithm"] != res["best_algorithm"]:
        raise RuntimeError(f"{sc.name}: best algorithm "
                           f"{res['best_algorithm']} on the card, "
                           f"{cpu_res['best_algorithm']} on the CPU")
    return cpu_res, forks


class AlgCompareProbe:
    """Records, during one ``alg_compare`` run, each algorithm's last lane
    batch (its timed dispatch: the runner calls the engines by their
    module-level names) and the host time of SRES's stochastic ranking
    (from a synchronize, on the card, to the permutation back)."""

    def __init__(self, torch, cuda=True):
        from repro_torch.core import baselines
        from repro_torch.experiments import runner
        self.torch, self.runner, self.baselines = torch, runner, baselines
        self.cuda = cuda
        self.results, self.rank_calls, self.rank_s = {}, 0, 0.0

    def __enter__(self):
        r, b = self.runner, self.baselines
        self.real = (r.batched_joint_search, r.batched_baseline_search,
                     b.stochastic_rank)

        def joint(*args, **kwargs):
            self.results["ga"] = self.real[0](*args, **kwargs)
            return self.results["ga"]

        def baseline(keys, space, score, alg, **kwargs):
            self.results[alg] = self.real[1](keys, space, score, alg,
                                             **kwargs)
            return self.results[alg]

        def rank(*args, **kwargs):
            if self.cuda:
                self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real[2](*args, **kwargs)
            self.rank_s += time.perf_counter() - t0
            self.rank_calls += 1
            return out
        r.batched_joint_search, r.batched_baseline_search = joint, baseline
        b.stochastic_rank = rank
        return self

    def __exit__(self, *exc):
        (self.runner.batched_joint_search,
         self.runner.batched_baseline_search,
         self.baselines.stochastic_rank) = self.real


# per-seed searches of phases 18-19 known to take another path on the
# card than on the CPU (ROADMAP Queue 3): (scenario, algorithm) -> seed
# offsets from the scenario's seed. A fork not listed here fails the phase
ALG_COMPARE_FORKS: dict = {}


def phase_alg_compare(torch, counters, name, dev, out_dir) -> dict:
    """Phases 18 and 19: one Table 3 scenario at its registry budget on
    the card (six algorithms, 5 seeds each a lane). The reduced space's
    exhaustive ground truth is held to the CPU's (same global design,
    minimum within rtol 1e-6); every algorithm's per-seed best genome is
    re-scored on the CPU (rtol 1e-5) and the hits are recomputed from
    those scores. The same study then runs through the port on the CPU
    at the same budget and seeds: each algorithm's per-seed best genome
    must equal the card's (a fork is named by algorithm and seed) and
    its score agree within rtol 1e-5, with the same hits, feasible
    counts and best algorithm. No kernel of the port may launch: the
    scores are ``edap:mean``, with no accuracy term."""
    import dataclasses

    import numpy as np
    from repro_torch.experiments import get_scenario
    from repro_torch.experiments import runner
    sc = get_scenario(name)
    for c in counters:
        c.launches = 0
    with AlgCompareProbe(torch) as probe:
        t0 = time.perf_counter()
        res = runner.run_scenario(sc, out_dir=out_dir, force=True,
                                  device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {c.__name__: c.launches for c in counters}
    b = sc.budget
    if (b.p_ga, b.total_generations, b.n_seeds) != (24, 40, 5) or \
            res["budget"] != dataclasses.asdict(b) or any(launched.values()) \
            or sorted(probe.results) != sorted(
                a for _, a in runner.TABLE3_ALGORITHMS):
        raise RuntimeError(f"{name}: budget {res['budget']}, kernel "
                           f"launches {launched}, engines run "
                           f"{sorted(probe.results)}")
    st = runner.setup_scenario(sc)
    if sc.reduced_space:
        cpu_score = runner.make_landscape_scorer(st.space, st.wa,
                                                 st.objective, device="cpu")
        gmin, gdesign, n_enum = runner.enumerate_ground_truth(
            st.space, cpu_score, "cpu")
        gt = res["ground_truth"]
        if not (gt["exhaustive"] and gt["n_enumerated"] == n_enum == 240
                and gt["global_design"] == st.space.decode(gdesign)
                and math.isclose(gt["global_min"], gmin, rel_tol=1e-6)):
            raise RuntimeError(f"{name}: ground truth on the card {gt} vs "
                               f"CPU {gmin} at {st.space.decode(gdesign)}")
        log(f"{name}: exhaustive ground truth over {n_enum} designs, global "
            f"min {gt['global_min']!r} on the card, {gmin!r} on the CPU, "
            f"same design {json.dumps(gt['global_design'])}")
    else:
        cpu_sc = dataclasses.replace(sc, backend="jnp")
        cpu_score = runner.build_scenario_scorer(cpu_sc, st,
                                                 device="cpu").score
    cpu_scores, worst = {}, 0.0
    for disp, alg in runner.TABLE3_ALGORITHMS:
        r = probe.results[alg]
        card = np.asarray(r.best_scores)
        cpu = cpu_score(torch.as_tensor(r.best_genomes)).numpy()
        rel = float(np.max(np.abs(cpu - card) / np.abs(card)))
        worst = max(worst, rel)
        if not (np.isfinite(cpu).all() and rel <= 1e-5 and np.array_equal(
                card, np.asarray(res["algorithms"][disp]["best_scores"],
                                 np.float32))):
            raise RuntimeError(f"{name} {disp}: card scores {card} vs CPU "
                               f"re-score {cpu} (max rel {rel:.3g})")
        cpu_scores[disp] = cpu
    ref = (res["ground_truth"]["global_min"] if sc.reduced_space
           else min(float(v.min()) for v in cpu_scores.values()))
    for disp, cpu in cpu_scores.items():
        a = res["algorithms"][disp]
        hits = int(np.sum(cpu <= ref * (1 + 1e-4)))
        if hits != a["hits"]:
            raise RuntimeError(f"{name} {disp}: {a['hits']} hits on the card,"
                               f" {hits} from the CPU re-scores")
    cpu_res, forks = compare_alg_compare_cpu(torch, sc, st, probe, res)
    log(f"{name} on {res['device']['name']}: wall {wall:.2f} s (run_scenario,"
        f" every algorithm run twice: untimed, then timed), best "
        f"{res['objective']} {res['best_score']!r} by {res['best_algorithm']};"
        f" every per-seed best genome re-scored on the CPU, max rel "
        f"{worst:.2e}, hits recomputed from them equal; kernel launches "
        f"{launched}")
    for disp, _ in runner.TABLE3_ALGORITHMS:
        a, c = res["algorithms"][disp], cpu_res["algorithms"][disp]
        log(f"  {disp}: hits {a['hit_rate']} (CPU {c['hit_rate']}), "
            f"feasible {a['n_feasible']}/5 (CPU {c['n_feasible']}/5), best "
            f"{a['best_score']:.6g}, mean wall {a['mean_wall_time_s']:.4f} s"
            f" a seed, {a['evaluations']} evaluations a seed")
    log(f"{name}: the port on the CPU at the same budget and seeds: best "
        f"{cpu_res['best_score']!r} by {cpu_res['best_algorithm']}; per-seed "
        f"forks from the card {forks or 'none'}")
    log(f"{name}: SRES stochastic ranking {probe.rank_calls} calls "
        f"(L=5 lanes of N=32), {probe.rank_s:.3f} s on the host in all, "
        f"{1e3 * probe.rank_s / max(probe.rank_calls, 1):.3f} ms a call")
    return {"res": res, "wall": wall, "rank_s": probe.rank_s}


TIMING_FIELDS = ("wall_time_s", "search_wall_time_s", "sampling_time_s",
                 "cached")


def same_result(a: dict, b: dict) -> bool:
    """Two result dicts equal as result.json text, timing fields and
    the cache flag left out."""
    def text(d):
        return json.dumps({k: v for k, v in d.items()
                           if k not in TIMING_FIELDS},
                          sort_keys=True, default=float)
    return text(a) == text(b)


def phase_campaign(torch, counters, dev, seq) -> dict:
    """Phase 20: ``run --all`` on the card: ``campaign.run_campaign``
    over every registry scenario at its registry budget with a fresh
    output directory and kernel-build cache. Each bucket-kind scenario's
    result.json is held to the sequential ``run_scenario`` of it on the
    card (``seq`` holds earlier phases' runs of the same scenario, budget
    and seed; the rest run here), timing fields aside. Then a second
    campaign over the bucket-kind scenarios, ``force=True``, the same
    cache: every bucket signature a hit and no kernel library built."""
    from repro_torch.experiments import REGISTRY, campaign
    from repro_torch.experiments.runner import run_scenario
    from repro_torch.kernels import build
    default_build = build.BUILD_DIR
    scs = list(REGISTRY.values())
    with tempfile.TemporaryDirectory() as tmp:
        out, cache = os.path.join(tmp, "out"), os.path.join(tmp, "cache")
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        results, st = campaign.run_campaign(scs, out_dir=out,
                                            compile_cache=cache, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {c.__name__: c.launches for c in counters}
        # every GA / NSGA-II scenario is bucket-kind; random search and
        # the Table 3 study run through run_scenario inside the campaign
        bucketed = [sc for sc in scs
                    if sc.algorithm not in ("random", "alg_compare")]
        in_buckets = [n for b in st["buckets"] for n in b["scenarios"]]
        reused, t_seq, bad = 0, 0.0, []
        for sc in bucketed:
            with open(os.path.join(out, sc.name, "result.json")) as f:
                got = json.load(f)
            if sc.name in seq:
                want = seq[sc.name]
                reused += 1
            else:
                t1 = time.perf_counter()
                want = run_scenario(sc, write=False, device=dev)
                torch.cuda.synchronize()
                t_seq += time.perf_counter() - t1
            if not same_result(got, want):
                bad.append(sc.name)
        pc = st["persistent_cache"]
        t1 = time.perf_counter()
        _, st2 = campaign.run_campaign(bucketed, out_dir=out, force=True,
                                       compile_cache=cache, device=dev)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t1
        pc2 = st2["persistent_cache"]
    build.set_build_dir(default_build)
    ok_counts = (st["n_scenarios"] == len(scs) == 31
                 and sorted(in_buckets) == sorted(sc.name for sc in bucketed)
                 and st["n_fallback"] == len(scs) - len(bucketed)
                 and all(r is not None for r in results))
    if bad or not ok_counts or launched["imc_fused_gemm_keyed"] <= 0 or \
            pc2["signature_hits"] != st2["n_buckets"] or \
            pc2["signature_misses"] or \
            pc2["entries_after"] != pc2["entries_before"]:
        raise RuntimeError(
            f"run --all: result.json differs from the sequential run for "
            f"{bad}; counts {ok_counts}; launches {launched}; second "
            f"campaign signatures {pc2['signature_hits']}h/"
            f"{pc2['signature_misses']}m of {st2['n_buckets']} buckets, "
            f"libraries {pc2['entries_before']} -> {pc2['entries_after']}")
    kc = st["kernel_cache"]
    log(f"run --all on {torch.cuda.get_device_name(0)}: "
        f"{st['n_scenarios']} scenarios, {st['n_bucketed']} in "
        f"{st['n_buckets']} buckets ({st['lanes_total']} lanes, "
        f"{st['lanes_padded']} padding), {st['n_fallback']} sequential; "
        f"wall {wall:.2f} s, {st['scenarios_per_sec']:.3f} scenarios/s; "
        f"bucket cache {kc['hits']}h/{kc['misses']}m; kernel-build cache "
        f"{pc['signature_hits']}h/{pc['signature_misses']}m signatures, "
        f"{pc['entries_after'] - pc['entries_before']} libraries built; "
        f"launches {launched}")
    dispatch = sum(b["dispatch_s"] for b in st["buckets"])
    drain = sum(b["drain_s"] for b in st["buckets"])
    log(f"run --all: buckets dispatch {dispatch:.2f} s, drain {drain:.2f} "
        f"s; the {len(bucketed)} bucket-kind result.json files equal the "
        f"sequential runs on the card ({reused} from earlier phases, "
        f"{len(bucketed) - reused} run here in {t_seq:.2f} s)")
    log(f"run --all again (force, the {len(bucketed)} bucket-kind "
        f"scenarios, same cache): wall {wall2:.2f} s, signatures "
        f"{pc2['signature_hits']}h/{pc2['signature_misses']}m of "
        f"{st2['n_buckets']} buckets, libraries {pc2['entries_before']} -> "
        f"{pc2['entries_after']} (none built)")
    return {"wall": wall, "launches": launched["imc_fused_gemm_keyed"]}


def profiled_launches(torch, fn):
    """(device kernel launches, device busy s, host wall s) of ``fn()``
    under ``torch.profiler`` (CUDA activity)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    return len(kernels), busy / 1e6, wall


def service_burst(torch, name, seeds, dev):
    """``len(seeds)`` requests of ``name`` at its registry budget inside
    one micro-batch window of a fresh ``CodesignService`` on ``dev``:
    (responses, service stats, wall from start to the last answer)."""
    from repro_torch.api import CodesignService, SearchRequest
    # submitted before the worker starts: one window holds them all
    svc = CodesignService(write=False, window_s=0.0, autostart=False,
                          device=dev)
    try:
        rids = [svc.submit(SearchRequest(name, seed=s)) for s in seeds]
        t0 = time.perf_counter()
        svc.start()
        got = [svc.result(rid, timeout=600) for rid in rids]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        svc.close()
    return got, svc.stats(), wall


def phase_service(torch, fused, dev, name="rram_accuracy",
                  seeds=tuple(range(8)), profile=True) -> dict:
    """Phase 21: a burst of ``SearchRequest(name, seed=s)`` into one
    ``CodesignService`` window on the card: one bucket of the seeds'
    main lanes and their specific-baseline lanes through the keyed
    ``imc_fused`` kernel. Each response's result is held to the
    sequential ``run_scenario`` of its seed on the card, timing fields
    aside. The bucket's wall against the sum of the sequential walls,
    with the keyed kernel's launches of each; with ``profile``, each
    side again under the profiler for its device kernel launches and
    idle share."""
    import dataclasses
    from repro_torch.experiments import get_scenario
    from repro_torch.experiments.runner import run_scenario
    sc = get_scenario(name)
    fused.imc_fused_gemm_keyed.launches = 0
    got, st, wall = service_burst(torch, name, seeds, dev)
    launches = fused.imc_fused_gemm_keyed.launches
    seq_walls, seq_launches, bad = [], [], []
    for s, r in zip(seeds, got):
        fused.imc_fused_gemm_keyed.launches = 0
        t0 = time.perf_counter()
        want = run_scenario(dataclasses.replace(sc, seed=s), write=False,
                            device=dev)
        torch.cuda.synchronize()
        seq_walls.append(time.perf_counter() - t0)
        seq_launches.append(fused.imc_fused_gemm_keyed.launches)
        if r.status != "completed" or not same_result(r.result, want):
            bad.append(s)
    if bad or st.buckets != 1 or st.batches != 1 or launches <= 0:
        raise RuntimeError(
            f"service {name}: responses differ from the sequential runs "
            f"for seeds {bad}; {st.batches} batches, {st.buckets} buckets, "
            f"keyed launches {launches}")
    log(f"service {name} x{len(seeds)} seeds on "
        f"{torch.cuda.get_device_name(0)}: 1 bucket of {st.lanes_total} "
        f"lanes ({st.lanes_padded} padding), wall {wall:.3f} s against "
        f"{sum(seq_walls):.3f} s for the {len(seeds)} sequential runs "
        f"({min(seq_walls):.3f}-{max(seq_walls):.3f} s each); keyed "
        f"imc_fused launches {launches} in the bucket, "
        f"{min(seq_launches)}-{max(seq_launches)} a sequential run; every "
        f"response equals its seed's sequential run")
    out = {"wall": wall, "seq_wall": sum(seq_walls), "launches": launches}
    if profile:
        n_b, busy_b, wall_b = profiled_launches(
            torch, lambda: service_burst(torch, name, seeds, dev))
        n_s, busy_s, wall_s = profiled_launches(
            torch, lambda: run_scenario(dataclasses.replace(sc, seed=seeds[0]),
                                        write=False, device=dev))
        log(f"service {name} profiled: the bucket {n_b} device launches, "
            f"busy {busy_b:.3f} of {wall_b:.3f} s (idle "
            f"{100 * (1 - busy_b / wall_b):.1f}%); one sequential run "
            f"(seed {seeds[0]}) {n_s} launches, busy {busy_s:.3f} of "
            f"{wall_s:.3f} s (idle {100 * (1 - busy_s / wall_s):.1f}%)")
        out.update(bucket_launches=n_b, seq_launches=n_s)
    return out


def run_module(args, timeout: float = 600.0):
    """``python -m <args>`` from this checkout with its ``src`` on the
    path: (stdout, wall s); raises unless it exits 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *args], cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"python -m {' '.join(args)}: exit "
                           f"{r.returncode}\n{r.stdout[-4000:]}\n"
                           f"{r.stderr[-4000:]}")
    return r.stdout, time.perf_counter() - t0


def phase_launchers(torch, fused, dev, res) -> dict:
    """Phase 22: the co-design launchers and the analysis suite on the
    card, each in a subprocess; then every audited call in this process
    under the profiler (see the module docstring)."""
    from repro_torch.analysis import launch_audit as la
    from repro_torch.experiments import get_scenario, scenario_names
    from repro_torch.experiments.runner import (build_scenario_scorer,
                                                setup_scenario)
    from repro_torch.launch import search
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out, wall = run_module(
            ["repro_torch.launch.search", "--scenario", "rram_accuracy",
             "--out", os.path.join(tmp, "search")])
        rep = json.loads(out)
        if rep["best_score"] != res["best_score"] or \
                rep["best_design"] != res["generalized"]["design"]:
            raise RuntimeError(
                f"launch.search rram_accuracy: best {rep['best_score']!r} "
                f"vs phase 5's {res['best_score']!r}, designs equal "
                f"{rep['best_design'] == res['generalized']['design']}")
        log(f"launch.search --scenario rram_accuracy on the card: "
            f"{wall:.2f} s (process included), best {rep['best_score']!r} "
            f"== phase 5's, same design")

        flags = ["--mem", "sram", "--workloads", "alexnet", "--generations",
                 "1", "--pga", "8", "--ph", "40", "--pe", "16"]
        out, wall = run_module(["repro_torch.launch.search", *flags])
        rep = json.loads(out)
        sc = search.scenario_from_args(search.parser().parse_args(flags))
        st = setup_scenario(sc)
        scorer = build_scenario_scorer(sc, st, device="cpu")
        genome = _genome_of(st.space, rep["best_design"])
        cpu = float(scorer.score(torch.tensor([genome]))[0])
        if not math.isclose(cpu, rep["best_score"], rel_tol=1e-5):
            raise RuntimeError(f"launch.search {' '.join(flags)}: CPU "
                               f"re-score {cpu} != card {rep['best_score']}")
        log(f"launch.search {' '.join(flags)} on the card: {wall:.2f} s, "
            f"best {rep['best_score']:.7g}, CPU re-score {cpu:.7g} (rel "
            f"{abs(cpu - rep['best_score']) / rep['best_score']:.2e})")

        out, wall = run_module(
            ["repro_torch.launch.codesign_serve", "--scenario", "rram_smoke",
             "--requests", "4", "--smoke", "--out", os.path.join(tmp, "svc"),
             "--compile-cache", os.path.join(tmp, "cache")])
        if "payloads equal" not in out:
            raise RuntimeError(f"codesign_serve: no verified replay\n{out}")
        log(f"launch.codesign_serve --scenario rram_smoke --requests 4 "
            f"--smoke on the card: exit 0 in {wall:.2f} s")
        for ln in out.splitlines():
            log(f"  {ln}")

        report_path = os.path.join(tmp, "analysis.json")
        out, wall_audit = run_module(
            ["repro_torch.analysis", "--all", "--device", "cuda",
             "--report", report_path])
        with open(report_path) as f:
            report = json.load(f)
    audit = report["launch_audit"]
    kernels = audit["kernels"]
    with open(os.path.join(HERE, "analysis", "baseline.json")) as f:
        want_ids = set(json.load(f)["kernels"])
    base = la.load_baseline(HERE, "cuda")
    over = [k for k, e in kernels.items() if base is None or k not in base
            or e["n_ops"] > int(base[k] * la.BLOAT_RATIO + la.BLOAT_SLACK)]
    if set(kernels) != want_ids or over or audit["device"]["type"] != "cuda":
        raise RuntimeError(
            f"analysis --all --device cuda: ids {len(kernels)} (missing "
            f"{sorted(want_ids - set(kernels))}), outside the cuda "
            f"block's bound: {over}")
    j001 = [f for f in report["findings"] + report["suppressed"]
            if f["rule"] == "J001"]
    log(f"analysis --all --device cuda: exit 0 in {wall_audit:.2f} s; "
        f"{len(kernels)} ids within the cuda block's bound; "
        f"{len(report['suppressed'])} findings suppressed, "
        f"{len(report['findings'])} warnings; {len(j001)} host-sync sites "
        f"(J001) on {audit['device']['name']}:")
    for f in j001:
        log(f"  {f['path']}:{f['line']} [{f['symbol']}] {f['message']}")

    # each audited call again under the profiler: device launches
    fused.imc_fused_gemm_keyed.launches = 0
    t0 = time.perf_counter()
    rows = []
    for name in scenario_names():
        for c in la.scenario_calls(get_scenario(name), dev):
            kid = f"{name}::{c.label}"
            n_dev, busy, wall = profiled_launches(torch, c.fn)
            rows.append((kid, kernels[kid]["n_ops"], n_dev, busy, wall))
    keyed = fused.imc_fused_gemm_keyed.launches
    t_prof = time.perf_counter() - t0
    log(f"audited calls under the profiler ({t_prof:.2f} s): id, "
        f"dispatched ATen ops, device kernel launches, device busy / wall")
    for kid, n_ops, n_dev, busy, wall in rows:
        log(f"  {kid:40s} {n_ops:7d} ops {n_dev:7d} launches  busy "
            f"{1e3 * busy:8.2f} of {1e3 * wall:8.2f} ms")
    top = sorted(kernels["rram_accuracy::kernel"]["ops"].items(),
                 key=lambda kv: -kv[1])[:5]
    log(f"rram_accuracy::kernel's most dispatched ops: "
        f"{', '.join(f'{k} {v}' for k, v in top)}")
    wall = time.perf_counter() - t_phase
    log(f"phase 22: {len(rows)} ids, {sum(r[1] for r in rows)} dispatched "
        f"ops, {sum(r[2] for r in rows)} device launches; keyed imc_fused "
        f"launches {keyed} in the profiled pass; phase wall {wall:.2f} s")
    if keyed <= 0:
        raise RuntimeError("phase 22: the audited calls launched no keyed "
                           "imc_fused kernel")
    return {"wall": wall, "launches": keyed}


# phase 11: tests/test_kernels.py's flash shapes (B, S, T, H, hd, causal,
# window, q_offset, dtype), the non-causal ragged case the reference pads
# wrongly, and bfloat16 shapes for the tensor-core route: head dims 8
# through 256 (zero-padded to 64, 128 or 256), S and T off the 128-row and
# 64/128-key tiles, a window, a query offset with S != T, B and H above 1
FLASH_TESTS = [(2, 32, 32, 2, 16, True, 0, 0, "float32"),
               (1, 64, 64, 4, 32, True, 0, 0, "float32"),
               (2, 48, 48, 2, 16, False, 0, 0, "float32"),
               (1, 64, 64, 2, 16, True, 16, 0, "float32"),
               (1, 40, 40, 2, 16, True, 0, 0, "float32"),
               (2, 32, 32, 2, 16, True, 0, 0, "bfloat16"),
               (1, 40, 40, 2, 16, False, 0, 0, "float32"),
               (1, 1, 1, 2, 128, True, 0, 0, "bfloat16"),
               (1, 129, 129, 2, 64, True, 0, 0, "bfloat16"),
               (1, 300, 300, 4, 128, True, 0, 0, "bfloat16"),
               (1, 1000, 1000, 2, 128, True, 0, 0, "bfloat16"),
               (1, 1000, 1000, 2, 128, True, 100, 0, "bfloat16"),
               (2, 37, 120, 3, 64, True, 0, 83, "bfloat16"),
               (1, 129, 300, 2, 128, False, 0, 0, "bfloat16"),
               (2, 129, 129, 3, 128, True, 0, 0, "bfloat16"),
               (1, 300, 300, 2, 256, True, 0, 0, "bfloat16"),
               (1, 33, 33, 2, 8, True, 0, 0, "bfloat16")]
# the serving shapes: qwen3-4b heads (32 query, 8 KV, hd 128), bf16, causal;
# (S, window)
FLASH_SERVE = [(512, 0), (2048, 0), (4096, 0), (4096, 1024)]
QWEN_H, QWEN_KV, QWEN_HD = 32, 8, 128
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bfloat16, element-wise: kernel and plain version round float32 results
# that differ by float32 rounding, so they differ by at most one bf16 step
# (<= 2^-7 |want|); the limit allows two, plus a floor near zero
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-4
# the planted fault of phase 11: keys DROP dropped from the last ROWS_LATE
# query rows at S = T = 4096
DROP, ROWS_LATE = (2048, 2080), 512
# the float32 route (CUDA cores), timed once for the record: S = T
FLASH_F32 = 2048


def visible_pairs(S, T, causal, window, q_offset=0) -> int:
    """(query, key) pairs the mask lets through: the work this input
    needs (S * (S + 1) / 2 for a causal square, about S * T / 2)."""
    import numpy as np
    pos = np.arange(S, dtype=np.int64) + q_offset
    hi = np.minimum(T - 1, pos) if causal else np.full(S, T - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(S)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bound_ms(S, T, H, hd, causal, window, itemsize) -> dict:
    """Least time for the attention on an H100 SXM: 4 FLOP per visible
    (query, key) pair and head dim (two products) at the bf16 dense
    tensor-core peak (the float32 CUDA-core peak for float32 inputs),
    against q, k, v read once and o written once (k and v at all H heads,
    as the kernel takes them)."""
    flops = 4 * visible_pairs(S, T, causal, window) * H * hd
    nbytes = itemsize * H * hd * (2 * S + 2 * T)
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def serving_qkv(torch, gen, S, dev):
    """q (1, S, 32, 128) and k, v expanded from 8 KV heads, bf16."""
    from repro_torch.models.attention import _expand_kv
    q = torch.randn((1, S, QWEN_H, QWEN_HD), generator=gen, device=dev)
    k, v = (torch.randn((1, S, QWEN_KV, QWEN_HD), generator=gen, device=dev)
            for _ in range(2))
    return [x.to(torch.bfloat16) for x in
            (q, _expand_kv(k, QWEN_H), _expand_kv(v, QWEN_H))]


def flash_plain(fa, q, k, v, causal, window, q_offset=0):
    """The plain version on (B, S, H, hd) tensors."""
    return fa.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, q_offset=q_offset).transpose(1, 2)


def bf16_over(torch, got, want) -> int:
    """Elements of ``got`` outside the bfloat16 limit around ``want``."""
    want = want.float()
    return int(((got.float() - want).abs() >
                BF16_ATOL + BF16_RTOL * want.abs()).sum())


def flash_check(torch, fa, name, q, k, v, causal, window, dt, q_offset=0):
    """``flash_mha`` (the kernel) vs the plain version on the same
    (B, S, H, hd) inputs: the max abs error within FLASH_ATOL and, in
    bfloat16, no element outside the element-wise limit. Returns the
    max abs error, the kernel's output and the plain version's."""
    from repro_torch.kernels.ops import flash_mha
    got = flash_mha(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = flash_plain(fa, q, k, v, causal, window, q_offset)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    over = bf16_over(torch, got, want) if dt == "bfloat16" else 0
    if not (got.shape == q.shape and got.dtype == q.dtype and
            math.isfinite(err) and err <= FLASH_ATOL[dt] and over == 0):
        raise RuntimeError(f"flash_attention {name}: max abs err {err} "
                           f"(atol {FLASH_ATOL[dt]}), {over} elements over "
                           f"the bf16 limit, shape {tuple(got.shape)}, "
                           f"dtype {got.dtype}")
    return err, got, want


def causal_rows_dense(torch, q, k, v, r0, drop=None):
    """Rows r0.. of causal attention of (1, S, H, hd) tensors as one
    masked softmax in float32, keys drop[0] <= j < drop[1] left out;
    (1, S - r0, H, hd) in q's type."""
    S, hd = q.shape[1], q.shape[-1]
    qf = q[0, r0:].transpose(0, 1).float() / math.sqrt(hd)
    kf, vf = (x[0].transpose(0, 1).float() for x in (k, v))
    pos = torch.arange(r0, S, device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    vis = j <= pos
    if drop is not None:
        vis = vis & ((j < drop[0]) | (j >= drop[1]))
    s = (qf @ kf.transpose(1, 2)).masked_fill(~vis, float("-inf"))
    return (torch.softmax(s, -1) @ vf).transpose(0, 1)[None].to(q.dtype)


def planted_fault(torch, q, k, v, want) -> dict:
    """The bf16 limit's power at S = T = 4096: a kernel that dropped one
    32-key tile (DROP) from the last ROWS_LATE rows, modelled by a dense
    masked softmax, must put elements outside the limit around the plain
    version ``want``; the same dense softmax without the drop must not."""
    r0 = q.shape[1] - ROWS_LATE
    late = want[:, r0:].float()
    sound = causal_rows_dense(torch, q, k, v, r0)
    fault = causal_rows_dense(torch, q, k, v, r0, drop=DROP)
    out = {"sound_err": float((sound.float() - late).abs().max()),
           "sound_over": bf16_over(torch, sound, late),
           "fault_err": float((fault.float() - late).abs().max()),
           "fault_over": bf16_over(torch, fault, late),
           "elements": late.numel()}
    if out["sound_over"] or not out["fault_over"]:
        raise RuntimeError(f"bf16 limit: dense sound vs plain "
                           f"{out['sound_over']} over, dropped tile "
                           f"{out['fault_over']} over: {out}")
    return out


def phase_flash(torch, fa, dev) -> dict:
    """Phase 11: flash kernel vs plain; serving shapes timed."""
    from repro_torch.kernels.ops import flash_mha
    import torch.nn.functional as F
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    worst, timed_at = 0.0, {}
    for B, S, T, H, hd, causal, win, q_off, dt in FLASH_TESTS:
        tdt = getattr(torch, dt)
        q, k, v = (torch.randn((B, L, H, hd), generator=gen, device=dev
                               ).to(tdt) for L in (S, T, T))
        name = (f"B={B} S={S} T={T} H={H} hd={hd} causal={causal} win={win}"
                f" q_offset={q_off} {dt}")
        err = flash_check(torch, fa, name, q, k, v, causal, win, dt,
                          q_off)[0]
        worst = max(worst, err)
        log(f"flash_attention {name}: max_abs_err {err:.3g}")
    # the float32 route at one serving-like shape, for the record
    q, k, v = (torch.randn((1, FLASH_F32, QWEN_H, QWEN_HD), generator=gen,
                           device=dev) for _ in range(3))
    name = f"B=1 S=T={FLASH_F32} H={QWEN_H} hd={QWEN_HD} causal float32"
    err = flash_check(torch, fa, name, q, k, v, True, 0, "float32")[0]
    worst = max(worst, err)
    ms = time_ms(torch, lambda: flash_mha(q, k, v), reps=5)
    bound = flash_bound_ms(FLASH_F32, FLASH_F32, QWEN_H, QWEN_HD, True, 0, 4)
    log(f"flash_attention {name} (CUDA-core route): max_abs_err {err:.3g}, "
        f"kernel {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']}, float32 peak); kernel at "
        f"{bound['flops'] / ms / 1e9:.2f} TFLOP/s")
    for S, win in FLASH_SERVE:
        q, k, v = serving_qkv(torch, gen, S, dev)
        name = (f"B=1 S=T={S} H={QWEN_H} (KV {QWEN_KV}) hd={QWEN_HD} causal "
                f"win={win} bfloat16")
        err, _, want = flash_check(torch, fa, name, q, k, v, True, win,
                                   "bfloat16")
        worst = max(worst, err)
        line = f"flash_attention {name}: max_abs_err {err:.3g}"
        ms = time_ms(torch, lambda: flash_mha(q, k, v, causal=True,
                                              window=win), reps=5)
        plain_ms = time_ms(torch, lambda: flash_plain(fa, q, k, v, True, win),
                           reps=1, windows=3)
        lib_ms = None
        if win == 0:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), reps=20)
        bound = flash_bound_ms(S, S, QWEN_H, QWEN_HD, True, win, 2)
        timed_at[(S, win)] = {"ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, **bound}
        line += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                 f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                 f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}:"
                 f" {bound['flops'] / 1e9:.3f} GFLOP, "
                 f"{bound['bytes'] / 1e6:.2f} MB); kernel at "
                 f"{bound['flops'] / ms / 1e9:.2f} TFLOP/s")
        log(line)
        if (S, win) == (4096, 0):
            pf = planted_fault(torch, q, k, v, want)
            flat = ("pass" if pf["fault_err"] <= FLASH_ATOL["bfloat16"]
                    else "fail")
            log(f"bf16 limit (2 bf16 steps of |plain| + {BF16_ATOL:g}) at "
                f"S=T=4096, rows {S - ROWS_LATE}..{S - 1}: dense softmax vs "
                f"plain max_abs_err {pf['sound_err']:.3g}, "
                f"{pf['sound_over']} of {pf['elements']} over; keys "
                f"{DROP[0]}..{DROP[1] - 1} dropped: max_abs_err "
                f"{pf['fault_err']:.3g}, {pf['fault_over']} over (atol "
                f"{FLASH_ATOL['bfloat16']:g} alone would {flat} it)")
    return {"max_abs_err": worst, "timed": timed_at}


SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS, SERVE_MAX_LEN = 8, 16, 4, 4352


def phase_serve(torch, fa, dev) -> dict:
    """Phase 12: qwen3-4b at full width through ServeEngine."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.models import init_params
    from repro_torch.serve import LMRequest, ServeEngine
    cfg = get_config("qwen3_4b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"qwen3_4b init on the card: {n_params / 1e9:.3f} B parameters, "
        f"{cfg.dtype}, {time.perf_counter() - t0:.2f} s")
    eng = ServeEngine(model, cfg, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      device=dev)
    # warm-up: cuBLAS handles and the kernel library load, outside the run
    eng.submit(LMRequest(rid=-1, prompt=np.arange(256) % cfg.vocab_size,
                         max_new_tokens=2))
    eng.run()
    eng.done.clear()
    eng.stats = dict.fromkeys(eng.stats, 0)
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 4097, SERVE_REQUESTS)
    for i, n in enumerate(lens):
        eng.submit(LMRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                             max_new_tokens=SERVE_NEW))
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated(dev)
    outs = [done[i].output for i in sorted(done)]
    bad = [t for o in outs for t in o if not 0 <= t < cfg.vocab_size]
    if sorted(done) != list(range(SERVE_REQUESTS)) or \
            any(len(o) != SERVE_NEW for o in outs) or bad or \
            launches != cfg.n_layers * SERVE_REQUESTS:
        raise RuntimeError(f"serve: done {sorted(done)}, lengths "
                           f"{[len(o) for o in outs]}, bad tokens {bad[:5]},"
                           f" flash launches {launches} (want "
                           f"{cfg.n_layers * SERVE_REQUESTS})")
    st = eng.stats
    log(f"serve qwen3_4b: prompt lengths {[int(n) for n in lens]}")
    log(f"serve qwen3_4b: {SERVE_REQUESTS} requests x {SERVE_NEW} tokens "
        f"in {wall:.3f} s wall; prefill {st['prefill_tokens']} tokens in "
        f"{st['prefill_s']:.3f} s ({st['prefill_tokens'] / st['prefill_s']:.1f}"
        f" tok/s); decode {st['decode_tokens']} tokens in "
        f"{st['decode_s']:.3f} s over {st['decode_steps']} steps "
        f"({st['decode_tokens'] / st['decode_s']:.1f} tok/s); peak memory "
        f"{peak / 2**30:.2f} GiB; flash launches {launches}")
    log(f"serve qwen3_4b: first tokens {[o[:4] for o in outs]}")
    # the kernel at each prompt length the prefills gave it: checked
    # against the plain version, then timed alone, once per layer
    kgen = torch.Generator(device=dev)
    kgen.manual_seed(3)
    kernel_s, errs = 0.0, []
    for n in lens:
        q, k, v = serving_qkv(torch, kgen, int(n), dev)
        errs.append(flash_check(
            torch, fa, f"B=1 S=T={n} H={QWEN_H} hd={QWEN_HD} causal bfloat16",
            q, k, v, True, 0, "bfloat16")[0])
        kernel_s += cfg.n_layers * time_ms(
            torch, lambda: flash_mha(q, k, v), reps=2, windows=3) / 1e3
    log(f"serve qwen3_4b: flash kernel vs plain at these prompt lengths: "
        f"max_abs_err {[f'{e:.3g}' for e in errs]}, none over the bf16 "
        f"limit")
    log(f"serve qwen3_4b: flash kernel time at these prompts {kernel_s:.3f} s"
        f" = {100 * kernel_s / st['prefill_s']:.1f}% of the prefill time, "
        f"{100 * kernel_s / wall:.1f}% of the wall")
    return {"launches": launches, "wall": wall, "max_abs_err": max(errs)}


def phase_logits(torch, fa, dev) -> None:
    """Phase 13: kernel route (card) vs plain route (CPU), 2 layers at
    qwen3-4b widths, float32."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = dataclasses.replace(get_config("qwen3_4b"), n_layers=2,
                              dtype="float32")
    model = init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 512)))
    with torch.inference_mode():
        cpu, _ = prefill(model, cfg, {"tokens": tokens}, cache_len=512)
        before = fa.flash_attention.launches
        card, _ = prefill(model.to(dev), cfg, {"tokens": tokens.to(dev)},
                          cache_len=512)
        launches = fa.flash_attention.launches - before
    err = float((card.cpu() - cpu).abs().max())
    scale = float(cpu.abs().max())
    if launches != cfg.n_layers or not math.isfinite(err) or \
            err > 1e-3 * scale:
        raise RuntimeError(f"logits: card vs CPU max abs err {err} vs "
                           f"max|logits| {scale}, flash launches {launches}")
    log(f"qwen3_4b widths, 2 layers, float32, 512-token prefill: card "
        f"(flash kernel, {launches} launches) vs CPU (plain) last-token "
        f"logits max abs err {err:.3g}, max|logits| {scale:.4g} "
        f"(rel {err / scale:.3g}, limit 1e-3)")


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, imc_fused as fused
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import imc_matmul as mm

    dev = resolve_device("cuda:0")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    log(card_line())                                                 # 1
    built = build.build_timed()                                      # 2
    log(f"kernel build: {built['seconds']:.2f} s")
    for name, text in built["logs"].items():
        for ln in text.splitlines():
            if any(w in ln.lower() for w in ("registers", "spill", "error",
                                             "warning", "entry function")):
                log(f"  {name}: {ln.strip()}")
    main_k = phase_kernel(torch, fused, dev)                         # 3
    phase_accuracy(torch, dev)                                       # 4
    seq = {}   # sequential card runs at the registry budget, for phase 20
    with tempfile.TemporaryDirectory() as out_dir:
        with HostDraws() as draws:                                   # 5
            fused.imc_fused_gemm_keyed.launches = 0
            fused.imc_fused_gemm.launches = 0
            res = phase_scenario(torch, "rram_accuracy", dev, out_dir)
            launches = fused.imc_fused_gemm_keyed.launches
            eps_launches = fused.imc_fused_gemm.launches
        if launches <= 0 or eps_launches or draws.calls or \
                res["backend"] != "cuda":
            raise RuntimeError(
                f"rram_accuracy did not run the keyed kernel alone: keyed "
                f"launches {launches}, eps kernel launches {eps_launches}, "
                f"host normal draws {draws.calls}, backend {res['backend']}")
        log(f"rram_accuracy: imc_fused keyed launches {launches}, host noise "
            f"draws in the accuracy model 0")
        phase_scenario_ref(torch, dev, res)
        phase_rescore_cpu(res)                                       # 6
        seq["rram_accuracy"] = res
        fused.imc_fused_gemm_keyed.launches = 0                      # 7
        seq["rram_smoke"] = phase_scenario(torch, "rram_smoke", dev,
                                           out_dir)
        log(f"rram_smoke: imc_fused launches "
            f"{fused.imc_fused_gemm_keyed.launches} (EDAP only)")
    main_m = phase_matmul(torch, mm, dev)                            # 8
    phase_host_oracle(torch, mm, dev)                                # 9
    lm = phase_lm_example(torch, mm, dev)                            # 10
    phase_rescore_cpu(lm["res"], rtol=1e-5)
    seq["sram_lm_archs"] = lm["res"]
    main_f = phase_flash(torch, fa, dev)                             # 11
    served = phase_serve(torch, fa, dev)                             # 12
    phase_logits(torch, fa, dev)                                     # 13
    with tempfile.TemporaryDirectory() as out_dir:
        joint = phase_joint(torch, fused, dev, out_dir)              # 14
        seq["joint_rram_resnet_family"] = joint["res"]
        keyed_joint = phase_keyed_joint(torch, fused, dev)           # 15
        seq.update(phase_mo(torch, fused, dev, out_dir))             # 16
        seq["rram_tech_cost"] = phase_tech_cost(torch, fused, dev,   # 17
                                                out_dir)
        counters = (fused.imc_fused_gemm_keyed, fused.imc_fused_gemm,
                    mm.imc_matmul, fa.flash_attention)
        for name in ("table3_reduced_rram", "alg_compare_rram"):     # 18, 19
            phase_alg_compare(torch, counters, name, dev, out_dir)
    t20 = time.perf_counter()
    camp = phase_campaign(torch, counters, dev, seq)                 # 20
    svc = phase_service(torch, fused, dev)                           # 21
    if time.perf_counter() - t20 < 240:
        phase_service(torch, fused, dev, "joint_rram_resnet_family",
                      seeds=tuple(range(4)), profile=False)
    launchers = phase_launchers(torch, fused, dev, res)              # 22
    log(f"imc_fused keyed kernel a launch on the device: {main_k['ms']:.4f}"
        f" ms at phase 3's P=120 flat indices below 2^31, "
        f"{keyed_joint['ms']:.4f} ms at P=120 joint-space indices above "
        f"2^24; {joint['launches']} launches in joint_rram_resnet_family")
    log(f"imc_fused keyed kernel at P=120: {main_k['ms']:.4f} ms a launch "
        f"on the device, {main_k['call_ms']:.4f} ms a call against the old "
        f"route's {main_k['old_ms']:.4f} ms; eps kernel "
        f"{main_k['eps_ms']:.4f} ms a launch; bound {main_k['bound_ms']:.4f}"
        f" ms ({main_k['pipe']})")
    # the projection's shape at the row count the example ran
    proj = main_m["timed"][(*PROJ, lm["rows"])]
    log(f"imc_matmul at the projection, R={lm['rows']} (the LM example's "
        f"rows): {proj['ms']:.4f} ms a launch on the device, "
        f"{proj['call_ms']:.4f} ms a call; bound {proj['bound_ms']:.4f} ms "
        f"(set bits), {proj['dense_ms']:.4f} ms (all 8 M K N adds)")
    fused_entry = {"name": "imc_fused", "route": "cuda",
                   "source": "src/repro_torch/csrc/imc_fused.cu",
                   "replaces": "src/repro/kernels/imc_fused.py:83",
                   "launches": launches + camp["launches"]
                   + svc["launches"] + launchers["launches"],
                   "max_abs_err": max(main_k["max_abs_err"],
                                      keyed_joint["max_abs_err"]),
                   "ms": main_k["ms"],
                   "plain_ms": main_k["plain_ms"],
                   "bound_ms": main_k["bound_ms"],
                   "bound_by": main_k["bound_by"], "library_ms": None}
    matmul_entry = {"name": "imc_matmul", "route": "cuda",
                    "source": "src/repro_torch/csrc/imc_matmul.cu",
                    "replaces": "src/repro/kernels/imc_matmul.py:29",
                    "launches": lm["launches"],
                    "max_abs_err": main_m["max_abs_err"], "ms": proj["ms"],
                    "plain_ms": proj["plain_ms"],
                    "bound_ms": proj["bound_ms"],
                    "bound_by": proj["bound_by"], "library_ms": None}
    flash = main_f["timed"][(4096, 0)]
    flash_entry = {"name": "flash_attention", "route": "cuda",
                   "source": "src/repro_torch/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention.py:25",
                   "launches": served["launches"],
                   "max_abs_err": max(main_f["max_abs_err"],
                                      served["max_abs_err"]),
                   "ms": flash["ms"],
                   "plain_ms": flash["plain_ms"],
                   "bound_ms": flash["bound_ms"],
                   "bound_by": flash["bound_by"],
                   "library_ms": flash["library_ms"]}
    log(json.dumps({"kernels": [fused_entry, matmul_entry, flash_entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
