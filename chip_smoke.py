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
width (the ``flash_attention`` kernel in every prefill, the
``decode_attention`` kernel in every decode step, on the bf16 and the
int8 cache), on recurrentgemma-9b (the ``rglru_scan`` kernel in its
recurrent layers) and on xlstm-350m (the ``mlstm_scan`` and
``slstm_scan`` kernels in its prefills and decode steps); llama-3.2-vision
served at full width (the flash kernel not causal in its cross-attention
layers, the decode kernel's cross route in their decode steps) and
hubert-xlarge's encoder run and trained at full width (the flash
kernels, bidirectional, at head dim 80); recurrentgemma-9b trained on
the scan's backward kernel and phi3.5-moe and mixtral-8x22b served
(phi3.5-moe also trained) at full width with their depth cut;
xlstm-350m trained at full width on the xLSTM scans' backward kernels
and llama-3.2-vision trained at full width cut in depth; qwen2.5-3b,
glm4-9b and phi4-mini-3.8b served at full width and qwen2.5-3b and
glm4-9b (cut in depth) trained, with the gradient compression of
``repro_torch.parallel`` on the card. Phases:

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
     1e-4); the float32 (split-TF32) route at its two timed shapes
     (FLASH_F32_TIMED: 2048 tokens, 32 heads of 128, causal, and
     hubert-xlarge's 4 x 1024, 16 heads of 80); and at the serving
     shapes (B=1, 32 heads expanded from 8 KV heads, hd 128, bf16,
     causal, S = T in {512, 2048, 4096}, and S=4096 with a 1024
     window), with CUDA-event timings beside the plain version,
     PyTorch's ``scaled_dot_product_attention`` and the bound; then the
     bf16 limit's power: one 32-key tile dropped from the late rows at
     S=4096 (a dense masked softmax) must fail it;
 12. qwen3-4b at full width (36 layers, bf16, seeded random weights)
     served by ``ServeEngine(n_slots=4, max_len=4352)``: 8 requests with
     prompt lengths drawn in 256..4096 by ``numpy.random.default_rng(0)``,
     16 new tokens each; every request must finish with 16 in-vocabulary
     tokens, the flash kernel must launch 36 x 8 = 288 times and the
     decode kernel (``csrc/decode_attention.cu``) 36 times a decode step
     on its bf16 route; wall, prefill and decode tokens/s, peak memory;
     then the same 8 requests on the int8 cache (``kv_quant=True``, the
     same weights), the decode kernel on its int8 route; then the kernel vs the
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
     ``rram_accuracy::kernel`` and the phase's wall;
 23. the attention gradient kernel (``csrc/flash_attention_bwd.cu``)
     through ``flash_mha``'s autograd function vs
     ``flash_attention_bwd_plain`` in float32 on the same inputs, at
     phase 11's shapes plus float32 window, query-offset and hd 256
     cases, qwen3-4b's training shapes (8 x 128 and 1 x 4096 tokens, 32
     heads of 128, bf16, causal) and recurrentgemma-9b's local attention
     (1 x 4096, 16 heads of 256, bf16, causal, window 2048): every
     launch's route asserted by type (bf16 at every head dim on the
     tensor cores, ``flash_attention_bwd_wgmma.cuh``; float32 as split
     TF32, ``tf32x3``; both from the forward's saved log-sum-exp);
     float32 within 1e-4 of each gradient's largest entry, bf16 every
     element within two bf16 steps plus 1e-4; a second launch on the
     same inputs bitwise equal; at every shape the forward's output with
     the lse store bitwise the one without it and the lse within 5e-5 of
     the plain version's; then at S = T = 4096, 32 heads, bf16, causal
     the kernel (with the saved lse, as training passes it), the plain
     version and SDPA's backward timed beside the bound and the design's
     floor (10 products at the bf16 peak), and the same at
     recurrentgemma's shape beside SDPA's backward with the window band
     as its mask and with
     ``is_causal`` (more work), the forward with and without its lse
     store and SDPA's band-masked forward; then the float32 routes at
     FLASH_F32_TIMED: forward and gradient (saved lse) checked again and
     timed beside the plain versions, SDPA in float32 on its
     memory-efficient and math backends, the split-TF32 floor and the
     float32 pipe's, and the gradient's two kernels by the profiler;
 24. qwen3-4b at full width trains on the card through
     ``repro_torch.launch.train``'s code path (36 layers, bf16, seeded
     random weights, batch 8 x seq 128, 4 steps, no checkpoints): every
     loss and grad norm finite, 36 backward launches a step, all on the
     tensor-core route, and 72 forward flash launches (remat recomputes
     each block's forward); the median step time over steps 2-4,
     tokens/s, peak memory, then one step under the profiler (launches,
     idle share, device time by kernel kind); then the same at batch 1
     x seq 4096 (3 steps; 2048 if 4096 does not fit), with the gradient
     kernel's device time in its profiled step; then at ``--reduced``
     size 4 steps straight against 2 steps, a checkpoint, a fresh state
     and 2 resumed steps: params, m and v bitwise equal;
 25. the decode kernel vs ``decode_attention_plain`` at qwen3-4b's
     serving shape (4 slots of 4352, 8 KV heads of 4 query heads, hd
     128) on the bf16 and the int8 cache, recurrentgemma-9b's wrapped
     2048-slot local ring (1 KV head of 16, hd 256) in bf16, a reduced
     float32 shape and an int8 one (hd 64) with a row that sees no slot,
     with ragged, empty and late slots: bf16 every element within two
     bf16 steps plus 1e-4, float32 within 1e-5 x max|out|, the route
     asserted (the ring's G 16 on the grouped route, by its count), two
     launches bitwise, a CUDA graph of one call replayed
     twice bitwise equal to the eager launch (its arrival counters
     return to zero), 2 device kernels a call; device time from a CUDA
     graph beside the bound (the visible slots' K and V), the plain
     version and, for bf16, SDPA with ``enable_gqa`` (a yardstick) timed
     in a CUDA graph as the kernel is and by events around calls;
 26. the RG-LRU scan kernel (``csrc/rglru_scan.cu``) vs
     ``rglru_scan_plain`` at (1, 4096, 4096) in bf16 and float32, at
     (2, 37, 4096) and at the tile's edges (bf16 two bf16 steps, float32
     1e-5 x max|h|), two launches bitwise, graph replays bitwise, 1
     device kernel a call, timed beside its bound and the plain loop;
 27. recurrentgemma-9b at its published width (38 layers: 26 RG-LRU, 12
     local attention with a 2048 window; bf16, seeded random weights)
     served as in phase 12 (8 requests of 256..4096 tokens, 16 new each,
     4 slots): flash 12 x 8, scan 26 x 8 and decode 12 launches a step;
     wall, prefill and decode tokens/s, peak memory; then a 3-layer
     [R, R, A] cut at full width in float32: a 512-token prefill and 2
     decode steps on the card (the three kernels) and on the CPU (their
     plain versions), logits within 1e-3 x max|logits|;
 28. the mLSTM scan kernel (``csrc/mlstm_scan.cu``) vs
     ``mlstm_scan_plain`` at (B, S, H, hd) = (1, 4096, 4, 512),
     (4, 1, 4, 512), (2, 37, 4, 16), (1, 5, 4, 512) (under one staged
     chunk of 8 steps) and (2, 45, 2, 128) (a gate batch of 32 and a
     ragged chunk), and at (1, 67, 4, 512) with gates made so that i_pre
     wins the stabiliser's max on some steps, log_f + m on others, and
     ties it exactly on the rest; and the sLSTM scan kernel
     (``csrc/slstm_scan.cu``) vs ``slstm_scan_plain`` at (B, S, w) =
     (1, 4096, 1024) and (4, 1, 1024) with bf16 gates, (4, 1, 1024)
     and (2, 37, 32) in float32, and widths off the warp with S off the
     staged chunk of 32 steps, (1, 300, 1000) bf16 and (3, 70, 7)
     float32, each from a random state: h and every
     state tensor within 1e-5 of their largest entry, the route asserted
     (head width; gates' type), two launches bitwise (h and state), a
     CUDA graph of one call replayed twice from the state restored before
     each replay bitwise the eager launch, 1 device kernel a call, the
     scan over S - 1 steps and then 1 bitwise the scan over S; device
     time from a CUDA graph beside the bound (the mLSTM's operations at
     the FP32 lanes' rate: no product is fused with a sum) and the plain
     loop, and the sLSTM's chain floor (one warp of chains alone at the
     same S);
 29. xlstm-350m at its published width (24 layers [slstm, mlstm] x 12,
     d 1024, mLSTM heads of 512, bf16, seeded random weights) served as
     in phase 12: 12 launches of each scan kernel a prefill and a decode
     step, every mLSTM launch on its hd-512 route and every sLSTM launch
     on bf16; wall, prefill and decode tokens/s, peak memory; the first
     sLSTM and mLSTM layers' scans on the model's own inputs split at the
     last prompt token bitwise the whole, and prefill(N) + a decode step
     bitwise prefill(N + 1) in every state tensor of every layer; then a
     2-layer [slstm, mlstm] cut at full width in float32: a 512-token
     prefill and 2 decode steps on the card and on the CPU, logits within
     1e-3 x max|logits|;
 30. the decode kernel's cross route (``cross_decode_attention_kernel``:
     every slot visible, the scores times float32(1 / sqrt(hd)), p kept
     in float32) vs ``cross_decode_attention_plain`` at llama-3.2-vision's
     cross cache (4 slots of 1600 image keys, 8 KV heads of 4 query heads,
     hd 128, bf16) and a reduced float32 shape: float32 within 1e-5 x
     max|out|, bf16 every element between the bf16 roundings of the plain
     float32 value minus and plus that; two launches bitwise, a CUDA
     graph's replays bitwise, 1 device kernel a call; device time from a
     CUDA graph beside the bound (every slot's K and V), the plain version
     and SDPA (``enable_gqa``, no mask) in a CUDA graph; then the flash
     kernel not causal at the cross prefill's shape (1, 2048 queries, 1600
     keys, 32 heads of 128, bf16), at hubert's (1, 1024, 1024, 16 heads of
     80, bf16) and at hd 80 in float32: forward and gradient vs their plain
     versions within phases 11 and 23's limits, the bf16 forward's lse
     store bitwise; the bf16 shapes timed beside their bounds and SDPA's
     forward and backward;
 31. llama-3.2-vision at its published width (40 layers, 8 cross
     attention over 1600 image tokens of 4096, 9.79 B parameters; bf16,
     seeded random weights, every gate drawn in [0.25, 1) from the seed,
     since zero gates leave the image layers out) served through
     ``prefill`` (tokens and ``image_embeds``) and greedy ``decode_step``s:
     4 prompts of 1024 tokens, each with its image, then 16 decode steps,
     and 1 prompt of 4096 tokens, then 16 steps; 40 flash launches a
     prefill, 32 decode kernel and 8 cross route launches a step; prefill
     and decode tokens/s, peak memory; a prefill of the 4 x 1024 batch
     and 4 decode steps under the profiler (idle share, launches, device
     time by kernel kind); then a 5-layer (one pattern period)
     float32 cut at full width: a 64-token prefill with its image and 2
     decode steps on the card and on the CPU, logits within 1e-3 x
     max|logits|;
 32. hubert-xlarge at its published width (48 layers, d 1280, 16 heads of
     80, bidirectional, 0.95 B parameters; bf16, seeded random weights): a
     forward at 4 x 1024 bf16 frames (48 flash launches), then 3 train
     steps (48 gradient launches a step, all on the tensor-core route, 96
     forward), median step time, frames/s, peak memory, and a fourth
     step under the profiler (as phase 24's); then a 2-layer
     float32 cut on the card and on the CPU: logits (1e-3 x max), the
     frame CE loss (rtol 1e-4) and every gradient leaf (1e-3 of its
     largest entry); then one train step of a bf16 2-layer cut on the
     token pipeline's float32 frames (the promoted float32 trunk: the
     flash kernels' float32 routes), its loss against the CPU's;
 33. the RG-LRU scan's backward kernel (``csrc/rglru_scan_bwd.cu``, on
     the forward launch's carry buffer) vs ``rglru_scan_backward_plain``
     at (1, 4096, 4096) bf16 and float32, (2, 37, 4096), (3, 300, 1000),
     (1, 1, 7), (2, 257, 4100) and (2, 263, 1036): float32 dx within
     1e-5 x max|dx|, bf16 dx within two bf16 steps plus that, each
     parameter gradient within 1e-4 of its max; two launches bitwise, a
     CUDA graph's replays bitwise, 1 device kernel a call, its workspace
     zero after; device time from a CUDA graph beside the bound and the
     plain version; then the autograd route (``rglru_scan`` with gradients: 1 forward and 1
     backward launch) at (2, 300, 40) float32 against the plain backward
     and its directional derivative against a float64 central
     difference;
 34. recurrentgemma-9b at full width cut to 6 layers ((R, R, A) x 2,
     3.3 B parameters; bf16, seeded random weights) trains through
     ``launch.train``'s code path, 3 steps at batch 8 x 128 and 3 at 1 x
     4096 (16 time tiles a scan call): finite losses, 2 flash and 1
     gradient launch an attention layer a step (all on the gradient's
     tensor-core route), 2 scan and 1 scan-gradient launches an RG-LRU
     layer a step; median step, tokens/s, peak memory, a profiled step;
     then a 3-layer float32 cut's loss and gradients, card against CPU;
 35. phi3.5-moe at full width cut to 24 of 32 layers (bf16, seeded random
     weights) served as in phase 12 (each prompt prefilled alone at batch
     1, so no padding takes capacity): a flash launch a layer a prefill,
     a decode launch a layer a step; wall, prefill and decode tokens/s,
     peak memory, a profiled prefill and decode; then a 1-layer float32
     cut, card against CPU: every MoE call's chosen experts (a choice may
     differ only within 1e-5 of a tie of the k-th and (k+1)-th
     probabilities), rows and dropped tokens, and the logits on every
     path where no choice differed;
 36. mixtral-8x22b at full width cut to 12 of 56 layers served the same
     way (its 4096-token prompt's decode wraps the 4096-slot window
     ring; the decode kernel on its grouped route, G 6); then the decode
     kernel at that ring (4 slots, 8 KV heads of 6, hd 128) checked and
     timed as in phase 25, and the flash kernel at its 48 heads against
     its plain version;
 37. phi3.5-moe at full width cut to 2 layers trains 3 steps at 8 x 128
     through ``launch.train``'s code path: the loss with its aux term
     (positive each step), 2 flash and 1 gradient launch a layer a step;
     median step, tokens/s, peak memory, a profiled step;
 38. the xLSTM scans' backward kernels (``csrc/mlstm_scan_bwd.cu``, seven
     kernels a call; ``csrc/slstm_scan_bwd.cu``, one, given the forward's
     saving launch's hs and states, which are held bitwise to the launch
     without saving) vs
     ``mlstm_scan_backward_plain`` and ``slstm_scan_backward_plain`` at
     xlstm-350m's training shapes (1 x 4096 and 8 x 128; the sLSTM also in
     float32) and ragged ones, the mLSTM also at its stabiliser's planted
     ties: dq, dk, dv and float32 dgates within 1e-5 of their largest
     entry, bf16 dgates within two bf16 steps plus that, the gates'
     gradients and dr within 1e-4; two launches bitwise, a CUDA graph's
     replays bitwise, the kernels a call, the sLSTM's workspace zero;
     device time from a CUDA graph beside the bound and the plain
     version, the mLSTM's by kernel at the two training shapes (the
     profiler), the sLSTM's one-warp chain floor and its forward with and
     without saving at 1 x 4096; each autograd route's
     directional derivative against a float64 central difference;
 39. xlstm-350m at full width and depth (24 layers, bf16) trains 3 steps
     at 8 x 128 and 3 at 1 x 4096 through ``launch.train``'s code path:
     finite losses and grad norms, 2 scan launches (remat) and 1 backward
     call an mLSTM and an sLSTM layer a step; median step, tokens/s, peak
     memory, a profiled step; then a 2-layer float32 cut's loss and
     gradients, card against CPU;
 40. llama-3.2-vision at full width cut to 10 layers (two pattern periods:
     8 attn + 2 cross_attn; bf16, gates drawn non-zero) trains 3 steps at
     2 x 1024 with 1600 image embeddings through ``launch.train``'s code
     path: finite losses, 2 flash and 1 gradient launch a layer a step on
     the tensor-core route, the self layers causal and the cross layers
     not causal at S != T (every call recorded); median step, peak memory,
     a profiled step; then one pattern period in float32, card against
     CPU;
 41. qwen2.5-3b, glm4-9b and phi4-mini-3.8b at full width (bf16, seeded
     random weights) served as phase 12 serves qwen3-4b, on the bf16 and
     the int8 cache: every request done, the flash kernel a layer a
     prefill and the decode kernel a layer a decode step on the cache's
     route, the flash kernel against its plain version at each prompt
     length with the arch's heads; then the decode kernel at their GQA
     groups (KV, G) = (2, 8), (2, 16) (the grouped route, asserted by
     its count), (8, 3) (the split route, one partly filled head group
     of 4) at the serving shape, bf16 and int8, checked and timed as in
     phase 25;
 42. the three archs cut to 2 layers in float32 (qwen2.5-3b's QKV biases
     drawn non-zero): a 512-token prefill's last-token logits card
     against CPU, as phase 13; qwen2.5-3b's loss and gradients, the three
     bias leaves among them, card against CPU;
 43. qwen2.5-3b at full width trains 4 steps at 8 x 128 through
     ``launch.train``'s code path, checked as phase 24, with a profiled
     step; glm4-9b cut to GLM_TRAIN_LAYERS of 40 layers trains 3; then
     ``parallel.error_feedback_compress`` on every gradient leaf of one
     qwen2.5-3b step, on the card against the same leaves on the CPU,
     bitwise;
 44. the mesh path on the card: qwen3-4b at full width trains 3 steps at
     8 x 128 through ``launch.train.setup`` with ``--model-shards 1``
     (the state placed on the 1 x 1 host mesh, ``train.loop``'s step
     over it; 36 gradient and 72 forward flash launches a step); its m
     and v copied to the host; ``elastic_remesh`` onto the 1 x 1 mesh
     keeps every leaf; the parameters saved, zeroed and restored through
     ``checkpoint``; then the plain step from the same seed (the mesh
     run's m and v freed first, its restored parameters kept): losses
     and every parameter, m and v leaf bitwise. The dry run (``launch/dryrun.py``) of that cell on
     the 1 x 1 mesh, in a subprocess: its parameter, m and v argument
     bytes against the card's build of the state (the allocator's
     requested bytes within 512 B a leaf); ``xlstm_350m x decode_32k``
     dry-run on the 256-rank fake pod in a subprocess, its record
     printed. Since this slice every ``launch.train`` run (phases 24, 34,
     37, 39, 40, 43, 45) goes through the mesh step on the 1 x 1 mesh;
 45. hubert-xlarge at its published width (48 layers, bf16 weights from a
     seed) trains 3 steps at 4 x 1024 through ``launch.train``'s code
     path on its own data pipeline, whose float32 frames promote the
     trunk to float32: 48 gradient and 96 forward flash launches a step,
     every one on the split-TF32 float32 routes; finite losses, the
     median step, frames/s, peak memory and a profiled step by kind.

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
PEAK_TF32_FLOPS = 495e12
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


def profiled_kernels(torch, fn):
    """(device kernel events, device busy s, host wall s) of ``fn()``
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
    return kernels, busy / 1e6, wall


def profiled_launches(torch, fn):
    """(device kernel launches, device busy s, host wall s) of ``fn()``
    under ``torch.profiler`` (CUDA activity)."""
    kernels, busy, wall = profiled_kernels(torch, fn)
    return len(kernels), busy, wall


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
# the float32 route's timed shapes (B, S = T, H, hd, causal): qwen3-4b's
# heads at 2048 tokens, causal (the shape its CUDA-core design was timed
# at), and hubert-xlarge's training shape (phase 45's), whose times are
# the float32 entries of the kernels line
FLASH_F32_TIMED = [(1, 2048, 32, 128, True), (4, 1024, 16, 80, False)]


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
    tensor-core peak, or for float32 inputs three TF32 products for each
    (split TF32, the least float32-accurate tensor-core work) at the TF32
    peak, against q, k, v read once and o written once (k and v at all H
    heads, as the kernel takes them; pass B x H as H for B > 1). Float32
    also gets ``design_ms``: the same FLOP on the float32 pipe."""
    flops = 4 * visible_pairs(S, T, causal, window) * H * hd
    nbytes = itemsize * H * hd * (2 * S + 2 * T)
    t_ops = (flops / PEAK_BF16_FLOPS if itemsize == 2
             else 3 * flops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    out = {"bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    if itemsize == 4:
        out["design_ms"] = flops / PEAK_FP32_FLOPS * 1e3
    return out


def serving_qkv(torch, gen, S, dev, H=QWEN_H, KV=QWEN_KV, hd=QWEN_HD):
    """q (1, S, H, hd) and k, v expanded from KV heads, bf16 (qwen3-4b's
    32 heads of 128 over 8 by default)."""
    from repro_torch.models.attention import _expand_kv
    q = torch.randn((1, S, H, hd), generator=gen, device=dev)
    k, v = (torch.randn((1, S, KV, hd), generator=gen, device=dev)
            for _ in range(2))
    return [x.to(torch.bfloat16) for x in
            (q, _expand_kv(k, H), _expand_kv(v, H))]


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
    worst, f32_worst, timed_at = 0.0, 0.0, {}
    for B, S, T, H, hd, causal, win, q_off, dt in FLASH_TESTS:
        tdt = getattr(torch, dt)
        q, k, v = (torch.randn((B, L, H, hd), generator=gen, device=dev
                               ).to(tdt) for L in (S, T, T))
        name = (f"B={B} S={S} T={T} H={H} hd={hd} causal={causal} win={win}"
                f" q_offset={q_off} {dt}")
        err = flash_check(torch, fa, name, q, k, v, causal, win, dt,
                          q_off)[0]
        worst = max(worst, err)
        if dt == "float32":
            f32_worst = max(f32_worst, err)
        log(f"flash_attention {name}: max_abs_err {err:.3g}")
    # the float32 route at the shape it is timed at (phase 23) and at
    # hubert-xlarge's (the pipeline-fed training of phase 45)
    for B, S, H, hd, causal in FLASH_F32_TIMED:
        q, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev)
                   for _ in range(3))
        name = (f"B={B} S=T={S} H={H} hd={hd} causal={causal} float32")
        err = flash_check(torch, fa, name, q, k, v, causal, 0, "float32")[0]
        worst, f32_worst = max(worst, err), max(f32_worst, err)
        log(f"flash_attention {name} (tf32x3 route): max_abs_err {err:.3g}")
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
    return {"max_abs_err": worst, "f32_err": f32_worst, "timed": timed_at}


SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS, SERVE_MAX_LEN = 8, 16, 4, 4352
# decode tok/s of phase 12 before the decode kernel, when each step copied
# the whole cache to float32 (PERF.md)
DECODE_BEFORE = "41.7-93.8"


def serve_requests(cfg, seed=0):
    """``SERVE_REQUESTS`` prompts of 256..4096 tokens drawn by
    ``numpy.random.default_rng(seed)``: (lengths, prompts)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(256, 4097, SERVE_REQUESTS)
    return lens, [rng.integers(0, cfg.vocab_size, n) for n in lens]


def serve_run(torch, eng, prompts, counters, dev) -> dict:
    """A warm-up request (cuBLAS handles, the kernel libraries), then the
    prompts through ``eng`` with every counter in ``counters`` (objects
    with a ``launches`` attribute, and ``routes`` where they have one)
    set to 0 just before and read just after. Returns the outputs, the
    launches and routes, wall, stats and peak memory."""
    from repro_torch.serve import LMRequest
    eng.submit(LMRequest(rid=-1, prompt=prompts[0][:256],
                         max_new_tokens=2))
    eng.run()
    eng.done.clear()
    eng.stats = dict.fromkeys(eng.stats, 0)
    for i, p in enumerate(prompts):
        eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=SERVE_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
        if hasattr(c, "routes"):
            c.routes = dict.fromkeys(c.routes, 0)
        if hasattr(c, "grouped"):
            c.grouped = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"outs": [done[i].output for i in sorted(done)],
            "rids": sorted(done), "wall": wall, "stats": dict(eng.stats),
            "peak": torch.cuda.max_memory_allocated(dev),
            "launches": [c.launches for c in counters],
            "routes": [dict(getattr(c, "routes", {})) for c in counters],
            "grouped": [getattr(c, "grouped", 0) for c in counters]}


def decode_route_checked(cfg, run, i, cache, want, label) -> None:
    """The decode kernel (``run``'s counter ``i``) ran ``want`` times on
    the cache type ``cache``, all of them on the grouped route where the
    arch's GQA group takes it (``launch_plan``: G > 4, a bf16 q), none
    there otherwise."""
    import torch
    from repro_torch.kernels import decode_attention as dk
    G = cfg.n_heads // cfg.n_kv_heads
    route = dk.launch_plan(1, 1, 1, G, cfg.head_dim,
                           getattr(torch, cfg.dtype), getattr(torch, cache))[0]
    grouped = want if route == "grouped" else 0
    if run["routes"][i][cache] != want or run["grouped"][i] != grouped:
        raise RuntimeError(f"serve {label}: decode kernel routes "
                           f"{run['routes'][i]}, grouped {run['grouped'][i]};"
                           f" want {want} on {cache}, {grouped} grouped "
                           f"(G {G})")


def serve_checked(cfg, run, want_launches, label) -> None:
    """Every request done with ``SERVE_NEW`` in-vocabulary tokens and the
    launches ``want_launches`` (a list beside ``run['launches']``)."""
    outs = run["outs"]
    bad = [t for o in outs for t in o if not 0 <= t < cfg.vocab_size]
    if run["rids"] != list(range(SERVE_REQUESTS)) or \
            any(len(o) != SERVE_NEW for o in outs) or bad or \
            run["launches"] != want_launches:
        raise RuntimeError(f"serve {label}: done {run['rids']}, lengths "
                           f"{[len(o) for o in outs]}, bad tokens {bad[:5]},"
                           f" launches {run['launches']} (want "
                           f"{want_launches}), routes {run['routes']}")


def serve_line(label, run, extra="") -> str:
    st = run["stats"]
    return (f"serve {label}: {SERVE_REQUESTS} requests x {SERVE_NEW} tokens "
            f"in {run['wall']:.3f} s wall; prefill {st['prefill_tokens']} "
            f"tokens in {st['prefill_s']:.3f} s "
            f"({st['prefill_tokens'] / st['prefill_s']:.1f} tok/s); decode "
            f"{st['decode_tokens']} tokens in {st['decode_s']:.3f} s over "
            f"{st['decode_steps']} steps "
            f"({st['decode_tokens'] / st['decode_s']:.1f} tok/s); peak "
            f"memory {run['peak'] / 2**30:.2f} GiB{extra}")


def phase_serve(torch, fa, dev, arch="qwen3_4b") -> dict:
    """Phase 12 (qwen3-4b; phase 41 the other dense archs): ``arch`` at
    full width through ServeEngine, the bf16 cache, then the int8 cache
    (``kv_quant``) on the same weights and requests; the decode kernel on
    its route once a layer a decode step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    cfg = get_config(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{arch} init on the card: {n_params / 1e9:.3f} B parameters, "
        f"{cfg.n_layers} layers, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads, {cfg.dtype}, "
        f"{time.perf_counter() - t0:.2f} s")
    lens, prompts = serve_requests(cfg)
    counters = (fa.flash_attention, dk.decode_attention_kernel)
    runs = {}
    for label, c in (("bf16 cache", cfg),
                     ("int8 cache", dataclasses.replace(cfg, kv_quant=True))):
        eng = ServeEngine(model, c, n_slots=SERVE_SLOTS,
                          max_len=SERVE_MAX_LEN, device=dev)
        run = serve_run(torch, eng, prompts, counters, dev)
        del eng
        steps = run["stats"]["decode_steps"]
        route = "int8" if c.kv_quant else "bfloat16"
        serve_checked(cfg, run, [cfg.n_layers * SERVE_REQUESTS,
                                 cfg.n_layers * steps], f"{arch} {label}")
        decode_route_checked(cfg, run, 1, route, cfg.n_layers * steps,
                             f"{arch} {label}")
        runs[label] = run
        if label == "bf16 cache":
            log(f"serve {arch}: prompt lengths {[int(n) for n in lens]}")
        before = ("" if arch != "qwen3_4b" else
                  f"; decode tok/s before the decode kernel (a float32 "
                  f"copy of the cache every step): {DECODE_BEFORE}")
        log(serve_line(f"{arch} {label}", run,
                       f"; flash launches {run['launches'][0]}, decode "
                       f"kernel launches {run['launches'][1]} "
                       f"({cfg.n_layers} a step, route {route}, "
                       f"{run['grouped'][1]} on the grouped route)"
                       f"{before}"))
        log(f"serve {arch} {label}: first tokens "
            f"{[o[:4] for o in run['outs']]}")
    same = sum(a == b for a, b in zip(runs["bf16 cache"]["outs"],
                                      runs["int8 cache"]["outs"]))
    log(f"serve {arch}: {same} of {SERVE_REQUESTS} requests give the same "
        f"16 tokens on the int8 cache as on the bf16 cache (random "
        f"weights; not a check)")
    # the kernel at each prompt length the prefills gave it: checked
    # against the plain version, then timed alone, once per layer
    kgen = torch.Generator(device=dev)
    kgen.manual_seed(3)
    kernel_s, errs = 0.0, []
    for n in lens:
        q, k, v = serving_qkv(torch, kgen, int(n), dev, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim)
        errs.append(flash_check(
            torch, fa, f"B=1 S=T={n} H={cfg.n_heads} (KV {cfg.n_kv_heads}) "
            f"hd={cfg.head_dim} causal bfloat16", q, k, v, True, 0,
            "bfloat16")[0])
        kernel_s += cfg.n_layers * time_ms(
            torch, lambda: flash_mha(q, k, v), reps=2, windows=3) / 1e3
    del q, k, v
    st = runs["bf16 cache"]["stats"]
    log(f"serve {arch}: flash kernel vs plain at these prompt lengths: "
        f"max_abs_err {[f'{e:.3g}' for e in errs]}, none over the bf16 "
        f"limit")
    log(f"serve {arch}: flash kernel time at these prompts {kernel_s:.3f} s"
        f" = {100 * kernel_s / st['prefill_s']:.1f}% of the prefill time, "
        f"{100 * kernel_s / runs['bf16 cache']['wall']:.1f}% of the wall")
    return {"launches": runs["bf16 cache"]["launches"][0],
            "decode_launches": sum(r["launches"][1] for r in runs.values()),
            "grouped": sum(r["grouped"][1] for r in runs.values()),
            "wall": runs["bf16 cache"]["wall"], "max_abs_err": max(errs)}


def draw_qkv_biases(torch, model, gen) -> None:
    """Every attention block's ``bq``, ``bk``, ``bv`` drawn in place from
    ``gen`` as standard normals, the scale of the projections' outputs at
    unit-RMS inputs (the init's zeros would add nothing)."""
    with torch.no_grad():
        for blk in model.blocks:
            for name in ("bq", "bk", "bv"):
                b = getattr(blk, name)
                b.copy_(torch.randn(b.shape, generator=gen,
                                    device=b.device).to(b.dtype))


def phase_logits(torch, fa, dev, arch="qwen3_4b"):
    """Phase 13 (qwen3-4b; phase 42 the other dense archs): ``arch``'s
    widths cut to 2 layers, float32, weights drawn on the card from a
    seed (QKV biases drawn non-zero where the arch has them) and copied
    to the CPU: one 512-token prefill's last-token logits through the
    kernel (card) and the plain version (CPU) within 1e-3 x max|logits|.
    Returns the card's model and its config."""
    import copy
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    card = init_params(gen, cfg)
    if cfg.qkv_bias:
        draw_qkv_biases(torch, card, gen)
    cpu_model = copy.deepcopy(card).to("cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 512)))
    with torch.inference_mode():
        cpu, _ = prefill(cpu_model, cfg, {"tokens": tokens}, cache_len=512)
        before = fa.flash_attention.launches
        got, _ = prefill(card, cfg, {"tokens": tokens.to(dev)},
                         cache_len=512)
        launches = fa.flash_attention.launches - before
    del cpu_model
    err = float((got.cpu() - cpu).abs().max())
    scale = float(cpu.abs().max())
    if got.shape != (1, cfg.vocab_size) or launches != cfg.n_layers or \
            not math.isfinite(err) or err > 1e-3 * scale:
        raise RuntimeError(f"logits {arch}: card vs CPU max abs err {err} "
                           f"vs max|logits| {scale}, flash launches "
                           f"{launches}, shape {tuple(got.shape)}")
    bias = ", QKV biases drawn non-zero" if cfg.qkv_bias else ""
    log(f"{arch} widths, 2 layers, float32{bias}, 512-token prefill: card "
        f"(flash kernel, {launches} launches) vs CPU (plain) last-token "
        f"logits ({cfg.vocab_size}) max abs err {err:.3g}, max|logits| "
        f"{scale:.4g} (rel {err / scale:.3g}, limit 1e-3)")
    return card, cfg


# phase 23: the attention gradient kernel; FLASH_TESTS plus float32 cases of
# a window, a query offset and the widest head, the two training shapes
# of qwen3-4b (32 heads of 128, bf16, causal): batch 8 x 128 tokens and
# phase 24's long sequence, batch 1 x 4096 (64 query tiles a key block,
# sums over 4096 rows), and recurrentgemma-9b's local attention at phase
# 34's long sequence (its one KV head expanded to 16 heads of 256, window
# 2048: 33 query tiles a 64-key block, 68 key tiles a dq block)
FLASH_BWD_RG = (1, 4096, 4096, 16, 256, True, 2048, 0, "bfloat16")
FLASH_BWD_TESTS = FLASH_TESTS + [
    (1, 257, 257, 2, 128, True, 100, 0, "float32"),
    (2, 37, 120, 3, 64, True, 0, 83, "float32"),
    (1, 70, 70, 2, 256, True, 0, 0, "float32"),
    (8, 128, 128, 32, 128, True, 0, 0, "bfloat16"),
    (1, 4096, 4096, 32, 128, True, 0, 0, "bfloat16"),
    FLASH_BWD_RG]
FLASH_BWD_TIMED = 4096   # S = T of the timed shape (B=1, H=32, hd=128)
# float32 gradients within this share of each gradient's largest entry
FLASH_BWD_REL = 1e-4
# the bf16 forward's log-sum-exp (base 2, values of a few units to a few
# tens) against the plain version's: scores summed in another order, ex2
# and log2 on the card, exp and log in the plain version, float32 rounding
# of each (a few ULP of 16 is 1e-6)
LSE_ATOL = 5e-5


def flash_bwd_bound_ms(S, T, H, hd, causal, window, itemsize) -> dict:
    """Least time for the attention gradient on an H100 SXM: 5 products
    of 2 FLOP per visible (query, key) pair and head dim (dO.v, q.k
    recomputed, P^T dO, dS^T q, dS k) at the bf16 dense tensor-core peak
    (for float32 inputs three TF32 products for each, at the TF32 peak),
    against q, k, v, o and dO read once and dq, dk, dv written once (pass
    B x H as H for B > 1). ``design_ms``: in bfloat16 the floor of the 10
    products the tensor-core design issues (S^T, dP^T, P^T dO and dS^T q
    each split in two for dk and dv; S, dP, dS k split in two for dq) at
    the bf16 peak; in float32 the 5 products on the float32 pipe, and
    ``issued_ms`` the 7 products the split-TF32 design issues (q.k and
    dO.v again for dq) at the TF32 peak."""
    pairs = visible_pairs(S, T, causal, window)
    flops = 10 * pairs * H * hd
    nbytes = itemsize * H * hd * (4 * S + 4 * T)
    t_ops = (flops / PEAK_BF16_FLOPS if itemsize == 2
             else 3 * flops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    out = {"bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    if itemsize == 2:
        out["design_flops"] = 20 * pairs * H * hd
        out["design_ms"] = out["design_flops"] / PEAK_BF16_FLOPS * 1e3
    else:
        out["design_ms"] = flops / PEAK_FP32_FLOPS * 1e3
        out["issued_ms"] = 3 * 14 * pairs * H * hd / PEAK_TF32_FLOPS * 1e3
    return out


def flash_bwd_inputs(torch, gen, B, S, T, H, hd, dt, dev):
    """(B, S, H, hd) q, (B, T, H, hd) k and v, and dO, in type ``dt``."""
    tdt = getattr(torch, dt)
    return [torch.randn((B, L, H, hd), generator=gen, device=dev).to(tdt)
            for L in (S, T, T, S)]


def bwd_route_of(dt, hd) -> str:
    """The gradient kernel's route a shape must take, at every head dim
    up to 256: bf16 tensor-core products for bfloat16, split TF32
    (``tf32x3``) for float32."""
    del hd
    return "wgmma" if dt == "bfloat16" else "tf32x3"


def lse_check(torch, fa, name, q, k, v, causal, win, q_off) -> float:
    """The forward with its log-sum-exp store (either route): the output
    bit for bit the one without it, the lse within LSE_ATOL of the plain
    version's (base 2). Returns the lse's max abs error."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(causal=causal, window=win, q_offset=q_off)
    plain = fa.flash_attention(qt, kt, vt, **kw)
    out, lse = fa.flash_attention(qt, kt, vt, return_lse=True, **kw)
    _, want = fa.flash_attention_plain(*(x.float() for x in (qt, kt, vt)),
                                       return_lse=True, **kw)
    torch.cuda.synchronize()
    err = float((lse - want).abs().max())
    if not torch.equal(out, plain) or not err <= LSE_ATOL:
        raise RuntimeError(f"flash_attention lse {name}: output with the "
                           f"lse store equal: {torch.equal(out, plain)}; "
                           f"lse max abs err {err} (limit {LSE_ATOL})")
    return err


def flash_bwd_check(torch, fa, name, q, k, v, do, causal, win, dt, q_off):
    """The gradient through ``flash_mha`` (one backward kernel launch, on
    the route ``bwd_route_of`` names) vs ``flash_attention_bwd_plain`` in
    float32 on the same inputs, and a second launch on the same inputs
    (with the log-sum-exp from its own forward launch) bitwise equal.
    Returns the max abs error."""
    from repro_torch.kernels.ops import flash_mha
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_mha(q, k, v, causal=causal, window=win, q_offset=q_off)
    before = fa.flash_attention_bwd.launches
    route = bwd_route_of(dt, q.shape[-1])
    routed = fa.flash_attention_bwd.routes[route]
    got = torch.autograd.grad(out, (q, k, v), do)
    views = [x.detach().transpose(1, 2) for x in (q, k, v, out)]
    want = fa.flash_attention_bwd_plain(
        *(x.float() for x in views), do.transpose(1, 2).float(),
        causal=causal, window=win, q_offset=q_off)
    again = fa.flash_attention_bwd(*views, do.transpose(1, 2),
                                   causal=causal, window=win, q_offset=q_off)
    torch.cuda.synchronize()
    err, bad = 0.0, []
    for nm, g, w, a in zip("qkv", got, want, again):
        w = w.transpose(1, 2)
        e = float((g.float() - w).abs().max())
        err = max(err, e)
        lim = FLASH_BWD_REL * float(w.abs().max())
        over = (bf16_over(torch, g, w) if dt == "bfloat16"
                else int(((g - w).abs() > lim).sum()))
        if not (math.isfinite(e) and over == 0 and g.dtype == q.dtype):
            bad.append(f"d{nm}: max abs err {e}, {over} over the limit")
        if not torch.equal(a.transpose(1, 2), g):
            bad.append(f"d{nm}: a second launch differs")
    if fa.flash_attention_bwd.launches != before + 2:
        bad.append("the gradient did not launch the kernel once a call")
    if fa.flash_attention_bwd.routes[route] != routed + 2:
        bad.append(f"the launches did not take the {route} route")
    if bad:
        raise RuntimeError(f"flash_attention_bwd {name}: " + "; ".join(bad))
    return err


def phase_flash_bwd(torch, fa, dev) -> dict:
    """Phase 23: the attention gradient kernel vs its plain version on
    both routes (asserted by shape), its determinism, the bf16 forward's
    log-sum-exp store, and the tensor-core route's time beside SDPA's
    backward at S = T = 4096 with the saved lse passed, as training
    passes it."""
    import torch.nn.functional as F
    from repro_torch.kernels.ops import flash_mha
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    worst, f32_worst, lse_worst = 0.0, 0.0, 0.0
    for B, S, T, H, hd, causal, win, q_off, dt in FLASH_BWD_TESTS:
        q, k, v, do = flash_bwd_inputs(torch, gen, B, S, T, H, hd, dt, dev)
        name = (f"B={B} S={S} T={T} H={H} hd={hd} causal={causal} win={win}"
                f" q_offset={q_off} {dt}")
        err = flash_bwd_check(torch, fa, name, q, k, v, do, causal, win, dt,
                              q_off)
        worst = max(worst, err)
        if dt == "float32":
            f32_worst = max(f32_worst, err)
        if (B, S, T, H, hd, causal, win, q_off, dt) == FLASH_BWD_RG:
            rg_err = err
        e = lse_check(torch, fa, name, q, k, v, causal, win, q_off)
        lse_worst = max(lse_worst, e)
        extra = f"; forward with lse bitwise, lse max abs err {e:.3g}"
        log(f"flash_attention_bwd {name}: route {bwd_route_of(dt, hd)}, "
            f"max_abs_err {err:.3g}, two launches bitwise equal{extra}")
    S = FLASH_BWD_TIMED
    q, k, v, do = flash_bwd_inputs(torch, gen, 1, S, S, QWEN_H, QWEN_HD,
                                   "bfloat16", dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out, lse = fa.flash_attention(qt, kt, vt, return_lse=True)
    dot = do.transpose(1, 2)
    routed = fa.flash_attention_bwd.routes["wgmma"]
    fwd = fa.flash_attention.launches
    ms = time_ms(torch, lambda: fa.flash_attention_bwd(
        qt, kt, vt, out, dot, lse=lse), reps=10, windows=5)
    if fa.flash_attention_bwd.routes["wgmma"] == routed or \
            fa.flash_attention.launches != fwd:
        raise RuntimeError("flash_attention_bwd at S=T=4096: not on the "
                           "wgmma route, or a forward launch for the lse")
    plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
        qt, kt, vt, out, dot), reps=1, windows=3)
    # the forward as training launches it (with the lse store) beside the
    # forward as prefill launches it (without)
    fwd_ms = time_ms(torch, lambda: fa.flash_attention(qt, kt, vt), reps=20)
    fwd_lse_ms = time_ms(torch, lambda: fa.flash_attention(
        qt, kt, vt, return_lse=True), reps=20)
    ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))
    sdpa = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa, (ql, kl, vl), dot, retain_graph=True), reps=5)
    bound = flash_bwd_bound_ms(S, S, QWEN_H, QWEN_HD, True, 0, 2)
    log(f"flash_attention_bwd B=1 S=T={S} H={QWEN_H} hd={QWEN_HD} causal "
        f"bfloat16, wgmma route, saved lse: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, sdpa backward {lib_ms:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
        f"{bound['flops'] / 1e9:.1f} GFLOP, {bound['bytes'] / 1e6:.1f} MB; "
        f"this design's 10 products need >= {bound['design_ms']:.3f} ms); "
        f"kernel at {bound['flops'] / ms / 1e9:.2f} TFLOP/s of the least "
        f"work, {bound['design_flops'] / ms / 1e9:.2f} TFLOP/s issued")
    log(f"flash_attention B=1 S=T={S} H={QWEN_H} hd={QWEN_HD} causal "
        f"bfloat16: {fwd_ms:.4f} ms without the lse store, {fwd_lse_ms:.4f}"
        f" ms with it")
    rg = flash_bwd_rg_times(torch, fa, gen, dev)
    f32 = flash_f32_times(torch, fa, gen, dev)
    return {"max_abs_err": worst, "lse_max_abs_err": lse_worst, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, **bound,
            "rg": {**rg, "max_abs_err": rg_err}, "f32": f32,
            "f32_err": f32_worst}


def sdpa_f32_ms(torch, qt, kt, vt, dot, causal, backend) -> tuple:
    """SDPA's forward and its backward through autograd on float32
    (B, H, L, hd) views, on one backend (``torch.nn.attention.
    SDPBackend``), timed by events: (forward ms, backward ms)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel
    with sdpa_kernel(backend):
        fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=10)
        ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        bwd = time_ms(torch, lambda: torch.autograd.grad(
            out, (ql, kl, vl), dot, retain_graph=True), reps=5)
    return fwd, bwd


def flash_f32_times(torch, fa, gen, dev) -> dict:
    """Phase 23's float32 part: the forward and the gradient kernels
    (split TF32, the gradient with the forward's saved lse, as training
    passes it) at each of FLASH_F32_TIMED, each checked once more
    against its plain version (the gradient within FLASH_BWD_REL of each
    gradient's largest entry, two launches bitwise), timed beside the
    plain versions, SDPA in float32 on its memory-efficient backend
    (CUTLASS's split-TF32 kernels; the math backend beside it) and the
    bounds (the split-TF32 floor; the float32 pipe's and the issued
    products' floors beside it), and the gradient's two kernels' device
    times under the profiler. Returns each shape's numbers by (B, S, H,
    hd, causal)."""
    from torch.nn.attention import SDPBackend
    out = {}
    for B, S, H, hd, causal in FLASH_F32_TIMED:
        q, k, v, do = flash_bwd_inputs(torch, gen, B, S, S, H, hd,
                                       "float32", dev)
        name = f"B={B} S=T={S} H={H} hd={hd} causal={causal} float32"
        berr = flash_bwd_check(torch, fa, name, q, k, v, do, causal, 0,
                               "float32", 0)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        o, lse = fa.flash_attention(qt, kt, vt, causal=causal,
                                    return_lse=True)
        routed = fa.flash_attention_bwd.routes["tf32x3"]
        ms = time_ms(torch, lambda: fa.flash_attention(qt, kt, vt,
                                                       causal=causal),
                     reps=20)
        bms = time_ms(torch, lambda: fa.flash_attention_bwd(
            qt, kt, vt, o, dot, causal=causal, lse=lse), reps=10)
        if fa.flash_attention_bwd.routes["tf32x3"] == routed:
            raise RuntimeError(f"flash_attention_bwd {name}: not on the "
                               "tf32x3 route")
        calls = max(3, math.ceil(50 / bms))  # a 50 ms window
        split = kernel_split(torch, lambda: fa.flash_attention_bwd(
            qt, kt, vt, o, dot, causal=causal, lse=lse), calls,
            TF32_BWD_KERNELS)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            qt, kt, vt, causal=causal), reps=1, windows=3)
        bplain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
            qt, kt, vt, o, dot, causal=causal), reps=1, windows=3)
        eff = sdpa_f32_ms(torch, qt, kt, vt, dot, causal,
                          SDPBackend.EFFICIENT_ATTENTION)
        math_ = sdpa_f32_ms(torch, qt, kt, vt, dot, causal,
                            SDPBackend.MATH)
        fb = flash_bound_ms(S, S, B * H, hd, causal, 0, 4)
        bb = flash_bwd_bound_ms(S, S, B * H, hd, causal, 0, 4)
        log(f"flash_attention {name}, tf32x3 route: forward {ms:.4f} ms "
            f"(plain {plain_ms:.3f} ms, sdpa memory-efficient {eff[0]:.4f} "
            f"ms, sdpa math {math_[0]:.4f} ms), bound {fb['bound_ms']:.4f} "
            f"ms ({fb['bound_by']}: {fb['flops'] / 1e9:.2f} GFLOP as split "
            f"TF32; {fb['design_ms']:.4f} ms on the float32 pipe), "
            f"{ms / fb['bound_ms']:.2f}x the bound; gradient (saved lse) "
            f"{bms:.4f} ms (plain {bplain_ms:.3f} ms, sdpa memory-efficient "
            f"backward {eff[1]:.4f} ms, math {math_[1]:.4f} ms), bound "
            f"{bb['bound_ms']:.4f} ms ({bb['bound_by']}: 5 products, "
            f"{bb['flops'] / 1e9:.2f} GFLOP; {bb['design_ms']:.4f} ms on "
            f"the float32 pipe; the 7 issued products need >= "
            f"{bb['issued_ms']:.4f} ms), {bms / bb['bound_ms']:.2f}x the "
            f"bound; gradient by kernel (profiler, ms a call over {calls} "
            f"calls): {split_text(split, calls)}; gradient max_abs_err "
            f"{berr:.3g}")
        out[(B, S, H, hd, causal)] = {
            "fwd": {"ms": ms, "plain_ms": plain_ms, "library_ms": eff[0],
                    **fb},
            "bwd": {"ms": bms, "plain_ms": bplain_ms, "library_ms": eff[1],
                    "err": berr, **bb}}
    return out


def band_mask(torch, S, window, dev):
    """(S, S) boolean mask of the causal window band, True where query i
    sees key j (0 <= i - j < window): SDPA's ``attn_mask`` for the
    function the kernels compute at FLASH_BWD_RG."""
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    return (i >= j) & (i - j < window)


def flash_bwd_rg_times(torch, fa, gen, dev) -> dict:
    """Phase 23 at recurrentgemma-9b's local attention (FLASH_BWD_RG,
    checked against the plain version above): the gradient with the
    saved lse (one launch a call on the wgmma route, no forward), its
    plain version, SDPA's backward with the window band as its mask (the
    same function) and with ``is_causal`` (more work: every causal pair,
    not the band's), the forward with and without its lse store and
    SDPA's band-masked forward, beside the bounds and the design's
    floor."""
    import torch.nn.functional as F
    B, S, T, H, hd, causal, win, _, dt = FLASH_BWD_RG
    q, k, v, do = flash_bwd_inputs(torch, gen, B, S, T, H, hd, dt, dev)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(causal=causal, window=win)
    out, lse = fa.flash_attention(qt, kt, vt, return_lse=True, **kw)
    bwd = fa.flash_attention_bwd
    routed, fwd = bwd.routes["wgmma"], fa.flash_attention.launches
    ms = time_ms(torch, lambda: bwd(qt, kt, vt, out, dot, lse=lse, **kw),
                 reps=10, windows=5)
    if bwd.routes["wgmma"] != routed + 2 + 5 * 10 or \
            fa.flash_attention.launches != fwd:
        raise RuntimeError(f"flash_attention_bwd at {FLASH_BWD_RG}: a launch"
                           " off the wgmma route, or a forward launch for "
                           "the lse")
    plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
        qt, kt, vt, out, dot, **kw), reps=1, windows=3)
    fwd_ms = time_ms(torch, lambda: fa.flash_attention(qt, kt, vt, **kw),
                     reps=20)
    fwd_lse_ms = time_ms(torch, lambda: fa.flash_attention(
        qt, kt, vt, return_lse=True, **kw), reps=20)
    mask = band_mask(torch, S, win, dev)
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), reps=10)
    ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))
    band = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    band_ms = time_ms(torch, lambda: torch.autograd.grad(
        band, (ql, kl, vl), dot, retain_graph=True), reps=5)
    del band
    full = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    causal_ms = time_ms(torch, lambda: torch.autograd.grad(
        full, (ql, kl, vl), dot, retain_graph=True), reps=5)
    del full, mask
    bound = flash_bwd_bound_ms(S, T, H, hd, causal, win, 2)
    fbound = flash_bound_ms(S, T, H, hd, causal, win, 2)
    band_pairs = visible_pairs(S, T, causal, win)
    causal_pairs = visible_pairs(S, T, True, 0)
    log(f"flash_attention_bwd B={B} S=T={S} H={H} hd={hd} causal window "
        f"{win} bfloat16, wgmma route, saved lse: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, sdpa backward with the band mask "
        f"{band_ms:.4f} ms, sdpa is_causal backward {causal_ms:.4f} ms (more"
        f" work: {causal_pairs / 1e6:.2f} M pairs a head against the "
        f"band's {band_pairs / 1e6:.2f} M), bound {bound['bound_ms']:.4f} "
        f"ms ({bound['bound_by']}: {bound['flops'] / 1e9:.1f} GFLOP, "
        f"{bound['bytes'] / 1e6:.1f} MB; this design's 10 products need >= "
        f"{bound['design_ms']:.3f} ms); kernel at "
        f"{bound['flops'] / ms / 1e9:.2f} TFLOP/s of the least work, "
        f"{bound['design_flops'] / ms / 1e9:.2f} TFLOP/s issued")
    log(f"flash_attention B={B} S=T={S} H={H} hd={hd} causal window {win} "
        f"bfloat16: {fwd_ms:.4f} ms without the lse store, {fwd_lse_ms:.4f}"
        f" ms with it, sdpa with the band mask {sdpa_fwd_ms:.4f} ms, bound "
        f"{fbound['bound_ms']:.4f} ms ({fbound['bound_by']})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": band_ms,
            "causal_library_ms": causal_ms, "fwd_ms": fwd_ms,
            "fwd_lse_ms": fwd_lse_ms, "fwd_library_ms": sdpa_fwd_ms,
            "fwd_bound_ms": fbound["bound_ms"], **bound}


# phase 24's device time split by kernel name (as the profiler demangles
# it): the attention gradient kernel (csrc/flash_attention_bwd.cu: the
# tensor-core route's rows, dkdv and dq kernels in namespace wgmma_fa_bwd,
# the split-TF32 route's dq and dkdv kernels), the forward attention
# kernel (wgmma_fa's, tf32_fa's fwd_kernel), cuBLAS products (nvjet and
# the older gemm families), and PyTorch's elementwise, copy and reduction
# kernels (AdamW, the clip, norms, RoPE, casts). The float32 routes'
# earlier CUDA-core kernels (stats_kernel, flash_kernel) are named too,
# so tools/bench_flash_bwd.py sorts an older checkout's alike.
TRAIN_KERNEL_GROUPS = [
    ("attention gradient", ("wgmma_fa_bwd", "dkdv_kernel", "dq_kernel",
                            "stats_kernel")),
    ("attention forward", ("wgmma_fa", "fwd_kernel", "flash_kernel")),
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
    ("elementwise and reductions", ("elementwise", "reduce", "copy"))]
TRAIN_ARGS = ["--arch", "qwen3_4b", "--steps", "4", "--batch", "8", "--seq",
              "128", "--device", "cuda"]
# phase 24's long-sequence run: batch 1, the first of these lengths that
# fits the card, LONG_STEPS steps (the median of steps 2.. is reported)
LONG_SEQS = (4096, 2048)
LONG_STEPS = 3


def train_run(torch, launch_train, dev, argv, n_steps, ckpt_dir=None,
              cfg=None):
    """``launch.train``'s code path: its arguments and set-up (``cfg``,
    a depth cut, in place of the arch's config), then ``train_loop`` to
    step ``n_steps`` (resuming from ``ckpt_dir``). Returns (state,
    step_fn, pipe, per-step metrics)."""
    from repro_torch.train.loop import train_loop
    args = launch_train.parse_args(argv)
    _, state, step_fn, pipe = launch_train.setup(args, dev, cfg)
    hist = []
    state = train_loop(state, step_fn, pipe, n_steps, ckpt_dir=ckpt_dir,
                       ckpt_every=2, log_every=1,
                       on_metrics=lambda s, m: hist.append(m))
    return state, step_fn, pipe, hist


def profile_step(torch, step_fn, state, pipe, label) -> dict:
    """One more train step under the profiler: launches, busy and idle
    share, the top kernels and the device time by TRAIN_KERNEL_GROUPS
    kind, logged under ``label``."""
    batch = pipe.next_batch()
    return profile_by_kind(torch, lambda: float(step_fn(state, batch)[1][
        "loss"]), TRAIN_KERNEL_GROUPS, f"{label} profiled step")


def profile_by_kind(torch, fn, kinds, label) -> dict:
    """``fn()`` under the profiler: launches, busy and idle share, the top
    kernels and the device time by kind (``kinds``: (name, substrings of
    the kernel names) pairs, the first match wins), logged under
    ``label``."""
    kernels, busy, pwall = profiled_kernels(torch, fn)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"{label}: {pwall:.4f} s wall, {len(kernels)} device kernel "
        f"launches, device busy {busy:.4f} s, idle share "
        f"{1 - busy / pwall:.3f}")
    for nm, ms in top:
        log(f"  {ms:9.3f} ms  {nm[:100]}")
    groups, others = {}, []
    for nm, ms in by_name.items():
        g = next((g for g, keys in kinds if any(k in nm for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + ms
        if g == "other":
            others.append((ms, nm))
    log(f"{label}, device ms by kind: " + ", ".join(
        f"{g} {groups.get(g, 0.0):.3f}"
        for g in [g for g, _ in kinds] + ["other"]))
    for ms, nm in sorted(others, reverse=True)[:3]:
        log(f"  other: {ms:9.3f} ms  {nm[:100]}")
    return {"groups": groups, "idle": 1 - busy / pwall,
            "launches": len(kernels)}


def train_checked(torch, fa, launch_train, dev, argv, n_steps, label,
                  cfg=None, route="wgmma"):
    """``train_run`` (``cfg``: a depth cut in place of the arch's config)
    with the counters reset first, then the checks every full-width run
    must pass: finite losses and grad norms, 1 gradient launch a layer a
    step and 2 forward launches a layer a step (remat), all on ``route``
    (the bf16 tensor-core route, or ``tf32x3`` for a float32 trunk).
    Returns (state, step_fn, pipe, summary)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention.launches = 0
    fa.flash_attention.routes = {"wgmma": 0, "tf32x3": 0}
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_bwd.routes = {"wgmma": 0, "tf32x3": 0}
    t0 = time.perf_counter()
    state, step_fn, pipe, hist = train_run(torch, launch_train, dev, argv,
                                           n_steps, cfg=cfg)
    wall = time.perf_counter() - t0
    bwd, fwd = fa.flash_attention_bwd.launches, fa.flash_attention.launches
    routed = (fa.flash_attention_bwd.routes[route],
              fa.flash_attention.routes[route])
    n_layers = len(state.params.blocks)
    losses = [m["loss"] for m in hist]
    gnorms = [m["grad_norm"] for m in hist]
    times = [m["step_time_s"] for m in hist]
    if len(hist) != n_steps or not all(
            math.isfinite(x) for x in losses + gnorms) \
            or bwd != n_steps * n_layers or fwd != 2 * n_steps * n_layers \
            or routed != (bwd, fwd):
        raise RuntimeError(f"{label}: {len(hist)} steps, losses {losses}, "
                           f"grad norms {gnorms}, backward launches {bwd}, "
                           f"forward launches {fwd}, on the {route} route "
                           f"{routed} (want {n_steps * n_layers} and "
                           f"{2 * n_steps * n_layers}, all {route})")
    med = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"{label}: losses {[f'{x:.4f}' for x in losses]}, grad norms "
        f"{[f'{x:.4f}' for x in gnorms]}, step times "
        f"{[f'{x:.3f}' for x in times]} s, {wall:.2f} s wall (init "
        f"included)")
    return state, step_fn, pipe, {
        "median_step_s": med, "peak": peak, "launches": bwd, "fwd": fwd,
        "n_layers": n_layers,
        "n_params": sum(p.numel() for p in state.params.parameters())}


def phase_train(torch, fa, dev) -> dict:
    """Phase 24: qwen3-4b at full width trains on the card through
    ``launch.train``'s code path, at batch 8 x 128 and at one long
    sequence (LONG_SEQS: the first that fits); then the resume check at
    reduced size."""
    from repro_torch.launch import train as launch_train
    state, step_fn, pipe, run = train_checked(
        torch, fa, launch_train, dev, TRAIN_ARGS, 4, "train qwen3_4b")
    med, peak, bwd, fwd = (run["median_step_s"], run["peak"],
                           run["launches"], run["fwd"])
    tokens = 8 * 128
    log(f"train qwen3_4b full width: {run['n_params'] / 1e9:.3f} B "
        f"parameters, {run['n_layers']} layers, bf16, batch 8 x seq 128")
    log(f"train qwen3_4b: median step (steps 2-4) {med:.4f} s, "
        f"{tokens / med:.1f} tokens/s; flash_attention_bwd launches {bwd} "
        f"({bwd // 4} a step, all on the wgmma route), forward launches "
        f"{fwd} (remat: 2 a layer); peak memory {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.2f} GB)")
    prof = profile_step(torch, step_fn, state, pipe, "train qwen3_4b")
    del state, step_fn, pipe
    long = None
    for seq in LONG_SEQS:
        argv = ["--arch", "qwen3_4b", "--steps", str(LONG_STEPS), "--batch",
                "1", "--seq", str(seq), "--device", "cuda"]
        label = f"train qwen3_4b batch 1 x {seq}"
        try:
            state, step_fn, pipe, long = train_checked(
                torch, fa, launch_train, dev, argv, LONG_STEPS, label)
        except torch.cuda.OutOfMemoryError:
            log(f"{label}: out of memory on this card; the next length")
            state = step_fn = pipe = None
            continue
        lmed = long["median_step_s"]
        log(f"{label}: median step (steps 2-{LONG_STEPS}) {lmed:.4f} s, "
            f"{seq / lmed:.1f} tokens/s; flash_attention_bwd launches "
            f"{long['launches']} ({long['launches'] // LONG_STEPS} a step, "
            f"all on the wgmma route); peak memory "
            f"{long['peak'] / 2**30:.2f} GiB ({long['peak'] / 1e9:.2f} GB)")
        long.update(seq=seq, prof=profile_step(torch, step_fn, state, pipe,
                                               label))
        log(f"{label}: the gradient kernel's device time in the profiled "
            f"step {long['prof']['groups'].get('attention gradient', 0):.3f}"
            f" ms ({long['launches'] // LONG_STEPS} launches)")
        del state, step_fn, pipe
        break
    if long is None:
        raise RuntimeError(f"train qwen3_4b: no sequence of {LONG_SEQS} "
                           "fits at batch 1")
    torch.cuda.empty_cache()
    # resume, bitwise, at reduced size: 4 steps straight against 2 steps,
    # a checkpoint, a fresh state and 2 more from it
    small = ["--arch", "qwen3_4b", "--reduced", "--steps", "4", "--batch",
             "8", "--seq", "128", "--device", "cuda"]
    straight = train_run(torch, launch_train, dev, small, 4)[0]
    with tempfile.TemporaryDirectory() as ck:
        train_run(torch, launch_train, dev, small, 2, ckpt_dir=ck)
        resumed = train_run(torch, launch_train, dev, small, 4,
                            ckpt_dir=ck)[0]
    diff = [n for (n, a), (_, b) in zip(straight.params.named_parameters(),
                                        resumed.params.named_parameters())
            if not torch.equal(a, b)]
    diff += [f"{t}.{n}" for t in ("m", "v")
             for n, a in getattr(straight.opt, t).items()
             if not torch.equal(a, getattr(resumed.opt, t)[n])]
    if diff or resumed.step != 4:
        raise RuntimeError(f"train resume: step {resumed.step}, leaves that "
                           f"differ from the straight run: {diff[:8]}")
    log(f"train resume (qwen3_4b reduced, 4 straight vs 2 + checkpoint + 2 "
        f"on a fresh state): params, m and v bitwise equal "
        f"({len(straight.opt.m)} leaves each)")
    return {"launches": bwd, "median_step_s": med, "peak": peak,
            "idle": prof["idle"], "long": long}


# phase 25: the decode kernel's shapes (name, B, T, KV, G, hd, cache type,
# window, rows): qwen3-4b serving (4 slots of 4352, 8 KV heads of 4 query
# heads, hd 128) on the bf16 and the int8 cache, recurrentgemma-9b's local
# ring (4 slots of 2048, 1 KV head of 16, hd 256, window 2048) in bf16, and
# a reduced float32 shape, and the int8 route at head dim 64 with a row
# whose every slot lies past its query. Rows: "fill" fills a ragged prefix
# (the rest empty), "ring" a wrapped ring buffer, "late" a prefix whose last
# slots lie past the query, "dead" every slot past the query (the softmax
# over all NEG_INF: p = 1 / T on every slot).
DECODE_TESTS = [
    ("qwen3-4b bf16", 4, 4352, 8, 4, 128, "bfloat16", 0,
     ("fill", "fill", "fill", "late")),
    ("qwen3-4b int8", 4, 4352, 8, 4, 128, "int8", 0,
     ("fill", "fill", "fill", "late")),
    ("recurrentgemma-9b ring bf16", 4, 2048, 1, 16, 256, "bfloat16", 2048,
     ("ring", "ring", "fill", "late")),
    ("reduced float32", 3, 40, 2, 2, 16, "float32", 6,
     ("fill", "ring", "late")),
    ("int8, hd 64, a row that sees no slot", 3, 70, 2, 4, 64, "int8", 0,
     ("fill", "dead", "late")),
]
# float32: within this share of max|out| of the plain version (sums in
# another order, expf against torch.exp)
DECODE_F32_REL = 1e-5


def decode_inputs(torch, gen, B, T, KV, G, hd, cache, window, rows, dev):
    """q, the cache (k, v and, int8, their scales through the model's
    quantiser) and the slot and query positions of ``rows``."""
    from repro_torch.models.transformer import _kv_quantize
    qdt = torch.float32 if cache == "float32" else torch.bfloat16
    q = torch.randn((B, 1, KV * G, hd), generator=gen, device=dev).to(qdt)
    k, v = (torch.randn((B, T, KV, hd), generator=gen, device=dev)
            for _ in range(2))
    ks = vs = None
    if cache == "int8":
        (k, ks), (v, vs) = _kv_quantize(k), _kv_quantize(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    pos = torch.full((B, T), -1, dtype=torch.long, device=dev)
    q_pos = torch.zeros((B,), dtype=torch.long, device=dev)
    lens = torch.randint(T // 4, T + 1, (B,), generator=gen, device=dev)
    for b, kind in enumerate(rows):
        n = int(lens[b])
        if kind == "dead":
            pos[b] = torch.arange(T, device=dev) + 1
            continue
        if kind == "ring":
            q_pos[b] = T + n
            p = torch.arange(q_pos[b] - T + 1, q_pos[b] + 1, device=dev)
            pos[b, p % T] = p
        else:
            pos[b, :n] = torch.arange(n, device=dev)
            q_pos[b] = n - 1 - (min(3, n - 1) if kind == "late" else 0)
    return q, k, v, ks, vs, pos, q_pos


def decode_bound_ms(q, k, ks, pos, q_pos, window) -> dict:
    """Least time for the decode step on an H100 SXM: q read and the
    output written once, every slot's position read, and K and V (with
    their scales) of the visible slots only (the kernel loads no other:
    this input's need), against 4 FLOP per visible slot, query head and
    head dim at the rate of the units the route gives them: the bf16
    tensor cores' on the grouped route (``launch_plan``), else the
    float32 rate."""
    from repro_torch.kernels.decode_attention import launch_plan, \
        visible_slots
    B, _, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    route = launch_plan(B, T, KV, H // KV, hd, q.dtype, k.dtype)[0]
    peak = PEAK_BF16_FLOPS if route == "grouped" else PEAK_FP32_FLOPS
    vis = int(visible_slots(pos, q_pos, window).sum())
    nbytes = (2 * q.numel() * q.element_size() + pos.numel() * 8
              + q_pos.numel() * 8
              + vis * KV * (2 * hd * k.element_size()
                            + (8 if ks is not None else 0)))
    flops = 4 * vis * H * hd
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "visible": vis}


def graph_replay_equal(torch, fn, want) -> bool:
    """One ``fn()`` call captured in a CUDA graph and replayed twice: both
    replays' outputs (a tensor or a tuple of them) bitwise ``want`` (an
    eager launch's), so whatever
    the call leaves in its workspace (counters, flags) lets it run
    again."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    if isinstance(out, torch.Tensor):
        out, want = (out,), (want,)
    same = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same.append(all(torch.equal(o, w) for o, w in zip(out, want)))
    del graph
    return all(same)


def _cudart():
    """The CUDA runtime library PyTorch runs on (its soname), or the
    toolkit's, through ctypes."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for name in ("libcudart.so.12", "libcudart.so",
                 os.path.join(cuda_home, "lib64", "libcudart.so")):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise RuntimeError("libcudart not found")


def kernels_a_call(torch, fn) -> tuple:
    """(kernel nodes, all nodes) of a CUDA graph that captured one
    ``fn()`` call: the device kernels the call launches, counted from
    the graph (cudaGraphGetNodes, cudaGraphNodeGetType) and not by the
    profiler, which can drop the device events of a short window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    rt = _cudart()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = rt.cudaGraphGetNodes(raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(1, n.value))()
    err = err or rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n))
    kinds = []
    for i in range(n.value):
        kind = ctypes.c_int(-1)
        err = err or rt.cudaGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                             ctypes.byref(kind))
        kinds.append(kind.value)
    del graph
    if err:
        raise RuntimeError(f"cudaGraphGetNodes/NodeGetType: CUDA error {err}")
    # cudaGraphNodeTypeKernel is 0
    return sum(k == 0 for k in kinds), len(kinds)


def phase_decode(torch, dev, tests=DECODE_TESTS, seed=25) -> dict:
    """Phase 25 (phase 41: GQA_DECODE_TESTS; phase 36: MIXTRAL_RING): the
    decode kernel vs ``decode_attention_plain`` at each shape of
    ``tests``, the inputs drawn in order from a generator seeded
    ``seed``, the cache type's route and the grouped route (where
    ``launch_plan`` gives it: G > 4, a bf16 q) asserted by their counts,
    the ring rows wrapped, two launches bitwise equal, a CUDA graph's
    replays bitwise the eager launch, two device kernels a call (scores
    and values passes); device time from a CUDA graph beside the bound,
    the plain version and, for bf16, SDPA with ``enable_gqa`` (a
    yardstick only), timed both in a CUDA graph as the kernel is and by
    events around calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kern = dk.decode_attention_kernel
    timed, worst = {}, 0.0
    for name, B, T, KV, G, hd, cache, win, rows in tests:
        q, k, v, ks, vs, pos, q_pos = decode_inputs(
            torch, gen, B, T, KV, G, hd, cache, win, rows, dev)
        route, _, L, splits = dk.launch_plan(B, T, KV, G, hd, q.dtype,
                                             k.dtype)

        def call():
            return kern(q, k, v, pos, q_pos, win, ks, vs)
        before, before_g = dict(kern.routes), kern.grouped
        got = call()
        again = call()
        want = dk.decode_attention_plain(q, k, v, pos, q_pos, win, ks, vs)
        torch.cuda.synchronize()
        routed = kern.routes[cache] - before[cache]
        grouped = kern.grouped - before_g
        want_g = 2 if route == "grouped" else 0
        wrapped = int((q_pos >= T).sum())
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        over = (bf16_over(torch, got, want) if q.dtype == torch.bfloat16
                else int(err > DECODE_F32_REL * scale))
        bitwise = torch.equal(got, again)
        replay = graph_replay_equal(torch, call, got)
        n_kernels, n_nodes = kernels_a_call(torch, call)
        if not (got.shape == q.shape and got.dtype == q.dtype and
                math.isfinite(err) and over == 0 and bitwise and
                routed == 2 and grouped == want_g and
                wrapped == rows.count("ring") and replay and
                n_kernels == n_nodes == 2):
            raise RuntimeError(f"decode_attention {name}: max abs err {err}"
                               f" (max|out| {scale}), {over} over the limit,"
                               f" bitwise {bitwise}, {routed} launches on "
                               f"route {cache} (want 2), {grouped} on the "
                               f"grouped route (want {want_g}), {wrapped} "
                               f"rows wrapped, graph replays "
                               f"equal {replay}, {n_kernels} kernels of "
                               f"{n_nodes} graph nodes a call (want 2 of "
                               f"2)")
        worst = max(worst, err)
        ms = graph_ms(torch, call)
        call_ms = time_ms(torch, call, reps=20)
        plain_ms = time_ms(torch, lambda: dk.decode_attention_plain(
            q, k, v, pos, q_pos, win, ks, vs), reps=3, windows=3)
        lib_ms = lib_graph_ms = None
        if cache == "bfloat16":
            mask = dk.visible_slots(pos, q_pos, win)[:, None, None, :]
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            lib_ms = time_ms(torch, sdpa, reps=20)
            try:
                lib_graph_ms = graph_ms(torch, sdpa)
            except Exception as exc:  # the yardstick only: say why
                torch.cuda.synchronize()
                log(f"decode_attention {name}: sdpa(enable_gqa) would not "
                    f"run in a CUDA graph ({type(exc).__name__}: {exc}); "
                    f"its event time stands")
        bound = decode_bound_ms(q, k, ks, pos, q_pos, win)
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "route": route,
                       "err": err,
                       "library_ms": (lib_graph_ms if lib_graph_ms
                                      is not None else lib_ms),
                       "library_call_ms": lib_ms,
                       "library_graph_ms": lib_graph_ms,
                       "call_ms": call_ms, **bound}
        limit = ("2 bf16 steps + 1e-4" if q.dtype == torch.bfloat16 else
                 f"{DECODE_F32_REL:g} x max|out|")
        sdpa_txt = "n/a" if lib_ms is None else (
            f"{lib_ms:.4f} ms a call, "
            + ("graph n/a" if lib_graph_ms is None else
               f"{lib_graph_ms:.4f} ms a launch (CUDA graph)"))
        log(f"decode_attention {name} (B={B} T={T} KV={KV} G={G} hd={hd} "
            f"window={win}, {bound['visible']} of {B * T} slots visible, "
            f"{wrapped} rows wrapped, {splits} splits of {L}): route "
            f"{cache} ({route}), max_abs_err {err:.3g} (max|out| "
            f"{scale:.3g}, limit {limit}), two launches bitwise, graph "
            f"replays bitwise, {n_kernels} device kernels a call; kernel "
            f"{ms:.4f} ms a launch on the device (CUDA graph), {call_ms:.4f}"
            f" ms a call; plain {plain_ms:.4f} ms; sdpa(enable_gqa) "
            f"{sdpa_txt}; bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
            f"{bound['bytes'] / 1e6:.2f} MB)")
    return {"max_abs_err": worst, "timed": timed}


# phase 26: the scan kernel's shapes (B, S, W, dtype): a 4096-token
# recurrentgemma-9b prefill (rnn width 4096) in bf16 and float32, and a
# ragged one; then the tile's edges (32 channels x 256 steps): S off the
# tile with B > 1 and W off the channel tile, S one step past a tile, and
# S and W below one tile
SCAN_TESTS = [(1, 4096, 4096, "bfloat16"), (1, 4096, 4096, "float32"),
              (2, 37, 4096, "bfloat16"), (3, 300, 1000, "float32"),
              (2, 257, 4100, "bfloat16"), (1, 1, 7, "float32")]
# float32 h within this share of max|h| of the plain version (the carry
# into each 32-step sub-chunk goes through the product of its a_t, where the
# plain loop applies them one at a time; expf, log1pf and the division
# against torch's; the recurrence damps both)
SCAN_F32_REL = 1e-5
# float32 operations an element: the two gate pre-activations (4), the two
# sigmoids (exp, add, divide: 6), log a, a, 2 log a, its exp, 1 - it, the
# floor, the root, i x, b (9), a h + b (2)
SCAN_OPS = 21


def scan_inputs(torch, gen, B, S, W, dt, dev):
    """x as a bf16 model's post-conv activations, and the five lru leaves
    drawn around the reference's init values."""
    x = (torch.randn((B, S, W), generator=gen, device=dev) * 2).to(dt)
    u = [torch.rand((W,), generator=gen, device=dev) for _ in range(5)]
    p = (u[0] * 28.0 - 3.0, u[1] + 0.5, u[2] - 0.5, u[3] + 0.5, u[4] - 0.5)
    return x, p


def phase_scan(torch, dev) -> dict:
    """Phase 26: the RG-LRU scan kernel vs ``rglru_scan_plain`` at
    SCAN_TESTS (bf16: every element within two bf16 steps + 1e-4;
    float32: 1e-5 x max|h|), two launches bitwise, a CUDA graph's
    replays bitwise the eager launch, one device kernel a call; timed
    beside its bound and the plain loop."""
    from repro_torch.kernels import rglru_scan as rs
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    timed, worst = {}, 0.0
    with torch.no_grad():
        for B, S, W, dt in SCAN_TESTS:
            x, p = scan_inputs(torch, gen, B, S, W, getattr(torch, dt), dev)
            def call():
                return rs.rglru_scan(x, *p)
            before = rs.rglru_scan.launches
            got, again = call(), call()
            launched = rs.rglru_scan.launches - before
            want = rs.rglru_scan_plain(x, *p)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            over = (bf16_over(torch, got, want) if dt == "bfloat16"
                    else int(err > SCAN_F32_REL * scale))
            bitwise = torch.equal(got, again)
            replay = graph_replay_equal(torch, call, got)
            n_kernels, n_nodes = kernels_a_call(torch, call)
            if not (got.shape == x.shape and got.dtype == x.dtype and
                    math.isfinite(err) and over == 0 and bitwise and
                    launched == 2 and replay and n_kernels == n_nodes == 1):
                raise RuntimeError(f"rglru_scan ({B}, {S}, {W}) {dt}: max "
                                   f"abs err {err} (max|h| {scale}), {over} "
                                   f"over the limit, bitwise {bitwise}, "
                                   f"graph replays equal {replay}, "
                                   f"{n_kernels} kernels of {n_nodes} graph "
                                   f"nodes a call (want 1 of 1)")
            worst = max(worst, err)
            ms = graph_ms(torch, call, launches=5)
            plain_ms = time_ms(torch, lambda: rs.rglru_scan_plain(x, *p),
                               reps=1, windows=3)
            nbytes = 2 * x.numel() * x.element_size() + 5 * W * 4
            t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
            t_ops = SCAN_OPS * x.numel() / RATE_FP32 * 1e3
            bound = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
            timed[(B, S, W, dt)] = {"ms": ms, "plain_ms": plain_ms, **bound}
            limit = ("2 bf16 steps + 1e-4" if dt == "bfloat16" else
                     f"{SCAN_F32_REL:g} x max|h|")
            log(f"rglru_scan ({B}, {S}, {W}) {dt}: max_abs_err {err:.3g} "
                f"(max|h| {scale:.3g}, limit {limit}), two launches "
                f"bitwise, graph replays bitwise, "
                f"{n_kernels} device kernel a call; kernel "
                f"{ms:.4f} ms a launch on the device (CUDA graph), plain "
                f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']}: {nbytes / 1e6:.2f} MB, "
                f"{SCAN_OPS * x.numel() / 1e9:.3f} G float32 ops)")
    return {"max_abs_err": worst, "timed": timed}


def phase_recurrentgemma(torch, fa, dev) -> dict:
    """Phase 27: recurrentgemma-9b at its published width (38 layers,
    bf16, seeded random weights) through ServeEngine, phase 12's request
    shape: 8 prompts of 256..4096 tokens (those above 2048 wrap the local
    ring), 16 new each, 4 slots; flash 12 x 8, scan 26 x 8 and decode 12
    a step; then a 3-layer [R, R, A] cut at full width in float32: the
    card's prefill and decode logits against the CPU's."""
    import copy
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import ServeEngine
    cfg = get_config("recurrentgemma_9b")
    n_attn = cfg.layout().count("local_attn")
    n_rec = cfg.layout().count("rglru")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"recurrentgemma_9b init on the card: {n_params / 1e9:.3f} B "
        f"parameters, {cfg.dtype} ({n_rec} rglru + {n_attn} local_attn "
        f"layers, window {cfg.local_window}), "
        f"{time.perf_counter() - t0:.2f} s")
    lens, prompts = serve_requests(cfg)
    eng = ServeEngine(model, cfg, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      device=dev)
    counters = (fa.flash_attention, rs.rglru_scan, dk.decode_attention_kernel)
    run = serve_run(torch, eng, prompts, counters, dev)
    del eng, model
    steps = run["stats"]["decode_steps"]
    serve_checked(cfg, run, [n_attn * SERVE_REQUESTS, n_rec * SERVE_REQUESTS,
                             n_attn * steps], "recurrentgemma_9b")
    decode_route_checked(cfg, run, 2, "bfloat16", n_attn * steps,
                         "recurrentgemma_9b")
    log(f"serve recurrentgemma_9b: prompt lengths {[int(n) for n in lens]}")
    log(serve_line("recurrentgemma_9b", run,
                   f"; flash launches {run['launches'][0]}, scan launches "
                   f"{run['launches'][1]}, decode kernel launches "
                   f"{run['launches'][2]} ({n_attn} a step, route "
                   f"bfloat16, {run['grouped'][2]} on the grouped route)"))
    log(f"serve recurrentgemma_9b: first tokens "
        f"{[o[:4] for o in run['outs']]}")
    torch.cuda.empty_cache()
    # the card against the CPU at full width, 3 layers, float32
    cut = dataclasses.replace(cfg, n_layers=3, dtype="float32")
    gen.manual_seed(1)
    card = init_params(gen, cut)
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(27)
    S, n_dec = 512, 2
    toks = torch.as_tensor(rng.integers(0, cut.vocab_size, (1, S + n_dec)))
    errs, scale = [], 0.0
    before = [c.launches for c in counters]
    with torch.inference_mode():
        outs = []
        for m, d in ((cpu, "cpu"), (card, dev)):
            t = toks.to(d)
            last, cache = prefill(m, cut, {"tokens": t[:, :S]},
                                  cache_len=S + n_dec)
            logits = [last.float().cpu()]
            for i in range(n_dec):
                lg, cache = decode_step(m, cut, t[:, S + i:S + i + 1], cache,
                                        torch.full((1,), S + i, device=d))
                logits.append(lg.float().cpu())
            outs.append(logits)
    launches = [c.launches - b for c, b in zip(counters, before)]
    for c_lg, g_lg in zip(*outs):
        errs.append(float((g_lg - c_lg).abs().max()))
        scale = max(scale, float(c_lg.abs().max()))
    if launches != [1, 2, n_dec] or not all(math.isfinite(e) for e in errs) \
            or max(errs) > 1e-3 * scale:
        raise RuntimeError(f"recurrentgemma_9b 3-layer cut: card vs CPU max "
                           f"abs errs {errs} vs max|logits| {scale}, "
                           f"launches {launches} (flash, scan, decode; want "
                           f"[1, 2, {n_dec}])")
    log(f"recurrentgemma_9b widths, 3 layers [R, R, A], float32, "
        f"{S}-token prefill + {n_dec} decode steps: card (flash, scan and "
        f"decode kernels: {launches} launches) vs CPU (plain versions) "
        f"logits max abs err {[f'{e:.3g}' for e in errs]}, max|logits| "
        f"{scale:.4g} (limit 1e-3 x max)")
    del card, cpu
    torch.cuda.empty_cache()
    return {"flash": run["launches"][0], "scan": run["launches"][1],
            "decode": run["launches"][2], "grouped": run["grouped"][2],
            "wall": run["wall"]}


# phase 28: the xLSTM scans' shapes. mLSTM (B, S, H, hd): a 4096-token
# xlstm-350m prefill (4 heads of 512), its decode step at 4 slots, a ragged
# reduced one (heads of 16), S under one staged chunk of 8 steps at full
# width, and S = 45 (a gate batch of 32 and a ragged chunk) at heads of
# 128; MLSTM_TIES, at full width, runs gates made so that i_pre wins the
# max on some steps, log_f + m on others, and ties it exactly on the rest
# (``mlstm_tie_gates``). sLSTM (B, S, w, gates' type): the prefill (width
# 1024) with bf16 gates, the decode step at 4 slots in bf16 and float32, a
# ragged reduced float32 one, and widths off the warp's 32 channels with S
# off the staged chunk of 32 steps
MLSTM_TESTS = [(1, 4096, 4, 512), (4, 1, 4, 512), (2, 37, 4, 16),
               (1, 5, 4, 512), (2, 45, 2, 128)]
MLSTM_TIES = (1, 67, 4, 512)
SLSTM_TESTS = [(1, 4096, 1024, "bfloat16"), (4, 1, 1024, "bfloat16"),
               (4, 1, 1024, "float32"), (2, 37, 32, "float32"),
               (1, 300, 1000, "bfloat16"), (3, 70, 7, "float32")]
# h and the state within this share of their largest entry of the plain
# version's (the state rounds as the plain loop; the mLSTM's dot products
# are summed in another order; the transcendentals' last bits may differ)
XLSTM_REL = 1e-5
# float32 instructions a step and (b, head) that the mLSTM needs: 4 an
# element of C and 4 a row, the gates' few scalars left out. The state must
# round as the plain loop's, so C's and n's updates are unfused: where one
# gate is exactly 1 (m' is one of log_f + m and i_pre, so for finite inputs
# every step) C's is 3 (v_i k_j, the other gate x it or x C, their sum: a
# product with 1.0 is exact) and n's 2. h is held only within XLSTM_REL,
# so C' q and n' . q take 1 FMA an element each; h's division 1 a row. They
# run at the FP32 lanes' rate (RATE_FP32, an instruction a lane and clock),
# not the data sheet's 67 TFLOP/s, which counts an FMA as 2. Of the sLSTM, a step and channel: 4 products and 4 sums into pre (8),
# the sigmoid (negate, exp, add, divide: 4), tanh (1), -softplus(-pre_f)
# (negate, abs, negate, exp, log1p, max, add, negate: 8), log f + m, its
# difference with pre_i, the max and one exp (4), c (2 products, a sum:
# 3), n (a product, a sum, the floor: 3), c / n and o x it (2)
MLSTM_OPS_C, MLSTM_OPS_ROW = 4, 4
SLSTM_OPS = 33


def mlstm_tie_gates(torch, gen, S, m0):
    """Gate pre-activations i_pre, f_pre (B, S, H) for the stabiliser m0
    (B, H), every entry at least 1: at t % 3 == 0 i_pre = m + 1 + u wins
    the max (u uniform in [0, 1)) and f_pre is normal; at t % 3 == 1 and 2
    f_pre = 30, whose log_f = -softplus(-30) ~ -9.4e-14 leaves log_f + m
    = m bit for bit (whatever the last bits of exp and log1p), against
    i_pre = m - 1 - u (log_f + m wins) and i_pre = m (an exact tie). So
    the stabiliser is known exactly at every step."""
    shape = (m0.shape[0], S, m0.shape[1])
    u = torch.rand(shape, generator=gen, device=m0.device)
    f_pre = torch.randn(shape, generator=gen, device=m0.device) * 2
    i_pre = torch.empty(shape, device=m0.device)
    m = m0.clone()
    for t in range(S):
        if t % 3 == 0:
            i_pre[:, t] = m + 1 + u[:, t]
            m = i_pre[:, t].clone()
        else:
            f_pre[:, t] = 30.0
            i_pre[:, t] = m - 1 - u[:, t] if t % 3 == 1 else m
    return i_pre, f_pre


def xlstm_state(torch, gen, shapes, dev, positive=()):
    """Random state tensors of ``shapes`` (a dict name -> shape): normal,
    |normal| + 0.5 for the names in ``positive``."""
    out = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=gen, device=dev)
        out[name] = t.abs() + 0.5 if name in positive else t
    return out


def scan_check(torch, name, call, plain, state, route_of, route):
    """One scan kernel against its plain version on the same inputs and a
    copy each of ``state``: h and every state tensor within XLSTM_REL of
    their largest entry, ``route`` counted twice for two launches that are
    bitwise equal (h and state), a CUDA graph of one call replayed twice
    from the state restored before each replay bitwise the eager launch,
    one device kernel a call. Returns the max abs error."""
    def fresh():
        return {k: t.clone() for k, t in state.items()}
    before = route_of()
    s1, s2, sp = fresh(), fresh(), fresh()
    got, again = call(s1), call(s2)
    want = plain(sp)
    torch.cuda.synchronize()
    routed = route_of() - before
    errs = [float((got - want).abs().max())]
    over = int(errs[0] > XLSTM_REL * float(want.abs().max()))
    for k in state:
        errs.append(float((s1[k] - sp[k]).abs().max()))
        over += int(errs[-1] > XLSTM_REL * float(sp[k].abs().max()))
    bitwise = torch.equal(got, again) and all(
        torch.equal(s1[k], s2[k]) for k in state)
    # the graph works on static state tensors, restored before each replay
    static = fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(fresh())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = call(static)
    replay = True
    for _ in range(2):
        for k in state:
            static[k].copy_(state[k])
        graph.replay()
        torch.cuda.synchronize()
        replay &= torch.equal(out, got) and all(
            torch.equal(static[k], s1[k]) for k in state)
    del graph
    scratch = fresh()
    n_kernels, n_nodes = kernels_a_call(torch, lambda: call(scratch))
    if not (all(math.isfinite(e) for e in errs) and over == 0 and bitwise
            and routed == 2 and replay and n_kernels == n_nodes == 1):
        raise RuntimeError(f"{name}: max abs errs (h, {', '.join(state)}) "
                           f"{errs}, {over} over {XLSTM_REL:g} x max, "
                           f"bitwise {bitwise}, {routed} launches on route "
                           f"{route} (want 2), graph replays equal {replay},"
                           f" {n_kernels} kernels of {n_nodes} graph nodes a"
                           f" call (want 1 of 1)")
    return max(errs)


def split_check(torch, name, call, state, S, cut):
    """The scan over S steps against the scan over the first ``cut``
    steps followed by the rest from the state it left (a prefill, then
    decode steps): the state and the later h bitwise. ``call(state, t0,
    t1)`` runs steps t0..t1 - 1."""
    one = {k: t.clone() for k, t in state.items()}
    two = {k: t.clone() for k, t in state.items()}
    h_all = call(one, 0, S)
    call(two, 0, cut)
    h_rest = call(two, cut, S)
    torch.cuda.synchronize()
    if not (torch.equal(h_all[:, cut:], h_rest) and all(
            torch.equal(one[k], two[k]) for k in state)):
        raise RuntimeError(f"{name}: the scan over {S} steps and over "
                           f"{cut} + {S - cut} steps differ")


def phase_xlstm_kernels(torch, dev) -> dict:
    """Phase 28: the mLSTM and sLSTM scan kernels vs ``mlstm_scan_plain``
    and ``slstm_scan_plain`` at MLSTM_TESTS and SLSTM_TESTS from a random
    state (``scan_check``: XLSTM_REL, route, two launches bitwise, graph
    replays from a restored state bitwise, one device kernel a call); a
    scan split in two bitwise the whole one; device time a launch from a
    CUDA graph beside the bound and the plain loop; the sLSTM's chain
    floor, one warp's chains alone (B = 1, w = 32) at the same S."""
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import slstm_scan as ss
    gen = torch.Generator(device=dev)
    gen.manual_seed(28)
    out = {"mlstm": {}, "slstm": {}, "max_abs_err": {}}
    worst = 0.0
    with torch.no_grad():
        for B, S, H, hd, ties in [*((*s, False) for s in MLSTM_TESTS),
                                  (*MLSTM_TIES, True)]:
            q, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev)
                       for _ in range(3))
            k = k * (1.0 / math.sqrt(hd))
            i_pre, f_pre = (torch.randn((B, S, H), generator=gen,
                                        device=dev) * 2 for _ in range(2))
            state = xlstm_state(torch, gen, {"C": (B, H, hd, hd),
                                             "n": (B, H, hd), "m": (B, H)},
                                dev)
            state["C"] *= 0.3
            if ties:
                state["m"] = state["m"].abs() + 1
                i_pre, f_pre = mlstm_tie_gates(torch, gen, S, state["m"])
            args = (q, k, v, i_pre, f_pre)

            def call(st, a=args):
                return ms.mlstm_scan(*a, st["C"], st["n"], st["m"])

            def plain(st, a=args):
                return ms.mlstm_scan_plain(*a, st["C"], st["n"], st["m"])
            route = f"hd{hd}"
            label = f"mlstm_scan ({B}, {S}, {H}, {hd})" + (
                " ties" if ties else "")
            err = scan_check(torch, label, call, plain, state,
                             lambda: ms.mlstm_scan.routes[route], route)
            if S > 1:
                split_check(torch, label, lambda st, t0, t1: ms.mlstm_scan(
                    *(a[:, t0:t1] for a in args), st["C"], st["n"],
                    st["m"]), state, S, S - 1)
            worst = max(worst, err)
            long = S > 256
            ms_ = graph_ms(torch, lambda: call(state),
                           launches=5 if long else 20,
                           reps=5 if long else 10)
            plain_ms = time_ms(torch, lambda: plain(
                {k_: t.clone() for k_, t in state.items()}),
                reps=1 if long else 5, windows=3)
            if not all(bool(torch.isfinite(t).all()) for t in
                       (i_pre, f_pre, state["m"])):
                raise RuntimeError(f"{label}: non-finite gates (the bound "
                                   "counts one exact gate a step)")
            flops = B * S * H * (MLSTM_OPS_C * hd * hd + MLSTM_OPS_ROW * hd)
            nbytes = 4 * (4 * B * S * H * hd + 2 * B * S * H
                          + 2 * B * H * (hd * hd + hd + 1))
            t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
            t_ops = flops / RATE_FP32 * 1e3
            bound = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
            out["mlstm"][(B, S, H, hd) + (("ties",) if ties else ())] = {
                "ms": ms_, "plain_ms": plain_ms, **bound}
            log(f"{label}: route {route}, max_abs_err {err:.3g} (h and "
                f"state, limit {XLSTM_REL:g} x max), two launches bitwise, "
                f"graph replays from the restored state bitwise, 1 device "
                f"kernel a call" + (f", {S - 1} + 1 steps bitwise {S}"
                                    if S > 1 else "")
                + f"; kernel {ms_:.4f} ms a launch on the device (CUDA "
                f"graph), plain {plain_ms:.4f} ms, bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
                f"{flops / 1e9:.3f} G float32 instructions at the lane rate, "
                f"{nbytes / 1e6:.2f} MB)")
        out["max_abs_err"]["mlstm"] = worst
        worst = 0.0
        for B, S, w, dt in SLSTM_TESTS:
            gates = (torch.randn((B, S, w, 4), generator=gen, device=dev)
                     * 2).to(getattr(torch, dt))
            r = torch.randn((w, 4), generator=gen, device=dev) * 0.5
            state = xlstm_state(torch, gen, {k: (B, w) for k in "cnmh"},
                                dev, positive=("n",))

            def call(st, g=gates, r=r):
                return ss.slstm_scan(g, r, st["c"], st["n"], st["m"],
                                     st["h"])

            def plain(st, g=gates, r=r):
                return ss.slstm_scan_plain(g, r, st["c"], st["n"], st["m"],
                                           st["h"])
            label = f"slstm_scan ({B}, {S}, {w}) {dt}"
            err = scan_check(torch, label, call, plain, state,
                             lambda: ss.slstm_scan.routes[dt], dt)
            if S > 1:
                split_check(torch, label, lambda st, t0, t1: ss.slstm_scan(
                    gates[:, t0:t1], r, st["c"], st["n"], st["m"], st["h"]),
                    state, S, S - 1)
            worst = max(worst, err)
            long = S > 256
            ms_ = graph_ms(torch, lambda: call(state),
                           launches=5 if long else 20,
                           reps=5 if long else 10)
            plain_ms = time_ms(torch, lambda: plain(
                {k_: t.clone() for k_, t in state.items()}),
                reps=1 if long else 5, windows=3)
            nbytes = (gates.numel() * gates.element_size() + 4 * B * S * w
                      + 16 * w + 2 * 4 * 4 * B * w)
            t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
            t_ops = SLSTM_OPS * B * S * w / RATE_FP32 * 1e3
            entry = {"ms": ms_, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
            chain = ""
            if long:
                # the chain's floor: one warp of chains alone, same S
                g1 = gates[:1, :, :32].contiguous()
                r1 = r[:32].contiguous()
                st1 = {k: t[:1, :32].contiguous() for k, t in state.items()}
                entry["chain_ms"] = graph_ms(
                    torch, lambda: ss.slstm_scan(g1, r1, st1["c"], st1["n"],
                                                 st1["m"], st1["h"]),
                    launches=5, reps=5)
                chain = (f"; one warp's chains alone (1, {S}, 32): "
                         f"{entry['chain_ms']:.4f} ms, "
                         f"{entry['chain_ms'] * 1e6 / S:.1f} ns a step")
            out["slstm"][(B, S, w, dt)] = entry
            log(f"{label}: route {dt}, max_abs_err {err:.3g} (h and state, "
                f"limit {XLSTM_REL:g} x max), two launches bitwise, graph "
                f"replays from the restored state bitwise, 1 device kernel "
                f"a call" + (f", {S - 1} + 1 steps bitwise {S}"
                             if S > 1 else "")
                + f"; kernel {ms_:.4f} ms a launch on the device (CUDA "
                f"graph), plain {plain_ms:.4f} ms, bound "
                f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}: "
                f"{nbytes / 1e6:.2f} MB, "
                f"{SLSTM_OPS * B * S * w / 1e9:.3f} G float32 ops){chain}")
        out["max_abs_err"]["slstm"] = worst
    return out


class ScanInputs:
    """Records the inputs of the first ``mlstm_scan`` and ``slstm_scan``
    call the model makes (through ``models.recurrent``), for replaying
    them: ``calls`` maps the kind to the inputs."""

    def __init__(self):
        from repro_torch.models import recurrent as rec
        self.rec, self.calls = rec, {}

    def __enter__(self):
        self.saved = (self.rec.mlstm_scan, self.rec.slstm_scan)
        m_fn, s_fn = self.saved

        def m_rec(q, k, v, i, f, *state):
            self.calls.setdefault("mlstm", [t.clone() for t in
                                            (q, k, v, i, f)])
            return m_fn(q, k, v, i, f, *state)

        def s_rec(g, r, *state):
            self.calls.setdefault("slstm", [g.clone(), r.clone()])
            return s_fn(g, r, *state)
        self.rec.mlstm_scan, self.rec.slstm_scan = m_rec, s_rec
        return self

    def __exit__(self, *exc):
        self.rec.mlstm_scan, self.rec.slstm_scan = self.saved


def phase_xlstm(torch, dev) -> dict:
    """Phase 29: xlstm-350m at its published width (24 layers [slstm,
    mlstm] x 12, d 1024, mLSTM heads of 512, bf16, seeded random weights)
    through ServeEngine, phase 12's request shape: 12 mLSTM and 12 sLSTM
    launches a prefill and a decode step; the scans split at the last
    prompt token on the model's own inputs bitwise the whole (a prefill
    and the decode step after it); then a 2-layer float32 cut at full
    width: the card's prefill and decode logits against the CPU's."""
    import copy
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import ServeEngine
    cfg = get_config("xlstm_350m")
    n_m, n_s = cfg.layout().count("mlstm"), cfg.layout().count("slstm")
    hd = 2 * cfg.d_model // cfg.n_heads
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"xlstm_350m init on the card: {n_params / 1e9:.3f} B parameters, "
        f"{cfg.dtype} ({n_s} slstm + {n_m} mlstm layers, d {cfg.d_model}, "
        f"{cfg.n_heads} mLSTM heads of {hd}), "
        f"{time.perf_counter() - t0:.2f} s")
    lens, prompts = serve_requests(cfg)
    eng = ServeEngine(model, cfg, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      device=dev)
    counters = (ms.mlstm_scan, ss.slstm_scan)
    run = serve_run(torch, eng, prompts, counters, dev)
    del eng
    steps = run["stats"]["decode_steps"]
    serve_checked(cfg, run, [n_m * (SERVE_REQUESTS + steps),
                             n_s * (SERVE_REQUESTS + steps)], "xlstm_350m")
    if run["routes"][0][f"hd{hd}"] != run["launches"][0] or \
            run["routes"][1]["bfloat16"] != run["launches"][1]:
        raise RuntimeError(f"serve xlstm_350m: routes {run['routes']}, want "
                           f"every mLSTM launch on hd{hd}, every sLSTM "
                           f"launch on bfloat16")
    log(f"serve xlstm_350m: prompt lengths {[int(n) for n in lens]}")
    log(serve_line("xlstm_350m", run,
                   f"; mlstm_scan launches {run['launches'][0]} and "
                   f"slstm_scan launches {run['launches'][1]} ({n_m} and "
                   f"{n_s} a prefill and a decode step: "
                   f"{SERVE_REQUESTS} prefills, {steps} decode steps)"))
    log(f"serve xlstm_350m: first tokens {[o[:4] for o in run['outs']]}")
    # a prefill and the decode step after it: the model's scan inputs of a
    # prompt one token longer, split at its last token
    N = int(lens[0])
    toks = torch.as_tensor(np.append(prompts[0], prompts[1][0])[None],
                           device=dev)
    with torch.inference_mode():
        with ScanInputs() as rec:
            prefill(model, cfg, {"tokens": toks}, cache_len=N + 1)
        for kind, args in sorted(rec.calls.items()):
            if kind == "mlstm":
                B, S, H, hd_ = args[0].shape
                state = dict(zip("Cnm", ms.init_state(B, H, hd_, dev)))
                split_check(torch, "xlstm_350m mlstm layer",
                            lambda st, a, b: ms.mlstm_scan(
                                *(x[:, a:b] for x in args), st["C"],
                                st["n"], st["m"]), state, S, N)
            else:
                g, r = args
                state = dict(zip("cnmh", ss.init_state(g.shape[0],
                                                       g.shape[2], dev)))
                split_check(torch, "xlstm_350m slstm layer",
                            lambda st, a, b: ss.slstm_scan(
                                g[:, a:b], r, st["c"], st["n"], st["m"],
                                st["h"]), state, g.shape[1], N)
        # the whole model: prefill(N) + 1 decode step against prefill(N + 1)
        _, short = prefill(model, cfg, {"tokens": toks[:, :N]},
                           cache_len=N + 1)
        _, short = decode_step(model, cfg, toks[:, N:], short,
                               torch.full((1,), N, device=dev))
        _, full = prefill(model, cfg, {"tokens": toks}, cache_len=N + 1)
        same = sum(torch.equal(a[k], b[k]) for a, b in zip(short, full)
                   for k in a)
        total = sum(len(a) for a in short)
        diff = max(float((a[k] - b[k]).abs().max()) for a, b in
                   zip(short, full) for k in a)
    if same != total:
        raise RuntimeError(f"xlstm_350m: prefill({N}) + decode step vs "
                           f"prefill({N + 1}): {same} of {total} state "
                           f"tensors bitwise, max abs diff {diff}")
    log(f"xlstm_350m: prefill of {N + 1} tokens: the first sLSTM and mLSTM "
        f"layers' scans on their own inputs, {N} steps + 1, bitwise the "
        f"{N + 1}-step scan; the whole model's prefill({N}) + decode step "
        f"vs prefill({N + 1}): all {total} state tensors of the "
        f"{cfg.n_layers} layers bitwise")
    del model, short, full
    torch.cuda.empty_cache()
    # the card against the CPU at full width, 2 layers, float32
    cut = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    gen.manual_seed(1)
    card = init_params(gen, cut)
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(29)
    S, n_dec = 512, 2
    toks = torch.as_tensor(rng.integers(0, cut.vocab_size, (1, S + n_dec)))
    errs, scale = [], 0.0
    before = [c.launches for c in counters]
    t0 = time.perf_counter()
    with torch.inference_mode():
        outs = []
        for m, d in ((cpu, "cpu"), (card, dev)):
            t = toks.to(d)
            last, cache = prefill(m, cut, {"tokens": t[:, :S]},
                                  cache_len=S + n_dec)
            logits = [last.float().cpu()]
            for i in range(n_dec):
                lg, cache = decode_step(m, cut, t[:, S + i:S + i + 1], cache,
                                        torch.full((1,), S + i, device=d))
                logits.append(lg.float().cpu())
            outs.append(logits)
    launches = [c.launches - b for c, b in zip(counters, before)]
    for c_lg, g_lg in zip(*outs):
        errs.append(float((g_lg - c_lg).abs().max()))
        scale = max(scale, float(c_lg.abs().max()))
    if launches != [1 + n_dec, 1 + n_dec] or \
            not all(math.isfinite(e) for e in errs) or \
            max(errs) > 1e-3 * scale:
        raise RuntimeError(f"xlstm_350m 2-layer cut: card vs CPU max abs "
                           f"errs {errs} vs max|logits| {scale}, launches "
                           f"{launches} (mlstm, slstm; want "
                           f"[{1 + n_dec}, {1 + n_dec}])")
    log(f"xlstm_350m widths, 2 layers [slstm, mlstm], float32, {S}-token "
        f"prefill + {n_dec} decode steps: card (scan kernels: {launches} "
        f"launches) vs CPU (plain versions) logits max abs err "
        f"{[f'{e:.3g}' for e in errs]}, max|logits| {scale:.4g} (limit "
        f"1e-3 x max), {time.perf_counter() - t0:.1f} s")
    del card, cpu
    torch.cuda.empty_cache()
    return {"mlstm": run["launches"][0], "slstm": run["launches"][1],
            "wall": run["wall"]}


# phase 30: llama-3.2-vision's cross decode (B, T, KV, G, hd): 4 slots of
# 1600 image keys, 8 KV heads of 4 query heads, hd 128, in bf16, and a
# reduced float32 shape off the chunks (T 37, 2 KV heads of 3, hd 16)
CROSS_DECODE_TESTS = [("llama-3.2-vision cross bf16", 4, 1600, 8, 4, 128,
                       "bfloat16"),
                      ("reduced cross float32", 3, 37, 2, 3, 16, "float32")]
# the cross route against its plain version: float32 within this share of
# max|out|; bfloat16 every element the bf16 rounding of a value within it
# of the plain version's float32 output
CROSS_REL = 1e-5
# phase 30's flash shapes (B, S, T, H, hd, causal, window, q_offset,
# dtype): llama-3.2-vision's cross prefill (2048 prompt queries against
# 1600 image keys, 32 heads expanded from 8), hubert-xlarge's encoder (16
# heads of 80, bidirectional) in bf16, and hd 80 on the float32 route that
# a bf16 hubert fed float32 frames takes
FLASH_NEW = [(1, 2048, 1600, 32, 128, False, 0, 0, "bfloat16"),
             (1, 1024, 1024, 16, 80, False, 0, 0, "bfloat16"),
             (2, 300, 300, 4, 80, False, 0, 0, "float32")]


def cross_decode_bound_ms(q, k) -> dict:
    """Least time for the cross decode step on an H100 SXM: q read and the
    output written once, every slot's K and V read once (every slot is
    visible), against 4 FLOP per slot, query head and head dim at the
    float32 rate."""
    B, _, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    nbytes = 2 * q.numel() * q.element_size() + 2 * B * T * KV * hd * \
        k.element_size()
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 4 * B * T * H * hd / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}


def cross_decode_check(torch, dk, name, q, k, v) -> dict:
    """The cross route (``cross_decode_attention_kernel``) vs its plain
    version on the same inputs, within CROSS_REL of max|out| (bfloat16:
    each element between the bf16 roundings of the plain float32 value
    minus and plus that), one launch a call, two launches bitwise, a CUDA
    graph's replays bitwise the eager launch, 1 device kernel a call
    (``cross_kernel``)."""
    kern = dk.cross_decode_attention_kernel

    def call():
        return kern(q, k, v)
    before = kern.launches
    got = call()
    again = call()
    want = dk.cross_decode_attention_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    launched = kern.launches - before
    scale = float(want.abs().max())
    tol = CROSS_REL * scale
    err = float((got.float() - want).abs().max())
    if q.dtype == torch.float32:
        over = int(((got - want).abs() > tol).sum())
    else:
        lo, hi = (want - tol).to(q.dtype), (want + tol).to(q.dtype)
        over = int(((got < lo) | (got > hi)).sum())
    bitwise = torch.equal(got, again)
    replay = graph_replay_equal(torch, call, got)
    n_kernels, n_nodes = kernels_a_call(torch, call)
    if not (got.shape == q.shape and got.dtype == q.dtype and
            math.isfinite(err) and over == 0 and bitwise and replay and
            launched == 2 and n_kernels == n_nodes == 1):
        raise RuntimeError(f"cross decode {name}: max abs err {err} (max|out|"
                           f" {scale}), {over} over the limit, bitwise "
                           f"{bitwise}, graph replays equal {replay}, "
                           f"{launched} launches for 2 calls, {n_kernels} "
                           f"kernels of {n_nodes} graph nodes a call (want 1"
                           f" of 1)")
    return {"err": err, "scale": scale, "call": call}


def set_gates(torch, model, gen) -> int:
    """Every ``cross_attn`` block's gates drawn in [0.25, 1) from ``gen``
    (they start at 0, and tanh(0) = 0 would leave the image layers out);
    returns the number of gated blocks."""
    n = 0
    with torch.no_grad():
        for blk in model.blocks:
            if hasattr(blk, "gate_attn"):
                for g in (blk.gate_attn, blk.gate_mlp):
                    g.copy_(torch.rand((), generator=gen, device=g.device)
                            * 0.75 + 0.25)
                n += 1
    return n


def phase_cross_kernels(torch, fa, dev) -> dict:
    """Phase 30: the decode kernel's cross route vs its plain version at
    llama-3.2-vision's cross cache and a reduced float32 shape (limits in
    ``cross_decode_check``), timed from a CUDA graph beside its bound,
    the plain version and SDPA (``enable_gqa``, no mask; a yardstick) in
    a CUDA graph; the flash kernel not causal at the cross prefill's S !=
    T and at hd 80 (hubert), forward (plus the lse store at bf16) and
    gradient vs their plain versions (phases 11 and 23's limits), the bf16
    shapes timed beside their bounds and SDPA's forward and backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels.ops import flash_mha
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    out = {"decode": {}, "max_abs_err": 0.0, "flash_err": 0.0,
           "bwd_err": 0.0}
    for name, B, T, KV, G, hd, dt in CROSS_DECODE_TESTS:
        tdt = getattr(torch, dt)
        q = torch.randn((B, 1, KV * G, hd), generator=gen, device=dev).to(tdt)
        k, v = (torch.randn((B, T, KV, hd), generator=gen, device=dev
                            ).to(tdt) for _ in range(2))
        chk = cross_decode_check(torch, dk, name, q, k, v)
        out["max_abs_err"] = max(out["max_abs_err"], chk["err"])
        _, _, L, splits = dk.launch_plan(B, T, KV, G, hd, tdt, tdt, True)
        ms = graph_ms(torch, chk["call"])
        call_ms = time_ms(torch, chk["call"], reps=20)
        plain_ms = time_ms(torch, lambda: dk.cross_decode_attention_plain(
            q, k, v), reps=3, windows=3)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True)
        lib_call_ms = time_ms(torch, sdpa, reps=20)
        try:
            lib_ms = graph_ms(torch, sdpa)
        except Exception as exc:  # the yardstick only: say why
            torch.cuda.synchronize()
            log(f"cross decode {name}: sdpa(enable_gqa) would not run in a "
                f"CUDA graph ({type(exc).__name__}: {exc}); its event time "
                f"stands")
            lib_ms = lib_call_ms
        bound = cross_decode_bound_ms(q, k)
        out["decode"][name] = {"ms": ms, "call_ms": call_ms,
                               "plain_ms": plain_ms, "library_ms": lib_ms,
                               **bound}
        log(f"cross decode {name} (B={B} T={T} KV={KV} G={G} hd={hd}, "
            f"{splits} splits of {L}): max_abs_err "
            f"{chk['err']:.3g} (max|out| {chk['scale']:.3g}, limit "
            f"{CROSS_REL:g} x max|out|"
            + (", bf16 rounding of a value within it" if dt == "bfloat16"
               else "") + "), two launches bitwise, graph replays bitwise, "
            f"1 device kernel a call; kernel {ms:.4f} ms a launch on the "
            f"device (CUDA graph), {call_ms:.4f} ms a call; plain "
            f"{plain_ms:.4f} ms; sdpa(enable_gqa) {lib_call_ms:.4f} ms a "
            f"call, {lib_ms:.4f} ms a launch (CUDA graph); bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
            f"{bound['bytes'] / 1e6:.2f} MB)")
    for B, S, T, H, hd, causal, win, q_off, dt in FLASH_NEW:
        q, k, v, do = flash_bwd_inputs(torch, gen, B, S, T, H, hd, dt, dev)
        name = (f"B={B} S={S} T={T} H={H} hd={hd} causal={causal} {dt}")
        err = flash_check(torch, fa, name, q, k, v, causal, win, dt)[0]
        berr = flash_bwd_check(torch, fa, name, q, k, v, do, causal, win,
                               dt, q_off)
        out["flash_err"] = max(out["flash_err"], err)
        out["bwd_err"] = max(out["bwd_err"], berr)
        line = (f"flash_attention {name}: forward max_abs_err {err:.3g}, "
                f"gradient (route {bwd_route_of(dt, hd)}) max_abs_err "
                f"{berr:.3g}, two gradient launches bitwise")
        if dt == "bfloat16":
            e = lse_check(torch, fa, name, q, k, v, causal, win, q_off)
            line += f"; forward with lse bitwise, lse max abs err {e:.3g}"
            qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
            o, lse = fa.flash_attention(qt, kt, vt, causal=causal,
                                        return_lse=True)
            ms = time_ms(torch, lambda: flash_mha(q, k, v, causal=causal),
                         reps=10)
            bms = time_ms(torch, lambda: fa.flash_attention_bwd(
                qt, kt, vt, o, dot, causal=causal, lse=lse), reps=10)
            plain_ms = time_ms(torch, lambda: flash_plain(
                fa, q, k, v, causal, win), reps=1, windows=3)
            bplain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                qt, kt, vt, o, dot, causal=causal), reps=1, windows=3)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), reps=10)
            ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))
            sd = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
            blib_ms = time_ms(torch, lambda: torch.autograd.grad(
                sd, (ql, kl, vl), dot, retain_graph=True), reps=5)
            fb = flash_bound_ms(S, T, H, hd, causal, win, 2)
            bb = flash_bwd_bound_ms(S, T, H, hd, causal, win, 2)
            line += (f"; forward {ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
                     f"{lib_ms:.4f} ms, bound {fb['bound_ms']:.4f} ms "
                     f"({fb['bound_by']}); gradient with the saved lse "
                     f"{bms:.4f} ms, plain {bplain_ms:.3f} ms, sdpa backward"
                     f" {blib_ms:.4f} ms, bound {bb['bound_ms']:.4f} ms "
                     f"({bb['bound_by']})")
        log(line)
    return out


def vision_serve(torch, model, cfg, toks, img, n_new, counters, dev) -> dict:
    """A warm-up (a 16-token prefill and a decode step: cuBLAS handles,
    the kernel libraries), then the served run with every counter set to
    0 just before and read just after: ``prefill`` of ``toks`` with
    ``img``, then ``n_new`` greedy ``decode_step``s. Returns the new
    tokens, launches, times and peak memory."""
    from repro_torch.models import decode_step, prefill
    B, S = toks.shape
    with torch.inference_mode():
        last, cache = prefill(model, cfg, {"tokens": toks[:, :16],
                                           "image_embeds": img}, 17)
        decode_step(model, cfg, last.argmax(-1)[:, None], cache,
                    torch.full((B,), 16, device=dev))
        del last, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        last, cache = prefill(model, cfg, {"tokens": toks,
                                           "image_embeds": img}, S + n_new)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_launches = [c.launches for c in counters]
        new = [last.argmax(-1)]
        finite = bool(torch.isfinite(last).all())
        for i in range(n_new):
            last, cache = decode_step(model, cfg, new[-1][:, None], cache,
                                      torch.full((B,), S + i, device=dev))
            new.append(last.argmax(-1))
        finite = finite and bool(torch.isfinite(last).all())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = [c.launches for c in counters]
    return {"tokens": torch.stack(new, 1).cpu().tolist(),
            "prefill_s": t1 - t0, "decode_s": t2 - t1, "finite": finite,
            "prefill_launches": prefill_launches,
            "decode_launches": [a - b for a, b in zip(launches,
                                                      prefill_launches)],
            "peak": torch.cuda.max_memory_allocated(dev)}


def vision_profiled(torch, model, cfg, toks, img, dev) -> None:
    """A prefill of ``toks`` with ``img`` and then 4 greedy decode steps,
    each under the profiler: idle share, launches, device time by
    SERVE_KERNEL_GROUPS kind."""
    from repro_torch.models import decode_step, prefill
    B, S = toks.shape
    box = {}

    def pre():
        box["last"], box["cache"] = prefill(
            model, cfg, {"tokens": toks, "image_embeds": img}, S + 4)

    def dec():
        for i in range(4):
            box["last"], box["cache"] = decode_step(
                model, cfg, box["last"].argmax(-1)[:, None], box["cache"],
                torch.full((B,), S + i, device=dev))
    with torch.inference_mode():
        profile_by_kind(torch, pre, SERVE_KERNEL_GROUPS,
                        f"llama32_vision_11b {B} x {S} profiled prefill")
        profile_by_kind(torch, dec, SERVE_KERNEL_GROUPS,
                        f"llama32_vision_11b {B} x {S} profiled 4 decode "
                        "steps")
    del box


# phase 31's served shapes (label, batch, prompt length) and decode steps
VISION_RUNS = [("4 x 1024", 4, 1024), ("1 x 4096", 1, 4096)]
VISION_NEW = 16
# serving's device time by kernel kind: phase 24's kinds with the decode
# kernel (its two passes) beside the flash forward
SERVE_KERNEL_GROUPS = [("decode attention", ("scores_kernel",
                                             "values_kernel",
                                             "cross_kernel"))] + \
    TRAIN_KERNEL_GROUPS[1:]


def phase_vision(torch, fa, dev) -> dict:
    """Phase 31: llama-3.2-vision at its published width (40 layers, 8 of
    them cross attention over 1600 image tokens; bf16, seeded random
    weights, the gates drawn non-zero) served through ``prefill`` (tokens
    and ``image_embeds``) and greedy ``decode_step``s, the functions the
    reference's dry run lowers for its prefill and decode cells (its
    ServeEngine passes no image): 40 flash launches a prefill, 32 decode
    and 8 cross decode launches a step; then a 5-layer (one pattern
    period) float32 cut at full width: a 64-token prefill and 2 decode
    steps on the card (the kernels) and on the CPU (their plain
    versions), logits within 1e-3 x max|logits|."""
    import copy
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config("llama32_vision_11b")
    kinds = cfg.layout()
    n_cross = kinds.count("cross_attn")
    n_self = len(kinds) - n_cross
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(gen, cfg)
    gated = set_gates(torch, model, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"llama32_vision_11b init on the card: {n_params / 1e9:.3f} B "
        f"parameters, {cfg.dtype} ({n_self} attn + {n_cross} cross_attn "
        f"layers, {cfg.n_img_tokens} image tokens of {cfg.d_vision}; "
        f"{gated} blocks' gates drawn in [0.25, 1)), "
        f"{time.perf_counter() - t0:.2f} s")
    counters = (fa.flash_attention, dk.decode_attention_kernel,
                dk.cross_decode_attention_kernel)
    want_pre = [n_self + n_cross, 0, 0]
    want_dec = [0, n_self * VISION_NEW, n_cross * VISION_NEW]
    runs = {}
    for label, B, S in VISION_RUNS:
        rng = np.random.default_rng(31 + S)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               device=dev)
        img = torch.randn((B, cfg.n_img_tokens, cfg.d_vision), generator=gen,
                          device=dev).to(cfg.torch_dtype)
        run = vision_serve(torch, model, cfg, toks, img, VISION_NEW,
                           counters, dev)
        bad = [t for row in run["tokens"] for t in row
               if not 0 <= t < cfg.vocab_size]
        if not run["finite"] or bad or \
                run["prefill_launches"] != want_pre or \
                run["decode_launches"] != want_dec:
            raise RuntimeError(f"serve llama32_vision_11b {label}: finite "
                               f"logits {run['finite']}, bad tokens "
                               f"{bad[:5]}, launches (flash, decode, cross "
                               f"decode) prefill {run['prefill_launches']} "
                               f"(want {want_pre}), decode "
                               f"{run['decode_launches']} (want {want_dec})")
        runs[label] = run
        log(f"serve llama32_vision_11b {label} (+ {cfg.n_img_tokens} image "
            f"tokens each): prefill {B * S} tokens in {run['prefill_s']:.3f}"
            f" s ({B * S / run['prefill_s']:.1f} tok/s, flash launches "
            f"{run['prefill_launches'][0]}); {VISION_NEW} greedy decode "
            f"steps of {B} in {run['decode_s']:.3f} s "
            f"({B * VISION_NEW / run['decode_s']:.1f} tok/s; decode kernel "
            f"launches {run['decode_launches'][1]}, cross route "
            f"{run['decode_launches'][2]}: {n_self} and {n_cross} a step); "
            f"peak memory {run['peak'] / 2**30:.2f} GiB; first tokens "
            f"{[row[:4] for row in run['tokens']]}")
        if label == VISION_RUNS[0][0]:
            vision_profiled(torch, model, cfg, toks, img, dev)
        del toks, img
    del model
    torch.cuda.empty_cache()
    # the card against the CPU at full width, one pattern period, float32
    cut = dataclasses.replace(cfg, n_layers=len(cfg.pattern),
                              dtype="float32")
    gen.manual_seed(1)
    card = init_params(gen, cut)
    set_gates(torch, card, gen)
    img = torch.randn((1, cut.n_img_tokens, cut.d_vision), generator=gen,
                      device=dev)
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(31)
    S, n_dec = 64, 2
    toks = torch.as_tensor(rng.integers(0, cut.vocab_size, (1, S + n_dec)))
    t0 = time.perf_counter()
    for c in counters:
        c.launches = 0
    outs = []
    with torch.inference_mode():
        for m, d in ((cpu, "cpu"), (card, dev)):
            t = toks.to(d)
            last, cache = prefill(m, cut, {"tokens": t[:, :S],
                                           "image_embeds": img.to(d)},
                                  cache_len=S + n_dec)
            logits = [last.float().cpu()]
            for i in range(n_dec):
                lg, cache = decode_step(m, cut, t[:, S + i:S + i + 1], cache,
                                        torch.full((1,), S + i, device=d))
                logits.append(lg.float().cpu())
            outs.append(logits)
    launches = [c.launches for c in counters]
    errs = [float((g - c).abs().max()) for c, g in zip(*outs)]
    scale = max(float(c.abs().max()) for c in outs[0])
    want = [len(cut.pattern), (len(cut.pattern) - 1) * n_dec, n_dec]
    if launches != want or not all(math.isfinite(e) for e in errs) or \
            max(errs) > 1e-3 * scale:
        raise RuntimeError(f"llama32_vision_11b 5-layer cut: card vs CPU max "
                           f"abs errs {errs} vs max|logits| {scale}, "
                           f"launches {launches} (flash, decode, cross "
                           f"decode; want {want})")
    log(f"llama32_vision_11b widths, {cut.n_layers} layers "
        f"{list(cut.pattern)}, float32, gates drawn in [0.25, 1), {S}-token "
        f"prefill with {cut.n_img_tokens} image tokens + {n_dec} decode "
        f"steps: card (launches {launches}: flash, decode, cross decode) "
        f"vs CPU (plain versions) logits max abs err "
        f"{[f'{e:.3g}' for e in errs]}, max|logits| {scale:.4g} (limit "
        f"1e-3 x max), {time.perf_counter() - t0:.1f} s")
    del card, cpu
    torch.cuda.empty_cache()
    return {"flash": sum(r["prefill_launches"][0] for r in runs.values()),
            "decode": sum(r["decode_launches"][1] for r in runs.values()),
            "cross": sum(r["decode_launches"][2] for r in runs.values())}


# phase 32's full-width batch (frames) and train steps
HUBERT_B, HUBERT_S, HUBERT_STEPS = 4, 1024, 3


def grads_of(torch, model, cfg, batch):
    """The loss and every parameter's gradient (a zero tensor where the
    loss reads no parameter, as ``make_train_step`` takes them)."""
    from repro_torch.models import loss_fn
    named = list(model.named_parameters())
    loss, _ = loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def phase_hubert(torch, fa, dev) -> dict:
    """Phase 32: hubert-xlarge at its published width (48 layers, d 1280,
    16 heads of 80, bidirectional; bf16, seeded random weights): a
    forward at (4, 1024) bf16 frames (the dry run's input type: the bf16
    hd-80 routes, 48 flash launches), then 3 train steps (48 gradient
    launches a step, all on the tensor-core route, 96 forward: remat);
    then a 2-layer float32 cut on the card against the CPU: logits, the
    frame CE loss and one step's gradients (each leaf within 1e-3 of its
    largest entry); then one train step of a bf16 2-layer cut on the data
    pipeline's float32 frames, so the promoted float32 trunk runs (the
    flash kernels' float32 routes), its loss against the CPU's."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models import forward, init_params, loss_fn
    from repro_torch.train.loop import init_train_state, make_train_step
    cfg = get_config("hubert_xlarge")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"hubert_xlarge init on the card: {n_params / 1e9:.3f} B parameters,"
        f" {cfg.dtype} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, causal={cfg.causal}), "
        f"{time.perf_counter() - t0:.2f} s")
    B, S, n = HUBERT_B, HUBERT_S, cfg.n_layers
    frames = torch.randn((B, S, cfg.frontend_dim), generator=gen,
                         device=dev).to(cfg.torch_dtype)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    batch = {"frames": frames, "labels": labels}
    with torch.inference_mode():
        forward(model, cfg, {"frames": frames})
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        logits = forward(model, cfg, {"frames": frames})[0]
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    fwd_launches = fa.flash_attention.launches
    if fwd_launches != n or logits.shape != (B, S, cfg.vocab_size) or \
            logits.dtype != cfg.torch_dtype or \
            not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"hubert_xlarge forward: flash launches "
                           f"{fwd_launches} (want {n}), logits "
                           f"{tuple(logits.shape)} {logits.dtype}")
    del logits
    log(f"hubert_xlarge forward, {B} x {S} bf16 frames: {fwd_s:.4f} s "
        f"({B * S / fwd_s:.1f} frames/s), flash launches {fwd_launches}")
    state = init_train_state(model)
    step_fn = make_train_step(cfg, total_steps=HUBERT_STEPS, warmup=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_bwd.routes = {"wgmma": 0, "tf32x3": 0}
    times, losses = [], []
    for _ in range(HUBERT_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    bwd, fwd = fa.flash_attention_bwd.launches, fa.flash_attention.launches
    wgmma = fa.flash_attention_bwd.routes["wgmma"]
    if not all(math.isfinite(x) for x in losses) or \
            bwd != HUBERT_STEPS * n or wgmma != bwd or \
            fwd != 2 * HUBERT_STEPS * n:
        raise RuntimeError(f"hubert_xlarge train: losses {losses}, backward "
                           f"launches {bwd} ({wgmma} wgmma), forward "
                           f"{fwd} (want {HUBERT_STEPS * n}, all wgmma, and "
                           f"{2 * HUBERT_STEPS * n})")
    med = statistics.median(times[1:])
    profile_by_kind(torch, lambda: float(step_fn(state, batch)[1]["loss"]),
                    TRAIN_KERNEL_GROUPS, "train hubert_xlarge profiled step")
    log(f"train hubert_xlarge full width, batch {B} x {S} bf16 frames: "
        f"losses {[f'{x:.4f}' for x in losses]}, step times "
        f"{[f'{x:.3f}' for x in times]} s, median (steps 2-{HUBERT_STEPS}) "
        f"{med:.4f} s, {B * S / med:.1f} frames/s; flash_attention_bwd "
        f"launches {bwd} ({bwd // HUBERT_STEPS} a step, all wgmma), forward"
        f" {fwd} (remat: 2 a layer); peak memory {peak / 2**30:.2f} GiB")
    del state, step_fn, model, batch, frames
    torch.cuda.empty_cache()
    # the card against the CPU at full width, 2 layers, float32
    cut = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    gen.manual_seed(1)
    card = init_params(gen, cut).train()
    cpu = copy.deepcopy(card).to("cpu")
    fr = torch.randn((2, 256, cut.frontend_dim), generator=gen, device=dev)
    lab = torch.randint(0, cut.vocab_size, (2, 256), generator=gen,
                        device=dev)
    res = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        b = {"frames": fr.to(d), "labels": lab.to(d)}
        with torch.no_grad():
            lg = forward(m, cut, b)[0].float().cpu()
        loss, g = grads_of(torch, m, cut, b)
        res.append((lg, float(loss), {k: x.float().cpu()
                                      for k, x in g.items()}))
    (c_lg, c_loss, c_g), (g_lg, g_loss, g_g) = res
    lerr = float((g_lg - c_lg).abs().max())
    lscale = float(c_lg.abs().max())
    bad = [k for k in c_g if float((g_g[k] - c_g[k]).abs().max())
           > 1e-3 * float(c_g[k].abs().max())]
    if lerr > 1e-3 * lscale or abs(g_loss - c_loss) > 1e-4 * abs(c_loss) \
            or bad or not math.isfinite(g_loss):
        raise RuntimeError(f"hubert_xlarge 2-layer cut: logits err {lerr} vs"
                           f" max {lscale}, loss {g_loss} vs CPU {c_loss}, "
                           f"gradient leaves over 1e-3 x max|g|: {bad}")
    gerr = max(float((g_g[k] - c_g[k]).abs().max())
               / max(float(c_g[k].abs().max()), 1e-30) for k in c_g)
    log(f"hubert_xlarge widths, 2 layers, float32, 2 x 256 frames: card vs "
        f"CPU logits max abs err {lerr:.3g} (max|logits| {lscale:.4g}, limit"
        f" 1e-3 x max), loss {g_loss:.6f} vs {c_loss:.6f}, gradients: "
        f"{len(c_g)} leaves, worst max abs err / max|g| {gerr:.3g} (limit "
        f"1e-3)")
    del card, cpu
    # the promoted float32 trunk: a bf16 cut fed the pipeline's frames
    cut16 = dataclasses.replace(cfg, n_layers=2)
    gen.manual_seed(2)
    card = init_params(gen, cut16)
    cpu = copy.deepcopy(card).to("cpu")
    pb = SyntheticTokenPipeline(cut16, 2, 256, seed=0).next_batch()
    with torch.no_grad():
        c_loss = float(loss_fn(cpu, cut16, {k: torch.as_tensor(x) for k, x
                                            in pb.items()})[0])
    state = init_train_state(card)
    step_fn = make_train_step(cut16, total_steps=1, warmup=1)
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_bwd.routes = {"wgmma": 0, "tf32x3": 0}
    state, m = step_fn(state, pb)
    g_loss = float(m["loss"])
    routes = dict(fa.flash_attention_bwd.routes)
    if pb["frames"].dtype.name != "float32" or \
            routes != {"wgmma": 0, "tf32x3": 2} or \
            fa.flash_attention.launches != 4 or \
            abs(g_loss - c_loss) > 1e-4 * abs(c_loss):
        raise RuntimeError(f"hubert_xlarge bf16 cut on float32 frames: loss "
                           f"{g_loss} vs CPU {c_loss}, gradient routes "
                           f"{routes}, forward launches "
                           f"{fa.flash_attention.launches} (want 2 on the "
                           f"CUDA cores and 4)")
    log(f"hubert_xlarge widths, 2 layers, bf16 weights, the pipeline's "
        f"float32 frames (2 x 256): one train step on the promoted float32 "
        f"trunk, loss {g_loss:.6f} vs the CPU's {c_loss:.6f}, gradient "
        f"routes {routes}, forward launches {fa.flash_attention.launches}")
    del card, cpu, state, step_fn
    torch.cuda.empty_cache()
    return {"launches": bwd, "fwd_launches": fwd + fwd_launches}


def phase_hubert_pipeline(torch, fa, dev) -> dict:
    """Phase 45: hubert-xlarge at its published width (48 layers, bf16
    weights from a seed) trained HUBERT_STEPS steps at HUBERT_B x HUBERT_S
    through ``launch.train``'s code path, fed by its own data pipeline
    (``SyntheticTokenPipeline``), whose float32 frames promote the whole
    trunk to float32: every flash call on the split-TF32 routes, 48
    gradient launches a step and 96 forward (remat), none on another
    route; finite losses and grad norms; the median step, frames/s, peak
    memory and one more step under the profiler, device ms by kind."""
    from repro_torch.launch import train as launch_train
    argv = ["--arch", "hubert_xlarge", "--steps", str(HUBERT_STEPS),
            "--batch", str(HUBERT_B), "--seq", str(HUBERT_S), "--device",
            "cuda"]
    t0 = time.perf_counter()
    label = (f"train hubert_xlarge full width, pipeline float32 frames, "
             f"batch {HUBERT_B} x {HUBERT_S}")
    state, step_fn, pipe, run = train_checked(
        torch, fa, launch_train, dev, argv, HUBERT_STEPS, label,
        route="tf32x3")
    frames = pipe.next_batch()["frames"]
    if frames.dtype.name != "float32":
        raise RuntimeError(f"{label}: the pipeline's frames are "
                           f"{frames.dtype}, not float32")
    med = run["median_step_s"]
    prof = profile_step(torch, step_fn, state, pipe, label)
    n, bwd, fwd = run["n_layers"], run["launches"], run["fwd"]
    log(f"{label}: {run['n_params'] / 1e9:.3f} B parameters, median step "
        f"(steps 2-{HUBERT_STEPS}) {med:.4f} s, "
        f"{HUBERT_B * HUBERT_S / med:.1f} frames/s; flash_attention_bwd "
        f"launches {bwd} ({bwd // HUBERT_STEPS} a step, all tf32x3), "
        f"forward {fwd} ({fwd // HUBERT_STEPS} a step, all tf32x3: remat, "
        f"2 a layer of {n}); peak memory {run['peak'] / 2**30:.2f} GiB; "
        f"phase {time.perf_counter() - t0:.1f} s")
    del state, step_fn, pipe
    torch.cuda.empty_cache()
    return {**run, "groups": prof["groups"], "idle": prof["idle"]}


# phase 33: the RG-LRU scan's backward kernel (B, S, W, type): a 4096-token
# recurrentgemma-9b sequence (rnn width 4096) in bf16 and float32, B > 1
# with a short tile, W off the forward's 32-channel tile with S off the
# 256-step tile, S = 1, a bf16 shape with both ragged edges, and the
# backward's own edges: W off its 8-channel tile with a last time tile of
# 7 steps, inside one 8-step sub-chunk
SCAN_BWD_TESTS = [(1, 4096, 4096, "bfloat16"), (1, 4096, 4096, "float32"),
                  (2, 37, 4096, "bfloat16"), (3, 300, 1000, "float32"),
                  (1, 1, 7, "float32"), (2, 257, 4100, "bfloat16"),
                  (2, 263, 1036, "float32")]
# float32: dx within SCAN_BWD_DX_REL of max|dx| (the h and g carries go
# through the sub-chunks' products of a, and expf and the divisions
# against torch's); each parameter gradient within SCAN_BWD_P_REL of its
# max (its sums over B and S run a thread's steps, a tile's sub-chunks,
# then the tiles in order, torch.sum in its own order).
# bf16 dx: within two bf16 steps of |dx| plus SCAN_BWD_DX_REL x max|dx|
SCAN_BWD_DX_REL = 1e-5
SCAN_BWD_P_REL = 1e-4
# float32 operations an element of the function: the coefficients (19),
# the recurrences of h and g (4), the chain rule through the coefficients
# (25) and the five parameter sums (8)
SCAN_BWD_OPS = 56


def scan_bwd_check(torch, rs, name, x, p, dh, work_numel) -> dict:
    """The backward kernel (on the forward launch's carry) vs
    ``rglru_scan_backward_plain`` on the same inputs, two launches
    bitwise, a CUDA graph's two replays bitwise, one device kernel a call,
    the workspace zero after the launches. Returns the call, the errors
    and each gradient's scale."""
    from repro_torch.kernels import build
    _, carry = rs._forward_kernel(x, p)

    def call():
        return rs.rglru_scan_backward(x, *p, dh, carry)
    before = rs.rglru_scan_backward.launches
    got, again = call(), call()
    launched = rs.rglru_scan_backward.launches - before
    want = rs.rglru_scan_backward_plain(x, *p, dh)
    torch.cuda.synchronize()
    work = build.workspace("rglru_scan_bwd", x.device, work_numel)
    dirty = int(work.abs().sum())
    errs, scales, over = [], [], 0
    for i, (g, w) in enumerate(zip(got, want)):
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        errs.append(err)
        scales.append(scale)
        if i == 0 and x.dtype == torch.bfloat16:
            wf = w.float()
            over += int(((g.float() - wf).abs() > 2.0 ** -7 * wf.abs()
                         + SCAN_BWD_DX_REL * scale).sum())
        else:
            rel = SCAN_BWD_DX_REL if i == 0 else SCAN_BWD_P_REL
            over += int(not err <= rel * scale)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    replay = graph_replay_equal(torch, call, got)
    n_kernels, n_nodes = kernels_a_call(torch, call)
    if not (got[0].shape == x.shape and got[0].dtype == x.dtype and
            all(math.isfinite(e) for e in errs) and over == 0 and bitwise
            and launched == 2 and replay and dirty == 0 and
            n_kernels == n_nodes == 1):
        raise RuntimeError(f"rglru_scan_backward {name}: max abs errs {errs}"
                           f" (scales {scales}), {over} over the limits, "
                           f"bitwise {bitwise}, graph replays equal "
                           f"{replay}, workspace sum {dirty}, {n_kernels} "
                           f"kernels of {n_nodes} graph nodes a call")
    return {"call": call, "errs": errs, "scales": scales}


def scan_bwd_gradcheck(torch, rs, dev) -> str:
    """The autograd route on the card (``rglru_scan`` with gradients: the
    forward kernel, then the backward kernel) at a small float32 shape
    against ``rglru_scan_backward_plain``, and its directional derivative
    along a random direction of (x, parameters) against a central
    difference (step 1e-5) of the forward in float64 on the CPU, within
    1e-5."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(331)
    x, p = scan_inputs(torch, gen, 2, 300, 40, torch.float32, dev)
    dh = torch.randn(x.shape, generator=gen, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (x, *p)]
    f0, b0 = rs.rglru_scan.launches, rs.rglru_scan_backward.launches
    h = rs.rglru_scan(*leaves)
    got = torch.autograd.grad(h, leaves, dh)
    launched = (rs.rglru_scan.launches - f0,
                rs.rglru_scan_backward.launches - b0)
    want = rs.rglru_scan_backward_plain(x, *p, dh)
    errs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]
    cpu = [t.detach().double().cpu() for t in (x, *p)]
    cgen = torch.Generator().manual_seed(332)
    dirs = [torch.randn(t.shape, generator=cgen, dtype=torch.float64)
            for t in cpu]
    dhc = dh.double().cpu()

    def scan_f64(xx, a, ai, bi, ar, br):
        # the plain forward's formulas in float64 (rglru_coeffs computes
        # in float32)
        i_t = torch.sigmoid(xx * ai + bi)
        log_a = -8.0 * torch.logaddexp(a, torch.zeros_like(a)) * \
            torch.sigmoid(xx * ar + br)
        b_t = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-8)) * (i_t * xx)
        a_t, h, out = torch.exp(log_a), torch.zeros_like(xx[:, 0]), []
        for t in range(xx.shape[1]):
            h = a_t[:, t] * h + b_t[:, t]
            out.append(h)
        return torch.stack(out, dim=1)

    def loss(s):
        return float((scan_f64(*(t + s * d for t, d in zip(cpu, dirs)))
                      * dhc).sum())
    eps = 1e-5
    fd = (loss(eps) - loss(-eps)) / (2 * eps)
    an = sum(float((g.double().cpu() * d).sum())
             for g, d in zip(got, dirs))
    fd_rel = abs(an - fd) / max(abs(fd), 1e-30)
    if launched != (1, 1) or errs[0] > SCAN_BWD_DX_REL or \
            max(errs[1:]) > SCAN_BWD_P_REL or not fd_rel <= 1e-5:
        raise RuntimeError(f"rglru_scan autograd route: launches (forward, "
                           f"backward) {launched}, errors / max {errs}, "
                           f"directional derivative {an} vs central "
                           f"difference {fd} (rel {fd_rel})")
    return (f"autograd route (2, 300, 40) float32: launches (forward, "
            f"backward) {launched}, errors / max vs the plain backward "
            f"{[f'{e:.3g}' for e in errs]}, directional derivative "
            f"{an:.8g} vs float64 central difference {fd:.8g} (rel "
            f"{fd_rel:.3g}, limit 1e-5)")


def phase_scan_bwd(torch, dev) -> dict:
    """Phase 33: the RG-LRU scan's backward kernel vs
    ``rglru_scan_backward_plain`` at SCAN_BWD_TESTS (limits above), two
    launches bitwise, graph replays bitwise, one device kernel a call,
    the workspace zero; timed from a CUDA graph beside its bound and the
    plain version; then the autograd route's gradcheck."""
    from repro_torch.kernels import rglru_scan as rs
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    timed, worst = {}, 0.0
    t0 = time.perf_counter()
    for B, S, W, dt in SCAN_BWD_TESTS:
        x, p = scan_inputs(torch, gen, B, S, W, getattr(torch, dt), dev)
        dh = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        name = f"({B}, {S}, {W}) {dt}"
        res = scan_bwd_check(torch, rs, name, x, p, dh,
                             rs.backward_tiles(B, S, W)[1])
        worst = max(worst, res["errs"][0])
        ms = graph_ms(torch, res["call"], launches=5)
        plain_ms = time_ms(torch, lambda: rs.rglru_scan_backward_plain(
            x, *p, dh), reps=1, windows=3)
        nbytes = 3 * x.numel() * x.element_size() + 10 * W * 4
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        t_ops = SCAN_BWD_OPS * x.numel() / RATE_FP32 * 1e3
        bound = {"bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        timed[(B, S, W, dt)] = {"ms": ms, "plain_ms": plain_ms, **bound}
        rel = [e / max(s, 1e-30) for e, s in zip(res["errs"],
                                                 res["scales"])]
        log(f"rglru_scan_backward {name}: dx max_abs_err "
            f"{res['errs'][0]:.3g} (max|dx| {res['scales'][0]:.3g}), "
            f"parameter gradients errors / max "
            f"{[f'{r:.3g}' for r in rel[1:]]} (limit {SCAN_BWD_P_REL:g}); "
            f"two launches bitwise, graph replays bitwise, workspace zero, "
            f"1 device kernel a call; kernel {ms:.4f} ms a launch on the "
            f"device (CUDA graph), plain {plain_ms:.4f} ms, bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
            f"{nbytes / 1e6:.2f} MB, "
            f"{SCAN_BWD_OPS * x.numel() / 1e9:.3f} G float32 ops)")
    log(f"rglru_scan_backward: {scan_bwd_gradcheck(torch, rs, dev)}")
    log(f"phase 33: {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": worst, "timed": timed}


# phase 34: recurrentgemma-9b trained at full width cut to two periods
# (R, R, A) x 2, RG_TRAIN_STEPS steps at each (batch, seq) of
# RG_TRAIN_RUNS (1 x 4096 chains 16 time tiles in every scan call); then a
# 3-layer float32 cut's gradients on the card against the CPU's, RG_CHECK_S
# tokens (two time tiles of the scans)
RG_TRAIN_LAYERS = 6
RG_TRAIN_RUNS = [(8, 128), (1, 4096)]
RG_TRAIN_STEPS = 3
RG_CHECK_S = 264
# training's device time by kernel kind with the two scan kernels
RG_TRAIN_GROUPS = [("rglru scan gradient", ("rglru_scan_bwd_kernel",)),
                   ("rglru scan", ("rglru_scan_kernel",))] + \
    TRAIN_KERNEL_GROUPS


def card_vs_cpu_grads(torch, card, cfg, batch, dev, counters, label,
                      show=()):
    """One loss and gradient (``grads_of``) of ``card`` on the card and of
    its deep copy on the CPU: the loss within rtol 1e-4 and every leaf
    within 1e-3 of its largest entry (phase 32's limits); the leaves whose
    names end in one of ``show`` must carry a gradient (max|g| > 0), and
    the line gives their worst error. Returns the launches of
    ``counters`` on the card and a log line."""
    import copy
    cpu = copy.deepcopy(card).to("cpu")
    res, launched = [], None
    for m, d in ((cpu, "cpu"), (card, dev)):
        b = {k: v.to(d) for k, v in batch.items()}
        before = [c.launches for c in counters]
        loss, g = grads_of(torch, m, cfg, b)
        launched = [c.launches - x for c, x in zip(counters, before)]
        res.append((float(loss), {k: x.float().cpu() for k, x in g.items()}))
        del g
    (c_loss, c_g), (g_loss, g_g) = res
    rel = {k: float((g_g[k] - c_g[k]).abs().max())
           / max(float(c_g[k].abs().max()), 1e-30) for k in c_g}
    bad = [k for k, r in rel.items() if not r <= 1e-3]
    shown = {end: [k for k in c_g if k.endswith("." + end)] for end in show}
    bad += [k for ks in shown.values() for k in ks
            if not float(c_g[k].abs().max()) > 0]
    if abs(g_loss - c_loss) > 1e-4 * abs(c_loss) or bad or \
            not math.isfinite(g_loss) or not all(shown.values()):
        raise RuntimeError(f"{label}: loss {g_loss} vs CPU {c_loss}, "
                           f"gradient leaves over 1e-3 x max|g| or zero: "
                           f"{bad}, leaves shown {shown}")
    worst = max(rel, key=rel.get)
    extra = "".join(
        f"; {end} ({len(ks)} leaves) worst {max(rel[k] for k in ks):.3g}, "
        f"max|g| {max(float(c_g[k].abs().max()) for k in ks):.3g}"
        for end, ks in shown.items())
    return launched, (f"{label}: card vs CPU loss {g_loss:.6f} vs "
                      f"{c_loss:.6f}, gradients: {len(c_g)} leaves, worst "
                      f"max abs err / max|g| {rel[worst]:.3g} ({worst}; "
                      f"limit 1e-3){extra}")


def phase_rg_train(torch, fa, dev) -> dict:
    """Phase 34: recurrentgemma-9b at full width cut to RG_TRAIN_LAYERS
    layers trains on the card through ``launch.train``'s code path (bf16,
    seeded random weights): at each of RG_TRAIN_RUNS, 2 flash forward and
    1 gradient launch an attention layer a step (remat; every gradient
    launch on the tensor-core route), 2 scan and 1 scan-gradient launches
    an RG-LRU layer a step, finite losses and grad norms; the median step,
    tokens/s, peak memory and a profiled step; then a 3-layer [R, R, A]
    float32 cut: one loss and gradient on the card against the CPU, its
    gradient launch on the CUDA-core route."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    full = get_config("recurrentgemma_9b")
    cut = dataclasses.replace(full, n_layers=RG_TRAIN_LAYERS)
    n_attn = cut.layout().count("local_attn")
    n_rec = cut.layout().count("rglru")
    n = RG_TRAIN_STEPS
    counters = (fa.flash_attention, fa.flash_attention_bwd, rs.rglru_scan,
                rs.rglru_scan_backward)
    want = [2 * n * n_attn, n * n_attn, 2 * n * n_rec, n * n_rec]
    out = {"launches": [0, 0, 0, 0]}
    for B, S in RG_TRAIN_RUNS:
        label = (f"train recurrentgemma_9b {RG_TRAIN_LAYERS} layers, batch "
                 f"{B} x {S}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters:
            c.launches = 0
        fa.flash_attention_bwd.routes = {"wgmma": 0, "tf32x3": 0}
        argv = ["--arch", "recurrentgemma_9b", "--steps", str(n), "--batch",
                str(B), "--seq", str(S), "--device", "cuda"]
        t0 = time.perf_counter()
        state, step_fn, pipe, hist = train_run(torch, launch_train, dev,
                                               argv, n, cfg=cut)
        wall = time.perf_counter() - t0
        got = [c.launches for c in counters]
        routes = dict(fa.flash_attention_bwd.routes)
        losses = [m["loss"] for m in hist]
        gnorms = [m["grad_norm"] for m in hist]
        times = [m["step_time_s"] for m in hist]
        if len(hist) != n or not all(math.isfinite(x)
                                     for x in losses + gnorms) \
                or got != want or routes != {"wgmma": n * n_attn,
                                             "tf32x3": 0}:
            raise RuntimeError(f"{label}: losses {losses}, grad norms "
                               f"{gnorms}, launches (flash, flash gradient, "
                               f"scan, scan gradient) {got} (want {want}), "
                               f"gradient routes {routes}")
        med = statistics.median(times[1:])
        peak = torch.cuda.max_memory_allocated(dev)
        n_params = sum(p.numel() for p in state.params.parameters())
        log(f"{label}: {n_params / 1e9:.3f} B parameters ({n_rec} rglru + "
            f"{n_attn} local_attn), bf16; losses "
            f"{[f'{x:.4f}' for x in losses]}, grad norms "
            f"{[f'{x:.4f}' for x in gnorms]}, step times "
            f"{[f'{x:.3f}' for x in times]} s ({wall:.2f} s wall, init "
            f"included); median step (steps 2-{n}) {med:.4f} s, "
            f"{B * S / med:.1f} tokens/s; launches (flash, flash gradient, "
            f"scan, scan gradient) {got}; peak memory {peak / 2**30:.2f} GiB")
        batch = pipe.next_batch()
        prof = profile_by_kind(
            torch, lambda: float(step_fn(state, batch)[1]["loss"]),
            RG_TRAIN_GROUPS, f"{label} profiled step")
        out[(B, S)] = {"median_step_s": med, "peak": peak, "prof": prof,
                       "tokens_s": B * S / med}
        out["launches"] = [a + b for a, b in zip(out["launches"], got)]
        del state, step_fn, pipe, batch
    torch.cuda.empty_cache()
    cut3 = dataclasses.replace(full, n_layers=3, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(34)
    card = init_params(gen, cut3).train()
    toks = torch.randint(0, cut3.vocab_size, (1, RG_CHECK_S), generator=gen,
                         device=dev)
    fa.flash_attention_bwd.routes = {"wgmma": 0, "tf32x3": 0}
    launched, line = card_vs_cpu_grads(
        torch, card, cut3, {"tokens": toks, "labels": toks}, dev,
        counters, f"recurrentgemma_9b widths, 3 layers [R, R, A], float32, "
        f"1 x {RG_CHECK_S} tokens")
    routes = dict(fa.flash_attention_bwd.routes)
    if launched != [2, 1, 4, 2] or routes != {"wgmma": 0, "tf32x3": 1}:
        raise RuntimeError(f"recurrentgemma_9b 3-layer cut: card launches "
                           f"(flash, flash gradient, scan, scan gradient) "
                           f"{launched}, want [2, 1, 4, 2]; gradient routes "
                           f"{routes}, want the CUDA cores'")
    log(f"{line}; card launches (flash, flash gradient, scan, scan "
        f"gradient) {launched}")
    del card
    torch.cuda.empty_cache()
    log(f"phase 34: {time.perf_counter() - t_phase:.1f} s")
    return out


# phases 35-36: the MoE archs served at full width with their depth cut so
# the bf16 weights fit one 80 GB card (phi3.5-moe 2.6 GB a layer,
# mixtral-8x22b 5.0 GB a layer)
MOE_SERVE_LAYERS = {"phi3_5_moe": 24, "mixtral_8x22b": 12}
# a top-k choice on the card may differ from the CPU's only where the k-th
# and (k + 1)-th router probabilities are within this (the router's float32
# product sums 4096 terms in another order)
MOE_TIE_MARGIN = 1e-5
MOE_DISPATCH = ("dispatch and combine", ("index", "scatter", "gather",
                                         "cumsum", "sort", "topk"))
MOE_KERNEL_GROUPS = SERVE_KERNEL_GROUPS[:3] + [MOE_DISPATCH] + \
    SERVE_KERNEL_GROUPS[3:]
MOE_TRAIN_GROUPS = TRAIN_KERNEL_GROUPS[:3] + [MOE_DISPATCH] + \
    TRAIN_KERNEL_GROUPS[3:]
# mixtral's sliding-window ring at its served shape: 4 slots of the 4096
# window, 8 KV heads of 6 query heads, hd 128, bf16, two wrapped rows
MIXTRAL_RING = ("mixtral-8x22b ring bf16", 4, 4096, 8, 6, 128, "bfloat16",
                4096, ("ring", "ring", "fill", "late"))


class RouteProbe:
    """Records every ``models.moe.route`` call (the routing of each MoE
    FFN call) while it is entered: the float32 probabilities, the expert
    indices, each slot's row and keep mask, on the CPU."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.calls = moe, moe.route, []
        stack = self.torch.stack

        def route(p, xf, top_k, C):
            res = self.orig(p, xf, top_k, C)
            probs, _, idx, slots = res
            self.calls.append({
                "probs": probs.detach().float().cpu(), "idx": idx.cpu(),
                "rows": stack([r for _, r, _ in slots]).cpu(),
                "keep": stack([k for _, _, k in slots]).cpu()})
            return res
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def route_diff(cpu, card, k) -> dict:
    """Compares one MoE call's routing on the CPU and the card: tokens
    whose chosen experts differ (each must have its k-th and (k+1)-th CPU
    probabilities within MOE_TIE_MARGIN), and, where none differs, the
    rows and dropped tokens, which must then be equal."""
    import torch
    differ = (cpu["idx"] != card["idx"]).any(-1)
    top = torch.sort(cpu["probs"], dim=-1, descending=True).values
    gap = top[:, k - 1] - top[:, k] if top.shape[1] > k else \
        torch.full_like(top[:, 0], float("inf"))
    bad = int((differ & ~(gap <= MOE_TIE_MARGIN)).sum())
    n_diff = int(differ.sum())
    same_rows = n_diff > 0 or (torch.equal(cpu["rows"], card["rows"]) and
                               torch.equal(cpu["keep"], card["keep"]))
    return {"differ": n_diff, "bad": bad, "same_rows": same_rows,
            "dropped": int((~cpu["keep"]).sum())}


def moe_card_vs_cpu(torch, cfg, dev, S, n_dec) -> str:
    """A 1-layer float32 cut at full width: a ``S``-token prefill and
    ``n_dec`` greedy decode steps on the card and on the CPU (the same
    seeded weights, deep-copied), every MoE call's routing compared
    (``route_diff``), the logits within 1e-3 x max|logits| on every path
    where no choice differed."""
    import copy
    import dataclasses

    import numpy as np
    from repro_torch.models import decode_step, init_params, prefill
    cut = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(35)
    card = init_params(gen, cut)
    cpu = copy.deepcopy(card).to("cpu")
    toks = torch.as_tensor(np.random.default_rng(35).integers(
        0, cut.vocab_size, (1, S + n_dec)))
    outs = []
    with torch.inference_mode():
        for m, d in ((cpu, "cpu"), (card, dev)):
            t = toks.to(d)
            with RouteProbe(torch) as probe:
                last, cache = prefill(m, cut, {"tokens": t[:, :S]},
                                      cache_len=S + n_dec)
                logits = [last.float().cpu()]
                for i in range(n_dec):
                    lg, cache = decode_step(m, cut, t[:, S + i:S + i + 1],
                                            cache,
                                            torch.full((1,), S + i,
                                                       device=d))
                    logits.append(lg.float().cpu())
            outs.append((logits, probe.calls))
            del cache
    (c_lg, c_calls), (g_lg, g_calls) = outs
    if len(c_calls) != len(g_calls) or len(c_calls) != 1 + n_dec:
        raise RuntimeError(f"{cfg.name} 1-layer cut: {len(c_calls)} MoE "
                           f"calls on the CPU, {len(g_calls)} on the card")
    diffs = [route_diff(c, g, cut.top_k) for c, g in zip(c_calls, g_calls)]
    if any(x["bad"] or not x["same_rows"] for x in diffs):
        raise RuntimeError(f"{cfg.name} 1-layer cut: routing card vs CPU "
                           f"{diffs}")
    errs, scale, clean = [], 0.0, True
    for x, c, g in zip(diffs, c_lg, g_lg):
        clean = clean and x["differ"] == 0
        scale = max(scale, float(c.abs().max()))
        if clean:
            errs.append(float((g - c).abs().max()))
    if not all(math.isfinite(e) for e in errs) or \
            (errs and max(errs) > 1e-3 * scale):
        raise RuntimeError(f"{cfg.name} 1-layer cut: logits errors {errs} vs"
                           f" max|logits| {scale}")
    del card, cpu
    torch.cuda.empty_cache()
    return (f"{cfg.name} widths, 1 layer, float32, {S}-token prefill + "
            f"{n_dec} decode steps: {len(diffs)} MoE calls, tokens whose "
            f"top-{cut.top_k} choice differed {[x['differ'] for x in diffs]}"
            f" (margin {MOE_TIE_MARGIN:g}), dropped tokens "
            f"{[x['dropped'] for x in diffs]} (the same on both where no "
            f"choice differed), logits max abs err "
            f"{[f'{e:.3g}' for e in errs]} on {len(errs)} of "
            f"{len(diffs)} paths, max|logits| {scale:.4g} (limit 1e-3 x "
            f"max)")


def moe_profiled(torch, model, cfg, dev, label) -> dict:
    """A 1 x 1024 prefill, then 4 greedy decode steps at batch 4, each
    under the profiler: device time by MOE_KERNEL_GROUPS kind."""
    from repro_torch.models import decode_step, prefill
    gen = torch.Generator(device=dev)
    gen.manual_seed(351)
    toks = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                         device=dev)
    box = {}

    def pre():
        box["last"], _ = prefill(model, cfg, {"tokens": toks}, 1028)

    dtoks = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                          device=dev)
    with torch.inference_mode():
        _, box["cache"] = prefill(model, cfg, {"tokens": dtoks}, 260)

        def dec():
            last = dtoks[:, -1:]
            for i in range(4):
                lg, box["cache"] = decode_step(
                    model, cfg, last, box["cache"],
                    torch.full((4,), 256 + i, device=dev))
                last = lg.argmax(-1)[:, None]
        res = {"prefill": profile_by_kind(torch, pre, MOE_KERNEL_GROUPS,
                                          f"{label} profiled 1 x 1024 "
                                          "prefill"),
               "decode": profile_by_kind(torch, dec, MOE_KERNEL_GROUPS,
                                         f"{label} profiled 4 decode steps "
                                         "at batch 4")}
    del box
    return res


def phase_moe_serve(torch, fa, dev, arch) -> dict:
    """Phases 35 (phi3.5-moe) and 36 (mixtral-8x22b): the arch at its
    published width cut to MOE_SERVE_LAYERS layers (bf16, seeded random
    weights) through ServeEngine, phase 12's requests (8 prompts of
    256..4096 tokens, each prefilled alone at batch 1, 16 new each, 4
    slots of 4352): a flash launch a layer a prefill and a decode launch
    a layer a step, on its bf16 route; wall, prefill and decode tokens/s,
    peak memory, a profiled prefill and decode; then phi3.5-moe's 1-layer
    float32 card-vs-CPU routing and logits (``moe_card_vs_cpu``), and
    mixtral's sliding-window ring (4096 slots, wrapped by its 4096-token
    prompt's decode) and the flash kernel at its 48 heads held to their
    plain versions."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=MOE_SERVE_LAYERS[arch])
    n = cfg.n_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{arch} init on the card: {n_params / 1e9:.3f} B parameters, "
        f"{cfg.dtype}, {n} of {get_config(arch).n_layers} layers at full "
        f"width ({cfg.n_experts} experts, top-{cfg.top_k}, d "
        f"{cfg.d_model}, ff {cfg.d_ff}, {cfg.n_heads} heads, window "
        f"{cfg.window}), {time.perf_counter() - t0:.2f} s")
    lens, prompts = serve_requests(cfg)
    eng = ServeEngine(model, cfg, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      device=dev)
    counters = (fa.flash_attention, dk.decode_attention_kernel)
    run = serve_run(torch, eng, prompts, counters, dev)
    del eng
    steps = run["stats"]["decode_steps"]
    serve_checked(cfg, run, [n * SERVE_REQUESTS, n * steps], arch)
    decode_route_checked(cfg, run, 1, "bfloat16", n * steps, arch)
    log(f"serve {arch}: prompt lengths {[int(x) for x in lens]}")
    log(serve_line(arch, run, f"; flash launches {run['launches'][0]}, "
                   f"decode kernel launches {run['launches'][1]} ({n} a "
                   f"step, route bfloat16, {run['grouped'][1]} on the "
                   f"grouped route)"))
    log(f"serve {arch}: first tokens {[o[:4] for o in run['outs']]}")
    prof = moe_profiled(torch, model, cfg, dev, arch)
    del model
    torch.cuda.empty_cache()
    ring = None
    if arch == "phi3_5_moe":
        log(moe_card_vs_cpu(torch, get_config(arch), dev, 512, 2))
    else:
        # the ring's inputs drawn from a generator seeded T + G
        ring = phase_decode(torch, dev, [MIXTRAL_RING],
                            seed=MIXTRAL_RING[2] + MIXTRAL_RING[4])
        kgen = torch.Generator(device=dev)
        kgen.manual_seed(36)
        from repro_torch.models.attention import _expand_kv
        S, H, KV, hd = 2048, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = torch.randn((1, S, H, hd), generator=kgen, device=dev)
        k, v = (_expand_kv(torch.randn((1, S, KV, hd), generator=kgen,
                                       device=dev), H) for _ in range(2))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        err = flash_check(torch, fa, f"B=1 S=T={S} H={H} hd={hd} causal "
                          f"window {cfg.window} bfloat16", q, k, v, True,
                          cfg.window, "bfloat16")[0]
        log(f"mixtral_8x22b: flash kernel vs plain at 48 heads (1, {S}, "
            f"{H}, {hd}) bf16 causal: max_abs_err {err:.3g}, none over the "
            f"bf16 limit")
    log(f"phase {35 if arch == 'phi3_5_moe' else 36}: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"flash": run["launches"][0], "decode": run["launches"][1],
            "grouped": run["grouped"][1], "wall": run["wall"], "prof": prof,
            "ring": ring}


MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 3


def phase_moe_train(torch, fa, dev) -> dict:
    """Phase 37: phi3.5-moe at full width cut to MOE_TRAIN_LAYERS layers
    trains on the card through ``launch.train``'s code path (bf16, seeded
    random weights, batch 8 x 128, MOE_TRAIN_STEPS steps): the loss with
    its aux term, finite, the aux positive every step; 2 flash forward
    and 1 gradient launch a layer a step (remat), the gradient on the
    tensor-core route; the median step, tokens/s, peak memory and a
    profiled step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    t_phase = time.perf_counter()
    cut = dataclasses.replace(get_config("phi3_5_moe"),
                              n_layers=MOE_TRAIN_LAYERS)
    n, L = MOE_TRAIN_STEPS, cut.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_bwd.routes = {"wgmma": 0, "tf32x3": 0}
    argv = ["--arch", "phi3_5_moe", "--steps", str(n), "--batch", "8",
            "--seq", "128", "--device", "cuda"]
    state, step_fn, pipe, hist = train_run(torch, launch_train, dev, argv,
                                           n, cfg=cut)
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    wgmma = fa.flash_attention_bwd.routes["wgmma"]
    losses = [m["loss"] for m in hist]
    auxes = [float(m["aux"]) for m in hist]
    times = [m["step_time_s"] for m in hist]
    label = f"train phi3_5_moe {L} layers, batch 8 x 128"
    if len(hist) != n or not all(math.isfinite(x) for x in losses + auxes) \
            or not all(a > 0 for a in auxes) or fwd != 2 * n * L or \
            bwd != n * L or wgmma != bwd:
        raise RuntimeError(f"{label}: losses {losses}, aux {auxes}, flash "
                           f"launches {fwd} (want {2 * n * L}), gradient "
                           f"{bwd} ({wgmma} wgmma; want {n * L})")
    med = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    log(f"{label}: {n_params / 1e9:.3f} B parameters, bf16; losses "
        f"{[f'{x:.4f}' for x in losses]} with aux "
        f"{[f'{x:.4f}' for x in auxes]} (weight 0.01), step times "
        f"{[f'{x:.3f}' for x in times]} s; median step (steps 2-{n}) "
        f"{med:.4f} s, {8 * 128 / med:.1f} tokens/s; flash launches {fwd}, "
        f"gradient {bwd} (wgmma); peak memory {peak / 2**30:.2f} GiB")
    batch = pipe.next_batch()
    prof = profile_by_kind(torch, lambda: float(step_fn(state, batch)[1][
        "loss"]), MOE_TRAIN_GROUPS, f"{label} profiled step")
    del state, step_fn, pipe, batch
    torch.cuda.empty_cache()
    log(f"phase 37: {time.perf_counter() - t_phase:.1f} s")
    return {"fwd": fwd, "bwd": bwd, "median_step_s": med, "peak": peak,
            "prof": prof}


# phase 38: the xLSTM scans' backward kernels. The mLSTM's (B, S, H, hd):
# xlstm-350m's two training shapes (1 x 4096 and 8 x 128, heads of 512),
# a ragged reduced one, S = 1 (its gate gradients exactly 0 from the zero
# state) and a width off the model's; then the stabiliser's planted ties
# from a random state (MLSTM_TIES). The sLSTM's (B, S, w, type): the two
# training shapes in bf16, 1 x 4096 in float32, widths off a block's 16
# channels with S off the 32-step chunk, S = 1
MLSTM_BWD_TESTS = [(1, 4096, 4, 512), (8, 128, 4, 512), (2, 37, 4, 16),
                   (1, 1, 4, 512), (2, 45, 2, 128)]
SLSTM_BWD_TESTS = [(1, 4096, 1024, "bfloat16"), (8, 128, 1024, "bfloat16"),
                   (1, 4096, 1024, "float32"), (2, 37, 32, "float32"),
                   (3, 70, 7, "float32"), (1, 1, 7, "float32"),
                   (1, 300, 1000, "bfloat16")]
# limits against the plain backward: the input gradients (dq, dk, dv, the
# float32 dgates) within XBWD_X_REL of their largest entry, bf16 dgates
# within two bf16 steps of each entry plus that (the float32 gradient
# rounded once); the gate pre-activations' gradients and dr within
# XBWD_GATE_REL of theirs (the mLSTM's Q recurrence carries each step's
# rounding down the sequence; dr sums B x S terms)
XBWD_X_REL = 1e-5
XBWD_GATE_REL = 1e-4
# float32 instructions the mLSTM's gradient needs an element of C a step:
# C again (2), G's update (2), the sums of dq, dk and dv (C^T dnum, G^T v,
# G k: one FMA each; <G, C> comes from a scalar recurrence, not from C);
# and a row a step (dN's update 2, dq's and dk's n terms 3, dv's
# gate 1, dN . k and dN . n 2). The sLSTM's a step and channel: the cell
# again (SLSTM_OPS) and its chain rule, 50: dH, c / n and its quotients
# with n (8), the floor's mask and dn (3), DF and DI (7), dz and the two
# carries (3), the gates' chain through the stabiliser with its tie weight
# and sigmoid(-pre_f) (12), the tanh and sigmoid derivatives (6), dr's four
# products and sums (8) and the feedback's (dH of the step before, 7)
MLSTM_BWD_OPS_C, MLSTM_BWD_OPS_ROW = 7, 8
SLSTM_BWD_OPS = SLSTM_OPS + 50


def xbwd_over(torch, got, want, kinds):
    """Each gradient's max abs error and scale, and the count of limits
    broken: kind 'x' within XBWD_X_REL of its largest entry (bf16: two
    bf16 steps of each entry plus that), 'gate' within XBWD_GATE_REL."""
    errs, scales, over = [], [], 0
    for g, w, kind in zip(got, want, kinds):
        gf, wf = g.float(), w.float()
        scale = float(wf.abs().max())
        diff = (gf - wf).abs()
        errs.append(float(diff.max()))
        scales.append(scale)
        if kind == "x":
            lim = XBWD_X_REL * scale + (2.0 ** -7 * wf.abs()
                                        if g.dtype == torch.bfloat16 else 0.0)
            over += int((diff > lim).sum())
        else:
            over += int(not errs[-1] <= XBWD_GATE_REL * scale)
    return errs, scales, over


def xbwd_check(torch, name, call, plain, kinds, counter, n_kernels,
               work=None) -> dict:
    """A backward kernel's ``call()`` against its ``plain()`` (limits of
    ``xbwd_over``; the plain call timed once by the host clock around a
    synchronize), two launches bitwise, counted twice, a CUDA graph's two
    replays bitwise, ``n_kernels`` device kernels a call, ``work`` (the
    kernel's int32 workspace) zero after the launches."""
    before = counter.launches
    got, again = call(), call()
    launched = counter.launches - before
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs, scales, over = xbwd_over(torch, got, want, kinds)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    replay = graph_replay_equal(torch, call, got)
    k_call, nodes = kernels_a_call(torch, call)
    dirty = int(work().abs().sum()) if work is not None else 0
    if not (all(math.isfinite(e) for e in errs) and over == 0 and bitwise
            and launched == 2 and replay and dirty == 0
            and k_call == n_kernels and nodes >= n_kernels):
        raise RuntimeError(f"{name}: max abs errs {errs} (scales {scales}), "
                           f"{over} over the limits, bitwise {bitwise}, "
                           f"{launched} launches counted (want 2), graph "
                           f"replays equal {replay}, {k_call} kernels a call"
                           f" (want {n_kernels}), workspace sum {dirty}")
    return {"call": call, "errs": errs, "scales": scales,
            "plain_ms": plain_ms}


# the kernels ``kernel_split`` reports: the mLSTM gradient's, the float32
# attention gradient's (with their template arguments)
MLSTM_BWD_KERNELS = r"mlstm_bwd_\w+(<[^>]*>)?"
TF32_BWD_KERNELS = r"tf32_fa_bwd::\w+(<[^>]*>)?"


def kernel_split(torch, call, calls: int, pattern: str) -> dict:
    """A gradient's device time a call by kernel: ``calls`` calls of
    ``call()`` (one gradient call) under the profiler after a warm-up
    (``profiled_kernels``), the kernel names ``pattern`` finds (each
    launches once a call) -> (ms a call, events recorded). The time is
    the mean over the events recorded, which the profiler can leave short
    of ``calls``; the count says so."""
    import re
    call()
    torch.cuda.synchronize()
    kernels, _, _ = profiled_kernels(
        torch, lambda: [call() for _ in range(calls)])
    total, events = {}, {}
    for e in kernels:
        found = re.search(pattern, e.name)
        if found:
            name = found.group(0)
            total[name] = total.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
            events[name] = events.get(name, 0) + 1
    return {n: (total[n] / events[n], events[n]) for n in total}


def split_text(split: dict, calls: int) -> str:
    """``kernel_split``'s result as text: the kernels' sum and each
    kernel's ms a call, with its event count where it is not ``calls``."""
    return f"{sum(t for t, _ in split.values()):.4f} in all: " + ", ".join(
        f"{n} {t:.4f}" + ("" if k == calls else f" ({k} of {calls} events)")
        for n, (t, k) in sorted(split.items()))


def xbwd_gradcheck(torch, name, route, leaves, f64_loss, counters) -> str:
    """The autograd route on the card (``route(*leaves)``: the forward
    kernel, then the backward kernel) at a tiny float32 case: its
    directional derivative along a random direction of the leaves against
    a central difference (step 1e-5) of ``f64_loss`` (the plain forward
    in float64 on the CPU), within 1e-5; one forward and one backward
    launch."""
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    before = [c.launches for c in counters]
    out = route(*leaves)
    gen = torch.Generator(device=out.device)
    gen.manual_seed(381)
    dout = torch.randn(out.shape, generator=gen, device=out.device)
    got = torch.autograd.grad(out, leaves, dout)
    launched = [c.launches - b for c, b in zip(counters, before)]
    cpu = [t.detach().double().cpu() for t in leaves]
    cgen = torch.Generator().manual_seed(382)
    dirs = [torch.randn(t.shape, generator=cgen, dtype=torch.float64)
            for t in cpu]
    dc = dout.double().cpu()

    def loss(s):
        return float((f64_loss(*(t + s * d for t, d in zip(cpu, dirs)))
                      * dc).sum())
    eps = 1e-5
    fd = (loss(eps) - loss(-eps)) / (2 * eps)
    an = sum(float((g.double().cpu() * d).sum()) for g, d in zip(got, dirs))
    rel = abs(an - fd) / max(abs(fd), 1e-30)
    if launched != [1, 1] or not rel <= 1e-5:
        raise RuntimeError(f"{name} autograd route: launches (forward, "
                           f"backward) {launched}, directional derivative "
                           f"{an} vs float64 central difference {fd} (rel "
                           f"{rel})")
    return (f"{name} autograd route {tuple(leaves[0].shape)}: launches "
            f"(forward, backward) {launched}, directional derivative "
            f"{an:.8g} vs float64 central difference {fd:.8g} (rel "
            f"{rel:.3g}, limit 1e-5)")


def slstm_saving_check(torch, ss, gates, r, state, label) -> tuple:
    """The sLSTM forward's saving launch (``SLSTMScan``'s forward) from
    ``state``: its hs and final state bitwise those of the launch without
    saving, its saved state at step 0 bitwise ``state`` and at step
    S // 2 bitwise the final state of a launch over the steps before.
    Returns (hs, (cs, ns, ms))."""
    one, two = ([t.clone() for t in state] for _ in range(2))
    with torch.no_grad():
        hs, saved = ss._forward_kernel(gates, r, *one, save=True)
        want = ss.slstm_scan(gates, r, *two)
        t = gates.shape[1] // 2
        part = [x.clone() for x in state]
        if t:
            ss.slstm_scan(gates[:, :t], r, *part)
    ok = torch.equal(hs, want) and all(
        torch.equal(a, b) for a, b in zip(one, two)) and all(
        torch.equal(x[:, 0], s0) and torch.equal(x[:, t], st)
        for x, s0, st in zip(saved, state, part))
    if not ok:
        raise RuntimeError(f"{label}: the saving forward's hs, final state "
                           f"or saved states differ from the forward "
                           f"launch without saving")
    return hs, saved


def phase_xlstm_bwd(torch, dev) -> dict:
    """Phase 38: the mLSTM and sLSTM scans' backward kernels
    (``csrc/mlstm_scan_bwd.cu``, seven kernels a call;
    ``csrc/slstm_scan_bwd.cu``, ``slstm_scan.BACKWARD_KERNELS``) vs
    ``mlstm_scan_backward_plain`` and ``slstm_scan_backward_plain`` at
    MLSTM_BWD_TESTS (+ the planted ties) and SLSTM_BWD_TESTS
    (``xbwd_check``: limits, two launches bitwise, graph replays bitwise,
    kernels a call, the sLSTM's arrival counters zero), the sLSTM's
    backward given the forward's saving launch's hs and states as
    ``SLSTMScan.backward`` gives them (``slstm_saving_check`` holds that
    launch to the one without saving); device time a launch from a CUDA
    graph beside the bound and the plain version (timed once, in the
    check), the mLSTM's by kernel at its two training shapes
    (``kernel_split``); the sLSTM's chain floor, one warp's chains
    alone at the same S, and its forward with and without saving; then
    each autograd route's float64 central difference."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import slstm_scan as ss
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(38)
    out = {"mlstm": {}, "slstm": {}, "max_abs_err": {}}
    worst = 0.0
    for B, S, H, hd, ties in [*((*s, False) for s in MLSTM_BWD_TESTS),
                              (*MLSTM_TIES, True)]:
        q, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev)
                   for _ in range(3))
        k = k * (1.0 / math.sqrt(hd))
        i_pre, f_pre = (torch.randn((B, S, H), generator=gen, device=dev)
                        * 2 for _ in range(2))
        if ties:
            st = xlstm_state(torch, gen, {"C": (B, H, hd, hd),
                                          "n": (B, H, hd), "m": (B, H)},
                             dev)
            state = (st["C"] * 0.3, st["n"], st["m"].abs() + 1)
            i_pre, f_pre = mlstm_tie_gates(torch, gen, S, state[2])
        else:
            state = ms.init_state(B, H, hd, dev)
        dh = torch.randn((B, S, H, hd), generator=gen, device=dev)
        args = (q, k, v, i_pre, f_pre, *state, dh)
        label = f"mlstm_scan_backward ({B}, {S}, {H}, {hd})" + (
            " ties" if ties else "")
        res = xbwd_check(torch, label,
                         lambda a=args: ms.mlstm_scan_backward(*a),
                         lambda a=args: ms.mlstm_scan_backward_plain(*a),
                         ("x",) * 3 + ("gate",) * 2, ms.mlstm_scan_backward,
                         ms.BACKWARD_KERNELS)
        worst = max(worst, max(res["errs"][:3]))
        long = S * B >= 1024
        ms_ = graph_ms(torch, res["call"], launches=3 if long else 10,
                       reps=3 if long else 10)
        flops = B * S * H * (MLSTM_BWD_OPS_C * hd * hd
                             + MLSTM_BWD_OPS_ROW * hd)
        nbytes = 4 * (7 * B * S * H * hd + 4 * B * S * H
                      + B * H * (hd * hd + hd + 1))
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        t_ops = flops / RATE_FP32 * 1e3
        bound = {"bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out["mlstm"][(B, S, H, hd) + (("ties",) if ties else ())] = {
            "ms": ms_, "plain_ms": res["plain_ms"], **bound}
        rel = [e / max(s, 1e-30) for e, s in zip(res["errs"], res["scales"])]
        log(f"{label}: errors / max (dq, dk, dv, d i_pre, d f_pre) "
            f"{[f'{r:.3g}' for r in rel]} (limits {XBWD_X_REL:g}, "
            f"{XBWD_GATE_REL:g}); two launches bitwise, graph replays "
            f"bitwise, {ms.BACKWARD_KERNELS} device kernels a call; kernel "
            f"{ms_:.4f} ms a call on the device (CUDA graph), plain "
            f"{res['plain_ms']:.2f} ms, bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}: {flops / 1e9:.3f} G float32 "
            f"instructions at the lane rate, {nbytes / 1e6:.2f} MB)")
        if (B, S, H, hd) in MLSTM_BWD_TESTS[:2] and not ties:
            calls = max(3, math.ceil(50 / ms_))  # a 50 ms window
            split = kernel_split(torch, res["call"], calls,
                                 MLSTM_BWD_KERNELS)
            out["mlstm"][(B, S, H, hd)]["split"] = split
            log(f"{label} by kernel (profiler, ms a call over {calls} "
                f"calls): {split_text(split, calls)}")
        del res, args
    out["max_abs_err"]["mlstm"] = worst
    worst = 0.0
    for B, S, w, dt in SLSTM_BWD_TESTS:
        gates = (torch.randn((B, S, w, 4), generator=gen, device=dev)
                 * 2).to(getattr(torch, dt))
        r = torch.randn((w, 4), generator=gen, device=dev) * 0.5
        state = ss.init_state(B, w, dev)
        dhs = torch.randn((B, S, w), generator=gen, device=dev)
        label = f"slstm_scan_backward ({B}, {S}, {w}) {dt}"
        hs, saved = slstm_saving_check(torch, ss, gates, r, state, label)
        res = xbwd_check(
            torch, label,
            lambda g=gates, r=r, d=dhs, h=hs, sv=saved:
                ss.slstm_scan_backward(g, r, *state, d, h, sv),
            lambda g=gates, r=r, d=dhs: ss.slstm_scan_backward_plain(
                g, r, *state, d),
            ("x", "gate"), ss.slstm_scan_backward, ss.BACKWARD_KERNELS,
            work=lambda w=w: build.workspace(
                "slstm_scan_bwd", dev, -(-w // ss.SCAN_BWD_CHANNELS)))
        worst = max(worst, res["errs"][0])
        long = S * B >= 1024
        ms_ = graph_ms(torch, res["call"], launches=3 if long else 10,
                       reps=3 if long else 10)
        # the function's bytes; the design also reads the saved states
        nbytes = (2 * gates.numel() * gates.element_size()
                  + 2 * 4 * B * S * w + 2 * 16 * w + 4 * 4 * B * w)
        design_bytes = nbytes + 3 * 4 * B * S * w
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        t_ops = SLSTM_BWD_OPS * B * S * w / RATE_FP32 * 1e3
        entry = {"ms": ms_, "plain_ms": res["plain_ms"],
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        chain = ""
        if B == 1 and S == 4096 and dt == "bfloat16":
            # the reverse chain's floor: one warp of chains alone, same S
            g1 = gates[:, :, :32].contiguous()
            st1 = [t[:, :32].contiguous() for t in state]
            d1 = dhs[:, :, :32].contiguous()
            h1 = hs[:, :, :32].contiguous()
            sv1 = tuple(t[:, :, :32].contiguous() for t in saved)
            entry["chain_ms"] = graph_ms(
                torch, lambda: ss.slstm_scan_backward(
                    g1, r[:32].contiguous(), *st1, d1, h1, sv1),
                launches=3, reps=3)
            # the forward with and without saving, from copies of the state
            fst = [t.clone() for t in state]
            with torch.no_grad():
                entry["fwd_ms"] = graph_ms(
                    torch, lambda: ss.slstm_scan(gates, r, *fst),
                    launches=3, reps=3)
                entry["fwd_save_ms"] = graph_ms(
                    torch, lambda: ss._forward_kernel(gates, r, *fst,
                                                      save=True),
                    launches=3, reps=3)
            chain = (f"; one warp's chains alone (1, {S}, 32): "
                     f"{entry['chain_ms']:.4f} ms, "
                     f"{entry['chain_ms'] * 1e6 / S:.1f} ns a step; the "
                     f"forward {entry['fwd_ms']:.4f} ms, its saving launch "
                     f"{entry['fwd_save_ms']:.4f} ms "
                     f"({entry['fwd_save_ms'] / entry['fwd_ms']:.3f}x)")
        out["slstm"][(B, S, w, dt)] = entry
        rel = [e / max(s, 1e-30) for e, s in zip(res["errs"], res["scales"])]
        log(f"{label}: errors / max (dgates, dr) {[f'{x:.3g}' for x in rel]}"
            f" (limits {XBWD_X_REL:g} + two bf16 steps in bf16, "
            f"{XBWD_GATE_REL:g}); the saving forward bitwise the forward; "
            f"two launches bitwise, graph replays bitwise, workspace zero, "
            f"{ss.BACKWARD_KERNELS} device kernel a call; kernel "
            f"{ms_:.4f} ms a call on the device (CUDA graph), plain "
            f"{res['plain_ms']:.2f} ms, bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']}: {nbytes / 1e6:.2f} MB, "
            f"{SLSTM_BWD_OPS * B * S * w / 1e9:.3f} G float32 ops; the "
            f"design moves {design_bytes / 1e6:.2f} MB with the saved "
            f"states){chain}")
        del res
    out["max_abs_err"]["slstm"] = worst
    # each autograd route against a float64 central difference
    q, k, v = (torch.randn((2, 30, 2, 16), generator=gen, device=dev)
               for _ in range(3))
    i_pre, f_pre = (torch.randn((2, 30, 2), generator=gen, device=dev) * 2
                    for _ in range(2))

    def m_route(*a):
        return ms.mlstm_scan(*a, *ms.init_state(2, 2, 16, dev))

    def m_f64(*a):
        st = [t.double() for t in ms.init_state(2, 2, 16, "cpu")]
        return ms.mlstm_scan_plain(*a, *st)
    log(xbwd_gradcheck(torch, "mlstm_scan", m_route,
                       (q, k * 0.25, v, i_pre, f_pre), m_f64,
                       (ms.mlstm_scan, ms.mlstm_scan_backward)))
    gates = torch.randn((2, 30, 8, 4), generator=gen, device=dev) * 2
    r = torch.randn((8, 4), generator=gen, device=dev) * 0.5

    def s_route(g, rr):
        return ss.slstm_scan(g, rr, *ss.init_state(2, 8, dev))

    def s_f64(g, rr):
        # the cell in float64 (slstm_scan_plain rounds the gates to
        # float32 first)
        c, n, h = (torch.zeros(g.shape[::2][:2], dtype=torch.float64)
                   for _ in range(3))
        m, out = torch.full_like(c, ss.M_INIT), []
        for t in range(g.shape[1]):
            pre = g[:, t] + h[..., None] * rr
            lfm = -torch.logaddexp(-pre[..., 2], torch.zeros_like(c)) + m
            m = torch.maximum(lfm, pre[..., 1])
            i_g, f_g = torch.exp(pre[..., 1] - m), torch.exp(lfm - m)
            c = f_g * c + i_g * torch.tanh(pre[..., 0])
            n = torch.clamp(f_g * n + i_g, min=ss.N_FLOOR)
            h = torch.sigmoid(pre[..., 3]) * (c / n)
            out.append(h)
        return torch.stack(out, dim=1)
    log(xbwd_gradcheck(torch, "slstm_scan", s_route, (gates, r), s_f64,
                       (ss.slstm_scan, ss.slstm_scan_backward)))
    torch.cuda.empty_cache()
    log(f"phase 38: {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 39: xlstm-350m at full width and depth trains XL_TRAIN_STEPS steps
# at each (batch, seq) of XL_TRAIN_RUNS; then a 2-layer float32 cut's
# gradients card against CPU at XL_CHECK_S tokens
XL_TRAIN_RUNS = [(8, 128), (1, 4096)]
XL_TRAIN_STEPS = 3
XL_CHECK_S = 128
XL_TRAIN_GROUPS = [("mlstm gradient", ("mlstm_bwd_",)),
                   ("slstm gradient", ("slstm_scan_bwd_kernel",)),
                   ("mlstm scan", ("mlstm_scan_kernel",)),
                   ("slstm scan", ("slstm_scan_kernel",))] + \
    TRAIN_KERNEL_GROUPS


def phase_xlstm_train(torch, dev) -> dict:
    """Phase 39: xlstm-350m at its published width and depth (24 layers
    [slstm, mlstm] x 12, bf16, seeded random weights) trains on the card
    through ``launch.train``'s code path: at each of XL_TRAIN_RUNS, 2
    forward launches (remat) and 1 backward call an mLSTM and an sLSTM
    layer a step, on the forward's hd-512 and bf16 routes; finite losses
    and grad norms; the median step, tokens/s, peak memory and a profiled
    step by kernel kind; then a 2-layer [slstm, mlstm] float32 cut: one
    loss and gradient on the card against the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    cfg = get_config("xlstm_350m")
    n_m, n_s = cfg.layout().count("mlstm"), cfg.layout().count("slstm")
    n = XL_TRAIN_STEPS
    counters = (ms.mlstm_scan, ms.mlstm_scan_backward, ss.slstm_scan,
                ss.slstm_scan_backward)
    want = [2 * n * n_m, n * n_m, 2 * n * n_s, n * n_s]
    out = {"launches": [0, 0, 0, 0]}
    for B, S in XL_TRAIN_RUNS:
        label = f"train xlstm_350m {cfg.n_layers} layers, batch {B} x {S}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters:
            c.launches = 0
        ms.mlstm_scan.routes = {k: 0 for k in ms.mlstm_scan.routes}
        ss.slstm_scan.routes = {k: 0 for k in ss.slstm_scan.routes}
        argv = ["--arch", "xlstm_350m", "--steps", str(n), "--batch",
                str(B), "--seq", str(S), "--device", "cuda"]
        t0 = time.perf_counter()
        state, step_fn, pipe, hist = train_run(torch, launch_train, dev,
                                               argv, n)
        wall = time.perf_counter() - t0
        got = [c.launches for c in counters]
        routes = (ms.mlstm_scan.routes["hd512"],
                  ss.slstm_scan.routes["bfloat16"])
        losses = [m["loss"] for m in hist]
        gnorms = [m["grad_norm"] for m in hist]
        times = [m["step_time_s"] for m in hist]
        if len(hist) != n or not all(math.isfinite(x)
                                     for x in losses + gnorms) \
                or got != want or routes != (want[0], want[2]):
            raise RuntimeError(f"{label}: losses {losses}, grad norms "
                               f"{gnorms}, launches (mlstm, its backward, "
                               f"slstm, its backward) {got} (want {want}), "
                               f"forward routes (hd512, bf16) {routes}")
        med = statistics.median(times[1:])
        peak = torch.cuda.max_memory_allocated(dev)
        n_params = sum(p.numel() for p in state.params.parameters())
        log(f"{label}: {n_params / 1e9:.3f} B parameters ({n_s} slstm + "
            f"{n_m} mlstm), bf16; losses {[f'{x:.4f}' for x in losses]}, "
            f"grad norms {[f'{x:.4f}' for x in gnorms]}, step times "
            f"{[f'{x:.3f}' for x in times]} s ({wall:.2f} s wall, init "
            f"included); median step (steps 2-{n}) {med:.4f} s, "
            f"{B * S / med:.1f} tokens/s; launches (mlstm, its backward, "
            f"slstm, its backward) {got}; peak memory "
            f"{peak / 2**30:.2f} GiB")
        batch = pipe.next_batch()
        prof = profile_by_kind(
            torch, lambda: float(step_fn(state, batch)[1]["loss"]),
            XL_TRAIN_GROUPS, f"{label} profiled step")
        out[(B, S)] = {"median_step_s": med, "peak": peak, "prof": prof,
                       "tokens_s": B * S / med}
        out["launches"] = [a + b for a, b in zip(out["launches"], got)]
        del state, step_fn, pipe, batch
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(39)
    card = init_params(gen, cut).train()
    toks = torch.randint(0, cut.vocab_size, (1, XL_CHECK_S), generator=gen,
                         device=dev)
    launched, line = card_vs_cpu_grads(
        torch, card, cut, {"tokens": toks, "labels": toks}, dev, counters,
        f"xlstm_350m widths, 2 layers [slstm, mlstm], float32, 1 x "
        f"{XL_CHECK_S} tokens")
    if launched != [2, 1, 2, 1]:
        raise RuntimeError(f"xlstm_350m 2-layer cut: card launches (mlstm, "
                           f"its backward, slstm, its backward) {launched},"
                           f" want [2, 1, 2, 1]")
    log(f"{line}; card launches (mlstm, its backward, slstm, its backward) "
        f"{launched}")
    del card
    torch.cuda.empty_cache()
    log(f"phase 39: {time.perf_counter() - t_phase:.1f} s")
    return out


class FlashProbe:
    """Records (causal, S, T) of every flash forward and gradient call the
    model makes through ``kernels.ops`` (``calls['fwd']``,
    ``calls['bwd']``)."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.calls = ops, {"fwd": [], "bwd": []}

    def __enter__(self):
        self.saved = (self.ops.flash_attention, self.ops.flash_attention_bwd)
        fwd, bwd = self.saved

        def f_rec(q, k, v, *a, causal=True, **kw):
            self.calls["fwd"].append((bool(causal), q.shape[2], k.shape[2]))
            return fwd(q, k, v, *a, causal=causal, **kw)

        def b_rec(q, k, v, *a, causal=True, **kw):
            self.calls["bwd"].append((bool(causal), q.shape[2], k.shape[2]))
            return bwd(q, k, v, *a, causal=causal, **kw)
        self.ops.flash_attention, self.ops.flash_attention_bwd = f_rec, b_rec
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.flash_attention_bwd = self.saved


# phase 40: llama-3.2-vision trained at full width cut to two pattern
# periods (VISION_TRAIN_LAYERS: 8 attn + 2 cross_attn), VISION_TRAIN_STEPS
# steps at VISION_TRAIN_B x VISION_TRAIN_S with the config's 1600 image
# embeddings; then one period's float32 cut card against CPU at
# VISION_CHECK_S tokens
VISION_TRAIN_LAYERS = 10
VISION_TRAIN_B, VISION_TRAIN_S = 2, 1024
VISION_TRAIN_STEPS = 3
VISION_CHECK_S = 32


def phase_vision_train(torch, fa, dev) -> dict:
    """Phase 40: llama-3.2-vision at full width cut to VISION_TRAIN_LAYERS
    layers trains on the card through ``launch.train``'s code path (bf16,
    seeded random weights, the gates drawn non-zero after set-up): 2 flash
    forward and 1 gradient launch a layer a step, every gradient on the
    tensor-core route, the self layers causal at S = T and the cross
    layers not causal against the image tokens; finite losses and grad
    norms, the median step, peak memory and a profiled step; then one
    pattern period in float32 (gates drawn): one loss and gradient on the
    card against the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    from repro_torch.train.loop import train_loop
    t_phase = time.perf_counter()
    full = get_config("llama32_vision_11b")
    cut = dataclasses.replace(full, n_layers=VISION_TRAIN_LAYERS)
    kinds = cut.layout()
    n_cross = kinds.count("cross_attn")
    n_self = len(kinds) - n_cross
    n, L = VISION_TRAIN_STEPS, cut.n_layers
    B, S = VISION_TRAIN_B, VISION_TRAIN_S
    label = (f"train llama32_vision_11b {L} layers ({n_self} attn + "
             f"{n_cross} cross_attn), batch {B} x {S} + "
             f"{cut.n_img_tokens} image tokens")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_bwd.routes = {"wgmma": 0, "tf32x3": 0}
    argv = ["--arch", "llama32_vision_11b", "--steps", str(n), "--batch",
            str(B), "--seq", str(S), "--device", "cuda"]
    args = launch_train.parse_args(argv)
    gen = torch.Generator(device=dev)
    gen.manual_seed(40)
    t0 = time.perf_counter()
    _, state, step_fn, pipe = launch_train.setup(args, dev, cut)
    gated = set_gates(torch, state.params, gen)
    hist = []
    with FlashProbe() as probe:
        state = train_loop(state, step_fn, pipe, n, log_every=1,
                           on_metrics=lambda s, m: hist.append(m))
    wall = time.perf_counter() - t0
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    wgmma = fa.flash_attention_bwd.routes["wgmma"]
    losses = [m["loss"] for m in hist]
    gnorms = [m["grad_norm"] for m in hist]
    times = [m["step_time_s"] for m in hist]
    T = cut.n_img_tokens
    kinds_b = sorted(set(probe.calls["bwd"]))
    want_kinds = sorted({(True, S, S), (False, S, T)})
    n_nc = sum(not c for c, _, _ in probe.calls["bwd"])
    if len(hist) != n or not all(math.isfinite(x) for x in losses + gnorms) \
            or fwd != 2 * n * L or bwd != n * L or wgmma != bwd \
            or kinds_b != want_kinds or n_nc != n * n_cross \
            or sorted(set(probe.calls["fwd"])) != want_kinds:
        raise RuntimeError(f"{label}: losses {losses}, grad norms {gnorms}, "
                           f"flash launches {fwd} (want {2 * n * L}), "
                           f"gradient {bwd} ({wgmma} wgmma; want {n * L}), "
                           f"gradient calls (causal, S, T) {kinds_b} with "
                           f"{n_nc} not causal (want {want_kinds}, "
                           f"{n * n_cross})")
    med = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    log(f"{label}: {n_params / 1e9:.3f} B parameters, bf16, {gated} blocks' "
        f"gates drawn in [0.25, 1); losses {[f'{x:.4f}' for x in losses]}, "
        f"grad norms {[f'{x:.4f}' for x in gnorms]}, step times "
        f"{[f'{x:.3f}' for x in times]} s ({wall:.2f} s wall, init "
        f"included); median step (steps 2-{n}) {med:.4f} s, "
        f"{B * S / med:.1f} tokens/s; flash launches {fwd}, gradient {bwd} "
        f"(wgmma), calls (causal, S, T) {want_kinds}, {n_nc} gradients not "
        f"causal; peak memory {peak / 2**30:.2f} GiB")
    batch = pipe.next_batch()
    prof = profile_by_kind(torch, lambda: float(step_fn(state, batch)[1][
        "loss"]), TRAIN_KERNEL_GROUPS, f"{label} profiled step")
    del state, step_fn, pipe, batch
    torch.cuda.empty_cache()
    one = dataclasses.replace(full, n_layers=len(full.pattern),
                              dtype="float32")
    gen.manual_seed(41)
    card = init_params(gen, one).train()
    set_gates(torch, card, gen)
    toks = torch.randint(0, one.vocab_size, (1, VISION_CHECK_S),
                         generator=gen, device=dev)
    img = torch.randn((1, one.n_img_tokens, one.d_vision), generator=gen,
                      device=dev)
    counters = (fa.flash_attention, fa.flash_attention_bwd)
    launched, line = card_vs_cpu_grads(
        torch, card, one, {"tokens": toks, "labels": toks,
                           "image_embeds": img}, dev, counters,
        f"llama32_vision_11b widths, {one.n_layers} layers "
        f"{list(one.pattern)}, float32, gates drawn, 1 x {VISION_CHECK_S} "
        f"tokens + {one.n_img_tokens} image tokens")
    if launched != [2 * one.n_layers, one.n_layers]:
        raise RuntimeError(f"llama32_vision_11b {one.n_layers}-layer cut: "
                           f"card launches (flash, gradient) {launched}, "
                           f"want {[2 * one.n_layers, one.n_layers]}")
    log(f"{line}; card launches (flash, gradient) {launched}")
    del card
    torch.cuda.empty_cache()
    log(f"phase 40: {time.perf_counter() - t_phase:.1f} s")
    return {"fwd": fwd, "bwd": bwd, "median_step_s": med, "peak": peak,
            "prof": prof}


# phases 41-43: the dense archs not run on the card before, at full width
DENSE_NEW = ("qwen2_5_3b", "glm4_9b", "phi4_mini_3_8b")
# phase 41: the decode kernel at their GQA groups (query heads a KV head:
# qwen2.5-3b 16 over 2 and glm4-9b 32 over 2 on the grouped route,
# phi4-mini 24 over 8 on the split route, a partly filled last head group
# of its 4) at phase 25's serving shape
GQA_DECODE_TESTS = [
    (f"{arch} {cache}", 4, 4352, KV, G, 128, cache, 0,
     ("fill", "fill", "fill", "late"))
    for arch, KV, G in (("qwen2.5-3b", 2, 8), ("glm4-9b", 2, 16),
                        ("phi4-mini", 8, 3))
    for cache in ("bfloat16", "int8")]
# phase 42: qwen2.5-3b's float32 cut's loss and gradients at 1 x this
QWEN25_CHECK_S = 256
# phase 43: glm4-9b trains cut to the first of these depths that fits
GLM_TRAIN_LAYERS = (20, 16)
GLM_TRAIN_STEPS = 3


def phase_dense_serve(torch, fa, dev) -> dict:
    """Phase 41: DENSE_NEW served at full width as phase 12 serves
    qwen3-4b; then the decode kernel at their groups (GQA_DECODE_TESTS)
    as phase 25 checks and times it."""
    t0 = time.perf_counter()
    out = {"flash": 0, "decode": 0, "grouped": 0, "max_abs_err": 0.0}
    for arch in DENSE_NEW:
        torch.cuda.empty_cache()
        served = phase_serve(torch, fa, dev, arch)
        out["flash"] += served["launches"]
        out["decode"] += served["decode_launches"]
        out["grouped"] += served["grouped"]
        out["max_abs_err"] = max(out["max_abs_err"], served["max_abs_err"])
    torch.cuda.empty_cache()
    out["kernel"] = phase_decode(torch, dev, GQA_DECODE_TESTS)
    log(f"phase 41: {time.perf_counter() - t0:.1f} s")
    return out


def phase_dense_logits(torch, fa, dev) -> dict:
    """Phase 42: DENSE_NEW's float32 2-layer cuts card against CPU
    (phase 13's check; qwen2.5-3b's QKV biases non-zero), then the
    qwen2.5-3b cut's loss and gradients, the bias leaves among them,
    card against CPU."""
    t0 = time.perf_counter()
    counters = (fa.flash_attention, fa.flash_attention_bwd)
    out = {"flash": 0, "bwd": 0}
    for arch in DENSE_NEW:
        card, cfg = phase_logits(torch, fa, dev, arch)
        out["flash"] += cfg.n_layers
        if cfg.qkv_bias:
            gen = torch.Generator(device=dev)
            gen.manual_seed(42)
            toks = torch.randint(0, cfg.vocab_size, (1, QWEN25_CHECK_S),
                                 generator=gen, device=dev)
            launched, line = card_vs_cpu_grads(
                torch, card.train(), cfg, {"tokens": toks, "labels": toks},
                dev, counters, f"{arch} widths, 2 layers, float32, QKV "
                f"biases non-zero, 1 x {QWEN25_CHECK_S} tokens",
                show=("bq", "bk", "bv"))
            want = [2 * cfg.n_layers, cfg.n_layers]
            if launched != want:
                raise RuntimeError(f"{arch} 2-layer cut: card launches "
                                   f"(flash, flash gradient) {launched}, "
                                   f"want {want}")
            log(f"{line}; card launches (flash, flash gradient) "
                f"{launched}")
            out["flash"] += launched[0]
            out["bwd"] += launched[1]
        del card
        torch.cuda.empty_cache()
    log(f"phase 42: {time.perf_counter() - t0:.1f} s")
    return out


def compress_check(torch, grads, label) -> None:
    """``error_feedback_compress`` from a zero residual (``init_residuals``)
    on every leaf of ``grads`` on the card, and on the same leaves copied
    to the CPU: q, scale and the new residual bitwise equal."""
    from repro_torch.parallel.compression import (error_feedback_compress,
                                                  init_residuals)
    bad, n_el, t_card, t_cpu = [], 0, 0.0, 0.0
    for name, g in grads.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = error_feedback_compress(g, init_residuals(g))
        torch.cuda.synchronize()
        t_card += time.perf_counter() - t0
        g_cpu = g.cpu()
        t0 = time.perf_counter()
        cpu = error_feedback_compress(g_cpu, init_residuals(g_cpu))
        t_cpu += time.perf_counter() - t0
        if not all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)):
            bad.append(name)
        n_el += g.numel()
    if bad:
        raise RuntimeError(f"{label}: error_feedback_compress differs card "
                           f"vs CPU on {len(bad)} leaves: {bad[:8]}")
    log(f"{label}: error_feedback_compress on all {len(grads)} gradient "
        f"leaves ({n_el / 1e9:.3f} G elements, {t_card:.3f} s on the card "
        f"with a sync a leaf, {t_cpu:.3f} s on the CPU): q, scale and "
        f"residual bitwise the CPU's")


def phase_dense_train(torch, fa, dev) -> dict:
    """Phase 43: qwen2.5-3b at full width trains as phase 24's first run,
    with a profiled step; one more step's gradients through
    ``compress_check``; then glm4-9b cut to GLM_TRAIN_LAYERS."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    t0 = time.perf_counter()
    out = {"bwd": 0, "fwd": 0}
    arch = "qwen2_5_3b"
    argv = ["--arch", arch] + TRAIN_ARGS[2:]
    state, step_fn, pipe, run = train_checked(
        torch, fa, launch_train, dev, argv, 4, f"train {arch}")
    med, tokens = run["median_step_s"], 8 * 128
    log(f"train {arch} full width: {run['n_params'] / 1e9:.3f} B "
        f"parameters, {run['n_layers']} layers, bf16, batch 8 x seq 128; "
        f"median step (steps 2-4) {med:.4f} s, {tokens / med:.1f} "
        f"tokens/s; flash_attention_bwd launches {run['launches']} "
        f"({run['launches'] // 4} a step, all on the wgmma route), forward "
        f"launches {run['fwd']} (remat: 2 a layer); peak memory "
        f"{run['peak'] / 2**30:.2f} GiB ({run['peak'] / 1e9:.2f} GB)")
    prof = profile_step(torch, step_fn, state, pipe, f"train {arch}")
    out.update(bwd=run["launches"], fwd=run["fwd"], qwen=run, prof=prof)
    batch = {k: torch.as_tensor(v).long().to(dev)
             for k, v in pipe.next_batch().items()}
    _, grads = grads_of(torch, state.params, get_config(arch), batch)
    del state, step_fn, pipe
    compress_check(torch, grads, f"{arch} full width, one step's gradients")
    del grads
    full = get_config("glm4_9b")
    for n_layers in GLM_TRAIN_LAYERS:
        torch.cuda.empty_cache()
        cut = dataclasses.replace(full, n_layers=n_layers)
        label = f"train glm4_9b {n_layers} of {full.n_layers} layers"
        argv = ["--arch", "glm4_9b", "--steps", str(GLM_TRAIN_STEPS)] + \
            TRAIN_ARGS[4:]
        try:
            state, step_fn, pipe, glm = train_checked(
                torch, fa, launch_train, dev, argv, GLM_TRAIN_STEPS, label,
                cfg=cut)
        except torch.cuda.OutOfMemoryError:
            log(f"{label}: out of memory on this card; the next depth")
            state = step_fn = pipe = None
            continue
        gmed = glm["median_step_s"]
        log(f"{label}: {glm['n_params'] / 1e9:.3f} B parameters, bf16, "
            f"batch 8 x seq 128; median step (steps 2-{GLM_TRAIN_STEPS}) "
            f"{gmed:.4f} s, {tokens / gmed:.1f} tokens/s; "
            f"flash_attention_bwd launches {glm['launches']} (all on the "
            f"wgmma route); peak memory {glm['peak'] / 2**30:.2f} GiB")
        out["bwd"] += glm["launches"]
        out["fwd"] += glm["fwd"]
        out["glm"] = dict(glm, layers=n_layers)
        del state, step_fn, pipe
        break
    if "glm" not in out:
        raise RuntimeError(f"train glm4_9b: no depth of {GLM_TRAIN_LAYERS} "
                           "fits")
    torch.cuda.empty_cache()
    log(f"phase 43: {time.perf_counter() - t0:.1f} s")
    return out


# phase 44: the mesh path on the card (qwen3-4b at phase 24's width and
# batch, 3 steps), the dry run of that state's cell on the 1 x 1 mesh
# (a train shape of 8 x 128, given to the cell function) and one
# production cell in a subprocess
MESH_STEPS = 3
MESH_CELL = ("train_8x128", 128, 8)
DRYRUN_CELL = r"""
import json, sys
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
name, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
trace, aux = dryrun.lower_cell(get_config("qwen3_4b"),
                               ShapeSpec(name, seq, batch, "train"),
                               make_host_mesh())
rec = trace()
rec.pop("events")
print(json.dumps({**rec, **aux}))
"""


def same_bits(torch, a, b) -> bool:
    """``a`` and ``b`` (on one device) hold the same bits."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


# an odd 64-bit constant (the golden ratio's bits) that spreads the
# weights of bits_digest
GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


def bits_digest(torch, x, chunk: int = 1 << 26):
    """A float32 leaf's bits on the card as two int64 sums: of its
    32-bit words, and of each word times an odd weight of its position
    (mod 2^64, as int64 arithmetic wraps). One element that differs
    always changes the second sum (an odd weight times a nonzero word
    difference under 2^32 is not 0 mod 2^64), so two leaves' digests
    differ wherever one element's bits do; leaves that differ in many
    elements have the same digests only if both sums cancel at once."""
    words = x.detach().reshape(-1).view(torch.int32)
    plain = torch.zeros((), dtype=torch.int64, device=x.device)
    weighted = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, words.numel(), chunk):
        w = words[lo:lo + chunk].long()
        pos = torch.arange(lo, lo + w.numel(), dtype=torch.int64,
                           device=x.device)
        plain += w.sum()
        weighted += (w * (pos.mul_(GOLDEN) | 1)).sum()
    return torch.stack([plain, weighted])


def mesh_steps(torch, step_fn, state, pipe, n) -> tuple:
    losses = []
    for _ in range(n):
        state, m = step_fn(state, pipe.next_batch())
        losses.append(m["loss"])
    return state, [float(x) for x in torch.stack(losses).cpu()]


def phase_mesh_train(torch, fa, dev) -> dict:
    """Phase 44: qwen3-4b at full width trains MESH_STEPS steps at 8 x 128
    through ``launch.train.setup`` with ``--model-shards 1`` (the state
    placed on the 1 x 1 host mesh, ``train.loop``'s step over it); the
    digests of its m and v taken on the card (``bits_digest``);
    ``elastic_remesh`` onto the 1 x 1 mesh (every leaf kept, nothing
    moved); the parameters saved under the temp directory, zeroed and
    restored through ``checkpoint``; then, with the mesh run's m and v
    freed (its restored parameters kept on the card, 8.8 GB), the step
    called without a mesh from the same seed: losses and every
    parameter (against the restored ones: the step's and the
    checkpoint's bits at once) bit for bit, m and v by their digests.
    The state's build on the card (the allocator's requested bytes, and
    its allocated bytes) against the dry run's state bytes of the same
    cell on the 1 x 1 mesh, and ``xlstm_350m x decode_32k`` dry-run on
    the 256-rank pod, both in subprocesses beside the card's work."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import is_placed
    from repro_torch.train.loop import (elastic_remesh, init_train_state,
                                        make_train_step,
                                        train_state_shardings)
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CELL, *map(str, MESH_CELL)],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
            subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "xlstm_350m", "--shape", "decode_32k", "--out", out_dir],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)]
        try:
            argv = ["--arch", "qwen3_4b", "--steps", str(MESH_STEPS),
                    "--batch", str(MESH_CELL[2]), "--seq", str(MESH_CELL[1]),
                    "--device", "cuda", "--model-shards", "1"]
            args = launch_train.parse_args(argv)
            torch.cuda.empty_cache()
            key = "requested_bytes.all.current"
            req0 = torch.cuda.memory_stats(dev).get(key)
            alloc0 = torch.cuda.memory_allocated(dev)
            cfg, state, step_fn, pipe = launch_train.setup(args, dev)
            req = torch.cuda.memory_stats(dev).get(key)
            built = {"allocated": torch.cuda.memory_allocated(dev) - alloc0,
                     "requested": None if req is None else req - req0}
            placed = [x for x in list(state.params.parameters())
                      + list(state.opt.m.values())
                      + list(state.opt.v.values()) if is_placed(x)]
            if placed:
                raise RuntimeError(f"mesh train: {len(placed)} placed leaves "
                                   "on the 1 x 1 mesh")
            split = {"setup": time.perf_counter() - t0}
            fa.flash_attention.launches = 0
            fa.flash_attention_bwd.launches = 0
            t1 = time.perf_counter()
            state, losses = mesh_steps(torch, step_fn, state, pipe,
                                       MESH_STEPS)
            mesh_s = split["mesh steps"] = time.perf_counter() - t1
            fwd = fa.flash_attention.launches
            bwd = fa.flash_attention_bwd.launches
            n_layers = cfg.n_layers
            if bwd != MESH_STEPS * n_layers or fwd != 2 * bwd:
                raise RuntimeError(f"mesh train: {fwd} forward and {bwd} "
                                   f"gradient flash launches in {MESH_STEPS} "
                                   f"steps of {n_layers} layers")
            t1 = time.perf_counter()
            digests = {t: {n: bits_digest(torch, x)
                           for n, x in getattr(state.opt, t).items()}
                       for t in ("m", "v")}
            torch.cuda.synchronize(dev)
            split["m and v digests"] = time.perf_counter() - t1
            before = {n: p for n, p in state.params.named_parameters()}
            mv = (dict(state.opt.m), dict(state.opt.v))
            state = elastic_remesh(state, train_state_shardings(
                cfg, make_host_mesh(), state.params))
            moved = [n for n, p in state.params.named_parameters()
                     if p is not before[n]]
            moved += [n for n in mv[0] if state.opt.m[n] is not mv[0][n]
                      or state.opt.v[n] is not mv[1][n]]
            if moved:
                raise RuntimeError(f"elastic_remesh onto 1 x 1 moved "
                                   f"{moved[:4]}")
            t1 = time.perf_counter()
            with tempfile.TemporaryDirectory() as ck:
                save(ck, MESH_STEPS, state.params)
                with torch.no_grad():
                    for p in state.params.parameters():
                        p.zero_()
                restore(ck, MESH_STEPS, state.params)
                ck_bytes = sum(os.path.getsize(os.path.join(ck, f))
                               for f in os.listdir(ck))
            ck_s = split["checkpoint"] = time.perf_counter() - t1
            kept = state.params
            n_leaves = 3 * len(before)
            del state, step_fn, before, mv
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            gen = torch.Generator(device=dev)
            gen.manual_seed(args.seed)
            plain = init_train_state(init_params(gen, cfg))
            plain_step = make_train_step(cfg, peak_lr=args.lr,
                                         total_steps=args.steps,
                                         warmup=max(args.steps // 20, 5),
                                         accum=args.accum)
            pipe = SyntheticTokenPipeline(cfg, args.batch, args.seq,
                                          seed=args.seed)
            plain, plain_losses = mesh_steps(torch, plain_step, plain, pipe,
                                             MESH_STEPS)
            split["plain run"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            ours = dict(kept.named_parameters())
            bad = [f"p.{n}" for n, p in plain.params.named_parameters()
                   if not same_bits(torch, ours[n], p)]
            bad += [f"{t}.{n}" for t in ("m", "v")
                    for n, x in getattr(plain.opt, t).items()
                    if not torch.equal(bits_digest(torch, x),
                                       digests[t][n])]
            split["compare"] = time.perf_counter() - t1
            if bad or plain_losses != losses:
                raise RuntimeError(f"mesh step (its parameters through the "
                                   f"checkpoint) vs the step without a "
                                   f"mesh: losses {losses} vs "
                                   f"{plain_losses}, leaves that differ "
                                   f"{bad[:6]} of {n_leaves}")
            del plain, plain_step, kept, ours, digests
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            outs = [p.communicate(timeout=300) for p in procs]
            split["dry runs' wait"] = time.perf_counter() - t1
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for p, (o, e) in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"dry run subprocess: exit {p.returncode}"
                                   f"\n{o[-3000:]}\n{e[-3000:]}")
        rec_path = os.path.join(out_dir,
                                "xlstm_350m__decode_32k__pod256.json")
        with open(rec_path) as f:
            pod = json.load(f)
    cell = json.loads(outs[0][0].strip().splitlines()[-1])
    batch_bytes = 2 * MESH_CELL[2] * MESH_CELL[1] * 4
    args_state = cell["memory"]["argument_size_in_bytes"] - batch_bytes
    if args_state != cell["state_bytes"] or cell["state_leaves"] != n_leaves:
        raise RuntimeError(f"dry run: argument bytes less the batch "
                           f"{args_state} vs state bytes "
                           f"{cell['state_bytes']}, {cell['state_leaves']} "
                           f"leaves vs the card's {n_leaves}")
    slack = 512 * n_leaves
    exact = built["requested"]
    ok_req = exact is None or 0 <= exact - args_state <= slack
    ok_alloc = 0 <= built["allocated"] - args_state
    if not (ok_req and ok_alloc):
        raise RuntimeError(f"dry run state bytes {args_state} vs the card's "
                           f"build: requested {exact}, allocated "
                           f"{built['allocated']} (within 512 B a leaf)")
    if pod["n_devices"] != 256 or not pod["cost"]["flops"] > 0:
        raise RuntimeError(f"xlstm_350m x decode_32k on pod256: {pod}")
    log(f"mesh train qwen3_4b full width, --model-shards 1 (1 x 1 mesh), "
        f"batch {MESH_CELL[2]} x {MESH_CELL[1]}: losses {losses} bitwise the "
        f"step's without a mesh, all {n_leaves // 3} parameters bitwise and "
        f"all {2 * n_leaves // 3} m and v leaves by their bits' digests; "
        f"{MESH_STEPS} steps {mesh_s:.3f} s; flash launches {fwd} forward, "
        f"{bwd} gradient; elastic_remesh onto 1 x 1 kept every leaf; "
        f"checkpoint of the parameters ({ck_bytes / 1e9:.2f} GB) saved, "
        f"zeroed and restored in {ck_s:.2f} s (under the temp directory), "
        f"bitwise the plain step's parameters")
    log("phase 44 split: " + ", ".join(f"{k} {v:.1f} s"
                                        for k, v in split.items()))
    log(f"dry run of that cell on the 1 x 1 mesh: parameters + m + v "
        f"{args_state} B in {cell['state_leaves']} leaves; the card's build "
        f"requested {exact} B ({None if exact is None else exact - args_state}"
        f" more), allocated {built['allocated']} B "
        f"({built['allocated'] - args_state} more: the caching allocator "
        f"keeps a large block's unsplit remainder); flops "
        f"{cell['cost']['flops']:.4e}, temp {cell['memory']['temp_size_in_bytes']}"
        f" B; {card_line()}")
    log(f"dry run xlstm_350m x decode_32k on pod256: {json.dumps(pod)}")
    log(f"phase 44: {time.perf_counter() - t0:.1f} s")
    return {"fwd": fwd, "bwd": bwd}


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
    main_b = phase_flash_bwd(torch, fa, dev)                         # 23
    trained = phase_train(torch, fa, dev)                            # 24
    main_d = phase_decode(torch, dev)                                # 25
    main_s = phase_scan(torch, dev)                                  # 26
    rg = phase_recurrentgemma(torch, fa, dev)                        # 27
    main_x = phase_xlstm_kernels(torch, dev)                         # 28
    xl = phase_xlstm(torch, dev)                                     # 29
    main_c = phase_cross_kernels(torch, fa, dev)                     # 30
    vis = phase_vision(torch, fa, dev)                               # 31
    hub = phase_hubert(torch, fa, dev)                               # 32
    main_g = phase_scan_bwd(torch, dev)                              # 33
    rgt = phase_rg_train(torch, fa, dev)                             # 34
    phi = phase_moe_serve(torch, fa, dev, "phi3_5_moe")              # 35
    mix = phase_moe_serve(torch, fa, dev, "mixtral_8x22b")           # 36
    moet = phase_moe_train(torch, fa, dev)                           # 37
    main_xb = phase_xlstm_bwd(torch, dev)                            # 38
    xlt = phase_xlstm_train(torch, dev)                              # 39
    vist = phase_vision_train(torch, fa, dev)                        # 40
    dense = phase_dense_serve(torch, fa, dev)                        # 41
    dense_l = phase_dense_logits(torch, fa, dev)                     # 42
    dense_t = phase_dense_train(torch, fa, dev)                      # 43
    mesh_t = phase_mesh_train(torch, fa, dev)                        # 44
    hub_p = phase_hubert_pipeline(torch, fa, dev)                    # 45
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
                   "launches": served["launches"] + vis["flash"]
                   + hub["fwd_launches"] + rgt["launches"][0]
                   + phi["flash"] + mix["flash"] + moet["fwd"]
                   + vist["fwd"] + dense["flash"] + dense_l["flash"]
                   + dense_t["fwd"] + mesh_t["fwd"],
                   "max_abs_err": max(main_f["max_abs_err"],
                                      served["max_abs_err"],
                                      main_c["flash_err"],
                                      dense["max_abs_err"]),
                   "ms": flash["ms"],
                   "plain_ms": flash["plain_ms"],
                   "bound_ms": flash["bound_ms"],
                   "bound_by": flash["bound_by"],
                   "library_ms": flash["library_ms"]}
    bwd_entry = {"name": "flash_attention_bwd", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:25 "
                             "(its gradient: JAX autodiff of "
                             "src/repro/models/attention.py:29)",
                 "launches": trained["launches"] + hub["launches"]
                 + moet["bwd"] + vist["bwd"] + dense_l["bwd"]
                 + dense_t["bwd"] + mesh_t["bwd"],
                 "max_abs_err": max(main_b["max_abs_err"],
                                    main_c["bwd_err"]),
                 "ms": main_b["ms"],
                 "plain_ms": main_b["plain_ms"],
                 "bound_ms": main_b["bound_ms"],
                 "bound_by": main_b["bound_by"],
                 "library_ms": main_b["library_ms"]}
    # the float32 routes (split TF32) at hubert-xlarge's training shape,
    # launched on phase 45's pipeline-fed training
    f32 = main_b["f32"][FLASH_F32_TIMED[-1]]
    flash_f32_entry = {**flash_entry, "name": "flash_attention_f32",
                       "launches": hub_p["fwd"],
                       "max_abs_err": main_f["f32_err"],
                       **{key: f32["fwd"][key] for key in (
                           "ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms")}}
    bwd_f32_entry = {**bwd_entry, "name": "flash_attention_bwd_f32",
                     "launches": hub_p["launches"],
                     "max_abs_err": max([main_b["f32_err"]] + [
                         t["bwd"]["err"] for t in main_b["f32"].values()]),
                     **{key: f32["bwd"][key] for key in (
                         "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms")}}
    rgb = main_b["rg"]
    bwd256_entry = {"name": "flash_attention_bwd_hd256", "route": "cuda",
                    "source": "src/repro_torch/csrc/"
                              "flash_attention_bwd_wgmma.cuh",
                    "replaces": bwd_entry["replaces"],
                    "launches": rgt["launches"][1],
                    "max_abs_err": rgb["max_abs_err"], "ms": rgb["ms"],
                    "plain_ms": rgb["plain_ms"],
                    "bound_ms": rgb["bound_ms"],
                    "bound_by": rgb["bound_by"],
                    "library_ms": rgb["library_ms"]}
    # the decode kernel's split route (qwen3-4b's groups of 4) and its
    # grouped route (G > 4: glm4-9b's 16 timed), launches partitioned
    dec = main_d["timed"]["qwen3-4b bf16"]
    timed_d = [*main_d["timed"].values(), *dense["kernel"]["timed"].values(),
               *mix["ring"]["timed"].values()]
    n_grouped = served["grouped"] + rg["grouped"] + phi["grouped"] \
        + mix["grouped"] + dense["grouped"]
    decode_entry = {"name": "decode_attention", "route": "cuda",
                    "source": "src/repro_torch/csrc/decode_attention.cu",
                    "replaces": "src/repro/models/attention.py:96 (plain "
                                "einsum decode; the JAX package has no "
                                "Pallas kernel there)",
                    "launches": served["decode_launches"] + rg["decode"]
                    + vis["decode"] + phi["decode"] + mix["decode"]
                    + dense["decode"] - n_grouped,
                    "max_abs_err": max(t["err"] for t in timed_d
                                       if t["route"] == "split"),
                    "ms": dec["ms"],
                    "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
                    "bound_by": dec["bound_by"],
                    "library_ms": dec["library_ms"]}
    grp = dense["kernel"]["timed"]["glm4-9b bfloat16"]
    grouped_entry = {**decode_entry, "name": "decode_attention_grouped",
                     "launches": n_grouped,
                     "max_abs_err": max(t["err"] for t in timed_d
                                        if t["route"] == "grouped"),
                     "ms": grp["ms"], "plain_ms": grp["plain_ms"],
                     "bound_ms": grp["bound_ms"],
                     "bound_by": grp["bound_by"],
                     "library_ms": grp["library_ms"]}
    scan = main_s["timed"][SCAN_TESTS[0]]
    scan_entry = {"name": "rglru_scan", "route": "cuda",
                  "source": "src/repro_torch/csrc/rglru_scan.cu",
                  "replaces": "src/repro/models/recurrent.py:73 "
                              "(lax.associative_scan; the JAX package has "
                              "no Pallas kernel there)",
                  "launches": rg["scan"] + rgt["launches"][2],
                  "max_abs_err": main_s["max_abs_err"], "ms": scan["ms"],
                  "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
                  "bound_by": scan["bound_by"], "library_ms": None}
    mlstm = main_x["mlstm"][MLSTM_TESTS[0]]
    mlstm_entry = {"name": "mlstm_scan", "route": "cuda",
                   "source": "src/repro_torch/csrc/mlstm_scan.cu",
                   "replaces": "src/repro/models/recurrent.py:124 "
                               "(lax.scan of _mlstm_cell; the JAX package "
                               "has no Pallas kernel there)",
                   "launches": xl["mlstm"] + xlt["launches"][0],
                   "max_abs_err": main_x["max_abs_err"]["mlstm"],
                   "ms": mlstm["ms"], "plain_ms": mlstm["plain_ms"],
                   "bound_ms": mlstm["bound_ms"],
                   "bound_by": mlstm["bound_by"], "library_ms": None}
    slstm = main_x["slstm"][SLSTM_TESTS[0]]
    slstm_entry = {"name": "slstm_scan", "route": "cuda",
                   "source": "src/repro_torch/csrc/slstm_scan.cu",
                   "replaces": "src/repro/models/recurrent.py:169 "
                               "(lax.scan of _slstm_cell; the JAX package "
                               "has no Pallas kernel there)",
                   "launches": xl["slstm"] + xlt["launches"][2],
                   "max_abs_err": main_x["max_abs_err"]["slstm"],
                   "ms": slstm["ms"], "plain_ms": slstm["plain_ms"],
                   "bound_ms": slstm["bound_ms"],
                   "bound_by": slstm["bound_by"], "library_ms": None}
    cross = main_c["decode"][CROSS_DECODE_TESTS[0][0]]
    cross_entry = {"name": "decode_attention_cross", "route": "cuda",
                   "source": "src/repro_torch/csrc/decode_attention.cu",
                   "replaces": "src/repro/models/attention.py:140 "
                               "(cross_attention's einsums at one decode "
                               "query; the JAX package has no Pallas "
                               "kernel there)",
                   "launches": vis["cross"],
                   "max_abs_err": main_c["max_abs_err"], "ms": cross["ms"],
                   "plain_ms": cross["plain_ms"],
                   "bound_ms": cross["bound_ms"],
                   "bound_by": cross["bound_by"],
                   "library_ms": cross["library_ms"]}
    scan_g = main_g["timed"][SCAN_BWD_TESTS[0]]
    scan_bwd_entry = {"name": "rglru_scan_bwd", "route": "cuda",
                      "source": "src/repro_torch/csrc/rglru_scan_bwd.cu",
                      "replaces": "src/repro/models/recurrent.py:64 (JAX "
                                  "autodiff of rglru_sequence's "
                                  "lax.associative_scan through "
                                  "_rglru_coeffs; the JAX package has no "
                                  "Pallas kernel there)",
                      "launches": rgt["launches"][3],
                      "max_abs_err": main_g["max_abs_err"],
                      "ms": scan_g["ms"], "plain_ms": scan_g["plain_ms"],
                      "bound_ms": scan_g["bound_ms"],
                      "bound_by": scan_g["bound_by"], "library_ms": None}
    mlstm_g = main_xb["mlstm"][MLSTM_BWD_TESTS[0]]
    mlstm_bwd_entry = {"name": "mlstm_scan_bwd", "route": "cuda",
                       "source": "src/repro_torch/csrc/mlstm_scan_bwd.cu",
                       "replaces": "src/repro/models/recurrent.py:101 (JAX "
                                   "autodiff of mlstm_sequence's lax.scan "
                                   "of _mlstm_cell; the JAX package has no "
                                   "Pallas kernel there)",
                       "launches": xlt["launches"][1],
                       "max_abs_err": main_xb["max_abs_err"]["mlstm"],
                       "ms": mlstm_g["ms"], "plain_ms": mlstm_g["plain_ms"],
                       "bound_ms": mlstm_g["bound_ms"],
                       "bound_by": mlstm_g["bound_by"], "library_ms": None}
    slstm_g = main_xb["slstm"][SLSTM_BWD_TESTS[0]]
    slstm_bwd_entry = {"name": "slstm_scan_bwd", "route": "cuda",
                       "source": "src/repro_torch/csrc/slstm_scan_bwd.cu",
                       "replaces": "src/repro/models/recurrent.py:148 (JAX "
                                   "autodiff of slstm_sequence's lax.scan "
                                   "of _slstm_cell; the JAX package has no "
                                   "Pallas kernel there)",
                       "launches": xlt["launches"][3],
                       "max_abs_err": main_xb["max_abs_err"]["slstm"],
                       "ms": slstm_g["ms"], "plain_ms": slstm_g["plain_ms"],
                       "bound_ms": slstm_g["bound_ms"],
                       "bound_by": slstm_g["bound_by"], "library_ms": None}
    log(json.dumps({"kernels": [fused_entry, matmul_entry, flash_entry,
                                flash_f32_entry, bwd_entry, bwd_f32_entry,
                                bwd256_entry, decode_entry,
                                grouped_entry, cross_entry, scan_entry,
                                scan_bwd_entry,
                                mlstm_entry, mlstm_bwd_entry, slstm_entry,
                                slstm_bwd_entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
