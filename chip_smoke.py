#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, started together) and runs, in order,
printing one JSON line per phase:

1. build         — compile ``hist_update.cu``, ``fifo_compact.cu``,
                   ``flash_attention.cu``,
                   ``flash_attention_backward.cu``,
                   ``decode_attention.cu``,
                   ``decode_attention_int8.cu``, ``ssd_scan.cu``,
                   ``ssd_scan_backward.cu``, ``mla_decode.cu`` and
                   ``campaign_fold.cu``; the card's name and power limit
                   from nvidia-smi.  Then the dry runs (below) and, in
                   three spawned worker processes, the host mirrors'
                   seed ladders (numpy loops, no device) that
                   gen_user_size and the loss, failure and fleet
                   contracts gate on, read by those phases.
2. kernel        — the CUDA ``hist_update`` against its plain torch
                   version on random blocks (lognormal latencies, an
                   i.i.d. 50% mask) of each path's user-size shape: the
                   sweep's (8,160 points, 32 × 768 block; full 512-bin
                   and 64-bin sketch modes) and the generate sweep's
                   (8,192 points, 16 × 64), and on a thinned generate
                   block whose size is not a multiple of 16 (8,192 × 5
                   × 63): counts bit for bit, sums within rtol 1e-6;
                   kernel, plain, library (one ``scatter_add_`` over
                   precomputed bins) and bound times.  The bound is
                   ``hist_update_min_bytes`` (32-byte sectors counted
                   on the block) over 3.35 TB/s; ``bound_ms_bytes4`` is
                   the earlier count (every included latency at 4
                   bytes, every row whole), kept for comparison.
3. fifo_compact  — the CUDA ``fifo_compact`` against its plain version
                   at the generate sweep's user-size shape (8,192 ×
                   1,409, random k and now): bit for bit; kernel,
                   plain, library (one ``torch.gather`` with its index
                   built beforehand) and bound times.
4. hist_cases    — the CUDA ``hist_update`` bit for bit against its
                   plain version, launched twice, on blocks random
                   inputs never give: ``bit_bins``' special values (±0,
                   denormals, ±inf, ±NaN, negatives, every bin edge),
                   all entries in one bin, the sweep's prefix masks,
                   n_bins 100 and 101, odd sizes (4,100 × 5 × 63, 33 ×
                   5 × 7, 37 × 7 × 1,001) and misaligned bases, in full
                   and sketch mode, covering one warp and one block a
                   point, the vector and the scalar loop and both
                   flushes; and ``fifo_compact`` at k ∈ {0, 1, n − 1,
                   n}, small k, an odd row of 77 and a misaligned
                   buffer.
5. contracts     — Threefry known-answer vectors on the card, and a
                   split sweep dispatch bitwise equal to the whole one.
6. main          — ``evaluate(SweepGrid.from_rhos([.1 … .9], V100),
                   backend="sweep", n_batches=4000, q_cap=1024,
                   seed=7)``: no buffer drops, mean latency at φ
                   (ρ ≥ 0.3), Remark 5, one kernel launch per superstep.
7. user_size     — the examples/sweep_grid.py grid at 8,192 requested
                   points (8,160 run), n_batches=3000, q_cap=768,
                   seed=0: no drops, the example's Theorem 2 / Remark 5
                   checks, wall time (first call and warm), jobs/s, peak
                   memory, kernel launches.  The first run clones the
                   block of superstep 60 of 94 as the kernel received it
                   (a further run, as deterministic, would stop there
                   with the same bits), and a ``path_kernel`` line
                   times ``hist_update`` on that block as ``kernel``
                   does on random ones.
8. gen_contracts — the generate sweep on the card: split dispatch
                   bitwise equal to the whole one, the two disciplines
                   bitwise equal at max_active = 1, and a hist_every=3
                   run whose blocks are 5 × 31 (no multiple of 16)
                   without drops, each of its hist_update calls held
                   bit for bit against the plain version.
9. gen_user_size — ``gen_sweep`` on the benchmarks/continuous.py grid
                   (16 ρ × gen_tokens 8/32/64/256 × max_active
                   8/16/32/64 × both disciplines, prompt 128) tiled 16
                   times into 8,192 points, n_steps=4096, adaptive caps:
                   no drops, every static point within max(3·CI, 4%) of
                   the port's ``sweep`` at its equivalent request-level
                   law, two continuous points against the port's exact
                   numpy loop (3σ over 3 seeds), wall time (first and
                   warm), requests/s, peak memory, launches of both
                   kernels (one each per 16-step superstep).  Both
                   kernels' inputs at superstep 160 of 256 are cloned
                   from the first run as in ``user_size``, and timed in
                   two ``path_kernel`` lines.
10. loss_contracts — the loss paths on the card: the neutral points of a
                   mixed loss grid bitwise equal to the loss-free path
                   (both sweeps), split dispatch with loss bitwise (caps,
                   r_cap included, pinned from the full grid), and
                   tests/test_backpressure.py's seed ladders (3 sweep and
                   2 generate configurations, 6 copies each) against the
                   port's own ``loss_ref`` mirrors on 3 seeds, 3σ with
                   floors of 1.5% and 0.004; the exact accounting laws;
                   one hist_update (and fifo_compact) launch per
                   superstep of every loss run.
11. loss_user_size — the benchmarks/backpressure.py grid (V100 law,
                   b_max 8, 4 ρ × 4 rooms × 3 deadlines × 2 overflow
                   modes × 2 retry rates = 192 points) tiled 43 times
                   into 8,256, n_batches=3000, a_cap 64, r_cap 96, seed
                   29: two runs bitwise equal, no buffer drops, the
                   accounting laws, reject_frac falling as q_max grows;
                   the benchmark's frontier and retry tax as tile means
                   with standard errors; wall time (first and warm),
                   jobs/s, peak memory.  Superstep 60's hist_update
                   block, cloned in the first run, timed as a
                   ``path_kernel`` line.
12. gen_loss_user_size — ``gen_user_size``'s grid with loss tiles (0–3
                   neutral, 4–7 reject at q_max 20, 8–11 drop at q_max 20
                   with retries, 12–15 reject with retries and a deadline
                   of twice the unloaded latency), its caps pinned and
                   r_cap from the loss grid: tiles 0–3 bitwise equal to
                   ``gen_user_size``'s points, no drops, the accounting
                   laws, launch counts; superstep 160's hist_update and
                   fifo_compact inputs (rows of the loss buffer length)
                   timed as ``path_kernel`` lines.

13. fail_contracts — the failure paths on the card: the mtbf = 0
                   points of a failure grid bitwise equal to the
                   failure-free path (the sweep with and without a drop
                   point, the generate sweep without), split dispatch with
                   failures bitwise (caps pinned from the full grid) and
                   an unpinned chunk refused, tests/test_failures.py's
                   seed ladders (resume, restart, and drop with throttle
                   0.85; 6 copies each, both sweeps) against the port's
                   ``loss_ref`` failure mirrors on 3 seeds, 3σ with floors
                   of 1.5% and 0.004, resume and restart (8 copies each)
                   against the port's exact completion-time chain, the
                   exact accounting laws, no truncated failure count and
                   resume's breakdowns at rate 1/MTBF over the busy
                   time, one hist_update (and fifo_compact) launch per
                   superstep.
14. fail_user_size — benchmarks/availability.py's single-server cells
                   (V100 law, b_max 8: 2 ρ × 3 (mtbf, mttr) pairs × 3
                   disciplines and 8 resume chain cells = 26) tiled 316
                   times into 8,216 points, n_batches=3000, q_cap sized
                   as the benchmark sizes it and a_cap = q_cap, r_cap 64,
                   seed 31: two runs bitwise equal, no buffer drops,
                   no truncated failure count, resume's breakdowns at
                   rate 1/MTBF, availability and the fractions' sum; the harsh/baseline
                   latency ratio per discipline at ρ 0.75 and the chain
                   cells' |z| against the port's chain, as tile means;
                   wall time (first and warm), jobs/s, peak memory.
                   Superstep 60's hist_update block, cloned in the first
                   run, timed as a ``path_kernel`` line.
15. gen_fail_user_size — ``gen_user_size``'s grid with failure tiles
                   (0–3 failure-free, 4–7 resume and 12–15 drop at mtbf
                   200 / mttr 5 ms, 8–11 restart at mtbf 20,000, odd
                   tiles throttle 0.85) and its own ``gen_caps``: tiles
                   0–3 bitwise equal to a failure-free run of the same
                   points with those caps pinned, no drops, no truncated
                   failure count, resume's breakdowns at rate 1/MTBF,
                   the longest static run's resume copies against the
                   mirror, the bands' availability, work loss and
                   abandonment, launch
                   counts, wall time and requests/s of one run;
                   superstep 160's hist_update and fifo_compact inputs
                   timed as ``path_kernel`` lines.

16. fleet_contracts — the k-replica fleet on the card: one mixed grid
                   (a loss point, a resume-restart and a drop failure
                   point, three neutral points, all three routings)
                   dispatched whole and in two chunks with
                   ``fleet_caps`` pinned, bitwise, an unpinned chunk
                   refused, and its neutral points bitwise equal to the
                   plain path; tests/test_fleet.py's grid (n_steps
                   4,992): k = 1 under each routing, the k = 4 random
                   split and the k = 1 timeout point against the port's
                   ``sweep`` within 3σ, the round-robin balance, JSQ at
                   k 4 against ``simulate_jsq_numpy`` (3 seeds); the
                   FL_CFG loss and failure ladders of
                   tests/test_backpressure.py and tests/test_failures.py
                   (12 copies each, 4,000 steps, one dispatch) against
                   the port's ``simulate_fleet_loss_numpy`` at 3σ;
                   accounting, ``buffer_dropped == 0``,
                   ``fail_truncated == 0``, resume's breakdowns at
                   1/MTBF, one hist_update launch per superstep.
17. fleet_user_size — benchmarks/replicas.py's grid (11 total loads × k
                   1…16 × random / round-robin / JSQ = 528 points)
                   tiled 16 times into 8,448 fleets, n_steps 4,000,
                   a_cap 32, hist_every 4, seed 17: two calls bitwise
                   equal, no drops, first and warm wall, jobs/s, peak
                   memory, the JSQ/random E[W] ratio at k 16 and the
                   ρ1 0.8 curve as tile means; superstep 60's
                   hist_update block (8,448 × 8 × 256), cloned in the
                   first run, as a ``path_kernel`` line.
18. fleet_fail_user_size — benchmarks/availability.py's fleet half (2 ρ
                   × k 1, 4 × 3 (mtbf, mttr) pairs × 3 disciplines = 36
                   JSQ points, b_max 8) tiled 228 times into 8,208,
                   q_cap 512 as the benchmark sizes it, a_cap 64, r_cap
                   64, n_steps 6,000, seed 31: no drops, no truncated
                   failure count, resume's breakdowns at 1/MTBF,
                   availability per cell and the harsh/baseline E[W]
                   per discipline at ρ 0.75, k 4, as tile means; one
                   timed run; superstep 60's block (8,208 × 32 × 8) as
                   a ``path_kernel`` line.
19. chain_grid   — examples/exact_surface.py's MarkovGrid (24 load
                   fractions × b_max 1…128 = 192 cells) through
                   ``solve_grid`` on the card (float64, adaptive K):
                   E[W], utilization and E[B] within rel 1e-10 and
                   ``tail_mass`` within 1e-12 of the host's GTH
                   recursion and of ``method="numpy"`` on every cell
                   (the banded host solve falls back to GTH on ROADMAP
                   C-R2's two cells, which are reported); K, V, wall,
                   peak memory.
20. campaign_fold — the CUDA ``campaign_fold`` against its plain
                   version, bit for bit, on random chunks of the
                   campaign path's shapes (8,192 × 512 counts; 8,192 ×
                   64 in sketch mode with the per-bin sums), with and
                   without the loss counters, NaN / inf points, tied
                   values and a padded tail, ``k_top`` up to 2,048 (the
                   lists past 1,908 slots walked in the accumulator's
                   device memory), and the campaign path's
                   own case (a loss grid, every lane valid), two
                   chunks in a row, each fold launched twice and held
                   bitwise; kernel, plain and bound times (bytes once
                   over 3.35 TB/s).
21. campaign_contracts — the campaign driver on the card: chunked =
                   whole bitwise on the CPU tests' sweep, fleet,
                   generate and sketch grids, with exactly one B1
                   launch a superstep a chunk, one B2 launch a
                   superstep a chunk on the generate grid and one fold
                   launch a chunk; ``verify_resume``; the dispatch,
                   NaN and corrupt-checkpoint faults and their
                   recoveries, bitwise; tapped = untapped
                   (``tap_every=2``); the serial driver against a
                   six-seed pipelined ladder within 3σ; the adaptive
                   mode on benchmarks/adaptive.py's 144-point grid
                   (n_batches 2,048, pilot 128, safety 6, seed 7): the
                   fixed baseline's max CI, the adaptive run's matched
                   precision and job savings, ``buffer_dropped == 0``,
                   the fixed-allocation witness bitwise at two chunk
                   sizes; every clean run quarantines nothing.
22. campaign_user_size — benchmarks/campaign.py's 1,048,576-point grid
                   in 128 chunks of 8,192 (n_batches 32, seed 11,
                   checkpoints every 8 chunks): two runs bitwise equal,
                   exact launch counts, no drops and no quarantine;
                   wall, points/s, jobs/s, peak host result bytes,
                   percentiles, the worst cells; the busy share of a
                   profiled 4-chunk run; the chunk witness (the first
                   131,072 points at chunk 8,192 and 32,768, equal
                   fingerprints); chunk 12's B1 block, captured
                   mid-run, timed as a ``path_kernel`` line.

23. attn_kernel   — the CUDA ``flash_attention`` and ``decode_attention``
                   against their plain versions (float32 matmuls, TF32
                   off): at the serve path's shapes (batch 1…32, prompt
                   32, cache 37, 16 heads of 64, bf16), at the long
                   serve shapes (32 × 1,024, cache 1,057) and at batch
                   1 on them (B4 splits the cache there), at
                   phi4-mini's GQA heads (24 over 8, hd 128), with a
                   window, ragged lengths (at batch 1 on the long cache
                   lengths that leave splits empty, and -1), and in
                   float32 at every width pair (GQA 32 over 8 × 128,
                   MLA's (192, 128), (32, 32), 32 queries over 1,500
                   keys, and a batch-1 prompt whose key axis splits):
                   bf16 within 2e-2 and float32 within 2e-5 max abs, a
                   row of length -1 exactly 0, and every case launched
                   twice with bitwise equal outputs; kernel, plain,
                   library (``scaled_dot_product_attention``) and bound
                   times at the serve, long and batch-1 shapes.  B3's
                   float32 operations are bounded at the 3xTF32 rate
                   (494.7 / 3 TFLOP/s), ``bound_ms_cuda_cores`` the same
                   work at the CUDA cores' 67.
24. serve        — ``python -m repro_torch.launch.serve --arch
                   qwen1.5-0.5b --full --workload generate --rho 0.5
                   --jobs 300 --max-batch 32`` through its ``run``: all
                   jobs served with finite latencies, τ^[b] per bucket,
                   α, τ0, R², E[W] against φ, p99, utilisation, peak
                   memory under the card's, tokens in the vocabulary,
                   finite logits, and exactly 24 ``flash_attention`` and
                   24 × 4 ``decode_attention`` launches per batch, over
                   the run and over one more batch.  ``serve_ssm``,
                   ``serve_moe``, ``serve_int8``, ``serve_mla`` and
                   ``serve_hybrid`` run the same gates (one helper,
                   ``_serve_model``), each with its own launch counts;
                   on a MoE model also a positive aux loss and the
                   dropped-token share at b 1 and 32.
25. serve_long   — the same model generating 32 tokens after a 1,024-
                   token prompt, ``calibrate(samples=3)`` on batches
                   1…32, then 300 Poisson requests at ρ = 0.5: τ^[b],
                   α, τ0, R², E[W] against φ, p99, peak memory, exact
                   launch counts.
26. model_consistency — qwen1.5-0.5b at full width in float32 from the
                   port's seeded init, batch 2: prefill(32) and three
                   decode steps against the forward logits of all 35
                   tokens, within 3e-4 (abs + rel): the two kernels held
                   against each other through the whole model.
27. ssd_kernel   — the CUDA ``ssd_scan`` against its plain version
                   (float32 matmuls) at mamba2-2.7b's heads (80 × 64,
                   d_state 128, one group, B and C strided slices of
                   one activation as in the model): the serve shape
                   (B 32, S 32, bf16), the long shape (B 32, S 1,024),
                   ragged lengths (S 1,000 at B 32 and at B 1, where
                   the time axis is split), batch 1, 2 and 4 at S
                   1,024 (4, 2 and 1 pieces), batch 1 at S 32, one
                   float32 case and one with two groups: y and the
                   final state each within 2e-3 (bf16) and 1e-4
                   (float32) max abs, the reference API's y bit for bit
                   the model call's rounded to x's dtype, and every
                   case launched twice with bitwise equal y and
                   state; each case's split count; kernel, plain and
                   bound times (no single PyTorch call computes the
                   SSD, so no library time) of the serve, long, batch-1
                   and float32 (B 4 × 300) shapes; the float32 route
                   runs 3xTF32 on the tensor cores, bounded at 494.7 /
                   3 TFLOP/s with ``bound_ms_cuda_cores`` at 67 beside.
28. serve_ssm    — ``python -m repro_torch.launch.serve --arch
                   mamba2-2.7b --full --workload generate --rho 0.5
                   --jobs 300 --max-batch 32`` through its ``run``: all
                   jobs served with finite latencies, τ^[b], α, τ0, R²,
                   E[W] against φ, p99, utilisation, peak memory, and
                   exactly 64 ``ssd_scan`` launches and no attention
                   launch per batch.
29. ssm_consistency — mamba2-2.7b at full width in float32 from the
                   port's seeded init, batch 2: prefill(300), which
                   crosses a 256-token chunk, and three decode steps
                   against the forward logits of all 303 tokens, within
                   3e-4 (abs + rel): the kernel's final state held
                   against the eager recurrence.
30. kv_int8_kernel — B4's int8-cache form (``decode_attention_int8``)
                   against its plain version: the continuous pool's
                   shape (B 64, cache 161, qwen1.5-0.5b's heads), the
                   long shape (B 32, cache 1,057), batch 1 at 1,057, a
                   ragged batch at lengths -1, 0, 63, S-1, S and S+5,
                   phi4-mini's GQA heads with a window, and float32 q;
                   every case launched twice and held bit for bit, a
                   row of length -1 exactly 0; kernel, plain and bound
                   times, the bf16-cache B4's time at the same shape,
                   and SDPA over a cache dequantized beforehand (not the
                   same function, so the library time is null).
31. continuous_serve — ``ContinuousEngine`` on qwen1.5-0.5b at full
                   width and depth, bf16: prompt 128, 32 tokens, 64
                   slots (examples/continuous_batching.py's PROMPT and
                   CAP), 300 Poisson jobs at half the capacity measured
                   in warm-up, 1 / (prefill + 32 × step / 64): every job
                   served, 1 ≤ mean_active ≤ 64, exactly 24
                   ``flash_attention`` launches per admission and 24
                   ``decode_attention`` per decode step, an idle slot's
                   length past the cache; E[W], p50/p99, utilisation,
                   steps, prefill ms per admission and the decode
                   step's ms against the active count.  Slot isolation:
                   an 8-layer float32 copy admits four prompts at
                   staggered steps, and each one's first three decode
                   logits in the pool agree with its solo prefill +
                   decode within 1e-4.
32. serve_moe    — ``python -m repro_torch.launch.serve --arch
                   olmoe-1b-7b --full --workload generate --rho 0.5
                   --jobs 300 --max-batch 32`` (bf16, capacity factor
                   1.25) through its ``run``: as ``serve``, exactly 16
                   ``flash_attention`` and 16 × 4 ``decode_attention``
                   launches per batch, and the share of routed (token,
                   slot) pairs dropped over capacity in one batch at b 1
                   and at b 32.
33. moe_consistency — olmoe-1b-7b at full width in float32 with
                   capacity factor E / k (nothing dropped), batch 2:
                   prefill(300) + 3 decode steps against forward(303),
                   within 3e-4 (abs + rel).
34. serve_int8   — ``serve``'s command with ``REPRO_KV_INT8=1`` set for
                   this phase only: exactly 24 ``flash_attention`` and
                   24 × 4 ``decode_attention_int8`` launches per batch
                   and no float ``decode_attention``; the cache's bytes
                   counted exactly (int8 codes plus float32 scales,
                   ≈ 0.53× the bf16 cache's at hd 64); the first decode
                   step's max |Δlogit| and top-1 agreement against the
                   bf16 cache on the same 32 prompts.
35. hybrid_kernels — B5 at jamba-v0.1-52b's widths (128 heads of 64,
                   d_state 16, one group) against its plain version at
                   2e-3 (bf16) / 1e-4: the serve shape (B 32, S 32),
                   the long shape (S 1,024) and batch 1 at S 1,024
                   (split) timed, ragged S 1,000 at B 4 and B 1, float32
                   at B 32 × 32 and B 2 × 300 (timed), every case twice
                   bitwise; B3 and B4 at Jamba's attention heads (32
                   over 8 of 128) at the serve batches, batch 32 timed,
                   and in float32.
36. mla_kernel   — B3 at MLA's (qk 192, v 128) pair against its plain
                   version at 2e-2 / 2e-5 (the serve batches; B 32 at S
                   32 and 1,024 and B 1 at S 1,024 timed, with SDPA at
                   the same widths; windowed; float32), and the MLA
                   decode kernel against its plain version at 2e-5 on
                   the float32 context, with a bf16 and a float32 cache:
                   the serve cache (B 32, 37 slots), the long one (B 32,
                   1,057) and batch 1 on 1,057 timed (SDPA with
                   ``enable_gqa`` over [c_kv ‖ k_pe] against c_kv as its
                   library time), lengths -1, 0, 63, S - 1, S + 5,
                   ragged and windowed; every case twice bitwise, a row
                   of length -1 exactly 0.
37. serve_mla    — ``python -m repro_torch.launch.serve --arch
                   deepseek-v2-lite-16b --full --workload generate
                   --rho 0.5 --jobs 300 --max-batch 32`` (bf16, all 27
                   layers) through its ``run``: as ``serve_moe``,
                   exactly 27 ``flash_attention`` and 27 × 4
                   ``mla_decode`` launches and no B4 or B5 per batch,
                   the dropped-token share at b 1 and 32, peak memory
                   under the card's.
38. mla_consistency — deepseek-v2-lite-16b in float32, its first 8
                   layers (the dense lead and 7 MoE layers), capacity
                   factor E / k: prefill(300) + 3 decode steps against
                   forward(303) within 3e-4 (abs + rel).
39. serve_hybrid — ``launch.serve``'s ``run`` on jamba-v0.1-52b at full
                   width cut to its first 16 of 32 layers (attention at
                   4 and 12, MoE on the odd layers; the config is
                   passed to ``run``, as the command line has no depth
                   flag), bf16: as ``serve_mla``, exactly 2
                   ``flash_attention``, 2 × 4 ``decode_attention`` and
                   14 ``ssd_scan`` launches per batch.
40. hybrid_consistency — jamba-v0.1-52b in float32, its first 8 layers
                   (one period), capacity factor E / k: prefill(300),
                   which crosses the 256-token chunk, + 3 decode steps
                   against forward(303) within 3e-4.
41. encdec_kernels — B3 and B4 at whisper-medium's and internvl2-1b's
                   shapes against their plain versions at 2e-2 / 2e-5,
                   every case twice bitwise: B3 unmasked at the
                   encoder's S 1,500 (16 × 64, float32 as the engine's
                   frames make it; B 32 and 1 timed against SDPA), B3
                   with 32 queries over 1,500 keys (B 32, 4, 2 and 1
                   timed; at B 1, 2 and 4 the float32 key axis splits,
                   and each also runs with ``lse``, held within 2e-5 of
                   ``flash_attention_lse_plain``) and a ragged 7 over
                   1,499 in both dtypes, B4 over
                   the float32 cross cache at lengths 1,499 (B 32 and B
                   1, which splits, timed against SDPA with no mask),
                   B3 causal at InternVL2's 288 positions (14 over 2 ×
                   64) and B4 at its group of 7 over the 293-slot cache
                   (B 32 timed; ragged lengths -1 … S + 5), the float32
                   consistency runs' shapes; and B3 refusing ``causal``
                   with a key length of its own.
42. serve_audio  — ``launch.serve --arch whisper-medium --full
                   --workload generate`` through its ``run`` (bf16
                   weights, the engine's float32 zero frames): as
                   ``serve``, exactly 72 ``flash_attention`` (24
                   encoder, 24 self, 24 cross) and 192
                   ``decode_attention`` (24 × 4 self, 24 × 4 cross)
                   launches per batch, and the encoder's ms and share
                   of a batch at b 1 and 32 (host clock, synchronised
                   around ``transformer.encode``).
43. serve_vlm    — the same on internvl2-1b (256 patch rows before the
                   32-token prompt, decoding from position 288 over a
                   293-slot cache): exactly 24 ``flash_attention`` and
                   24 × 4 ``decode_attention`` launches per batch.
44. audio_consistency / vlm_consistency — each whole in float32, batch
                   2, with frames (whisper) or patch embeddings at the
                   token table's scale (InternVL2) drawn after the
                   tokens from the same ``default_rng(5)``: prefill(300)
                   + 3 decode steps against forward(303) within 3e-4.
45. attn_backward — B3's backward kernels (``flash_attention_backward``
                   on the forward kernel's own ``out`` and ``lse``)
                   against ``flash_attention_backward_plain`` (float32
                   within 2e-5 of each gradient's largest value, bf16
                   within 2^-7 of it) and against autograd of the plain
                   forward (bf16 within 2^-6: autograd's D uses the
                   output before its bf16 rounding), dq, dk and dv
                   apart, each case launched twice and held bitwise:
                   qwen's training shape (B 8, S 512, 16 × 64, causal,
                   bf16, and in float32), B 1 at S 4,096 and at 512,
                   GQA (32 over 8 × 128, window 64, bf16 and float32),
                   OLMoE's 16 × 128, MLA's (192, 128), 32 queries over
                   1,500 keys
                   (unmasked, float32), ragged S 500 and 1,023; each
                   timed against its plain version and SDPA's forward +
                   backward; bound: q, k, v, o, dO, dq, dk, dv and lse
                   once over 3.35 TB/s, or 2.5 × the forward's flops
                   over the peak, whichever is larger.  Also the
                   forward with ``lse`` at the training shape.
46. train        — ``launch.train --arch qwen1.5-0.5b --steps 20 --batch
                   8 --seq 512`` through its ``run`` (bf16, full width,
                   the chunked cross-entropy in one chunk): exactly 24
                   B3 forward and 24 B3 backward calls a step and no
                   B4, B5 or MLA decode; finite losses with the last
                   under the first; every grad_norm finite and > 0; the
                   peak under the card's; then one ``--remat`` step with
                   the same first loss and 48 forward, 24 backward
                   calls.  Warm step ms (median of steps 2–20), tokens/s
                   and peaks.
47. train_consistency — qwen1.5-0.5b whole in float32 (TF32 off), batch
                   2 × 512, one train step through the kernels against
                   the same step with B3's forward and backward
                   replaced, here, by autograd of the plain forward on
                   the card: the loss at rel 1e-6; every gradient at
                   max|Δg| <= 1e-4 · max|g| + 1e-6; the parameters after
                   AdamW at the same bound where the gradient is
                   resolved (|g| >= 1e-6: Adam's first step divides by
                   |g| + 1e-8, so an unresolved gradient's update is
                   rounding either way), and every parameter within
                   twice the step's learning rate.
48. ssd_backward — B5's backward kernels (``ssd_scan_backward``)
                   against ``ssd_scan_backward_plain`` on the card, each
                   of dx, ddt, dA, dB and dC apart (1e-4 of its largest
                   magnitude in float32, 2^-7 where it is returned in
                   bf16), twice bitwise: mamba2-2.7b's training shape (B
                   2 × 512, 80 × 64, ds 128) in bf16 and float32, B 1 ×
                   4,096 and Jamba's (64, 16) with 128 heads at B 2 ×
                   512 (all timed against the plain backward; bound: x,
                   dt, B, C, dy in and dx, ddt, dB, dC out once over
                   3.35 TB/s, or 8 · hd · ds flops a step and head over
                   the tensor cores' rate, 3xTF32's 494.7 / 3 TFLOP/s
                   in float32 with ``bound_ms_cuda_cores`` at 67 beside,
                   whichever is larger), a ragged (32, 16) case at B 1 × 1,023 with 8
                   heads over 2 groups, and a non-zero gradient of the
                   final state at both widths.
49. train_ssm    — ``launch.train --arch mamba2-2.7b --steps 10 --batch
                   2 --seq 512`` through its ``run`` (whole: 64 layers,
                   full width, bf16): exactly 64 B5 forward and 64 B5
                   backward calls a step and no other kernel, finite
                   losses that fall, finite positive grad norms, the
                   peak under the card's; then one ``--remat`` step: 128
                   forward and 64 backward calls, the same first loss.
50. train_hybrid — Jamba at full width without its experts, one period
                   of 8 layers (7 Mamba2 and the attention layer at
                   offset 4), 5 steps at 2 × 512 through
                   ``launch.train``'s ``run(args, cfg=...)``: exactly 7
                   B5 forward and backward calls and 1 B3 forward and
                   backward call a step; finite losses and grad norms,
                   the peak under the card's.
51. train_ssm_consistency — one float32 train step through B5's kernels
                   against the same step with ``ssd_chunked`` replaced
                   by ``ssd_scan_plain`` (autograd through it) on the
                   card, ``train_consistency``'s gates: mamba2-2.7b at
                   full width (its first 8 of 64 layers), then
                   ``train_hybrid``'s config.
52. train_families — two train steps each at 2 × 256 of olmoe-1b-7b (4
                   of 16 layers), deepseek-v2-lite-16b (its dense lead
                   and two MoE layers), whisper-medium (the reference
                   trainer's zero frames) and internvl2-1b (seeded
                   0.02 · N(0, 1) patch rows: zero rows overflow the
                   gradient at depth 24, ROADMAP C-R5) whole: exact B3
                   forward and backward counts from the
                   config (whisper: encoder self, decoder self and
                   cross), finite losses and grad norms, the peak under
                   the card's; then whisper-medium whole through
                   ``launch.train`` (its batches carry the zero frames,
                   ROADMAP C-R6), two steps at 2 × 256.
53. mesh_train   — ``launch.train``'s ``run(distribute=True)`` on the
                   one-rank NCCL host mesh (``make_host_mesh``: its own
                   group over a ``HashStore``, destroyed after), where
                   ``shard_model``, ``shard_opt_state`` and
                   ``shard_batch`` make every parameter, moment and
                   batch a DTensor and B3, B5 and their backwards run
                   under ``local_map``; each run against the plain run
                   of the same seed and steps in the same phase:
                   qwen1.5-0.5b whole, 5 steps at 8 × 512, and
                   mamba2-2.7b at full width cut to 8 of its 64 layers,
                   3 steps at 2 × 512, both bf16; then, at
                   train_families' sizes (2 steps at 2 × 256), OLMoE
                   at 4 layers, DeepSeek-V2-Lite at 3, Jamba over
                   train_hybrid's period (without its experts),
                   whisper-medium (zero frames) and internvl2-1b (its
                   text, as the launcher feeds it) whole.  Losses and
                   grad norms bitwise equal, launches a step exactly
                   the plain step's (24 B3 and 24 B3 backward; 8 B5 and
                   8 B5 backward; each family's from its config), the
                   median warm step of each run beside the card's name
                   and power limit.  Then one ``prefill`` and one
                   ``decode_step`` on the mesh against the plain pair,
                   over a cache placed by ``cache_specs``: DeepSeek's
                   3 layers (MLA decode under ``local_call`` on a
                   latent cache of one shard) and whisper-medium whole
                   (its cross cache's B4 over heads kept per rank):
                   logits bitwise, launches exact.
54. dryrun       — ``python -m repro_torch.launch.dryrun --mesh both``,
                   one combo after another in one process, started
                   right after ``build`` with the GPU hidden from it
                   (it runs on ``meta`` tensors over a fake group of
                   256 / 512 ranks) and read here: qwen1.5-0.5b at
                   decode_32k and train_4k, mamba2-2.7b at train_4k,
                   deepseek-v2-lite-16b and whisper-medium at
                   decode_32k, olmoe-1b-7b at train_4k.  Every record
                   ``ok``; at decode_32k the cache's bytes a device are
                   the total over 256 (16 × 16) and over 512 (2 × 16 ×
                   16); each record printed on a line of its own.

Then a ``phase_seconds`` line (each phase's wall seconds), a
``{"kernels": [...]}`` line (one row per kernel and path: the
launches of that path's user-size run beside the times at that path's
shape; the ``hist_update`` and ``fifo_compact`` rows add ``path_ms``,
``path_plain_ms``, ``path_bound_ms`` and ``path_library_ms`` from the
path's own block, and ``bound_ms_bytes4`` beside each recounted
bound; the loss, failure, fleet and campaign paths' rows time B1 and
B2 on their captured blocks only; the ``campaign_fold`` row, a kernel
of the port with no TPU counterpart, takes its times from the path's
own case (8,192 × 512, loss counters, every lane valid) and adds the
loss-free, sketch and NaN cases' times; the ``flash_attention`` and
``decode_attention`` rows add the continuous and MoE paths' launches;
the ``decode_attention_int8`` row, on ``serve_int8``, is timed at the
continuous pool's shape with ``long_*``, ``batch1_*`` and the bf16-cache
B4's ``float_cache_ms`` beside; the ``flash_attention`` row adds
``mla_*`` (launches on ``serve_mla``, times at (192, 128)), and it, the
``decode_attention`` and the ``ssd_scan`` rows add ``hybrid_*``
(launches on ``serve_hybrid``, times at Jamba's shapes); the
``mla_decode`` row, a kernel with no TPU counterpart, is timed at
``serve_mla``'s last decode step with ``path_*``, ``long_*`` and
``batch1_*``; the ``flash_attention`` and ``decode_attention`` rows
add ``audio_launches`` and ``vlm_launches`` from ``serve_audio`` and
``serve_vlm`` and ``audio_*`` / ``vlm_*`` times at their shapes; the
``flash_attention`` row adds ``train_launches`` and ``train_*`` times
of the forward with ``lse`` at the training shape; the
``flash_attention_backward`` row, a kernel of the port with no TPU
counterpart, is timed at the training shape with ``long_*``,
``batch1_*`` and ``f32_*``; the ``ssd_scan`` row adds ``f32_*``,
``hybrid_f32_*`` and ``hybrid_f32_ragged_*`` (its
float32 route, 3xTF32 on the tensor cores, bound at 3xTF32's rate with
``*_bound_ms_cuda_cores`` at 67 TFLOP/s beside); the
``ssd_scan_backward`` row, also with no TPU counterpart, takes its
launches from ``train_ssm`` and its times at mamba2-2.7b's training
shape, with ``f32_*``, ``long_*`` and ``hybrid_*`` beside), the
nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; without a CUDA device it exits non-zero before
any phase.  Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (  # noqa: E402
    FleetGrid, GenGrid, GenServiceModel, MarkovGrid, SweepGrid, evaluate,
    fleet_caps, fleet_sweep, gen_caps, gen_sweep, sweep, sweep_caps)
from repro_torch.core.analytic import (  # noqa: E402
    LinearServiceModel, mean_batch_lower, phi, stability_limit)
from repro_torch.core import engine, prng  # noqa: E402
from repro_torch.core.campaign import (  # noqa: E402
    DEFAULT_TOP_K, FaultPlan, _init_acc as campaign_init_acc, campaign,
    verify_resume)
from repro_torch.core.chain_solver import (  # noqa: E402
    _grid_shapes, build_chain, chain_metrics, solve_pi_gth)
from repro_torch.core.markov import solve as markov_solve  # noqa: E402
from repro_torch.core.markov import solve_grid  # noqa: E402
from repro_torch.core.continuous_sim import (  # noqa: E402
    simulate_continuous_numpy)
from repro_torch.core.gen_sweep import buffer_length  # noqa: E402
from repro_torch.core.grid import OVERFLOW_CODE  # noqa: E402
from repro_torch.core.hist import (bit_bins, hist_edges,  # noqa: E402
                                   sketch_edges, thinned_rows)
from repro_torch.core.metrics import MetricsTap  # noqa: E402
from repro_torch.core.loss_ref import (  # noqa: E402
    simulate_fleet_loss_numpy, simulate_gen_loss_numpy, simulate_loss_numpy)
from repro_torch.core.replicas import simulate_jsq_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduced as reduce_config  # noqa: E402
from repro_torch.core.calibrate import fit_service_model  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import superstep as ss  # noqa: E402
from repro_torch.kernels.campaign_fold import (  # noqa: E402
    FoldAcc, campaign_fold, campaign_fold_plain, chain_floor,
    fold_min_bytes)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_int8, decode_attention_int8_plain,
    decode_attention_plain, decode_splits)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_backward,
    flash_attention_backward_plain, flash_attention_lse_plain,
    flash_attention_plain, flash_attention_with_lse, flash_splits)
from repro_torch.kernels.mla_decode import (  # noqa: E402
    mla_decode_attention, mla_decode_attention_plain, mla_splits)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunked, ssd_scan, ssd_scan_backward, ssd_scan_backward_plain,
    ssd_scan_plain, ssd_splits)
from repro_torch.launch import distribute as dst  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, owned_group  # noqa: E402
from repro_torch.models import attention as attn_module  # noqa: E402
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.models import mamba2 as mamba2_module  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.attention import quantize_kv  # noqa: E402
from repro_torch.serving import (ContinuousEngine,  # noqa: E402
                                 InferenceEngine)
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import optimizer as train_opt  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticCorpus  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
SLEEP_CYCLES = 40_000_000          # ≈ 20 ms at the H100's 1.98 GHz
# H100 SXM dense peaks: bf16 on the tensor cores, float32 on the CUDA
# cores (B4's float32 kernel)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# B3's and B5's float32 kernels, forward and backward, and MLA decode's
# products over a float32 cache run on the TF32 tensor
# cores as 3xTF32: three TF32 products (494.7 TFLOP/s dense) a float32
# product; the 67 TFLOP/s figure is reported beside as
# bound_ms_cuda_cores
FLASH_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 494.7e12 / 3}
V100 = (0.1438, 1.8874)            # README's V100 (α, τ0)
P4 = (0.5833, 1.4284)              # README's P4 (α, τ0)
# name: (source, TPU kernel it replaces as file:line and as function)
KERNELS = {
    "hist_update": ("src/repro_torch/kernels/csrc/hist_update.cu",
                    "src/repro/kernels/superstep.py:105",
                    "src/repro/kernels/superstep.py:_hist_body"),
    "fifo_compact": ("src/repro_torch/kernels/csrc/fifo_compact.cu",
                     "src/repro/kernels/superstep.py:180",
                     "src/repro/kernels/superstep.py:_compact_body"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:30",
                        "src/repro/kernels/flash_attention.py:_kernel"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:27",
                         "src/repro/kernels/decode_attention.py:_kernel"),
    # B4's int8-cache instantiation of the same template
    "decode_attention_int8": (
        "src/repro_torch/kernels/csrc/decode_attention_int8.cu",
        "src/repro/kernels/decode_attention.py:27",
        "src/repro/kernels/decode_attention.py:_kernel"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:28",
                 "src/repro/kernels/ssd_scan.py:_kernel"),
    # no TPU kernel: the reference's float32 einsum chain of MLA decode
    "mla_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                   "src/repro/models/attention.py:380",
                   "src/repro/models/attention.py:mla_decode"),
    # no TPU kernel: the reference trains through jax.grad of its sdpa
    "flash_attention_backward": (
        "src/repro_torch/kernels/csrc/flash_attention_backward.cu",
        "src/repro/models/attention.py:142",
        "src/repro/models/attention.py:sdpa (jax.grad)"),
    # no TPU kernel: the reference trains Mamba2 through jax.grad of its
    # _ssd_chunked
    "ssd_scan_backward": (
        "src/repro_torch/kernels/csrc/ssd_scan_backward.cu",
        "src/repro/models/mamba2.py:85",
        "src/repro/models/mamba2.py:_ssd_chunked (jax.grad)"),
    # no TPU kernel: the reference folds a chunk with a jitted lax.scan
    "campaign_fold": ("src/repro_torch/kernels/csrc/campaign_fold.cu",
                      "src/repro/core/campaign.py:391",
                      "src/repro/core/campaign.py:_build_fold"),
}
# the served model and the serve path's shapes (launch.serve: prompt 32,
# 4 generated tokens, a cache of 32 + 4 + 1 slots, batches 1…32)
SERVE_ARCH = "qwen1.5-0.5b"
SERVE_ARGS = ["--arch", SERVE_ARCH, "--full", "--workload", "generate",
              "--rho", "0.5", "--jobs", "300", "--max-batch", "32"]
SERVE_PROMPT, SERVE_GEN = 32, 4
LONG_PROMPT, LONG_GEN = 1024, 32
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# B3's rows' log-sum-exp (float32 whatever the dtype; ~10 at 1,500 keys)
# against its plain version
LSE_TOL = 2e-5
# B4 over the int8 cache against its plain version's float32 result,
# (relative, absolute): both do float32 arithmetic on the same codes and
# scales, so a bf16 output is that result rounded (half an ulp, at most
# 2^-8 of it) and float32 differs by the order of the sums
INT8_TOL = {torch.bfloat16: (2.0 ** -8, 1e-5), torch.float32: (0.0, 2e-5)}
# the Mamba2 serve path: launch.serve's arguments on mamba2-2.7b, one
# ssd_scan launch per layer per batch (in the prefill)
SSM_ARCH = "mamba2-2.7b"
SSM_ARGS = ["--arch", SSM_ARCH, "--full", "--workload", "generate",
            "--rho", "0.5", "--jobs", "300", "--max-batch", "32"]
SSM_PROMPT, SSM_LONG = 32, 1024
SSD_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
# the continuous engine: examples/continuous_batching.py's PROMPT and
# CAP, 32 generated tokens, 300 Poisson jobs (the serve phases' count) at
# half the capacity
CONT_PROMPT, CONT_GEN, CONT_CAP, CONT_JOBS = 128, 32, 64, 300
# the MoE serve path: launch.serve's arguments on olmoe-1b-7b
MOE_ARCH = "olmoe-1b-7b"
MOE_ARGS = ["--arch", MOE_ARCH, "--full", "--workload", "generate",
            "--rho", "0.5", "--jobs", "300", "--max-batch", "32"]
# the MLA serve path: launch.serve's arguments on deepseek-v2-lite-16b
# (whole: 27 layers, ≈ 31 GB of bf16 weights)
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_ARGS = ["--arch", MLA_ARCH, "--full", "--workload", "generate",
            "--rho", "0.5", "--jobs", "300", "--max-batch", "32"]
# MLA decode's float32 context against its plain version: both do
# float32 arithmetic on the same cache values, in another order
MLA_TOL = 2e-5
# the hybrid serve path: jamba-v0.1-52b at full width cut to its first
# 16 of 32 layers (two periods of 8: attention at 4 and 12, MoE on the
# odd layers; ≈ 52 GB of bf16 weights, where all 32 would be ≈ 104 GB)
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_LAYERS = 16
HYBRID_ARGS = ["--arch", HYBRID_ARCH, "--full", "--workload", "generate",
               "--rho", "0.5", "--jobs", "300", "--max-batch", "32"]


# the enc-dec serve path: launch.serve's arguments on whisper-medium
# (whole: 24 encoder and 24 decoder layers, 16 heads of 64, n_ctx 1,500;
# the engine's frames are float32 zeros, so the encoder and the cross
# K/V run in float32, the decoder's self-attention in bf16)
AUDIO_ARCH = "whisper-medium"
AUDIO_ARGS = ["--arch", AUDIO_ARCH, "--full", "--workload", "generate",
              "--rho", "0.5", "--jobs", "300", "--max-batch", "32"]
# the VLM serve path: internvl2-1b (Qwen2-0.5B's 24 layers, 14 query
# heads over 2 kv heads of 64) with its 256 patch rows in front of the
# prompt
VLM_ARCH = "internvl2-1b"
VLM_ARGS = ["--arch", VLM_ARCH, "--full", "--workload", "generate",
            "--rho", "0.5", "--jobs", "300", "--max-batch", "32"]
# the training path: launch.train on qwen1.5-0.5b at full width, 8 ×
# 512 tokens a step (S · V = 77.8 M >= 2^26: the chunked cross-entropy,
# one chunk of 512)
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", "20", "--batch", "8",
              "--seq", "512"]
TRAIN_B, TRAIN_S = 8, 512
# B3's backward against its plain version, relative to each gradient's
# largest magnitude: both compute in float32 from the same inputs, and
# a bf16 gradient is rounded once (half an ulp, 2^-8 of a value, is at
# most 2^-8 of the largest); against autograd of the plain forward bf16
# takes twice that, since autograd's D uses the output before rounding
BWD_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2e-5}
BWD_AUTOGRAD_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2e-5}
# SSM training: launch.train on mamba2-2.7b whole, 2 × 512 tokens a step
# (bf16 weights and gradients and float32 moments ≈ 32 GB, the
# activations of 64 layers at 1,024 tokens the rest; PERF.md reckons the
# peak)
TRAIN_SSM_ARGS = ["--arch", SSM_ARCH, "--steps", "10", "--batch", "2",
                  "--seq", "512"]
# the hybrid: Jamba at full width, one period of 8 layers without its
# experts, 2.7 B parameters (with its 4 MoE layers a period holds 13.3 B,
# ≈ 159 GB with bf16 gradients and float32 moments; split_pattern needs a
# whole period)
HYBRID_TRAIN_LAYERS = 8
TRAIN_HYBRID_ARGS = ["--arch", HYBRID_ARCH, "--steps", "5", "--batch", "2",
                     "--seq", "512"]
# the float32 consistency step on mamba2-2.7b at full width: 8 of its 64
# layers (float32 weights, gradients and moments of all 64 take 45 GB,
# and the plain scan's saved chunk matrices and activations of 64
# layers in float32 would not fit beside them)
SSM_CONSISTENCY_LAYERS = 8
# mesh_train: the training runs again on the one-rank NCCL host mesh,
# every tensor a DTensor; mamba2-2.7b at full width cut to 8 layers
MESH_TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", "5", "--batch", "8",
                   "--seq", "512"]
MESH_TRAIN_SSM_LAYERS = 8
MESH_TRAIN_SSM_ARGS = ["--arch", SSM_ARCH, "--steps", "3", "--batch", "2",
                       "--seq", "512"]
# the dry runs (launch.dryrun --mesh both), one after another in a
# process of their own
DRYRUNS = (("qwen1.5-0.5b", "decode_32k"), ("qwen1.5-0.5b", "train_4k"),
           ("mamba2-2.7b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"),
           ("whisper-medium", "decode_32k"), ("olmoe-1b-7b", "train_4k"))
# mesh_train's other families: train_families' sizes through launch.train
MESH_TRAIN_FAMILY_ARGS = ["--steps", "2", "--batch", "2", "--seq", "256"]
# mesh_train's prefill + decode_step pairs: batch, prompt, cache length
MESH_DECODE_SHAPE = (2, 64, 128)
# the processes this script starts, stopped before it returns
_CHILDREN: list = []
# (arch, layers) trained two steps each in train_families; 0 = whole.
# Depth cuts keep bf16 weights and gradients and float32 moments (12
# bytes a parameter) with the activations under 80 GB: OLMoE's 16 layers
# hold 6.9 B parameters (83 GB), DeepSeek-V2-Lite's 27 hold 15.7 B
# (188 GB); its first layer is the dense lead, then two MoE layers
# whisper through launch.train (its batches carry zero frames)
TRAIN_AUDIO_ARGS = ["--arch", AUDIO_ARCH, "--steps", "2", "--batch", "2",
                    "--seq", "256"]
TRAIN_FAMILIES = (("olmoe-1b-7b", 4), ("deepseek-v2-lite-16b", 3),
                  ("whisper-medium", 0), ("internvl2-1b", 0))


def hybrid_config(layers: int = HYBRID_LAYERS):
    """Jamba at full width, its first ``layers`` layers."""
    return dataclasses.replace(get_config(HYBRID_ARCH), num_layers=layers)


# benchmarks/continuous.py's token-level V100-like constants (ms) and
# grid axes
GEN_MODEL = GenServiceModel(alpha_decode=0.14, tau0_decode=1.9,
                            alpha_prefill=0.035, tau0_prefill=1.9)
GEN_PROMPT = 128
GEN_RHOS = [round(r, 4) for r in np.linspace(0.15, 0.85, 16)]
GEN_GENS = (8, 32, 64, 256)
GEN_CAPS = (8, 16, 32, 64)
GEN_DISCS = ("static", "continuous")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events.
    The calls are queued behind a device sleep of ≈ 20 ms, so that a
    short kernel is timed at the card's pace and not at the host's rate
    of launching it."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# the CUDA sources: one library each
SOURCES = sorted({Path(src).stem for src, _, _ in KERNELS.values()})


def phase_build() -> str:
    """Build every kernel source at once, one nvcc each, and load it."""
    t0 = time.perf_counter()
    _build.build(*SOURCES)
    for name in SOURCES:
        _build.library(name)
    smi = nvidia_smi()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds={k: _build.build_seconds.get(k) for k in SOURCES},
         flags=" ".join(_build.NVCC_FLAGS), nvidia_smi=smi)
    print(smi, flush=True)
    return smi


def hist_report(dev, start, lats, inc, *, n_bins: int, sketch: bool,
                block: str, emit_as: str = "kernel") -> dict:
    """The CUDA hist_update against its plain version on one block
    (``start`` the rows before the update): counts bit for bit, sums
    within rtol 1e-6; kernel, plain, library and bound times."""
    p = lats.shape[0]
    got = tuple(t.clone() for t in start)
    want = tuple(t.clone() for t in start)
    ss.hist_update(got, lats, inc, n_bins=n_bins, backend="cuda",
                   sketch=sketch)
    ss.hist_update_plain(want, lats, inc, n_bins=n_bins, sketch=sketch)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]),
          f"hist_update counts bitwise equal (sketch={sketch}, {block})")
    err = float((got[0] - want[0]).abs().max())
    if sketch:
        check(torch.allclose(got[1], want[1], rtol=1e-6, atol=0.0),
              f"hist_update sums within rtol 1e-6 ({block})")
        err = max(err, float((got[1] - want[1]).abs().max()))
    # the bound's row sectors are those of the rows the path updates
    min_bytes = ss.hist_update_min_bytes(got, lats, inc, n_bins=n_bins,
                                         sketch=sketch)
    scratch = got
    kernel_ms = time_ms(lambda: ss.hist_update(
        scratch, lats, inc, n_bins=n_bins, backend="cuda", sketch=sketch))
    plain_ms = time_ms(lambda: ss.hist_update_plain(
        scratch, lats, inc, n_bins=n_bins, sketch=sketch))
    # library yardstick: one scatter_add_ of the counts over bins
    # computed beforehand (binning and the sums are not in it)
    bins = bit_bins(lats, n_bins, sketch).reshape(p, -1).long()
    ones = inc.reshape(p, -1).to(torch.int32)
    library_ms = time_ms(lambda: scratch[0].scatter_add_(1, bins, ones))
    del bins, ones
    n_inc = int(inc.sum())
    # the earlier bound: every latency read at 4 bytes, every row whole
    bytes4 = inc.numel() + 4 * n_inc + 2 * p * n_bins * 4 * len(start)
    plan = ss.hist_update_plan(p, lats[0].numel(), n_bins, sketch=sketch,
                               lats_ptr=lats.data_ptr(),
                               inc_ptr=inc.data_ptr(),
                               row_ptrs=[h.data_ptr() for h in got])
    out = dict(block=block, sketch=sketch, shape=list(lats.shape),
               n_bins=n_bins, included=n_inc, bytes=min_bytes,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               library_note="scatter_add_ of counts over precomputed bins",
               bound_ms=min_bytes / HBM_BYTES_PER_S * 1e3,
               bytes4=bytes4,
               bound_ms_bytes4=bytes4 / HBM_BYTES_PER_S * 1e3,
               plan=plan._asdict(), max_abs_err=err, matches_plain=True)
    emit(emit_as, **out)
    return out


def random_hist_block(dev, p: int, rows: int, width: int, n_bins: int,
                      sketch: bool, seed: int):
    """Lognormal(1, 1.5) latencies, an i.i.d. 50% mask and random rows:
    the random blocks every PR has timed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lats = torch.empty(p, rows, width, device=dev).log_normal_(
        1.0, 1.5, generator=gen)
    inc = torch.rand(p, rows, width, device=dev, generator=gen) < 0.5
    start = (torch.randint(0, 1000, (p, n_bins), dtype=torch.int32,
                           device=dev, generator=gen),)
    if sketch:
        start += (torch.rand(p, n_bins, device=dev, generator=gen) * 100,)
    return start, lats, inc


def phase_kernel(dev, sketch: bool, p: int = 8160, rows: int = 32,
                 width: int = 768, block: str = "sweep") -> dict:
    """The CUDA hist_update against its plain version on a random
    block of a path's shape."""
    n_bins = 64 if sketch else 512
    start, lats, inc = random_hist_block(dev, p, rows, width, n_bins,
                                         sketch, 1234 + sketch)
    return hist_report(dev, start, lats, inc, n_bins=n_bins, sketch=sketch,
                       block=block)


def _hist_case(dev, name: str, lats, inc, n_bins: int, sketch: bool,
               seed: int) -> dict:
    """One block held bit for bit against the plain version, twice."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = lats.shape[0]
    start = (torch.randint(0, 1000, (p, n_bins), dtype=torch.int32,
                           device=dev, generator=gen),)
    if sketch:
        start += (torch.rand(p, n_bins, device=dev, generator=gen) * 100,)
    want = tuple(t.clone() for t in start)
    ss.hist_update_plain(want, lats, inc, n_bins=n_bins, sketch=sketch)
    for rep in range(2):
        got = tuple(t.clone() for t in start)
        ss.hist_update(got, lats, inc, n_bins=n_bins, backend="cuda",
                       sketch=sketch)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]),
              f"hist_update case {name}: counts differ (launch {rep})")
        if sketch:
            # the special values' sums are ±inf and NaN where they are
            # the plain version's
            check(torch.allclose(got[1], want[1], rtol=1e-6, atol=0.0,
                                 equal_nan=True),
                  f"hist_update case {name}: sums outside rtol 1e-6")
    plan = ss.hist_update_plan(p, lats[0].numel(), n_bins, sketch=sketch,
                               lats_ptr=lats.data_ptr(),
                               inc_ptr=inc.data_ptr(),
                               row_ptrs=[h.data_ptr() for h in got])
    return dict(shape=list(lats.shape), n_bins=n_bins, sketch=sketch,
                included=int(inc.sum()), warps_per_point=plan.warps_per_point,
                vec_loads=plan.vec_loads, vec_rows=plan.vec_rows)


def _special_values(dev) -> torch.Tensor:
    """bit_bins' edge cases: ±0.0, denormals, ±inf, ±NaN, negatives,
    every bin edge of both modes and the floats beside each."""
    edges = np.concatenate([hist_edges(512), sketch_edges()])
    special = [0.0, -0.0, 1e-45, 1e-40, 2.0 ** -149, 2.0 ** 40, -1.0,
               -2.0 ** 40, np.inf, -np.inf, np.nan, 1.0,
               np.finfo(np.float32).max]
    vals = np.concatenate([edges, special]).astype(np.float32)
    with np.errstate(over="ignore"):
        vals = np.concatenate([vals, np.nextafter(vals, np.float32(-np.inf)),
                               np.nextafter(vals, np.float32(np.inf))])
    vals = np.append(vals, np.array([0xFFC00000], np.uint32)
                     .view(np.float32))             # a negative NaN
    return torch.from_numpy(vals).to(dev)


def phase_hist_cases(dev) -> None:
    """The CUDA hist_update bit for bit against its plain version on the
    blocks random inputs never give: special values, one bin, prefix
    masks, n_bins = 100 and 101 (a row flushed element by element), odd
    sizes and misaligned bases; then
    fifo_compact at k in {0, n} and small k, an odd row and a misaligned
    buffer."""
    gen = torch.Generator(device=dev).manual_seed(4242)
    cases = {}
    vals = _special_values(dev)
    for name, (p, r, w) in {"special_warp": (4096, 16, 64),
                            "special_block": (16, 8, 1024)}.items():
        idx = torch.randint(0, len(vals), (p, r, w), device=dev,
                            generator=gen)
        lats = vals[idx]
        inc = torch.rand(p, r, w, device=dev, generator=gen) < 0.7
        for n_bins, sk in ((512, False), (100, False), (64, True)):
            cases[f"{name}_{n_bins}"] = _hist_case(dev, name, lats, inc,
                                                   n_bins, sk, 1)
    for name, (p, r, w) in {"one_bin_gen": (8192, 16, 64),
                            "one_bin_sweep": (256, 32, 768)}.items():
        # [3.0, 3.25) is one bin of the full histogram and of the sketch
        lats = 3.0 + 0.25 * torch.rand(p, r, w, device=dev, generator=gen)
        inc = torch.rand(p, r, w, device=dev, generator=gen) < 0.5
        for n_bins, sk in ((512, False), (64, True)):
            cases[f"{name}_{n_bins}"] = _hist_case(dev, name, lats, inc,
                                                   n_bins, sk, 2)
    # the sweep's prefix masks: each row includes its first b slots
    p, r, w = 512, 32, 768
    b = torch.randint(0, 40, (p, r, 1), device=dev, generator=gen)
    inc = torch.arange(w, device=dev) < b
    lats = 2.0 + torch.rand(p, r, w, device=dev, generator=gen)
    for n_bins, sk in ((512, False), (100, False), (101, False), (64, True)):
        cases[f"prefix_{n_bins}"] = _hist_case(dev, "prefix", lats, inc,
                                               n_bins, sk, 3)
    # odd sizes: rows start off every alignment (head and tail steps)
    for name, (p, r, w) in {"odd_warp": (4100, 5, 63),
                            "odd_tiny": (33, 5, 7),
                            "odd_block": (37, 7, 1001)}.items():
        _, lats, inc = random_hist_block(dev, p, r, w, 512, False, 5)
        for n_bins, sk in ((512, False), (101, False), (64, True)):
            cases[f"{name}_{n_bins}"] = _hist_case(dev, name, lats, inc,
                                                   n_bins, sk, 4)
    # misaligned bases: a mask one byte off (scalar loop), and latencies
    # and mask off together by one entry (vector loop, every row a head)
    for name, (lat_off, inc_off) in {"mask_off1": (0, 1),
                                     "both_off1": (1, 1)}.items():
        for p, r, w in ((4096, 16, 64), (16, 8, 1024)):
            n = p * r * w
            lats = torch.empty(n + 4, device=dev).log_normal_(
                1.0, 1.5, generator=gen)[lat_off:lat_off + n].view(p, r, w)
            inc = (torch.rand(n + 4, device=dev, generator=gen) < 0.5)[
                inc_off:inc_off + n].view(p, r, w)
            for n_bins, sk in ((512, False), (64, True)):
                cases[f"{name}_{w}_{n_bins}"] = _hist_case(
                    dev, name, lats, inc, n_bins, sk, 6)
    check(any(not c["vec_loads"] for c in cases.values())
          and any(c["vec_loads"] for c in cases.values())
          and {c["warps_per_point"] for c in cases.values()} == {1, 8}
          and any(not c["vec_rows"] for c in cases.values()),
          "hist cases cover both loops, both groupings and both flushes")

    compact = {}
    for name, (p, n, kmax, off) in {"small_k": (512, 1409, 8, 0),
                                    "random_k": (512, 1409, 1409, 0),
                                    "odd_row": (300, 77, 77, 0),
                                    "buf_off1": (300, 1409, 1409, 1)}.items():
        buf = (torch.randn(p * n + 4, device=dev, generator=gen)
               * 50.0)[off:off + p * n].view(p, n)
        k = torch.randint(0, kmax + 1, (p,), dtype=torch.int32, device=dev,
                          generator=gen)
        k[:4] = torch.tensor([0, n, 1, n - 1], dtype=torch.int32)
        now = torch.rand(p, device=dev, generator=gen) * 500.0
        want = ss.fifo_compact_plain(buf, k, now, out=torch.empty_like(buf))
        for rep in range(2):
            got = ss.fifo_compact(buf, k, now, backend="cuda",
                                  out=torch.empty_like(buf))
            torch.cuda.synchronize()
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"fifo_compact case {name} bitwise (launch {rep})")
        compact[name] = ss.fifo_compact_plan(
            p, n, buf_ptr=buf.data_ptr(), out_ptr=got.data_ptr())._asdict()
    check(any(not c["vec"] for c in compact.values()),
          "compact cases cover the scalar loop")
    emit("hist_cases", hist=cases, compact=compact, matches_plain=True)


CAPTURED = ("hist_update", "fifo_compact")


class _Stop(Exception):
    """Ends a capture run at the captured call."""


def _captured(run, at: int, stop_after):
    """``run()`` with ``ss.hist_update`` and ``ss.fifo_compact``
    wrapped: each clones the inputs of its ``at``-th call (the histogram
    rows as they were before it) into the returned dict, as ``(args,
    kwargs)`` under its name, and passes every call on to the kernel.
    With ``stop_after`` the run ends right after the ``at``-th call of
    that kernel.  The kernels count their launches on the module's
    names, which are the wrappers meanwhile: the counts carry over and
    back.  Returns ``(run's result, or None where it stopped, blocks)``."""
    blocks, kernels = {}, {}
    for name in CAPTURED:
        kernel = kernels[name] = getattr(ss, name)
        calls = [0]

        def wrapped(*args, _kernel=kernel, _name=name, _calls=calls, **kw):
            _calls[0] += 1
            if _calls[0] == at:
                first = (tuple(h.clone() for h in args[0])
                         if _name == "hist_update" else args[0].clone())
                blocks[_name] = ((first, *(a.clone() for a in args[1:])),
                                 kw)
            out = _kernel(*args, **kw)
            if _calls[0] == at and _name == stop_after:
                raise _Stop
            return out
        wrapped.launches = kernel.launches
        setattr(ss, name, wrapped)
    result = None
    try:
        result = run()
    except _Stop:
        pass
    finally:
        for name, kernel in kernels.items():
            kernel.launches = getattr(ss, name).launches
            setattr(ss, name, kernel)
    want = stop_after or "hist_update"
    check(want in blocks, f"the run made no {at}-th {want} call")
    return result, blocks


def capture_blocks(run, at: int, stop_after: str) -> dict:
    """The inputs of the ``at``-th call of ``hist_update`` and
    ``fifo_compact`` in ``run()``, which ends right after that call of
    ``stop_after``."""
    return _captured(run, at, stop_after)[1]


def run_captured(run, at: int) -> tuple:
    """``(run(), blocks)``: the run to its end, the inputs of the
    ``at``-th call of each kernel cloned on the way (a device copy of
    one block each).  A run's supersteps are deterministic (each
    user-size phase checks that two runs give the same bits), so these
    are the blocks a further run stopped there would give."""
    return _captured(run, at, None)


def compact_report(dev, buf, k, now, block: str,
                   emit_as: str = "fifo_compact") -> dict:
    """The CUDA fifo_compact against its plain version on one block:
    bit for bit; kernel, plain, library and bound times."""
    p, n = buf.shape
    got = ss.fifo_compact(buf, k, now, backend="cuda",
                          out=torch.empty_like(buf))
    want = ss.fifo_compact_plain(buf, k, now, out=torch.empty_like(buf))
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"fifo_compact bitwise equal to its plain version ({block})")
    err = float((got - want).abs().max())
    out_buf = torch.empty_like(buf)
    kernel_ms = time_ms(lambda: ss.fifo_compact(
        buf, k, now, backend="cuda", out=out_buf))
    plain_ms = time_ms(lambda: ss.fifo_compact_plain(buf, k, now,
                                                     out=out_buf))
    # library yardstick: the gather alone, its index built beforehand
    # (the subtraction of now and the fill past the end are left out)
    idx = (k.unsqueeze(1).long()
           + torch.arange(n, device=dev)).clamp_(max=n - 1)
    library_ms = time_ms(lambda: torch.gather(buf, 1, idx, out=out_buf))
    del idx
    survivors = int((n - k.long()).sum())
    bytes_moved = 4 * survivors + 4 * p * n + 8 * p
    out = dict(block=block, points=p, n=n, survivors=survivors,
               mean_k=float(k.float().mean()), bytes=bytes_moved,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               library_note="torch.gather with a prebuilt index; the "
                            "subtraction and the tail fill left out",
               bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
               plan=ss.fifo_compact_plan(
                   p, n, buf_ptr=buf.data_ptr(),
                   out_ptr=out_buf.data_ptr())._asdict(),
               max_abs_err=err, matches_plain=True)
    emit(emit_as, **out)
    return out


def phase_fifo_compact(dev, p: int = 8192, n: int = 1409) -> dict:
    """The CUDA fifo_compact against its plain version on the generate
    sweep's user-size shape (``buffer_length(256, 112, 64)``), random k
    and now."""
    gen = torch.Generator(device=dev).manual_seed(99)
    buf = torch.randn(p, n, device=dev, generator=gen) * 50.0
    k = torch.randint(0, n + 1, (p,), dtype=torch.int32, device=dev,
                      generator=gen)
    k[:4] = torch.tensor([0, 1, n - 1, n], dtype=torch.int32)
    now = torch.rand(p, device=dev, generator=gen) * 500.0
    now[0] = 0.0
    return compact_report(dev, buf, k, now, "random")


def phase_contracts(dev) -> None:
    """Threefry's known answers and split-dispatch invariance, on the
    card."""
    kat = [((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
           ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
            (0xc4923a9c, 0x483df7a0))]
    for (k0, k1), (c0, c1), want in kat:
        args = [torch.from_numpy(np.array([v], np.uint32).view(np.int32))
                .to(dev) for v in (k0, k1, c0, c1)]
        got = [int(x.item()) & 0xFFFFFFFF for x in prng.threefry2x32(*args)]
        check(got == list(want), f"threefry known answer {want}")
    g = SweepGrid.from_points([2.0, 3.0, 1.5, 2.5], V100[0], V100[1],
                              b_max=[0, 16, 0, 32],
                              dist=["gamma", "exp", "det", "gamma"],
                              cv=[0.5, 0.5, 0.5, 1.3],
                              wait_max=[0.0, 2.0, 0.0, 1.0],
                              wait_target=[0, 8, 0, 4])
    kw = dict(n_batches=256, seed=11, device=dev, **sweep_caps(g))
    whole = sweep(g, **kw)
    a = sweep(g.take(slice(0, 1)), **kw)
    b = sweep(g.take(slice(1, None)), key_offset=1, **kw)
    for f in ("mean_latency", "mean_batch", "n_jobs", "hist",
              "max_queue", "stderr"):
        split = np.concatenate([getattr(a, f), getattr(b, f)])
        check(np.array_equal(getattr(whole, f), split, equal_nan=True),
              f"split dispatch bitwise equal to whole on {f}")
    emit("contracts", threefry_kat=True, split_bitwise=True)


def phase_main(dev, n_batches: int = 4000, q_cap: int = 1024) -> None:
    rhos = [0.1, 0.3, 0.5, 0.7, 0.9]
    grid = SweepGrid.from_rhos(rhos, *V100)
    ss.hist_update.launches = 0
    t0 = time.perf_counter()
    res = evaluate(grid, backend="sweep", n_batches=n_batches,
                   q_cap=q_cap, seed=7, device=dev)
    seconds = time.perf_counter() - t0
    launches = ss.hist_update.launches
    supersteps = -(-n_batches // 32)
    check(launches == supersteps,
          f"main path launched hist_update {launches} times, expected "
          f"one per superstep ({supersteps})")
    # the same call through sweep() for the buffer witness (and the
    # same bits: the run is deterministic)
    r = sweep(grid, n_batches=n_batches, q_cap=q_cap, seed=7, device=dev)
    check(int(r.buffer_dropped.sum()) == 0, "main path buffer_dropped == 0")
    check(np.array_equal(r.mean_latency,
                         [x.mean_latency for x in res]),
          "evaluate and sweep give the same bits")
    rows = []
    for rho, x in zip(rhos, res):
        bound = float(phi(x.lam, *V100))
        eb_lo = float(mean_batch_lower(x.lam, *V100))
        check(np.isfinite(x.mean_latency) and x.n_jobs > 0,
              f"finite result at rho={rho}")
        if rho >= 0.3:
            tol = max(3.0 * x.ci_halfwidth, 0.04 * bound)
            check(abs(x.mean_latency - bound) <= tol,
                  f"rho={rho}: E[W]={x.mean_latency} within {tol} of "
                  f"phi={bound}")
        check(x.mean_batch >= 0.93 * eb_lo,
              f"rho={rho}: Remark 5 E[B]={x.mean_batch} >= 0.93*{eb_lo}")
        rows.append(dict(rho=rho, mean_latency=x.mean_latency, phi=bound,
                         ci_halfwidth=x.ci_halfwidth,
                         mean_batch=x.mean_batch, eb_lower=eb_lo,
                         p99=x.latency_p99))
    emit("main", seconds=seconds, launches=launches,
         supersteps=supersteps, points=rows)


def build_grid(target_points: int) -> SweepGrid:
    """examples/sweep_grid.py's grid: (load-fraction × α × τ0 × b_max),
    λ scaled to each point's own stability limit."""
    n_frac = max(8, target_points // (5 * 4 * 3))
    fracs = np.linspace(0.10, 0.85, n_frac)
    alphas = np.array([0.10, 0.1438, 0.25, 0.40, 0.5833])
    tau0s = np.array([0.75, 1.4284, 1.8874, 3.0])
    b_maxes = np.array([0, 32, 128])
    f, a, t, b = [x.reshape(-1) for x in
                  np.meshgrid(fracs, alphas, tau0s, b_maxes, indexing="ij")]
    lims = np.array([stability_limit(ai, ti, bi if bi > 0 else np.inf)
                     for ai, ti, bi in zip(a, t, b)])
    return SweepGrid.from_points(f * lims, a, t, b_max=b.astype(int))


def phase_user_size(dev, target_points: int = 8192, n_batches: int = 3000,
                    q_cap: int = 768, capture_at: int = 60) -> tuple:
    """Returns the run's hist_update launches and the path block: the
    inputs of superstep ``capture_at`` (past the warm-up), cloned as the
    kernel received them in the first run (``run_captured``)."""
    grid = build_grid(target_points)
    kw = dict(n_batches=n_batches, q_cap=q_cap, seed=0, device=dev)
    ss.hist_update.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, blocks = run_captured(
        lambda: sweep(grid, **kw), capture_at)
    first_s = time.perf_counter() - t0
    launches = ss.hist_update.launches
    supersteps = -(-n_batches // 32)
    check(launches == supersteps,
          f"user-size sweep launched hist_update {launches} times, "
          f"expected {supersteps}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r2 = sweep(grid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(np.array_equal(r.hist, r2.hist)
          and np.array_equal(r.mean_latency, r2.mean_latency),
          "two user-size runs give the same bits")
    check(int(r.buffer_dropped.sum()) == 0, "user-size buffer_dropped == 0")
    inf_mask = grid.b_max == 0
    bounds = phi(grid.lam[inf_mask], grid.alpha[inf_mask],
                 grid.tau0[inf_mask])
    excess = r.mean_latency[inf_mask] / bounds - 1.0
    tol = 0.05 * math.sqrt(3000 / n_batches)
    frac_ok = float((excess < tol).mean())
    check(excess.mean() < 0.01 and frac_ok >= 0.95,
          f"Theorem 2: mean excess {excess.mean():+.4%}, {frac_ok:.1%} "
          f"within phi*(1+{tol:.0%})")
    eb_def = float((r.mean_batch / mean_batch_lower(
        grid.lam, grid.alpha, grid.tau0) - 1.0).min())
    tol_eb = 0.12 * math.sqrt(3000 / n_batches)
    check(eb_def > -tol_eb, f"Remark 5: min E[B]/bound - 1 = {eb_def}")
    jobs = int(r.n_jobs.sum())
    emit("user_size", points=len(grid), n_batches=n_batches, q_cap=q_cap,
         first_call_s=first_s, warm_s=warm_s, jobs=jobs,
         jobs_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
         launches=launches, supersteps=supersteps,
         theorem2_mean_excess=float(excess.mean()),
         theorem2_frac_within=frac_ok, remark5_min_def=eb_def)
    return launches, blocks["hist_update"]


def gen_grid(tiles: int = 16) -> GenGrid:
    """benchmarks/continuous.py's grid (16 ρ × gen_tokens × max_active
    × discipline = 512 points, λ normalized by the cap-limited
    capacity), tiled ``tiles`` times: the copies of a point differ only
    in their global index, so they form a seed ladder."""
    lam, gens, caps, discs = [], [], [], []
    for rho in GEN_RHOS:
        for g in GEN_GENS:
            for c in GEN_CAPS:
                for d in GEN_DISCS:
                    lam.append(rho * GEN_MODEL.capped_capacity(
                        GEN_PROMPT, g, c))
                    gens.append(g)
                    caps.append(c)
                    discs.append(d)
    m = GEN_MODEL
    return GenGrid.from_points(
        np.tile(lam, tiles), m.alpha_decode, m.tau0_decode,
        m.alpha_prefill, m.tau0_prefill, prompt_len=GEN_PROMPT,
        gen_tokens=np.tile(gens, tiles), max_active=np.tile(caps, tiles),
        discipline=[d for _ in range(tiles) for d in discs])


def gen_index(rho: float, gen: int, cap: int, disc: str) -> int:
    """Index of a point in the first tile of ``gen_grid``."""
    return (((GEN_RHOS.index(rho) * len(GEN_GENS) + GEN_GENS.index(gen))
             * len(GEN_CAPS) + GEN_CAPS.index(cap))
            * len(GEN_DISCS) + GEN_DISCS.index(disc))


def phase_gen_contracts(dev) -> None:
    """The generate sweep's bitwise contracts and a thinned run whose
    histogram blocks are no multiple of 16 bytes, on the card."""
    m = GEN_MODEL
    # s_cap = max(max_active) = 31 is odd: with hist_every = 3 each
    # point bins 5 × 31 = 155 mask bytes per superstep, so the CUDA
    # hist_update runs its scalar head and tail on the real path
    g = GenGrid.from_points(
        [0.02, 0.012, 0.02, 0.015], m.alpha_decode, m.tau0_decode,
        m.alpha_prefill, m.tau0_prefill, prompt_len=GEN_PROMPT,
        gen_tokens=[8, 16, 8, 32], max_active=[15, 31, 15, 7],
        discipline=["continuous", "static", "static", "continuous"])
    block = len(thinned_rows(16, 3)) * int(g.max_active.max())
    check(block % 16 != 0, f"thinned block of {block} entries is odd")
    kw = dict(n_steps=2048, seed=13, device=dev, **gen_caps(g))
    for extra in ({}, dict(sketch=True, hist_every=3)):
        whole = gen_sweep(g, **kw, **extra)
        a = gen_sweep(g.take(slice(0, 2)), **kw, **extra)
        b = gen_sweep(g.take(slice(2, None)), key_offset=2, **kw, **extra)
        for f in ("mean_latency", "mean_batch", "utilization", "n_jobs",
                  "hist", "max_queue", "stderr"):
            split = np.concatenate([getattr(a, f), getattr(b, f)])
            check(np.array_equal(getattr(whole, f), split, equal_nan=True),
                  f"gen split dispatch bitwise equal to whole on {f} "
                  f"({extra})")
    alpha_eq = GEN_PROMPT * m.alpha_prefill + 32 * m.alpha_decode
    tau0_eq = m.tau0_prefill + 32 * m.tau0_decode
    one = {}
    for disc in GEN_DISCS:
        g1 = GenGrid.from_points([0.4 / (alpha_eq + tau0_eq)],
                                 m.alpha_decode, m.tau0_decode,
                                 m.alpha_prefill, m.tau0_prefill,
                                 prompt_len=GEN_PROMPT, gen_tokens=32,
                                 max_active=1, discipline=disc)
        one[disc] = gen_sweep(g1, n_steps=2048, q_cap=128, seed=3,
                              device=dev)
    for f in ("mean_latency", "mean_batch", "utilization", "n_jobs",
              "hist"):
        check(np.array_equal(getattr(one["static"], f),
                             getattr(one["continuous"], f)),
              f"max_active=1 disciplines bitwise equal on {f}")
    # every histogram update of the thinned run is held against the
    # plain version on the same block, on the real path: the counts
    # must agree bit for bit (the plain calls launch nothing)
    kernel = ss.hist_update
    same = []

    def checked(hists, lats, inc, *, n_bins, backend, sketch=False):
        want = tuple(h.clone() for h in hists)
        ss.hist_update_plain(want, lats, inc, n_bins=n_bins, sketch=sketch)
        got = kernel(hists, lats, inc, n_bins=n_bins, backend=backend,
                     sketch=sketch)
        same.append(torch.equal(got[0], want[0]))
        return got

    # the wrapper counts its launches on the module's name, which is
    # `checked` during the run: carry the count over and back
    before = checked.launches = kernel.launches
    ss.hist_update = checked
    try:
        th = gen_sweep(g, n_steps=2048, seed=5, hist_every=3, device=dev)
    finally:
        ss.hist_update = kernel
        kernel.launches = checked.launches
    th_launches = kernel.launches - before
    check(th_launches == 2048 // 16,
          f"thinned run launched hist_update {th_launches} times")
    check(len(same) == th_launches and all(same),
          f"thinned run: {same.count(False)} of {len(same)} CUDA "
          f"hist_update calls differ from the plain version")
    check(int(th.buffer_dropped.sum()) == 0,
          f"hist_every=3 run ({block} entries per block) without drops")
    check(bool(np.all(th.hist.sum(1) > 0)), "thinned histograms filled")
    emit("gen_contracts", split_bitwise=True, max_active_1_bitwise=True,
         thinned_block=block, thinned_launches=th_launches,
         thinned_matches_plain=True, thinned_jobs=th.n_jobs.tolist(),
         thinned_binned=th.hist.sum(1).tolist())


def _ladder_se(a, b, floor_frac: float = 0.015) -> float:
    """tests/test_gen_sweep.py's combined standard error of two seed
    ladders' means, floored at 1.5% of the reference mean."""
    se = math.sqrt(np.var(a, ddof=1) / len(a) + np.var(b, ddof=1) / len(b))
    return max(se, floor_frac * float(np.mean(b)))


def phase_gen_user_size(dev, grid: GenGrid, n_steps: int = 4096,
                        sweep_batches: int = 4000,
                        capture_at: int = 160) -> tuple:
    """Returns the phase's record and the path blocks of both kernels:
    their inputs at superstep ``capture_at``, cloned in the first run."""
    caps = gen_caps(grid)
    kw = dict(n_steps=n_steps, seed=29, device=dev)
    ss.hist_update.launches = 0
    ss.fifo_compact.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, blocks = run_captured(
        lambda: gen_sweep(grid, **kw), capture_at)
    first_s = time.perf_counter() - t0
    launches = {"hist_update": ss.hist_update.launches,
                "fifo_compact": ss.fifo_compact.launches}
    supersteps = n_steps // 16
    for name, n in launches.items():
        check(n == supersteps, f"gen user-size sweep launched {name} {n} "
              f"times, expected one per superstep ({supersteps})")
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r2 = gen_sweep(grid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(np.array_equal(r.hist, r2.hist)
          and np.array_equal(r.mean_latency, r2.mean_latency),
          "two gen user-size runs give the same bits")
    check(int(r.buffer_dropped.sum()) == 0,
          "gen user-size buffer_dropped == 0")
    check(bool(np.all(np.isfinite(r.mean_latency)) and np.all(r.n_jobs > 0)),
          "gen user-size results finite, every point completed jobs")

    # the static discipline is the paper's batch queue at the
    # equivalent request-level law: hold every static point against the
    # port's request-level sweep there
    st = np.flatnonzero(grid.discipline == 0)
    sg = SweepGrid.from_points(grid.lam[st], grid.equivalent_alpha[st],
                               grid.equivalent_tau0[st],
                               b_max=grid.max_active[st])
    rs = sweep(sg, n_batches=sweep_batches, seed=31, device=dev)
    check(int(rs.buffer_dropped.sum()) == 0,
          "equivalent-law sweep buffer_dropped == 0")
    gap = np.abs(r.mean_latency[st] - rs.mean_latency)
    tol = np.maximum(3.0 * np.hypot(r.ci_halfwidth[st], rs.ci_halfwidth),
                     0.04 * rs.mean_latency)
    worst = int(np.argmax(gap / tol))
    check(bool(np.all(gap <= tol)),
          f"{int((gap > tol).sum())} of {len(st)} static points outside "
          f"max(3·CI, 4%) of the equivalent-law sweep (worst: point "
          f"{int(st[worst])}, {r.mean_latency[st[worst]]} vs "
          f"{rs.mean_latency[worst]})")

    # two continuous points against the exact numpy loop; the tiles of
    # a point are its seed ladder.  The loop runs 60,000 jobs: at 12,000
    # its start-up transient still lifts the mean by ≈ 2% at ρ ≈ 0.76
    # (103.6 against 101.3 at 60,000, six seeds each, on the CPU),
    # which is more than the kernels' standard error
    cont = []
    n_base = len(GEN_RHOS) * len(GEN_GENS) * len(GEN_CAPS) * len(GEN_DISCS)
    for ci, (rho, gen, cap) in enumerate(GEN_CONT_POINTS):
        i = gen_index(rho, gen, cap, "continuous")
        ladder = r.mean_latency[i::n_base]
        ref = np.array(host_ladder("gen_continuous", ci))
        se = _ladder_se(ladder, ref)
        check(abs(ladder.mean() - ref.mean()) < 3.0 * se,
              f"continuous rho={rho} gen={gen} cap={cap}: "
              f"{ladder.mean()} vs numpy {ref.mean()} (3se={3 * se})")
        cont.append(dict(rho=rho, gen=gen, cap=cap,
                         kernel=float(ladder.mean()),
                         numpy=float(ref.mean()), se=se))
    jobs = int(r.n_jobs.sum())
    out = dict(points=len(grid), n_steps=n_steps, caps=caps,
               buffer_length=buffer_length(caps["q_cap"], caps["a_cap"],
                                           int(grid.max_active.max())),
               first_call_s=first_s, warm_s=warm_s, requests=jobs,
               requests_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
               launches=launches, supersteps=supersteps,
               static_points=len(st),
               static_worst_gap_over_tol=float(gap[worst] / tol[worst]),
               static_median_rel_gap=float(np.median(
                   gap / rs.mean_latency)),
               continuous_vs_numpy=cont)
    emit("gen_user_size", **out)
    return out, blocks, r


# tests/test_backpressure.py's seed ladders: (q_max, deadline, overflow,
# retry_rate, lam) on MODEL_BP, and (discipline, overflow, q_max,
# deadline, retry_rate) at GEN_BP_LAM on GEN_MODEL
MODEL_BP = LinearServiceModel(alpha=0.05, tau0=1.0)
SW_CFG = [(10, 6.0, "reject", 0.5, 6.0),
          (10, 6.0, "drop", 0.5, 6.0),
          (24, 3.0, "reject", 0.3, 7.5)]
GEN_CFG = [("continuous", "reject", 20, 40.0, 0.05),
           ("static", "drop", 20, 40.0, 0.05)]
GEN_BP_LAM = 1.08 / (GEN_MODEL.alpha_decode * 32
                     + GEN_MODEL.alpha_prefill * GEN_PROMPT)
LADDER_FIELDS = ("goodput_frac", "reject_frac", "abandon_frac",
                 "retry_inflation", "mean_latency")
# benchmarks/backpressure.py's grid on the V100 law: 4 ρ × 4 rooms × 3
# deadlines (ms) × 2 overflow modes × 2 retry rates (per ms) = 192 points
BP_B_MAX = 8
BP_RHOS = [0.7, 0.9, 1.1, 1.3]
BP_Q_MAXES = [4, 8, 16, 32]
BP_DEADLINES = [0.0, 6.0, 12.0]
BP_OVERFLOWS = ("reject", "drop")
BP_RETRY = [0.0, 0.2]


def check_accounting(r, what: str) -> None:
    """tests/test_backpressure.py's exact accounting laws on one run."""
    check(int(r.buffer_dropped.sum()) == 0, f"{what}: buffer_dropped == 0")
    offered = r.n_jobs + r.overflow_dropped + r.abandoned
    check(np.array_equal(r.offered, offered),
          f"{what}: offered = jobs + overflow + abandoned")
    total = r.goodput_frac + r.late_frac + r.reject_frac + r.abandon_frac
    check(bool(np.allclose(total[offered > 0], 1.0, atol=1e-6)),
          f"{what}: the four fractions sum to 1")
    check(bool(np.all(r.n_in_slo <= r.n_jobs)), f"{what}: n_in_slo <= n_jobs")
    check(bool(np.all(r.retry_inflation >= 1.0 - 1e-6)),
          f"{what}: retry_inflation >= 1")


def _gate_ladder(kernel_vals, ref_vals, label) -> dict:
    """tests/test_backpressure.py's 3σ gate (floors 1.5% relative and
    0.004 absolute)."""
    se = max(_ladder_se(kernel_vals, ref_vals), 0.004)
    gap = abs(float(np.mean(kernel_vals)) - float(np.mean(ref_vals)))
    check(gap < 3.0 * se, f"{label}: {np.mean(kernel_vals)} vs loss_ref "
          f"{np.mean(ref_vals)} (3se={3 * se})")
    return dict(kernel=float(np.mean(kernel_vals)),
                loss_ref=float(np.mean(ref_vals)), se=se)


def _counted(run, supersteps: int, what: str, compact: bool = False):
    """Run ``run()`` with the launch counts at 0; check one hist_update
    (and one fifo_compact) launch per superstep."""
    ss.hist_update.launches = 0
    ss.fifo_compact.launches = 0
    r = run()
    names = ("hist_update", "fifo_compact") if compact else ("hist_update",)
    for name in names:
        n = getattr(ss, name).launches
        check(n == supersteps, f"{what} launched {name} {n} times, expected "
              f"one per superstep ({supersteps})")
    return r


def phase_loss_contracts(dev) -> None:
    """The loss paths' bitwise contracts and seed ladders on the card."""
    m = GEN_MODEL
    # neutral reduction: the q_max = deadline = retry = 0 points of a
    # loss grid give the loss-free path's bits (tests/test_backpressure.py
    # shapes, pinned q_cap / a_cap, the same global indices)
    g = SweepGrid.from_points([6.0, 4.0, 5.0], MODEL_BP.alpha, MODEL_BP.tau0,
                              b_max=8, q_max=[10, 0, 0],
                              deadline=[6.0, 0.0, 0.0],
                              retry_rate=[0.5, 0.0, 0.0])
    kw = dict(n_batches=256, q_cap=64, a_cap=64, seed=11, device=dev)
    mixed = sweep(g, r_cap=32, **kw)
    base = sweep(g.take(slice(1, None)), key_offset=1, **kw)
    gg = GenGrid.from_points(
        [GEN_BP_LAM, 0.6 * GEN_BP_LAM, 0.4 * GEN_BP_LAM], m.alpha_decode,
        m.tau0_decode, m.alpha_prefill, m.tau0_prefill,
        prompt_len=GEN_PROMPT, gen_tokens=32, max_active=[32, 32, 16],
        discipline=["continuous", "continuous", "static"],
        q_max=[20, 0, 0], deadline=[40.0, 0.0, 0.0],
        retry_rate=[0.05, 0.0, 0.0])
    gkw = dict(n_steps=1024, q_cap=64, a_cap=64, seed=13, device=dev)
    gmixed = gen_sweep(gg, r_cap=32, **gkw)
    gbase = gen_sweep(gg.take(slice(1, None)), key_offset=1, **gkw)
    for name, (mx, bs) in {"sweep": (mixed, base),
                           "gen": (gmixed, gbase)}.items():
        for f in ("mean_latency", "mean_batch", "batch_m2", "utilization",
                  "n_jobs", "hist", "latency_p50", "latency_p99"):
            check(np.array_equal(getattr(mx, f)[1:], getattr(bs, f)),
                  f"{name} neutral points bitwise equal to the base path "
                  f"on {f}")
        check(int(mx.overflow_dropped[0] + mx.abandoned[0]) > 0
              and int(mx.overflow_dropped[1:].sum()
                      + mx.abandoned[1:].sum()) == 0,
              f"{name}: losses on the loss point only")

    # split dispatch with loss: chunks with key_offset and every cap,
    # r_cap included, pinned from the full grid
    g = SweepGrid.from_points(
        [6.0, 7.0, 6.0, 5.0], MODEL_BP.alpha, MODEL_BP.tau0, b_max=8,
        q_max=[10, 12, 0, 8], deadline=[6.0, 0.0, 0.0, 3.0],
        overflow=["reject", "drop", "reject", "reject"],
        retry_rate=[0.5, 0.0, 0.0, 1.0], dist=["det", "gamma"] * 2)
    gg = GenGrid.from_points(
        [GEN_BP_LAM] * 4, m.alpha_decode, m.tau0_decode, m.alpha_prefill,
        m.tau0_prefill, prompt_len=GEN_PROMPT, gen_tokens=32,
        max_active=[16, 32, 16, 8],
        discipline=["continuous", "static", "static", "continuous"],
        q_max=[20, 0, 12, 20], deadline=[40.0, 30.0, 0.0, 0.0],
        overflow=["reject", "drop", "drop", "reject"],
        retry_rate=[0.05, 0.0, 0.1, 0.0])
    for name, run, grid, kw in (
            ("sweep", sweep, g, dict(n_batches=128, seed=11,
                                     **sweep_caps(g))),
            ("gen", gen_sweep, gg, dict(n_steps=1024, seed=13,
                                        **gen_caps(gg)))):
        whole = run(grid, device=dev, **kw)
        a = run(grid.take(slice(0, 2)), device=dev, **kw)
        b = run(grid.take(slice(2, None)), key_offset=2, device=dev, **kw)
        for f in ("mean_latency", "mean_batch", "n_jobs", "hist",
                  "overflow_dropped", "abandoned", "n_in_slo", "n_fresh",
                  "n_retry", "max_queue"):
            split = np.concatenate([getattr(a, f), getattr(b, f)])
            check(np.array_equal(getattr(whole, f), split),
                  f"{name} split dispatch with loss bitwise on {f}")

    # the seed ladders against the port's own numpy mirrors; each loss
    # run launches hist_update (and fifo_compact) once per superstep
    cfg = [c for c in SW_CFG for _ in range(6)]
    g = SweepGrid.from_points(
        [c[4] for c in cfg], MODEL_BP.alpha, MODEL_BP.tau0, b_max=8,
        q_max=[c[0] for c in cfg], deadline=[c[1] for c in cfg],
        overflow=[c[2] for c in cfg], retry_rate=[c[3] for c in cfg])
    r = _counted(lambda: sweep(g, n_batches=6000, q_cap=64, a_cap=64,
                               r_cap=64, seed=11, device=dev),
                 -(-6000 // 32), "sweep ladder")
    check_accounting(r, "sweep ladder")
    check(bool(np.all(r.retry_inflation > 1.01)),
          "sweep ladder: retries inflate every point's arrivals")
    ladders = {}
    for ci in range(len(SW_CFG)):
        refs = host_ladder("loss_sweep", ci)
        sl = slice(ci * 6, (ci + 1) * 6)
        ladders[f"sweep_{ci}"] = {f: _gate_ladder(
            np.asarray(getattr(r, f)[sl], float),
            np.array([getattr(x, f) for x in refs]), f"sweep cfg {ci} {f}")
            for f in LADDER_FIELDS}
    cfg = [c for c in GEN_CFG for _ in range(6)]
    gg = GenGrid.from_points(
        [GEN_BP_LAM] * len(cfg), m.alpha_decode, m.tau0_decode,
        m.alpha_prefill, m.tau0_prefill, prompt_len=GEN_PROMPT,
        gen_tokens=32, max_active=64, discipline=[c[0] for c in cfg],
        q_max=[c[2] for c in cfg], deadline=[c[3] for c in cfg],
        overflow=[c[1] for c in cfg], retry_rate=[c[4] for c in cfg])
    # a_cap sized so the arrival chain always covers its windows: the
    # run-structured numpy mirror has no coverage splits
    r = _counted(lambda: gen_sweep(gg, n_steps=6000, q_cap=64, a_cap=96,
                                   r_cap=64, seed=5, device=dev),
                 -(-6000 // 2048) * 2048 // 16, "gen ladder", compact=True)
    check_accounting(r, "gen ladder")
    for ci in range(len(GEN_CFG)):
        refs = host_ladder("loss_gen", ci)
        sl = slice(ci * 6, (ci + 1) * 6)
        ladders[f"gen_{ci}"] = {f: _gate_ladder(
            np.asarray(getattr(r, f)[sl], float),
            np.array([getattr(x, f) for x in refs]), f"gen cfg {ci} {f}")
            for f in LADDER_FIELDS}
    emit("loss_contracts", neutral_bitwise=True, split_bitwise=True,
         accounting=True, launches_per_superstep=True, ladders=ladders)


def loss_grid(tiles: int = 43) -> SweepGrid:
    """benchmarks/backpressure.py's 192-point grid tiled ``tiles`` times:
    the copies of a point differ only in their global index, so they
    form a seed ladder."""
    cap = BP_B_MAX / (V100[0] * BP_B_MAX + V100[1])
    base = SweepGrid.from_product([r * cap for r in BP_RHOS], [V100[0]],
                                  [V100[1]], b_maxes=[BP_B_MAX],
                                  q_maxes=BP_Q_MAXES, deadlines=BP_DEADLINES,
                                  overflows=BP_OVERFLOWS,
                                  retry_rates=BP_RETRY)
    return base.take(np.tile(np.arange(len(base)), tiles))


def _tile_stats(vals: np.ndarray, n_base: int, i: int) -> dict:
    """Mean and standard error of point ``i``'s copies across tiles."""
    x = np.asarray(vals, float)[i::n_base]
    return {"mean": float(x.mean()),
            "se": float(x.std(ddof=1) / math.sqrt(len(x)))}


def phase_loss_user_size(dev, tiles: int = 43, n_batches: int = 3000,
                         capture_at: int = 60) -> tuple:
    """The backpressure benchmark's grid at 8,256 points, its run
    (a_cap 64, r_cap 96, seed 29); returns the record, the hist_update
    launches and the path block of superstep ``capture_at``."""
    grid = loss_grid(tiles)
    n_base = len(grid) // tiles
    kw = dict(n_batches=n_batches, a_cap=64, r_cap=96, seed=29, device=dev)
    supersteps = -(-n_batches // 32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, blocks = run_captured(lambda: _counted(
        lambda: sweep(grid, **kw), supersteps, "loss user-size sweep"),
        capture_at)
    first_s = time.perf_counter() - t0
    launches = ss.hist_update.launches
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r2 = sweep(grid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    for f in ("hist", "mean_latency", "overflow_dropped", "abandoned",
              "n_in_slo", "n_retry"):
        check(np.array_equal(getattr(r, f), getattr(r2, f)),
              f"two loss user-size runs give the same bits on {f}")
    check_accounting(r, "loss user-size")
    cap = BP_B_MAX / (V100[0] * BP_B_MAX + V100[1])

    def index(rho, q_max, deadline, overflow, retry) -> int:
        m = (np.isclose(grid.lam[:n_base], np.float32(rho * cap))
             & (grid.q_max[:n_base] == q_max)
             & (grid.deadline[:n_base] == np.float32(deadline))
             & (grid.overflow[:n_base] == OVERFLOW_CODE[overflow])
             & (grid.retry_rate[:n_base] == np.float32(retry)))
        (i,) = np.flatnonzero(m)
        return int(i)

    # a larger room turns fewer arrivals away (reject, no deadline, no
    # retry), at every load
    rooms = {}
    for rho in BP_RHOS:
        fr = [_tile_stats(r.reject_frac, n_base,
                          index(rho, q, 0.0, "reject", 0.0))["mean"]
              for q in BP_Q_MAXES]
        check(all(a >= b for a, b in zip(fr, fr[1:])) and fr[0] > fr[-1],
              f"rho={rho}: reject_frac {fr} falls as q_max grows")
        rooms[str(rho)] = fr
    frontier = {}
    for q in BP_Q_MAXES:
        i = index(1.1, q, 12.0, "reject", 0.0)
        frontier[str(q)] = {f: _tile_stats(getattr(r, f), n_base, i)
                            for f in ("mean_latency", "goodput_frac",
                                      "reject_frac")}
    i0 = index(1.3, 8, 12.0, "reject", 0.0)
    i1 = index(1.3, 8, 12.0, "reject", 0.2)
    tax = {"retry_inflation": _tile_stats(r.retry_inflation, n_base, i1),
           "goodput_frac_no_retry": _tile_stats(r.goodput_frac, n_base, i0),
           "goodput_frac_retry": _tile_stats(r.goodput_frac, n_base, i1),
           "EW_no_retry": _tile_stats(r.mean_latency, n_base, i0),
           "EW_retry": _tile_stats(r.mean_latency, n_base, i1)}
    jobs = int(r.n_jobs.sum())
    out = dict(points=len(grid), tiles=tiles, n_batches=n_batches,
               caps=dict(sweep_caps(grid), a_cap=64, r_cap=96),
               first_call_s=first_s, warm_s=warm_s, jobs=jobs,
               jobs_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
               launches=launches, supersteps=supersteps,
               reject_frac_by_room=rooms, frontier_rho_1_1=frontier,
               retry_tax_rho_1_3_q8=tax,
               goodput_frac_mean=float(r.goodput_frac.mean()),
               retry_inflation_max=float(r.retry_inflation.max()))
    emit("loss_user_size", **out)
    return out, launches, blocks["hist_update"]


def gen_loss_grid(grid: GenGrid, tiles: int = 16) -> GenGrid:
    """``gen_grid``'s points with loss axes by tile: tiles 0–3 neutral,
    4–7 reject at q_max 20, 8–11 drop at q_max 20 with retries at 0.05,
    12–15 reject at q_max 20 with retries at 0.05 and a deadline of
    twice the point's unloaded latency (prefill + gen decode steps)."""
    n = len(grid)
    tile = np.arange(n) // (n // tiles)
    band = tile // (tiles // 4)
    unloaded = (grid.alpha_prefill * grid.prompt_len + grid.tau0_prefill
                + grid.gen_tokens * (grid.alpha_decode + grid.tau0_decode))
    return dataclasses.replace(
        grid, q_max=np.where(band > 0, 20, 0).astype(np.int32),
        overflow=np.where(band == 2, OVERFLOW_CODE["drop"],
                          OVERFLOW_CODE["reject"]).astype(np.int32),
        retry_rate=np.where(band >= 2, 0.05, 0.0).astype(np.float32),
        deadline=np.where(band == 3, 2.0 * unloaded, 0.0).astype(np.float32))


def phase_gen_loss_user_size(dev, grid: GenGrid, base, n_steps: int = 4096,
                             capture_at: int = 160) -> tuple:
    """The generate sweep's loss path at full width: ``gen_grid`` with
    loss tiles, caps pinned to the base run's; tiles 0–3 bitwise equal
    to ``base`` (``gen_user_size``'s run: same seed, same indices).
    Returns the record and the path blocks of superstep
    ``capture_at``."""
    lgrid = gen_loss_grid(grid)
    caps = gen_caps(grid)
    caps["r_cap"] = gen_caps(lgrid)["r_cap"]
    kw = dict(n_steps=n_steps, seed=29, device=dev, **caps)
    supersteps = n_steps // 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, blocks = run_captured(lambda: _counted(
        lambda: gen_sweep(lgrid, **kw), supersteps,
        "gen loss user-size sweep", compact=True), capture_at)
    first_s = time.perf_counter() - t0
    launches = {"hist_update": ss.hist_update.launches,
                "fifo_compact": ss.fifo_compact.launches}
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r2 = gen_sweep(lgrid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(np.array_equal(r.hist, r2.hist)
          and np.array_equal(r.n_in_slo, r2.n_in_slo),
          "two gen loss user-size runs give the same bits")
    check_accounting(r, "gen loss user-size")
    neutral = np.arange(4 * len(grid) // 16)
    check(bool(np.all(lgrid.q_max[neutral] == 0)
               and np.all(lgrid.retry_rate[neutral] == 0)
               and np.all(lgrid.deadline[neutral] == 0)), "tiles 0-3 neutral")
    for f in ("mean_latency", "mean_batch", "batch_m2", "utilization",
              "n_jobs", "n_steps", "max_queue", "hist", "stderr"):
        check(np.array_equal(getattr(r, f)[neutral],
                             getattr(base, f)[neutral], equal_nan=True),
              f"gen loss tiles 0-3 bitwise equal to gen_user_size on {f}")
    bands = {}
    per = len(grid) // 4
    for bi, name in enumerate(("neutral", "reject", "drop_retry",
                               "reject_deadline_retry")):
        sl = slice(bi * per, (bi + 1) * per)
        bands[name] = {f: float(np.mean(getattr(r, f)[sl])) for f in (
            "goodput_frac", "reject_frac", "abandon_frac", "retry_inflation",
            "mean_latency")}
    # each loss band shows its regime at work: turned-away arrivals,
    # re-arrivals from the orbit, completions past the deadline
    check(bands["reject"]["reject_frac"] > 0
          and bands["drop_retry"]["retry_inflation"] > 1
          and bands["reject_deadline_retry"]["retry_inflation"] > 1
          and bands["reject_deadline_retry"]["goodput_frac"] < 1,
          f"the loss bands show their regimes: {bands}")
    jobs = int(r.n_jobs.sum())
    out = dict(points=len(lgrid), n_steps=n_steps, caps=caps,
               buffer_length=buffer_length(caps["q_cap"], caps["a_cap"],
                                           int(grid.max_active.max()),
                                           caps["r_cap"]),
               first_call_s=first_s, warm_s=warm_s, requests=jobs,
               requests_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
               launches=launches, supersteps=supersteps,
               neutral_tiles_bitwise=True, bands=bands)
    emit("gen_loss_user_size", **out)
    return out, blocks


# tests/test_failures.py's seed ladders: (fail_disc, mtbf, mttr,
# throttle, lam) on MODEL_BP at b_max 8, and (fail_disc, mtbf, mttr) at
# FAIL_GEN_LAM on GEN_MODEL (prompt 128, 32 tokens, max_active 64)
FAIL_SW_CFG = [("resume", 8.0, 0.5, 1.0, 4.0),
               ("restart", 8.0, 0.5, 1.0, 4.0),
               ("drop", 8.0, 0.5, 0.85, 4.0)]
FAIL_GEN_CFG = [("resume", 200.0, 5.0), ("restart", 200.0, 5.0),
                ("drop", 200.0, 5.0)]
FAIL_GEN_LAM = 0.7 / (GEN_MODEL.alpha_decode * 32
                      + GEN_MODEL.alpha_prefill * GEN_PROMPT)
FAIL_FIELDS = ("mean_latency", "utilization", "availability",
               "work_loss_frac")
# benchmarks/availability.py's single-server cells on the V100 law:
# (mtbf, mttr) in ms — failure-free, mild, harsh — under each
# discipline, and the chain cross-check's resume cells
AV_B_MAX = 8
AV_RHOS = [0.5, 0.75]
AV_FAIL_PAIRS = [(0.0, 0.0), (250.0, 12.0), (60.0, 12.0)]
AV_DISCS = ("resume", "restart", "drop")
AV_CHAIN_RHOS = [0.4, 0.6]
AV_CHAIN_PAIRS = [(40.0, 2.0), (10.0, 2.0), (60.0, 4.0), (20.0, 4.0)]


def check_fail_block(r, mtbf, resume, what: str) -> dict:
    """The failure block's witness and its law: no step's failure count
    was truncated (``fail_truncated``), and on the resume points
    (``resume`` mask) the measured breakdowns arrive at rate 1/MTBF over
    the measured busy time (a fleet's: utilization · k · span), within
    3√n (a truncated count falls short)."""
    check(int(r.fail_truncated.sum()) == 0, f"{what}: fail_truncated == 0")
    resume = np.asarray(resume, bool)
    busy = (np.asarray(r.utilization, float) * np.asarray(r.span, float)
            * np.asarray(getattr(r.grid, "k", 1), float))
    want = float((busy[resume] / np.asarray(mtbf, float)[resume]).sum())
    got = float(r.n_failures[resume].sum())
    z = (got - want) / math.sqrt(max(want, 1.0))
    check(abs(z) < 3.0, f"{what}: resume breakdowns {got} vs busy/MTBF "
          f"{want} (z={z})")
    return dict(resume_failures=got, busy_over_mtbf=want, z=z)


def check_fail_accounting(r, discs, what: str) -> None:
    """tests/test_failures.py's exact accounting laws on a failure run
    whose points all fail (``discs`` names each point's discipline)."""
    discs = np.asarray(discs)
    check(int(r.buffer_dropped.sum()) == 0, f"{what}: buffer_dropped == 0")
    check(int(r.fail_truncated.sum()) == 0, f"{what}: fail_truncated == 0")
    av = np.asarray(r.availability, float)
    check(bool(np.all((av > 0.0) & (av <= 1.0))), f"{what}: 0 < avail <= 1")
    check(bool(np.allclose(av, 1.0 - r.down_time / r.span)),
          f"{what}: availability = 1 - down_time / span")
    wl = np.asarray(r.work_loss_frac, float)
    check(bool(np.all((wl >= 0.0) & (wl < 1.0))), f"{what}: 0 <= wl < 1")
    check(bool(np.all(r.n_failures > 0) and np.all(r.down_time > 0.0)),
          f"{what}: every point failed and was repaired")
    lost = np.asarray(r.lost_work, float)
    check(bool(np.all(lost[discs == "resume"] == 0.0)
               and np.all(lost[discs != "resume"] > 0.0)),
          f"{what}: resume loses no work, restart and drop do")
    drop = discs == "drop"
    total = r.goodput_frac + r.late_frac + r.reject_frac + r.abandon_frac
    check(bool(np.allclose(total, 1.0, atol=1e-6)),
          f"{what}: the four fractions sum to 1")
    check(bool(np.all(r.abandoned[drop] > 0)
               and int(r.abandoned[~drop].sum()) == 0),
          f"{what}: only drop's aborted jobs are abandoned")


NEUTRAL_FIELDS = ("mean_latency", "mean_batch", "batch_m2", "utilization",
                  "n_jobs", "hist", "latency_p50", "latency_p99",
                  "max_queue", "stderr")


def phase_fail_contracts(dev) -> None:
    """The failure paths' bitwise contracts, seed ladders and exact
    chain on the card."""
    m = GEN_MODEL
    # mtbf = 0 points of a failure grid (with a drop point, a loss grid
    # too) give the failure-free path's bits at pinned caps; the
    # generate sweep's drop grid is gen_fail_user_size's, at full width
    for with_loss in (False, True):
        discs = ["drop" if with_loss else "restart", "resume", "resume"]
        g = SweepGrid.from_points(
            [4.0, 3.0, 2.0], MODEL_BP.alpha, MODEL_BP.tau0, b_max=8,
            fail_disc=discs, mtbf=[8.0, 0.0, 0.0], mttr=[0.5, 0.0, 0.0],
            throttle=[0.85, 1.0, 1.0])
        kw = dict(n_batches=256, q_cap=64, a_cap=64, seed=11, device=dev)
        gg = GenGrid.from_points(
            [FAIL_GEN_LAM, 0.8 * FAIL_GEN_LAM, 0.6 * FAIL_GEN_LAM],
            m.alpha_decode, m.tau0_decode, m.alpha_prefill, m.tau0_prefill,
            prompt_len=GEN_PROMPT, gen_tokens=32, max_active=[64, 32, 16],
            discipline=["continuous", "continuous", "static"],
            fail_disc=discs, mtbf=[200.0, 0.0, 0.0], mttr=[5.0, 0.0, 0.0])
        gkw = dict(n_steps=1024, q_cap=64, a_cap=96, seed=13, device=dev)
        pairs = {"sweep": (sweep(g, r_cap=32, **kw),
                           sweep(g.take(slice(1, None)), key_offset=1, **kw))}
        if not with_loss:
            pairs["gen"] = (gen_sweep(gg, r_cap=32, **gkw),
                            gen_sweep(gg.take(slice(1, None)), key_offset=1,
                                      **gkw))
        for name, (mx, bs) in pairs.items():
            for f in NEUTRAL_FIELDS:
                check(np.array_equal(getattr(mx, f)[1:], getattr(bs, f),
                                     equal_nan=True),
                      f"{name} mtbf=0 points bitwise equal to the base "
                      f"path on {f} (loss={with_loss})")
            check(int(mx.n_failures[0]) > 0
                  and int(mx.n_failures[1:].sum()) == 0
                  and bool(np.all(mx.availability[1:] == 1.0)),
                  f"{name}: failures on the failing point only")

    # split dispatch with failures: chunks with key_offset and every
    # cap pinned from the full grid; an unpinned chunk is refused
    discs = ["resume", "restart", "drop", "resume"]
    g = SweepGrid.from_points(
        [4.0, 3.5, 3.0, 2.5], MODEL_BP.alpha, MODEL_BP.tau0, b_max=8,
        fail_disc=discs, mtbf=[8.0, 8.0, 8.0, 0.0], mttr=[0.5, 0.5, 0.5, 0.0],
        throttle=[1.0, 0.85, 1.0, 1.0], dist=["det", "gamma"] * 2)
    gg = GenGrid.from_points(
        [FAIL_GEN_LAM] * 4, m.alpha_decode, m.tau0_decode, m.alpha_prefill,
        m.tau0_prefill, prompt_len=GEN_PROMPT, gen_tokens=32,
        max_active=[64, 32, 64, 16],
        discipline=["continuous", "static", "continuous", "static"],
        fail_disc=discs, mtbf=[200.0, 200.0, 200.0, 0.0],
        mttr=[5.0, 5.0, 5.0, 0.0], throttle=[0.85, 1.0, 1.0, 1.0])
    for name, run, grid, kw in (
            ("sweep", sweep, g, dict(n_batches=128, seed=11,
                                     **sweep_caps(g))),
            ("gen", gen_sweep, gg, dict(n_steps=1024, seed=13,
                                        **gen_caps(gg)))):
        whole = run(grid, device=dev, **kw)
        a = run(grid.take(slice(0, 2)), device=dev, **kw)
        b = run(grid.take(slice(2, None)), key_offset=2, device=dev, **kw)
        for f in ("mean_latency", "n_jobs", "hist", "n_failures",
                  "down_time", "lost_work", "utilization", "abandoned",
                  "fail_truncated"):
            split = np.concatenate([getattr(a, f), getattr(b, f)])
            check(np.array_equal(getattr(whole, f), split),
                  f"{name} split dispatch with failures bitwise on {f}")
        kw.pop("q_cap")
        try:
            run(grid.take(slice(2, None)), key_offset=2, device=dev, **kw)
        except ValueError as e:
            check("q_cap" in str(e), f"{name}: unpinned chunk refused: {e}")
        else:
            check(False, f"{name}: an unpinned chunk of a failure grid ran")

    # the seed ladders against the port's own numpy mirrors; each run
    # launches hist_update (and fifo_compact) once per superstep
    ladders = {}
    cfg = [c for c in FAIL_SW_CFG for _ in range(6)]
    g = SweepGrid.from_points(
        [c[4] for c in cfg], MODEL_BP.alpha, MODEL_BP.tau0, b_max=8,
        fail_disc=[c[0] for c in cfg], mtbf=[c[1] for c in cfg],
        mttr=[c[2] for c in cfg], throttle=[c[3] for c in cfg])
    r = _counted(lambda: sweep(g, n_batches=4000, q_cap=64, a_cap=64,
                               r_cap=64, seed=11, device=dev),
                 -(-4000 // 32), "sweep failure ladder")
    check_fail_accounting(r, [c[0] for c in cfg], "sweep failure ladder")
    blocks = {"sweep": check_fail_block(
        r, g.mtbf, np.array([c[0] for c in cfg]) == "resume",
        "sweep failure ladder")}
    for ci, (disc, *_) in enumerate(FAIL_SW_CFG):
        refs = host_ladder("fail_sweep", ci)
        sl = slice(ci * 6, (ci + 1) * 6)
        ladders[f"sweep_{disc}"] = {f: _gate_ladder(
            np.asarray(getattr(r, f)[sl], float),
            np.array([getattr(x, f) for x in refs]), f"sweep {disc} {f}")
            for f in FAIL_FIELDS}
    cfg = [c for c in FAIL_GEN_CFG for _ in range(6)]
    gg = GenGrid.from_points(
        [FAIL_GEN_LAM] * len(cfg), m.alpha_decode, m.tau0_decode,
        m.alpha_prefill, m.tau0_prefill, prompt_len=GEN_PROMPT,
        gen_tokens=32, max_active=64, fail_disc=[c[0] for c in cfg],
        mtbf=[c[1] for c in cfg], mttr=[c[2] for c in cfg])
    r = _counted(lambda: gen_sweep(gg, n_steps=4096, q_cap=96, a_cap=96,
                                   r_cap=64, seed=5, device=dev),
                 4096 // 16, "gen failure ladder", compact=True)
    check_fail_accounting(r, [c[0] for c in cfg], "gen failure ladder")
    blocks["gen"] = check_fail_block(
        r, gg.mtbf, np.array([c[0] for c in cfg]) == "resume",
        "gen failure ladder")
    for ci, (disc, *_) in enumerate(FAIL_GEN_CFG):
        refs = host_ladder("fail_gen", ci)
        sl = slice(ci * 6, (ci + 1) * 6)
        ladders[f"gen_{disc}"] = {f: _gate_ladder(
            np.asarray(getattr(r, f)[sl], float),
            np.array([getattr(x, f) for x in refs]), f"gen {disc} {f}")
            for f in FAIL_FIELDS}

    # resume and restart against the exact completion-time chain
    # (tests/test_failures.py's TestChainVsMC), 8 copies each
    lam, mtbf, mttr = 3.0, 8.0, 0.5
    g = SweepGrid.from_points([lam] * 16, MODEL_BP.alpha, MODEL_BP.tau0,
                              b_max=8, fail_disc=["resume"] * 8
                              + ["restart"] * 8, mtbf=mtbf, mttr=mttr)
    r = sweep(g, n_batches=4000, q_cap=64, a_cap=64, seed=3, device=dev)
    blocks["chain"] = check_fail_block(r, g.mtbf, np.arange(16) < 8,
                                       "chain cells")
    chain = {}
    for i, disc in enumerate(("resume", "restart")):
        ex = markov_solve(lam, MODEL_BP, b_max=8, mtbf=mtbf, mttr=mttr,
                          fail_disc=disc)
        lat = np.asarray(r.mean_latency[i * 8:(i + 1) * 8], float)
        se = max(lat.std(ddof=1) / math.sqrt(8), 0.003 * ex.mean_latency)
        z = (lat.mean() - ex.mean_latency) / se
        av = float(np.mean(r.availability[i * 8:(i + 1) * 8]))
        check(abs(z) < 3.0, f"{disc}: E[W] {lat.mean()} vs chain "
              f"{ex.mean_latency} (z={z})")
        check(abs(av - ex.availability) < 0.01,
              f"{disc}: availability {av} vs chain {ex.availability}")
        chain[disc] = dict(kernel=float(lat.mean()), chain=ex.mean_latency,
                           z=float(z), availability=av,
                           chain_availability=ex.availability)
    emit("fail_contracts", neutral_bitwise=True, split_bitwise=True,
         accounting=True, launches_per_superstep=True, ladders=ladders,
         chain=chain, fail_block=blocks)


def fail_grid(tiles: int = 316) -> tuple:
    """benchmarks/availability.py's single-server cells — 2 ρ × 3
    (mtbf, mttr) pairs × 3 disciplines and the 2 × 4 resume chain cells,
    26 in all — on the V100 law at b_max 8, tiled ``tiles`` times: the
    copies of a cell differ only in their global index, so they form a
    seed ladder.  Returns the grid and the cells."""
    cap = AV_B_MAX / (V100[0] * AV_B_MAX + V100[1])
    cells = [(rho, mb, mr, d) for rho in AV_RHOS
             for (mb, mr) in AV_FAIL_PAIRS for d in AV_DISCS]
    cells += [(rho, mb, mr, "resume") for rho in AV_CHAIN_RHOS
              for (mb, mr) in AV_CHAIN_PAIRS]
    base = SweepGrid.from_points(
        [c[0] * cap for c in cells], V100[0], V100[1], b_max=AV_B_MAX,
        mtbf=[c[1] for c in cells], mttr=[c[2] for c in cells],
        fail_disc=[c[3] for c in cells])
    return base.take(np.tile(np.arange(len(base)), tiles)), cells


def phase_fail_user_size(dev, tiles: int = 316, n_batches: int = 3000,
                         capture_at: int = 60) -> tuple:
    """The availability benchmark's single-server grid at 8,216 points:
    q_cap sized as the benchmark sizes it (the worst cell's completion
    law, restart at the harsh pair), a_cap = q_cap (``sweep_caps``' rule
    for failure grids: a failed batch's completion has no bound), r_cap
    64, seed 31.  Returns the record, the hist_update launches and the
    path block of superstep ``capture_at``."""
    grid, cells = fail_grid(tiles)
    n_base = len(cells)
    cap = AV_B_MAX / (V100[0] * AV_B_MAX + V100[1])
    q_cap = engine.queue_capacity(max(AV_RHOS) * cap, V100[0], V100[1],
                                  AV_B_MAX, mtbf=60.0, mttr=12.0,
                                  restart=True)
    kw = dict(n_batches=n_batches, q_cap=q_cap, a_cap=q_cap, r_cap=64,
              seed=31, device=dev)
    supersteps = -(-n_batches // 32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, blocks = run_captured(lambda: _counted(
        lambda: sweep(grid, **kw), supersteps, "failure user-size sweep"),
        capture_at)
    first_s = time.perf_counter() - t0
    launches = ss.hist_update.launches
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r2 = sweep(grid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    for f in ("hist", "mean_latency", "n_failures", "down_time",
              "lost_work", "abandoned"):
        check(np.array_equal(getattr(r, f), getattr(r2, f)),
              f"two failure user-size runs give the same bits on {f}")
    check(int(r.buffer_dropped.sum()) == 0,
          "failure user-size buffer_dropped == 0")
    fail_block = check_fail_block(
        r, grid.mtbf, np.array([c[3] == "resume" and c[1] > 0
                                for c in cells] * tiles),
        "failure user-size")
    total = r.goodput_frac + r.late_frac + r.reject_frac + r.abandon_frac
    check(bool(np.allclose(total, 1.0, atol=1e-6)),
          "failure user-size: the four fractions sum to 1")
    failing = np.array([c[1] > 0 for c in cells] * tiles)
    av = np.asarray(r.availability, float)
    check(bool(np.all(av[~failing] == 1.0)
               and np.all((av[failing] > 0.0) & (av[failing] < 1.0))),
          "failure user-size: availability 1 without failures, in (0, 1) "
          "with them")

    def index(rho, pair, disc) -> int:
        (i,) = [j for j, c in enumerate(cells)
                if c == (rho, pair[0], pair[1], disc)]
        return i

    # the benchmark's frontier: each discipline at the harsh pair
    # against its failure-free cell, ρ 0.75, as tile means
    frontier = {}
    for disc in AV_DISCS:
        i = index(0.75, (60.0, 12.0), disc)
        i0 = index(0.75, (0.0, 0.0), disc)
        lat = np.asarray(r.mean_latency, float)
        ratio = lat[i::n_base] / lat[i0::n_base]
        frontier[disc] = dict(
            latency_ratio=_tile_stats(ratio, 1, 0),
            availability=_tile_stats(r.availability, n_base, i),
            work_loss_frac=_tile_stats(r.work_loss_frac, n_base, i),
            abandon_frac=_tile_stats(r.abandon_frac, n_base, i))
    check(frontier["restart"]["work_loss_frac"]["mean"]
          > frontier["resume"]["work_loss_frac"]["mean"] == 0.0,
          f"restart loses work, resume none: {frontier}")
    # the chain cells against the port's exact completion-time chain
    chain = []
    for rho, (mb, mr) in ((rho, p) for rho in AV_CHAIN_RHOS
                          for p in AV_CHAIN_PAIRS):
        i = index(rho, (mb, mr), "resume")
        ex = markov_solve(float(grid.lam[i]),
                          LinearServiceModel(*V100), b_max=AV_B_MAX,
                          mtbf=mb, mttr=mr, fail_disc="resume")
        lat = np.asarray(r.mean_latency, float)[i::n_base]
        se = max(lat.std(ddof=1) / math.sqrt(tiles),
                 0.003 * ex.mean_latency)
        chain.append(dict(
            rho=rho, mtbf=mb, mttr=mr, kernel=float(lat.mean()),
            chain=ex.mean_latency, z=float((lat.mean() - ex.mean_latency)
                                           / se),
            availability=float(np.mean(r.availability[i::n_base])),
            chain_availability=ex.availability))
    jobs = int(r.n_jobs.sum())
    out = dict(points=len(grid), tiles=tiles, n_batches=n_batches,
               caps=dict(q_cap=q_cap, a_cap=q_cap, r_cap=64,
                         sweep_caps=sweep_caps(grid)),
               fail_block=fail_block,
               first_call_s=first_s, warm_s=warm_s, jobs=jobs,
               jobs_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
               launches=launches, supersteps=supersteps, buffer_dropped=0,
               frontier_rho_0_75=frontier, chain=chain,
               chain_max_abs_z=max(abs(c["z"]) for c in chain),
               chain_availability_max_abs_err=max(
                   abs(c["availability"] - c["chain_availability"])
                   for c in chain))
    emit("fail_user_size", **out)
    return out, launches, blocks["hist_update"]


# the generate failure tiles: mtbf and mttr (ms) by discipline.  Resume
# and drop take GEN_CFG's 200 and 5; restart at 200 is unstable on this
# grid's static runs of up to ≈ 3.1 s (15 MTBFs: completion inflation
# e^15, gen_caps q_cap 8,192), so restart takes 20,000 (0.15 MTBFs a
# run at most), where it is stable and still fails on the long runs
GEN_FAIL_PAIRS = {"resume": (200.0, 5.0), "restart": (20_000.0, 5.0),
                  "drop": (200.0, 5.0)}
# the grid's longest run: the static gen-256 cap-64 point at ρ 0.85,
# 15 resume MTBFs a run, held against the mirror (which draws the
# breakdown count unbounded) on its resume tiles at throttle 1
GEN_LONG = (0.85, 256, 64, "static")


def gen_fail_grid(grid: GenGrid, tiles: int = 16) -> GenGrid:
    """``gen_grid``'s points with failure axes by tile: tiles 0–3
    failure-free, 4–7 resume, 8–11 restart, 12–15 drop
    (``GEN_FAIL_PAIRS``), odd tiles degraded after a repair (throttle
    0.85)."""
    n = len(grid)
    tile = np.arange(n) // (n // tiles)
    band = np.clip(tile // (tiles // 4) - 1, -1, 2)
    names = np.array(AV_DISCS)[np.clip(band, 0, 2)]
    mtbf = np.array([GEN_FAIL_PAIRS[d][0] for d in names])
    mttr = np.array([GEN_FAIL_PAIRS[d][1] for d in names])
    return dataclasses.replace(
        grid, mtbf=np.where(band >= 0, mtbf, 0.0).astype(np.float32),
        mttr=np.where(band >= 0, mttr, 0.0).astype(np.float32),
        fail_disc=np.clip(band, 0, 2).astype(np.int32),
        throttle=np.where((band >= 0) & (tile % 2 == 1), 0.85,
                          1.0).astype(np.float32))


def phase_gen_fail_user_size(dev, grid: GenGrid, n_steps: int = 4096,
                             capture_at: int = 160) -> tuple:
    """The generate sweep's failure path at full width: ``gen_grid``
    with failure tiles and its own ``gen_caps``; tiles 0–3 bitwise equal
    to a failure-free run of the same points with those caps pinned.
    One timed run (the eager loop has nothing to warm: the other
    generate phases' first and warm calls differ by the host's noise).
    Returns the record and the path blocks of superstep
    ``capture_at``."""
    fgrid = gen_fail_grid(grid)
    caps = gen_caps(fgrid)
    kw = dict(n_steps=n_steps, seed=29, device=dev, **caps)
    supersteps = n_steps // 16
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, blocks = run_captured(lambda: _counted(
        lambda: gen_sweep(fgrid, **kw), supersteps,
        "gen failure user-size sweep", compact=True), capture_at)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {"hist_update": ss.hist_update.launches,
                "fifo_compact": ss.fifo_compact.launches}
    check(int(r.buffer_dropped.sum()) == 0,
          "gen failure user-size buffer_dropped == 0")
    fail_block = check_fail_block(
        r, fgrid.mtbf, (fgrid.mtbf > 0) & (fgrid.fail_disc == 0),
        "gen failure user-size")
    # the longest run's resume copies at throttle 1 (tiles 4 and 6)
    # against the mirror
    i0 = gen_index(*GEN_LONG)
    per_tile = len(grid) // 16
    long_i = [i0 + tile * per_tile for tile in (4, 6)]
    check(bool(np.all(fgrid.mtbf[long_i] == GEN_FAIL_PAIRS["resume"][0])
               and np.all(fgrid.fail_disc[long_i] == 0)
               and np.all(fgrid.throttle[long_i] == 1.0)),
          "the long-run copies are resume at throttle 1")
    mirror = [simulate_gen_loss_numpy(
        float(fgrid.lam[i0]), GEN_MODEL, prompt_len=GEN_PROMPT,
        gen_tokens=GEN_LONG[1], max_active=GEN_LONG[2],
        discipline=GEN_LONG[3], mtbf=GEN_FAIL_PAIRS["resume"][0],
        mttr=GEN_FAIL_PAIRS["resume"][1], fail_disc="resume",
        q_cap=caps["q_cap"], n_steps=12_000, seed=s) for s in range(3)]
    long_run = {f: _gate_ladder(
        np.asarray(getattr(r, f)[long_i], float),
        np.array([getattr(x, f) for x in mirror]), f"gen long resume {f}")
        for f in FAIL_FIELDS}
    total = r.goodput_frac + r.late_frac + r.reject_frac + r.abandon_frac
    check(bool(np.allclose(total, 1.0, atol=1e-6)),
          "gen failure user-size: the four fractions sum to 1")
    per = len(grid) // 4
    neutral = slice(0, per)
    check(bool(np.all(fgrid.mtbf[neutral] == 0)), "tiles 0-3 failure-free")
    base = gen_sweep(grid.take(neutral), n_steps=n_steps, seed=29,
                     device=dev, q_cap=caps["q_cap"], a_cap=caps["a_cap"])
    for f in ("mean_latency", "mean_batch", "batch_m2", "utilization",
              "n_jobs", "n_steps", "max_queue", "hist", "stderr"):
        check(np.array_equal(getattr(r, f)[neutral], getattr(base, f),
                             equal_nan=True),
              f"gen failure tiles 0-3 bitwise equal to a failure-free run "
              f"on {f}")
    bands = {}
    for bi, name in enumerate(("failure_free",) + AV_DISCS):
        sl = slice(bi * per, (bi + 1) * per)
        bands[name] = {f: float(np.mean(getattr(r, f)[sl])) for f in (
            "availability", "work_loss_frac", "abandon_frac",
            "mean_latency", "utilization")}
        bands[name]["n_failures"] = int(r.n_failures[sl].sum())
    check(bands["failure_free"]["availability"] == 1.0
          and all(bands[d]["n_failures"] > 0 for d in AV_DISCS)
          and bands["resume"]["work_loss_frac"] == 0.0
          and bands["drop"]["abandon_frac"] > 0.0,
          f"the failure bands show their regimes: {bands}")
    jobs = int(r.n_jobs.sum())
    out = dict(points=len(fgrid), n_steps=n_steps, caps=caps,
               pairs=GEN_FAIL_PAIRS,
               buffer_length=buffer_length(caps["q_cap"], caps["a_cap"],
                                           int(grid.max_active.max()),
                                           caps["r_cap"]),
               wall_s=wall_s, requests=jobs, requests_per_s=jobs / wall_s,
               peak_mem_bytes=peak, launches=launches,
               supersteps=supersteps, buffer_dropped=0,
               neutral_tiles_bitwise=True, bands=bands,
               fail_block=fail_block, long_resume_vs_mirror=long_run)
    emit("gen_fail_user_size", **out)
    return out, blocks


# -- the k-replica fleet (fleet_sweep) and the chain grid solver --------------

# tests/test_fleet.py's shared dispatch: k = 1 under each routing, a k = 4
# random and round-robin split, a k = 1 timeout point, a k = 4 JSQ ladder
FLEET_KW = dict(n_steps=4992, q_cap=128, a_cap=32, seed=7)
FLEET_LAM1 = 0.5 / V100[0]
FLEET_JSQ = 6
# the FL_CFG ladders of tests/test_backpressure.py (routing, overflow,
# q_max, deadline, retry) and tests/test_failures.py (fail_disc, routing)
FLEET_BP_CFG = [("random", "reject", 6, 4.0, 0.5),
                ("jsq", "drop", 12, 1.8, 0.5)]
FLEET_BP = (8.0, 2, 4)               # λ, k, b_max
FLEET_FAIL_CFG = [("resume", "jsq"), ("restart", "random"),
                  ("drop", "round_robin")]
FLEET_FAIL = (6.0, 2, 4, 8.0, 0.5)   # λ, k, b_max, mtbf, mttr
FLEET_REPS = 12
# benchmarks/replicas.py's grid: total load as a fraction of ONE
# replica's saturation rate × k 1…16 × 3 routings
REP_RHO1S = [0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.5, 0.6, 0.7, 0.8]
REP_KS = list(range(1, 17))
REP_ROUTINGS = ("random", "round_robin", "jsq")
# benchmarks/availability.py's fleet half: k 1 and 4, JSQ
AV_KS = [1, 4]
# examples/exact_surface.py's grid
SURFACE_B_MAXES = (1, 2, 4, 8, 16, 32, 64, 128)
SURFACE_FRACS = 24


def check_fleet_accounting(r, what: str) -> None:
    """The fleet's exact laws on one run: no capacity drop, every
    measured job attributed to exactly one active replica, and on loss
    grids the accounting laws of ``check_accounting``."""
    check(int(r.buffer_dropped.sum()) == 0, f"{what}: buffer_dropped == 0")
    check(np.array_equal(r.jobs_by_replica.sum(1), r.n_jobs),
          f"{what}: jobs_by_replica sums to n_jobs")
    k = np.asarray(r.grid.k)
    inactive = np.arange(r.jobs_by_replica.shape[1]) >= k[:, None]
    check(int(r.jobs_by_replica[inactive].sum()) == 0,
          f"{what}: no job on an inactive replica")
    if r.grid.has_loss:
        check_accounting(r, what)
    if r.grid.has_fail:
        av = np.asarray(r.availability, float)
        check(bool(np.allclose(av, 1.0 - r.down_time / (k * r.span))),
              f"{what}: availability = 1 - down_time / (k span)")


def _z_gate(a, se_a, b, se_b, what: str, floor: float = 0.01) -> float:
    """|a − b| within 3σ of the two batch-means errors (``floor`` of b
    at least)."""
    se = max(math.hypot(se_a, se_b), floor * abs(b))
    z = (a - b) / se
    check(abs(z) < 3.0, f"{what}: {a} vs {b} (z={z})")
    return float(z)


def phase_fleet_contracts(dev) -> dict:
    """The fleet's bitwise contracts, its reductions to the single
    server, and its seed ladders against the host oracles, on the
    card."""
    m = MODEL_BP
    # one mixed grid: a loss point, two failure points (drop makes it a
    # loss grid too), and three neutral points, every routing
    g = FleetGrid.from_points(
        [9.0, 6.0, 6.0, 5.0, 4.0, 5.5], m.alpha, m.tau0,
        k=[2, 2, 2, 2, 3, 2], b_max=4,
        routing=["jsq", "random", "round_robin", "jsq", "random",
                 "round_robin"],
        dist=["det", "gamma", "det", "det", "exp", "det"],
        q_max=[10, 0, 0, 0, 0, 0], deadline=[6.0, 0, 0, 0, 0, 0],
        retry_rate=[0.5, 0, 0, 0, 0, 0],
        fail_disc=["resume", "restart", "drop", "resume", "resume",
                   "resume"],
        mtbf=[0.0, 8.0, 8.0, 0.0, 0.0, 0.0], mttr=[0.0, 0.5, 0.5, 0, 0, 0],
        throttle=[1.0, 0.85, 1.0, 1.0, 1.0, 1.0])
    caps = fleet_caps(g)
    kw = dict(n_steps=256, a_cap=16, seed=13, device=dev, **caps)
    whole = _counted(lambda: fleet_sweep(g, **kw), 8, "fleet mixed grid")
    a = fleet_sweep(g.take(slice(0, 2)), **kw)
    b = fleet_sweep(g.take(slice(2, None)), key_offset=2, **kw)
    for f in ("mean_latency", "mean_batch", "utilization", "n_jobs", "hist",
              "jobs_by_replica", "stderr", "max_queue", "abandoned",
              "overflow_dropped", "n_retry", "n_failures", "down_time",
              "lost_work", "fail_truncated"):
        want = getattr(whole, f)
        parts = [getattr(x, f) for x in (a, b)]
        if f == "jobs_by_replica":
            # a chunk's replica axis is its own k_max wide
            parts = [np.pad(x, ((0, 0), (0, want.shape[1] - x.shape[1])))
                     for x in parts]
        split = np.concatenate(parts)
        check(np.array_equal(want, split, equal_nan=True),
              f"fleet split dispatch bitwise on {f}")
    kw.pop("q_cap")
    try:
        fleet_sweep(g.take(slice(2, None)), key_offset=2, **kw)
    except ValueError as e:
        check("q_cap" in str(e), f"fleet: unpinned chunk refused: {e}")
    else:
        check(False, "fleet: an unpinned chunk ran")
    # the neutral points (no q_max, deadline, retry or mtbf) give the
    # loss- and failure-free path's bits at the same caps and indices
    base = fleet_sweep(g.take(slice(3, None)), key_offset=3, n_steps=256,
                       a_cap=16, q_cap=caps["q_cap"], seed=13, device=dev)
    check(not g.take(slice(3, None)).has_loss, "the neutral slice is plain")
    for f in NEUTRAL_FIELDS + ("jobs_by_replica", "mean_service"):
        got = getattr(whole, f)[3:]
        if f == "jobs_by_replica":
            got = got[:, :base.jobs_by_replica.shape[1]]
        check(np.array_equal(got, getattr(base, f), equal_nan=True),
              f"fleet neutral points bitwise equal to the base path on {f}")
    check(int(whole.overflow_dropped[0] + whole.abandoned[0]) > 0
          and int(whole.n_failures[1:3].min()) > 0
          and int(whole.n_failures[3:].sum()) == 0,
          "fleet mixed grid: the loss and failure points lose and fail")

    # tests/test_fleet.py's grid: k = 1 is the single server for every
    # routing, a random 1/k split is the single queue at λ/k, JSQ
    # against the per-event numpy loop
    lam1 = FLEET_LAM1
    lam = [lam1] * 3 + [4 * lam1] * 2 + [lam1] + [4 * lam1] * FLEET_JSQ
    fg = FleetGrid.from_points(
        lam, *V100, k=[1, 1, 1, 4, 4, 1] + [4] * FLEET_JSQ,
        routing=(["random", "round_robin", "jsq", "random", "round_robin",
                  "random"] + ["jsq"] * FLEET_JSQ),
        b_max=[0] * 5 + [64] + [0] * FLEET_JSQ,
        wait_max=[0.0] * 5 + [5.0] + [0.0] * FLEET_JSQ,
        wait_target=[0] * 5 + [32] + [0] * FLEET_JSQ)
    n_super = FLEET_KW["n_steps"] // 32
    r = _counted(lambda: fleet_sweep(fg, device=dev, **FLEET_KW), n_super,
                 "fleet test grid")
    check_fleet_accounting(r, "fleet test grid")
    s = sweep(SweepGrid.from_points([lam1, lam1], *V100, b_max=[0, 64],
                                    wait_max=[0.0, 5.0], wait_target=[0, 32]),
              n_batches=6016, seed=5, device=dev)
    reductions = {}
    for i, j, name in ((0, 0, "k1_random"), (1, 0, "k1_round_robin"),
                       (2, 0, "k1_jsq"), (3, 0, "k4_random_split"),
                       (5, 1, "k1_timeout")):
        reductions[name] = dict(
            fleet=float(r.mean_latency[i]), sweep=float(s.mean_latency[j]),
            z=_z_gate(float(r.mean_latency[i]), float(r.stderr[i]),
                      float(s.mean_latency[j]), float(s.stderr[j]), name))
    jsq = r.mean_latency[6:6 + FLEET_JSQ]
    legacy = np.array(host_ladder("fleet_jsq", 0))
    se = max(_ladder_se(jsq, legacy), 0.01 * legacy.mean())
    check(abs(jsq.mean() - legacy.mean()) < 3.0 * se,
          f"fleet JSQ {jsq.mean()} vs the numpy loop {legacy.mean()}")
    bal = r.balance(4)
    check(bool(np.all(np.abs(bal - 0.25) < 0.05)),
          f"round-robin balances k = 4: {bal}")

    # the FL_CFG ladders, both in one dispatch, against the port's fleet
    # mirror: more copies at half the tests' steps (the card's wall time
    # is per step, not per point)
    lb, kb, bb = FLEET_BP
    lf, kf, bf, mtbf, mttr = FLEET_FAIL
    cfg_l = [c for c in FLEET_BP_CFG for _ in range(FLEET_REPS)]
    cfg_f = [c for c in FLEET_FAIL_CFG for _ in range(FLEET_REPS)]
    n_l = len(cfg_l)
    lg = FleetGrid.from_points(
        [lb] * n_l + [lf] * len(cfg_f), m.alpha, m.tau0,
        k=[kb] * n_l + [kf] * len(cfg_f), b_max=[bb] * n_l + [bf] * len(cfg_f),
        routing=[c[0] for c in cfg_l] + [c[1] for c in cfg_f],
        overflow=[c[1] for c in cfg_l] + ["reject"] * len(cfg_f),
        q_max=[c[2] for c in cfg_l] + [0] * len(cfg_f),
        deadline=[c[3] for c in cfg_l] + [0.0] * len(cfg_f),
        retry_rate=[c[4] for c in cfg_l] + [0.0] * len(cfg_f),
        fail_disc=["resume"] * n_l + [c[0] for c in cfg_f],
        mtbf=[0.0] * n_l + [mtbf] * len(cfg_f),
        mttr=[0.0] * n_l + [mttr] * len(cfg_f))
    lr = _counted(lambda: fleet_sweep(lg, n_steps=4000, q_cap=64, a_cap=32,
                                      r_cap=64, seed=7, device=dev),
                  -(-4000 // 32), "fleet ladders")
    check_fleet_accounting(lr, "fleet ladders")
    discs = np.array(["none"] * n_l + [c[0] for c in cfg_f])
    lost = np.asarray(lr.lost_work, float)
    check(int(lr.n_failures[:n_l].sum()) == 0
          and bool(np.all(lr.n_failures[n_l:] > 0))
          and bool(np.all(lost[discs == "resume"] == 0.0))
          and bool(np.all(lost[(discs == "restart") | (discs == "drop")]
                          > 0.0))
          and bool(np.all(lr.abandoned[discs == "drop"] > 0)),
          "fleet ladders: failures on the failure copies, resume loses no "
          "work, restart and drop do, drop abandons")
    fail_rate = check_fail_block(lr, lg.mtbf, discs == "resume",
                                 "fleet ladders")
    ladders = {}
    for ci, (route, ov, *_) in enumerate(FLEET_BP_CFG):
        refs = host_ladder("fleet_loss", ci)
        sl = slice(ci * FLEET_REPS, (ci + 1) * FLEET_REPS)
        ladders[f"loss_{route}_{ov}"] = {f: _gate_ladder(
            np.asarray(getattr(lr, f)[sl], float),
            np.array([getattr(x, f) for x in refs]), f"fleet {route} {f}")
            for f in LADDER_FIELDS}
    for ci, (disc, route) in enumerate(FLEET_FAIL_CFG):
        refs = host_ladder("fleet_fail", ci)
        sl = slice(n_l + ci * FLEET_REPS, n_l + (ci + 1) * FLEET_REPS)
        ladders[f"fail_{disc}_{route}"] = {f: _gate_ladder(
            np.asarray(getattr(lr, f)[sl], float),
            np.array([getattr(x, f) for x in refs]), f"fleet {disc} {f}")
            for f in FAIL_FIELDS}
    out = dict(split_bitwise=True, neutral_bitwise=True, unpinned_refused=True,
               accounting=True, launches_per_superstep=True,
               reductions=reductions,
               jsq_vs_numpy=dict(fleet=float(jsq.mean()),
                                 numpy=float(legacy.mean()), se=se),
               round_robin_balance=bal.tolist(), ladders=ladders,
               fail_rate=fail_rate)
    emit("fleet_contracts", **out)
    return out


def replicas_grid(tiles: int = 16) -> tuple:
    """benchmarks/replicas.py's grid — 11 total loads (fractions of one
    replica's saturation rate 1/α) × k 1…16 × 3 routings = 528 points,
    λ-major and routing-minor — tiled ``tiles`` times: the copies of a
    point differ only in their global index, so they form a seed
    ladder.  Returns the grid and the base point count."""
    base = FleetGrid.from_product([r / V100[0] for r in REP_RHO1S],
                                  [V100[0]], [V100[1]], ks=REP_KS,
                                  routings=REP_ROUTINGS)
    return base.take(np.tile(np.arange(len(base)), tiles)), len(base)


def replicas_index(rho1: float, k: int, routing: str) -> int:
    return ((REP_RHO1S.index(rho1) * len(REP_KS) + REP_KS.index(k))
            * len(REP_ROUTINGS) + REP_ROUTINGS.index(routing))


def phase_fleet_user_size(dev, tiles: int = 16, n_steps: int = 4000,
                          capture_at: int = 60) -> tuple:
    """The replicas benchmark's grid at 8,448 points, its own run
    (n_steps 4,000, a_cap 32, hist_every 4, seed 17, q_cap from
    ``fleet_caps``): two calls, bitwise equal; warm wall, jobs/s, peak
    memory; the JSQ/random E[W] ratio at k 16 as tile means.  Returns
    the record, the hist_update launches and the path block of
    superstep ``capture_at``, cloned in the first run."""
    grid, n_base = replicas_grid(tiles)
    kw = dict(n_steps=n_steps, a_cap=32, hist_every=4, seed=17, device=dev)
    supersteps = -(-n_steps // 32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, blocks = run_captured(lambda: _counted(
        lambda: fleet_sweep(grid, **kw), supersteps, "fleet user-size run"),
        capture_at)
    first_s = time.perf_counter() - t0
    launches = ss.hist_update.launches
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r2 = fleet_sweep(grid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    for f in ("hist", "mean_latency", "jobs_by_replica", "n_batches"):
        check(np.array_equal(getattr(r, f), getattr(r2, f)),
              f"two fleet user-size runs give the same bits on {f}")
    check_fleet_accounting(r, "fleet user-size")
    check(bool(np.all(r.n_jobs > 0)), "every fleet point served jobs")
    ratio = {}
    for rho1 in REP_RHO1S:
        ij = replicas_index(rho1, 16, "jsq")
        ir = replicas_index(rho1, 16, "random")
        lat = np.asarray(r.mean_latency, float)
        ratio[str(rho1)] = _tile_stats(lat[ij::n_base] / lat[ir::n_base], 1, 0)
    check(ratio["0.8"]["mean"] < 1.0,
          f"JSQ beats a random split at k 16, rho1 0.8: {ratio['0.8']}")
    # the consolidation curve's fleet side at rho1 0.8 (replicas.py's §2)
    curve = {str(k): {rt: _tile_stats(r.mean_latency, n_base,
                                      replicas_index(0.8, k, rt))
                      for rt in REP_ROUTINGS} for k in (2, 4, 8, 16)}
    jobs = int(r.n_jobs.sum())
    q_cap = fleet_caps(grid)["q_cap"]
    out = dict(points=len(grid), tiles=tiles, n_steps=n_steps,
               caps=dict(q_cap=q_cap, a_cap=32, hist_every=4, pop_cap=q_cap),
               first_call_s=first_s, warm_s=warm_s, jobs=jobs,
               jobs_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
               launches=launches, supersteps=supersteps, buffer_dropped=0,
               jsq_over_random_k16=ratio, ew_rho1_0_8=curve)
    emit("fleet_user_size", **out)
    return out, launches, blocks["hist_update"]


def fleet_fail_grid(tiles: int = 228) -> tuple:
    """benchmarks/availability.py's fleet half — 2 ρ (per replica) × k
    1, 4 × 3 (mtbf, mttr) pairs × 3 disciplines = 36 JSQ points at b_max
    8 — tiled ``tiles`` times.  Returns the grid and the cells."""
    cap = AV_B_MAX / (V100[0] * AV_B_MAX + V100[1])
    cells = [(rho, k, mb, mr, d) for rho in AV_RHOS for k in AV_KS
             for (mb, mr) in AV_FAIL_PAIRS for d in AV_DISCS]
    base = FleetGrid.from_points(
        [c[0] * c[1] * cap for c in cells], *V100, k=[c[1] for c in cells],
        routing="jsq", b_max=AV_B_MAX, mtbf=[c[2] for c in cells],
        mttr=[c[3] for c in cells], fail_disc=[c[4] for c in cells])
    return base.take(np.tile(np.arange(len(base)), tiles)), cells


def phase_fleet_fail_user_size(dev, tiles: int = 228, n_steps: int = 6000,
                               capture_at: int = 60) -> tuple:
    """The availability benchmark's fleet half at 8,208 points, its own
    run (q_cap as the benchmark sizes it, a_cap 64, r_cap 64, n_steps
    6,000, seed 31): no drops, no truncated failure count, resume's
    breakdowns at rate 1/MTBF, availability, and the harsh/baseline E[W]
    per discipline at ρ 0.75, k 4 (the benchmark's frontier) as tile
    means.  One timed run (the eager loop has nothing to warm after
    ``fleet_contracts``); returns the record, the hist_update launches
    and the path block of superstep ``capture_at``."""
    grid, cells = fleet_fail_grid(tiles)
    n_base = len(cells)
    cap = AV_B_MAX / (V100[0] * AV_B_MAX + V100[1])
    q_cap = engine.queue_capacity(max(AV_RHOS) * cap, V100[0], V100[1],
                                  AV_B_MAX, mtbf=60.0, mttr=12.0,
                                  restart=True)
    caps = fleet_caps(grid, q_cap=q_cap)
    kw = dict(n_steps=n_steps, q_cap=q_cap, a_cap=64, r_cap=64,
              f_cap=caps["f_cap"], seed=31, device=dev)
    supersteps = -(-n_steps // 32)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, blocks = run_captured(lambda: _counted(
        lambda: fleet_sweep(grid, **kw), supersteps,
        "fleet failure user-size run"), capture_at)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = ss.hist_update.launches
    check_fleet_accounting(r, "fleet failure user-size")
    failing = np.array([c[2] > 0 for c in cells] * tiles)
    av = np.asarray(r.availability, float)
    check(bool(np.all(av[~failing] == 1.0)
               and np.all((av[failing] > 0.0) & (av[failing] < 1.0))),
          "fleet failure user-size: availability 1 without failures, in "
          "(0, 1) with them")
    resume = np.array([c[4] == "resume" and c[2] > 0 for c in cells] * tiles)
    fail_rate = check_fail_block(r, grid.mtbf, resume,
                                 "fleet failure user-size")

    def index(rho, k, pair, disc) -> int:
        (i,) = [j for j, c in enumerate(cells)
                if c == (rho, k, pair[0], pair[1], disc)]
        return i

    frontier = {}
    lat = np.asarray(r.mean_latency, float)
    for disc in AV_DISCS:
        i = index(0.75, 4, (60.0, 12.0), disc)
        i0 = index(0.75, 4, (0.0, 0.0), disc)
        frontier[disc] = dict(
            latency_ratio=_tile_stats(lat[i::n_base] / lat[i0::n_base], 1, 0),
            availability=_tile_stats(r.availability, n_base, i),
            work_loss_frac=_tile_stats(r.work_loss_frac, n_base, i),
            abandon_frac=_tile_stats(r.abandon_frac, n_base, i))
    check(frontier["restart"]["work_loss_frac"]["mean"]
          > frontier["resume"]["work_loss_frac"]["mean"] == 0.0
          and frontier["drop"]["abandon_frac"]["mean"] > 0.0,
          f"fleet frontier shows its regimes: {frontier}")
    availability = {f"{c[0]}_{c[1]}_{c[2]:g}_{c[4]}":
                    _tile_stats(r.availability, n_base, i)["mean"]
                    for i, c in enumerate(cells) if c[2] > 0}
    jobs = int(r.n_jobs.sum())
    out = dict(points=len(grid), tiles=tiles, n_steps=n_steps,
               caps=dict(q_cap=q_cap, a_cap=64, r_cap=64, f_cap=caps["f_cap"],
                         pop_cap=AV_B_MAX),
               wall_s=wall_s, jobs=jobs, jobs_per_s=jobs / wall_s,
               peak_mem_bytes=peak, launches=launches, supersteps=supersteps,
               buffer_dropped=0, fail_truncated=0, fail_rate=fail_rate,
               frontier_rho_0_75_k4=frontier, availability=availability)
    emit("fleet_fail_user_size", **out)
    return out, launches, blocks["hist_update"]


def phase_chain_grid(dev) -> dict:
    """examples/exact_surface.py's MarkovGrid (24 load fractions × b_max
    1…128 = 192 cells) through the port's ``solve_grid`` on the card,
    adaptive K, against the host on every cell: rel ≤ 1e-10 on E[W],
    utilization and E[B] and abs ≤ 1e-12 on the truncation witness,
    against ``method="numpy"`` (the banded LAPACK solve, with its
    fallback to the GTH recursion where the anchored solve breaks down:
    ROADMAP C-R2's cells 190 and 191) and against the host GTH recursion
    (``solve_pi_gth``).  The two C-R2 cells are reported."""
    fracs = np.linspace(0.10, 0.95, SURFACE_FRACS)
    grid = MarkovGrid.from_fracs(fracs, *V100, b_maxes=SURFACE_B_MAXES)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = solve_grid(grid, device=dev)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    want = solve_grid(grid, method="numpy")
    host_s = time.perf_counter() - t0
    K = got.truncation
    check(K == want.truncation and got.method == "torch",
          f"chain grid: K {K} vs the host's {want.truncation}")
    model = LinearServiceModel(*V100)
    gth = {f: np.empty(len(grid)) for f in ("mean_latency", "utilization",
                                            "mean_batch", "tail_mass")}
    for i in range(len(grid)):
        ch = build_chain(float(grid.lam[i]), model, float(grid.b_max[i]), K)
        mt = chain_metrics(float(grid.lam[i]), solve_pi_gth(ch), ch.t_of,
                           ch.b_of)
        for f in gth:
            gth[f][i] = mt[f]

    def rel(a, b):
        return np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))

    errs = {}
    for f in ("mean_latency", "utilization", "mean_batch"):
        errs[f"{f}_vs_gth"] = float(rel(getattr(got, f), gth[f]).max())
        errs[f"{f}_vs_numpy"] = float(rel(getattr(got, f),
                                          getattr(want, f)).max())
        check(max(errs[f"{f}_vs_gth"], errs[f"{f}_vs_numpy"]) <= 1e-10,
              f"chain grid {f}: rel {errs} > 1e-10")
    errs["tail_mass_abs_vs_numpy"] = float(np.max(np.abs(
        got.tail_mass - want.tail_mass)))
    errs["tail_mass_abs_vs_gth"] = float(np.max(np.abs(got.tail_mass
                                                       - gth["tail_mass"])))
    check(max(errs["tail_mass_abs_vs_numpy"], errs["tail_mass_abs_vs_gth"])
          <= 1e-12, f"chain grid tail_mass: {errs}")
    check(float(got.tail_mass.max()) <= 1e-10, "chain grid: K adaptive")
    c_r2 = [dict(cell=i, b_max=int(grid.b_max[i]),
                 frac=float(fracs[i % SURFACE_FRACS]),
                 numpy=float(want.mean_latency[i]),
                 gth=float(gth["mean_latency"][i]),
                 card=float(got.mean_latency[i])) for i in (190, 191)]
    check(all(c["numpy"] > V100[0] + V100[1] for c in c_r2),
          f"chain grid: the C-R2 cells sit above the service time {c_r2}")
    V, D = _grid_shapes(grid.lam.astype(np.float64),
                        grid.alpha.astype(np.float64),
                        grid.tau0.astype(np.float64),
                        grid.b_max.astype(np.int64), K)
    out = dict(cells=len(grid), K=K, V=V, D=D, cells_per_dispatch=64,
               wall_s=wall_s, host_numpy_s=host_s, peak_mem_bytes=peak,
               max_err=errs, tail_mass_max=float(got.tail_mass.max()),
               c_r2_cells=c_r2)
    emit("chain_grid", **out)
    return out


# ---------------------------------------------------------------------------
# the campaign driver: its fold kernel, its contracts, a user-size run
# ---------------------------------------------------------------------------

def _fold_chunk(dev, rng, m: int, n_bins: int, has_loss: bool, sketch: bool,
                poison: bool, tied: bool = False) -> dict:
    """A random chunk of sweep outputs: tied latencies and rates, NaN /
    inf points where ``poison``, every latency and rate one value where
    ``tied``."""
    c = {"hist": rng.integers(0, 50, (m, n_bins)).astype(np.int32),
         "n_jobs": rng.integers(0, 1000, m).astype(np.int32),
         "batches": rng.integers(0, 100, m).astype(np.int32),
         "dropped": rng.integers(0, 3, m).astype(np.int32),
         "mean_latency": rng.lognormal(1.0, 1.0, m).astype(np.float32),
         "utilization": rng.uniform(0, 1, m).astype(np.float32),
         "mean_batch": rng.uniform(1, 30, m).astype(np.float32),
         "lam": rng.uniform(0.1, 10, m).astype(np.float32),
         "lat_bm_m2": rng.exponential(3.0, m).astype(np.float32),
         "lat_bm_n": rng.integers(0, 40, m).astype(np.int32)}
    c["mean_latency"][::5] = c["mean_latency"][0]
    c["lam"][1::7] = c["lam"][1]
    if tied:
        c["mean_latency"][:] = 3.0
        c["lam"][:] = 2.0
    if sketch:
        c["hist_sums"] = (c["hist"] * rng.lognormal(0, 1, (m, n_bins))
                          ).astype(np.float32)
    if has_loss:
        for k in ("overflow_dropped", "abandoned", "n_in_slo", "n_fresh",
                  "n_retry"):
            c[k] = rng.integers(0, 200, m).astype(np.int32)
        if tied:
            c["n_in_slo"][:] = 0
    if poison:
        c["mean_latency"][2] = np.nan
        c["utilization"][m // 2] = np.inf
        c["lat_bm_m2"][m - 2] = np.nan
        if sketch:
            c["hist_sums"][m - 3, 3] = np.nan
    return {k: torch.as_tensor(v, device=dev) for k, v in c.items()}


# the campaign_fold phase's chunks of m = 8,192 rows: name → (n_bins,
# has_loss, sketch, poison, rows short of m that are padding (None: all
# of them), k_top, tied); "loss" is the campaign_user_size path's own
# fold (the row's headline): a loss grid at 8,192 × 512, every lane
# valid, no NaN
FOLD_CASES = {
    "full": (512, False, False, False, 0, DEFAULT_TOP_K, False),
    "full_loss_nan": (512, True, False, True, 192, DEFAULT_TOP_K, False),
    "sketch": (64, False, True, False, 0, DEFAULT_TOP_K, False),
    "sketch_loss_nan": (64, True, True, True, 93, DEFAULT_TOP_K, False),
    "loss": (512, True, False, False, 0, DEFAULT_TOP_K, False),
    "k_top_1": (512, True, False, True, 7, 1, False),
    "k_top_256": (64, False, True, True, 0, 256, False),
    "n_valid_0": (512, True, False, False, None, DEFAULT_TOP_K, False),
    "tied": (512, True, False, False, 0, DEFAULT_TOP_K, True),
    "k_top_257": (64, True, False, True, 5, 257, False),
    "k_top_2048": (64, False, False, False, 0, 2048, False),
    "k_top_1024": (512, True, False, False, 0, 1024, False),
}
# the cases timed (the kernels line's headline and two more)
FOLD_TIMED = ("loss", "full", "full_loss_nan", "sketch")


def _acc_equal(a: FoldAcc, b: FoldAcc) -> bool:
    return (torch.equal(a.ints, b.ints)
            and torch.equal(a.floats.view(torch.int64),
                            b.floats.view(torch.int64)))


def phase_campaign_fold(dev, m: int = 8192) -> dict:
    """The CUDA campaign_fold against its plain version, bit for bit:
    random chunks of the campaign path's shapes (8,192 × 512 counts;
    8,192 × 64 in sketch mode, with the per-bin sums), with and without
    the loss counters, with NaN / inf points, tied values, every value
    tied, a padded tail (n_valid < m, and 0), k_top 1, 16, 256, 257 and
    1,024 (lists in shared memory) and 2,048 (in device memory), two
    chunks in a row into a non-empty accumulator; each fold launched
    twice from the same accumulator and held bitwise.  Kernel, plain
    and bound times (bytes once over 3.35 TB/s) of the timed cases, and
    the chain floor: one thread's m dependent float64 additions, which
    the ordered tail's sums cannot beat; no single PyTorch call
    computes the fold."""
    cases = {}
    for name, (n_bins, has_loss, sketch, poison, short, k_top,
               tied) in FOLD_CASES.items():
        n_valid = 0 if short is None else m - short
        rng = np.random.default_rng(len(cases) + 17)
        chunks = [_fold_chunk(dev, rng, m, n_bins, has_loss, sketch, poison,
                              tied) for _ in range(2)]
        acc_k = FoldAcc.from_host(campaign_init_acc(n_bins, k_top), dev)
        acc_p = FoldAcc.from_host(campaign_init_acc(n_bins, k_top), dev)
        kw = dict(has_loss=has_loss, sketch=sketch)
        for j, c in enumerate(chunks):
            g = torch.arange(j * m, (j + 1) * m, dtype=torch.int64,
                             device=dev)
            again = FoldAcc(acc_k.ints.clone(), acc_k.floats.clone(),
                            n_bins, k_top)
            s_k = campaign_fold(acc_k, c, g, n_valid, **kw)
            s_2 = campaign_fold(again, c, g, n_valid, **kw)
            s_p = campaign_fold_plain(acc_p, c, g, n_valid, **kw)
            torch.cuda.synchronize()
            check(torch.equal(s_k, s_p) and torch.equal(s_k, s_2),
                  f"campaign_fold summary bitwise ({name}, chunk {j})")
            check(_acc_equal(acc_k, acc_p),
                  f"campaign_fold accumulator bitwise its plain version "
                  f"({name}, chunk {j})")
            check(_acc_equal(acc_k, again),
                  f"campaign_fold launched twice bitwise ({name})")
        if poison:
            check(int(acc_k.views()["quarantined_points"]) > 0,
                  f"campaign_fold quarantined the poisoned points ({name})")
        if tied:
            check(acc_k.views()["top_lat_idx"].tolist()
                  == list(range(k_top)),
                  f"campaign_fold: tied values keep the first points in "
                  f"the first minimal slots ({name})")
        if n_valid == 0:
            check(int(acc_k.views()["points"]) == 0,
                  f"campaign_fold: n_valid 0 folds nothing ({name})")
        cases[name] = dict(m=m, n_bins=n_bins, n_valid=n_valid,
                           has_loss=has_loss, sketch=sketch, poison=poison,
                           k_top=k_top, tied=tied, max_abs_err=0.0)
        if name not in FOLD_TIMED:
            continue
        g = torch.arange(m, dtype=torch.int64, device=dev)
        scratch = FoldAcc(acc_k.ints.clone(), acc_k.floats.clone(), n_bins,
                          k_top)
        kernel_ms = time_ms(lambda: campaign_fold(scratch, chunks[0], g,
                                                  n_valid, **kw))
        plain_ms = time_ms(lambda: campaign_fold_plain(
            scratch, chunks[0], g, n_valid, **kw), reps=2, warm=1)
        nbytes = fold_min_bytes(m, n_bins, has_loss=has_loss, sketch=sketch,
                                k_top=k_top)
        cases[name].update(kernel_ms=kernel_ms, plain_ms=plain_ms,
                           bytes=nbytes,
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                           library_ms=None)
    floor_ms = time_ms(lambda: chain_floor(dev, m))
    for case in cases.values():
        case["chain_floor_ms"] = floor_ms
    emit("campaign_fold", cases=cases, chain_floor_ms=floor_ms)
    return cases


def _campaign_loss_grid(n: int = 48) -> SweepGrid:
    """tests/test_torch_campaign.py's loss grid (every loss axis, det and
    exp service)."""
    i = np.arange(n)
    b = np.where(i % 2 == 0, 4, 16).astype(np.int32)
    fr = np.linspace(0.3, 0.9, n, dtype=np.float32)
    lam = fr * b / (V100[0] * b + V100[1])
    return SweepGrid.from_points(
        lam, V100[0], V100[1], b_max=b,
        dist=np.where(i % 2 == 0, 0, 1).astype(np.int32),
        q_max=np.where(i % 3 == 0, 0, 16).astype(np.int32),
        deadline=np.where(i % 4 == 0, 50.0, 0.0).astype(np.float32),
        retry_rate=np.where(i % 5 == 0, 0.25, 0.0).astype(np.float32))


def stress_grid(n_fracs: int = 16) -> SweepGrid:
    """benchmarks/adaptive.py's ``_stress_grid``: det-service λ sweeps
    over {V100, P4} × b_max {2, 4, 8, 16} plus one exp-service stress
    slice (V100, b_max 8)."""
    fracs = np.linspace(0.05, 0.60, n_fracs)
    parts = []
    for alpha, tau0 in (V100, P4):
        for b in (2, 4, 8, 16):
            lam = fracs * b / (alpha * b + tau0)
            parts.append(SweepGrid.from_product(lam, [alpha], [tau0],
                                                b_maxes=[b], dists=["det"]))
    lam = fracs * 8 / (V100[0] * 8 + V100[1])
    parts.append(SweepGrid.from_product(lam, [V100[0]], [V100[1]],
                                        b_maxes=[8], dists=["exp"]))
    out = parts[0]
    for p in parts[1:]:
        out = out.concat(p)
    return out


def _launches() -> dict:
    return {"hist_update": ss.hist_update.launches,
            "fifo_compact": ss.fifo_compact.launches,
            "campaign_fold": campaign_fold.launches}


def _reset_launches() -> None:
    ss.hist_update.launches = ss.fifo_compact.launches = 0
    campaign_fold.launches = 0


def _clean(r, what: str) -> None:
    """A clean run folds every point and quarantines nothing: a chunk
    lost to a CUDA error would fail here, never be absorbed."""
    check(r.quarantined_points == 0 and r.quarantined_chunks == []
          and r.totals["quarantined_points"] == 0
          and r.totals["points"] == r.n_points and r.completed,
          f"{what}: a clean campaign quarantined points "
          f"({r.quarantined_chunks})")


def _counted_campaign(grid, supersteps: int, what: str, compact=False,
                      **kw):
    """A campaign with exact launch counts: one B1 launch a superstep a
    chunk, one B2 launch a superstep a chunk on the generate path, one
    fold launch a chunk."""
    _reset_launches()
    r = campaign(grid, **kw)
    got = _launches()
    want = {"hist_update": supersteps * r.n_chunks,
            "fifo_compact": supersteps * r.n_chunks if compact else 0,
            "campaign_fold": r.n_chunks}
    check(got == want, f"{what}: launches {got}, expected {want}")
    _clean(r, what)
    return r


def phase_campaign_contracts(dev) -> dict:
    """The campaign's bitwise contracts on the card (the CPU tests'
    grids): chunked = whole on the sweep, fleet, generate and sketch
    grids; kill-and-resume; the three injected faults and their
    recoveries; tapped = untapped; serial against pipelined within 3σ;
    adaptive mode on benchmarks/adaptive.py's grid; exact launch counts
    and no quarantine on every clean run."""
    out = {}
    d = dict(device=dev)
    # chunked = whole
    g = _campaign_loss_grid(48)
    a = _counted_campaign(g, 1, "sweep chunked", chunk_size=16, n_batches=12,
                          seed=3, **d)
    b = _counted_campaign(g, 1, "sweep whole", chunk_size=48, n_batches=12,
                          seed=3, **d)
    check(a.fingerprint() == b.fingerprint() and a.n_chunks == 3
          and a.totals["overflow_dropped"] > 0
          and a.top_latency == b.top_latency
          and a.percentiles() == b.percentiles(),
          "campaign sweep: chunked = whole bitwise")
    out["sweep"] = dict(fingerprint=a.fingerprint()[:16], **a.totals)
    k = np.tile([1, 2, 4], 8).astype(np.int32)
    fg = FleetGrid.from_points(np.linspace(0.5, 2.0, 24, dtype=np.float32) * k,
                               V100[0], V100[1], k=k, routing="jsq", b_max=8,
                               q_max=np.where(np.arange(24) % 2 == 0, 0,
                                              12).astype(np.int32))
    a = _counted_campaign(fg, 2, "fleet chunked", chunk_size=8, n_steps=48,
                          seed=7, **d)
    b = _counted_campaign(fg, 2, "fleet whole", chunk_size=24, n_steps=48,
                          seed=7, **d)
    check(a.fingerprint() == b.fingerprint(),
          "campaign fleet: chunked = whole bitwise")
    out["fleet"] = dict(fingerprint=a.fingerprint()[:16],
                        jobs=a.totals["jobs"])
    gg = GenGrid.from_points(
        np.linspace(0.05, 0.4, 18, dtype=np.float32), 0.02, 0.5, 0.01, 2.0,
        prompt_len=32, gen_tokens=8, max_active=16,
        q_max=np.where(np.arange(18) % 3 == 0, 0, 8).astype(np.int32))
    a = _counted_campaign(gg, 2048 // 16, "gen chunked", compact=True,
                          chunk_size=6, n_steps=64, seed=9, **d)
    b = _counted_campaign(gg, 2048 // 16, "gen whole", compact=True,
                          chunk_size=18, n_steps=64, seed=9, **d)
    check(a.fingerprint() == b.fingerprint(),
          "campaign gen: chunked = whole bitwise")
    out["gen"] = dict(fingerprint=a.fingerprint()[:16], jobs=a.totals["jobs"])
    sg = _campaign_loss_grid(32)
    a = _counted_campaign(sg, 1, "sketch chunked", chunk_size=16, sketch=True,
                          n_batches=12, seed=3, **d)
    b = _counted_campaign(sg, 1, "sketch whole", chunk_size=32, sketch=True,
                          n_batches=12, seed=3, **d)
    check(a.fingerprint() == b.fingerprint()
          and float(a.acc["hist_sums"].sum()) > 0,
          "campaign sketch: chunked = whole bitwise")
    out["sketch"] = dict(fingerprint=a.fingerprint()[:16])

    # resume and the three faults
    fgrid = SweepGrid.from_points(np.linspace(0.3, 0.9, 32), 0.05, 1.0,
                                  b_max=4)
    kw = dict(chunk_size=8, n_batches=128, fault_backoff_s=0.0, **d)
    clean = _counted_campaign(fgrid, 4, "fault grid, clean", **kw)
    with tempfile.TemporaryDirectory() as tmp:
        w = verify_resume(fgrid, out_dir=f"{tmp}/kill",
                          kill_after_chunks=2, checkpoint_every=1, **kw)
        check(w["match"] and w["resumed_from"] == 2
              and w["fingerprint"] == clean.fingerprint(),
              "verify_resume bitwise on the card")
        r = campaign(fgrid, fault_plan=FaultPlan(seed=3, p_dispatch=0.7,
                                                 max_per_chunk=2),
                     fault_retries=4, **kw)
        check(r.fingerprint() == clean.fingerprint()
              and r.quarantined_chunks == []
              and any(row["retries"] > 0 for row in r.rows),
              "dispatch retries heal bitwise")
        r = campaign(fgrid, fault_plan=FaultPlan(seed=5, p_nan=0.6),
                     out_dir=f"{tmp}/nan", **kw)
        bad = {q["chunk"] for q in r.quarantined_chunks}
        keep = np.concatenate([np.arange(8 * c, 8 * c + 8)
                               for c in range(4) if c not in bad])
        per_point = sweep(fgrid, n_batches=128, device=dev)
        check(bad and all(q["reason"] == "nonfinite"
                          for q in r.quarantined_chunks)
              and np.array_equal(per_point.hist[keep].sum(0), r.hist)
              and int(per_point.n_jobs[keep].sum()) == r.totals["jobs"]
              and np.all(np.isfinite(r.acc["sum_latency_jobs"])),
              "a NaN chunk is quarantined, the clean points folded exactly")
        seed = next(s for s in range(200)
                    if FaultPlan(seed=s, p_corrupt=0.5).roll("corrupt", 3)
                    and not FaultPlan(seed=s, p_corrupt=0.5).roll("corrupt",
                                                                  1))
        plan = FaultPlan(seed=seed, p_corrupt=0.5)
        campaign(fgrid, out_dir=f"{tmp}/corrupt", checkpoint_every=2,
                 fault_plan=plan, **kw)
        res = campaign(fgrid, out_dir=f"{tmp}/corrupt", checkpoint_every=2,
                       fault_plan=plan, resume=True, **kw)
        recov = [e for e in res.fault_events
                 if e["event"] == "checkpoint_recovered"]
        check(recov and recov[0]["chunks_done"] == 2
              and res.fingerprint() == clean.fingerprint(),
              "a corrupt checkpoint falls back a generation, bitwise")
        # tapped = untapped, every second chunk tapped
        tg = _campaign_loss_grid(32)
        plain = campaign(tg, chunk_size=8, n_batches=64, seed=3, **d)
        with MetricsTap(f"{tmp}/m.jsonl", label="chip",
                        expected_points=8) as tap:
            tapped = campaign(tg, chunk_size=8, n_batches=64, seed=3,
                              metrics_tap=tap, tap_every=2, **d)
        recs = [json.loads(x) for x in
                Path(f"{tmp}/m.jsonl").read_text().splitlines()]
        kinds = [x["type"] for x in recs]
        check(tapped.fingerprint() == plain.fingerprint()
              and tapped.tapped_chunks == 2
              and kinds.count("chunk") == 4
              and kinds.count("superstep") == 2 * 2,
              "tapped campaign bitwise equal to the untapped one")
    out["faults"] = dict(resume=w["replayed_chunks"], nan_chunks=sorted(bad),
                         corrupt_seed=seed)

    # serial against pipelined: a six-seed pipelined ladder against the
    # serial driver's per-chunk caps
    n = 24
    fr = np.linspace(0.3, 0.8, n, dtype=np.float32)
    bm = np.where(np.arange(n) % 2 == 0, 4, 8).astype(np.int32)
    stat = SweepGrid.from_points(fr * bm / (V100[0] * bm + V100[1]), V100[0],
                                 V100[1], b_max=bm, dist="det")
    ser = campaign(stat, chunk_size=8, n_batches=512, seed=5, mode="serial",
                   **d)
    ladder = [campaign(stat, chunk_size=8, n_batches=512, seed=s, **d)
              for s in range(6)]
    z = {}
    for f in ("mean_latency", "mean_utilization"):
        xs = np.array([getattr(r, f) for r in ladder])
        se = xs.std(ddof=1) * math.sqrt(1 + 1 / len(xs))
        z[f] = float((xs.mean() - getattr(ser, f)) / se)
        check(abs(z[f]) <= 3.0, f"serial vs pipelined {f}: z = {z[f]:.2f}")
    out["serial_vs_pipelined_z"] = z
    out["serial_shapes"] = ser.serial_compile_shapes

    # adaptive mode on benchmarks/adaptive.py's grid and settings
    sgrid = stress_grid(16)
    t0 = time.perf_counter()
    fixed = _counted_campaign(sgrid, 2048 // 32, "adaptive: fixed baseline",
                              chunk_size=48, n_batches=2048, seed=7, **d)
    fixed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ad = campaign(sgrid, chunk_size=48, mode="adaptive", n_batches=2048,
                  pilot=128, target_ci=fixed.max_ci_halfwidth, safety=6.0,
                  seed=7, keep_point_stats=True, **d)
    adaptive_s = time.perf_counter() - t0
    _clean(ad, "adaptive run")
    check(fixed.totals["buffer_dropped"] == 0
          and ad.totals["buffer_dropped"] == 0,
          "adaptive and fixed campaigns: buffer_dropped == 0")
    wg = sgrid.take(np.arange(0, len(sgrid), 2))
    wa = campaign(wg, chunk_size=16, mode="adaptive", n_batches=2048,
                  pilot=128, target_ci=1e9, seed=7, **d)
    wb = campaign(wg, chunk_size=16, n_batches=128, seed=7, **d)
    wc = campaign(wg, chunk_size=len(wg), n_batches=128, seed=7, **d)
    check(wa.fingerprint() == wb.fingerprint() == wc.fingerprint(),
          "adaptive fixed-allocation witness bitwise at two chunk sizes")
    tiers, counts = np.unique(ad.point_stats["alloc"], return_counts=True)
    out["adaptive"] = dict(
        points=len(sgrid), fixed_max_ci=fixed.max_ci_halfwidth,
        adaptive_max_ci=ad.max_ci_halfwidth,
        matched=bool(ad.max_ci_halfwidth <= 1.10 * fixed.max_ci_halfwidth),
        fixed_jobs=fixed.simulated_jobs, adaptive_jobs=ad.simulated_jobs,
        job_savings=fixed.simulated_jobs / ad.simulated_jobs,
        tiers={int(t): int(c) for t, c in zip(tiers, counts)},
        fixed_wall_s=fixed_s, adaptive_wall_s=adaptive_s)
    emit("campaign_contracts", **out)
    return out


def million_grid(n_fracs: int = 1024) -> SweepGrid:
    """benchmarks/campaign.py's ``_million_grid``: λ-fraction × {V100,
    P4} × 8 b_max × {det, exp} × 16 q_max × 2 overflow modes, every λ a
    fixed fraction of its own stability limit (2**20 points at 1,024
    fractions)."""
    fracs = np.linspace(0.2, 0.9, n_fracs, dtype=np.float32)
    b_maxes = np.array([1, 2, 4, 8, 16, 24, 32, 48], np.int32)
    q_maxes = np.array([0, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80,
                        96, 112, 128], np.int32)
    f, m, b, dd, q, o = (a.reshape(-1) for a in np.meshgrid(
        fracs, np.arange(2), b_maxes, np.arange(2), q_maxes, np.arange(2),
        indexing="ij"))
    alpha = np.where(m == 0, V100[0], P4[0]).astype(np.float32)
    tau0 = np.where(m == 0, V100[1], P4[1]).astype(np.float32)
    lam = f * b / (alpha * b + tau0)
    return SweepGrid.from_points(lam, alpha, tau0, b_max=b, dist=dd, q_max=q,
                                 overflow=o)


def _busy_share(run) -> dict:
    """Kernel time over the wall of ``run()`` on one stream: the run
    timed alone, then under ``torch.profiler``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0
    busy = sum(us(e) for e in kernels) / 1e6
    fold = sum(us(e) for e in kernels if "campaign_fold" in e.key) / 1e6
    return dict(wall_s=wall, kernel_s=busy, busy_share=busy / wall,
                fold_share_of_kernels=fold / busy if busy else None,
                kernels=sum(e.count for e in kernels))


def phase_campaign_user_size(dev, n_fracs: int = 1024, chunk: int = 8192,
                             n_batches: int = 32, capture_at: int = 12
                             ) -> tuple:
    """benchmarks/campaign.py's headline run: its 1,048,576-point grid,
    chunk 8,192 (128 chunks), n_batches 32, seed 11, pipelined, with
    checkpoints every 8 chunks into a temporary directory.  Two runs
    (first and warm), bitwise equal, exact launch counts, no drops and
    no quarantine; wall, points/s, jobs/s, peak host result bytes,
    percentiles and the worst cells.  The busy share from a profiled
    run of the first 4 chunks.  The chunk witness: the first 131,072
    points with the full grid's caps at chunk 8,192 and 32,768, equal
    fingerprints; the B1 block of its chunk ``capture_at``, cloned as
    the kernel received it.  Returns the record, the B1 launches of the
    run and the captured block."""
    grid = million_grid(n_fracs)
    caps = sweep_caps(grid)
    kw = dict(chunk_size=chunk, n_batches=n_batches, seed=11, caps=caps,
              device=dev)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(2):
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = campaign(grid, out_dir=f"{tmp}/run{rep}", checkpoint_every=8,
                         **kw)
            torch.cuda.synchronize()
            runs.append((r, time.perf_counter() - t0, _launches()))
    (r, first_s, launches), (r2, warm_s, _) = runs
    supersteps = -(-n_batches // 32)
    want = {"hist_update": supersteps * r.n_chunks, "fifo_compact": 0,
            "campaign_fold": r.n_chunks}
    check(launches == want, f"campaign user size: launches {launches}, "
          f"expected {want}")
    check(r.fingerprint() == r2.fingerprint(),
          "two user-size campaigns give the same bits")
    _clean(r, "campaign user size")
    check(r.totals["buffer_dropped"] == 0, "campaign user size: no drops")
    check(r.totals["overflow_dropped"] > 0 and r.totals["jobs"] > 0,
          "campaign user size: the loss axes fired")
    p50, p95, p99 = r.percentiles((50, 95, 99))
    check(all(np.isfinite([p50, p95, p99])) and p50 <= p95 <= p99,
          "campaign user size: finite ordered percentiles")
    busy = _busy_share(lambda: campaign(grid.take(np.arange(4 * chunk)),
                                        **kw))
    prefix = grid.take(np.arange(16 * chunk))
    wa = campaign(prefix, **kw)
    wb = campaign(prefix, **dict(kw, chunk_size=4 * chunk))
    check(wa.fingerprint() == wb.fingerprint(),
          "campaign chunk witness: 131,072 points at chunk 8,192 and 32,768")
    blocks = capture_blocks(lambda: campaign(prefix, **kw), capture_at,
                            "hist_update")
    jobs = r.totals["jobs"]
    out = dict(points=r.n_points, chunks=r.n_chunks, chunk_size=r.chunk_size,
               padded_points=r.padded_points, n_batches=n_batches,
               caps=caps, first_call_s=first_s, warm_s=warm_s,
               points_per_s_warm=r.n_points / warm_s,
               jobs=jobs, jobs_per_s_warm=jobs / warm_s,
               peak_host_result_bytes=r2.peak_host_result_bytes,
               p50=p50, p95=p95, p99=p99, mean_latency=r.mean_latency,
               top_latency=r.top_latency[:3], totals=r.totals,
               launches=launches, busy_4_chunks=busy,
               witness_fingerprint=wa.fingerprint()[:16],
               fingerprint=r.fingerprint()[:16])
    emit("campaign_user_size", **out)
    return out, blocks["hist_update"]


def _attn_inputs(dev, dtype, b, s, h, kv, hd, seed, decode=False,
                 hdv=None, sk=None):
    """q, k, v; ``sk``: a key length other than the query length."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qshape = (b, h, hd) if decode else (b, s, h, hd)
    sk = sk or s
    q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
               for shape in (qshape, (b, sk, kv, hd),
                             (b, sk, kv, hdv or hd)))
    return q, k, v


def _bound(nbytes: float, flops: float, dtype, peaks=PEAK_FLOPS) -> dict:
    """The least time for moving ``nbytes`` once and doing ``flops`` at
    ``peaks[dtype]``; at another rate than the CUDA cores' float32 one,
    that figure too (``bound_ms_cuda_cores``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peaks[dtype] * 1e3
    out = dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    if dtype == torch.float32 and peaks[dtype] != PEAK_FLOPS[dtype]:
        out["bound_ms_cuda_cores"] = max(
            t_bytes, flops / PEAK_FLOPS[dtype] * 1e3)
    return out


def _attn_bound(dtype, io_elems: int, pairs: int, hd: int,
                peaks=PEAK_FLOPS) -> dict:
    """Least time for attention over ``pairs`` admitted (query head,
    key) pairs: ``io_elems`` elements read once or written once, and
    2·hd multiply-adds (q·k and p·v) per admitted pair."""
    elt = torch.finfo(dtype).bits // 8
    return _bound(elt * io_elems, 4 * hd * pairs, dtype, peaks)


def _check_flash(dev, dtype, b, s, h, kv, hd, *, causal=True, window=0,
                 seed=0, timed=False, hdv=None, sk=None) -> dict:
    """B3 against its plain version; ``hdv``: a value width other than
    the query/key width (MLA's pair); ``sk``: a key length other than
    the query length (cross-attention, unmasked)."""
    q, k, v = _attn_inputs(dev, dtype, b, s, h, kv, hd, seed, hdv=hdv,
                           sk=sk)
    sk = k.shape[1]
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    case = dict(kernel="flash_attention", dtype=str(dtype), batch=b, seq=s,
                heads=h, kv_heads=kv, head_dim=hd, value_dim=v.shape[3],
                causal=causal, window=window, max_abs_err=err,
                # float32 pieces of the key axis (bf16 never splits)
                splits=flash_splits(b, h, s, sk, sms)[0]
                if dtype == torch.float32 else 1)
    if sk != s:
        case["key_seq"] = sk
    check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL[dtype],
          f"flash_attention vs plain: {case}")
    check(torch.equal(got, again), f"flash_attention repeats bitwise: {case}")
    if timed:
        pos = torch.arange(max(s, sk))
        pq, pk = pos[:s, None], pos[None, :sk]
        adm = torch.ones(s, sk, dtype=torch.bool)
        if causal:
            adm &= pk <= pq
        if window:
            adm &= pq - pk < window
        # q, k, v read once, the output written once; q·k over hd and
        # p·v over the value width per admitted pair
        case.update(_attn_bound(dtype, q.numel() + k.numel() + v.numel()
                                + got.numel(), b * h * int(adm.sum()),
                                (hd + v.shape[3]) / 2, FLASH_PEAK_FLOPS))
        case["kernel_ms"] = time_ms(lambda: flash_attention(
            q, k, v, causal=causal, window=window))
        case["plain_ms"] = time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, window=window), reps=3, warm=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        gqa = {"enable_gqa": True} if h != kv else {}
        case["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, **gqa))
        case["library_note"] = (f"scaled_dot_product_attention(is_causal="
                                f"{causal}) on (B, H, S, hd) copies made "
                                f"beforehand")
    return case


def _check_flash_lse(dev, dtype, b, s, h, kv, hd, *, causal=True, window=0,
                     seed=0, sk=None) -> dict:
    """B3 asked for ``lse`` (one call; split under one wave of blocks in
    float32, its merge writing out and lse) against its plain versions,
    twice, bitwise: the output within ATTN_TOL, the rows' log-sum-exp
    within LSE_TOL and +inf exactly where no key is admitted."""
    q, k, v = _attn_inputs(dev, dtype, b, s, h, kv, hd, seed, sk=sk)
    mode = dict(causal=causal, window=window)
    out, lse = flash_attention_with_lse(q, k, v, **mode)
    again, lse_again = flash_attention_with_lse(q, k, v, **mode)
    want = flash_attention_plain(q, k, v, **mode)
    want_lse = flash_attention_lse_plain(q, k, **mode)
    torch.cuda.synchronize()
    fin = torch.isfinite(want_lse)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    case = dict(kernel="flash_attention_with_lse", dtype=str(dtype),
                batch=b, seq=s, key_seq=k.shape[1], heads=h, kv_heads=kv,
                head_dim=hd, causal=causal, window=window,
                splits=flash_splits(b, h, s, k.shape[1], sms)[0],
                max_abs_err=float((out.float() - want.float()).abs().max()),
                lse_max_abs_err=float((lse - want_lse)[fin].abs().max())
                if bool(fin.any()) else 0.0)
    check(case["max_abs_err"] <= ATTN_TOL[dtype]
          and case["lse_max_abs_err"] <= LSE_TOL
          and torch.equal(fin, torch.isfinite(lse)),
          f"flash_attention_with_lse vs plain: {case}")
    check(torch.equal(out, again) and torch.equal(lse, lse_again),
          f"flash_attention_with_lse repeats bitwise: {case}")
    return case


def _check_decode(dev, dtype, b, s, h, kv, hd, lengths, *, window=0,
                  seed=0, timed=False, unmasked=False) -> dict:
    """B4 against its plain version; ``unmasked``: every row admits the
    whole cache (cross-attention's decode), and SDPA is timed with no
    mask."""
    q, k, v = _attn_inputs(dev, dtype, b, s, h, kv, hd, seed, decode=True)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lens, window=window)
    again = decode_attention(q, k, v, lens, window=window)
    want = decode_attention_plain(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    splits = decode_splits(b, kv, s, hd, torch.cuda.get_device_properties(
        dev).multi_processor_count)[0]
    case = dict(kernel="decode_attention", dtype=str(dtype), batch=b,
                cache=s, heads=h, kv_heads=kv, head_dim=hd, window=window,
                lengths=[min(lengths), max(lengths)], splits=splits,
                max_abs_err=err)
    check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL[dtype],
          f"decode_attention vs plain: {case}")
    check(torch.equal(got, again),
          f"decode_attention repeats bitwise (split merge): {case}")
    empty = [i for i, n in enumerate(lengths) if n < 0]
    check(bool((got[empty] == 0).all()),
          f"decode_attention: a row of length -1 gives 0: {case}")
    if timed:
        admitted = [max(0, min(s, n + 1) - (max(0, n - window + 1)
                                            if window else 0))
                    for n in lengths]
        cache_elems = 2 * sum(admitted) * kv * hd
        case.update(_attn_bound(dtype, 2 * q.numel() + cache_elems,
                                sum(admitted) * h, hd))
        case["bytes"] += 4 * b
        case["kernel_ms"] = time_ms(lambda: decode_attention(
            q, k, v, lens, window=window))
        case["plain_ms"] = time_ms(lambda: decode_attention_plain(
            q, k, v, lens, window=window))
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= lens.long()[:, None])[:, None, None, :]
        if unmasked:
            check(bool(mask.all()), f"decode_attention: an unmasked case "
                  f"admits every position: {case}")
            mask = None
        qt = q[:, :, None, :]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        gqa = {"enable_gqa": True} if h != kv else {}
        case["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, **gqa))
        case["library_note"] = (
            "scaled_dot_product_attention " + (
                "with no mask" if unmasked else "with a boolean length "
                "mask") + " on (B, KV, S, hd) copies made beforehand")
    return case


def phase_attn_kernel(dev) -> dict:
    """B3 and B4 against their plain versions on the card, at the serve
    path's shapes and the long serve shapes (timed), at the continuous
    pool's and OLMoE's serve shapes (timed), at phi4-mini's GQA heads,
    with a window, ragged lengths and in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(SERVE_ARCH)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache = SERVE_PROMPT + SERVE_GEN + 1
    long_cache = LONG_PROMPT + LONG_GEN + 1
    cases = []
    for b in (1, 2, 4, 8, 16):
        cases.append(_check_flash(dev, bf16, b, SERVE_PROMPT, h, kv, hd,
                                  seed=b))
        cases.append(_check_decode(dev, bf16, b, cache, h, kv, hd,
                                   [SERVE_PROMPT + i % SERVE_GEN
                                    for i in range(b)], seed=b))
    out = {}
    # timed: the serve path's largest batch at its last decode step, and
    # the long shapes at theirs
    out["flash_serve"] = _check_flash(dev, bf16, 32, SERVE_PROMPT, h, kv, hd,
                                      seed=32, timed=True)
    out["decode_serve"] = _check_decode(
        dev, bf16, 32, cache, h, kv, hd, [SERVE_PROMPT + SERVE_GEN - 1] * 32,
        seed=32, timed=True)
    out["flash_long"] = _check_flash(dev, bf16, 32, LONG_PROMPT, h, kv, hd,
                                     seed=33, timed=True)
    out["decode_long"] = _check_decode(
        dev, bf16, 32, long_cache, h, kv, hd,
        [LONG_PROMPT + LONG_GEN - 1] * 32, seed=33, timed=True)
    # batch 1 at the long shapes: one request's prefill, and its decode
    # over the cache split across blocks
    out["flash_batch1"] = _check_flash(dev, bf16, 1, LONG_PROMPT, h, kv, hd,
                                       seed=34, timed=True)
    out["decode_batch1"] = _check_decode(
        dev, bf16, 1, long_cache, h, kv, hd, [LONG_PROMPT + LONG_GEN - 1],
        seed=34, timed=True)
    cases += list(out.values())
    # batch 1 on the long cache with lengths that leave all, all but one
    # or some of the splits empty, and four ragged rows
    for i, n in enumerate((-1, 0, 63, 64, 500)):
        cases.append(_check_decode(dev, bf16, 1, long_cache, h, kv, hd, [n],
                                   seed=35 + i))
    cases.append(_check_decode(dev, bf16, 4, long_cache, h, kv, hd,
                               [-1, 5, 600, long_cache - 1], seed=40))
    phi4 = get_config("phi4-mini-3.8b")
    gh, gkv, ghd = phi4.num_heads, phi4.num_kv_heads, phi4.head_dim
    ragged = [0, 1, 250, 299, 511, 300, 17, 400]
    for dt in (bf16, f32):
        cases.append(_check_flash(dev, dt, 3, 300, gh, gkv, ghd, seed=40))
        cases.append(_check_decode(dev, dt, 8, 523, gh, gkv, ghd, ragged,
                                   seed=41))
        cases.append(_check_flash(dev, dt, 2, 200, h, kv, hd, window=64,
                                  seed=42))
        cases.append(_check_flash(dev, dt, 2, 77, h, kv, hd, causal=False,
                                  window=9, seed=43))
        cases.append(_check_decode(dev, dt, 8, 523, h, kv, hd, ragged,
                                   window=100, seed=44))
    # the paths of the continuous engine and of OLMoE: the pool's step
    # (B 64 over a 161-position cache, lengths over 128..160, and idle
    # rows past the cache), its one-prompt prefill, OLMoE's serve
    # batches (16/16 heads of width 128: one query head a kv head, so a
    # score is split over four threads) and its float32 consistency run
    pool = CONT_PROMPT + CONT_GEN + 1
    spread = [CONT_PROMPT + i % (CONT_GEN + 1) for i in range(CONT_CAP)]
    out["flash_continuous"] = _check_flash(dev, bf16, 1, CONT_PROMPT, h, kv,
                                           hd, seed=60, timed=True)
    out["decode_continuous"] = _check_decode(dev, bf16, CONT_CAP, pool, h,
                                             kv, hd, spread, seed=61,
                                             timed=True)
    cases.append(_check_decode(dev, bf16, CONT_CAP, pool, h, kv, hd,
                               [0, pool - 1, pool, pool + 100] + spread[4:],
                               seed=62))
    moe = get_config(MOE_ARCH)
    mh, mkv, mhd = moe.num_heads, moe.num_kv_heads, moe.head_dim
    for b in (1, 2, 4, 8, 16):
        cases.append(_check_flash(dev, bf16, b, SERVE_PROMPT, mh, mkv, mhd,
                                  seed=62 + b))
        cases.append(_check_decode(dev, bf16, b, cache, mh, mkv, mhd,
                                   [SERVE_PROMPT + i % SERVE_GEN
                                    for i in range(b)], seed=62 + b))
    out["flash_moe"] = _check_flash(dev, bf16, 32, SERVE_PROMPT, mh, mkv,
                                    mhd, seed=94, timed=True)
    out["decode_moe"] = _check_decode(
        dev, bf16, 32, cache, mh, mkv, mhd,
        [SERVE_PROMPT + SERVE_GEN - 1] * 32, seed=94, timed=True)
    cases += [out[k] for k in ("flash_continuous", "decode_continuous",
                               "flash_moe", "decode_moe")]
    cases.append(_check_flash(dev, f32, 2, 303, mh, mkv, mhd, seed=95))
    # float32 at every width pair on the tensor cores (3xTF32): GQA 32
    # over 8 x 128, MLA's (192, 128), (32, 32), the unmasked cross shape
    # and a batch-1 prompt whose 80 query blocks split the key axis
    cases += [_check_flash(dev, f32, 2, 300, 32, 8, 128, seed=97),
              _check_flash(dev, f32, 2, 300, 16, 16, 192, hdv=128, seed=98),
              _check_flash(dev, f32, 2, 61, 6, 2, 32, causal=False,
                           window=9, seed=99),
              _check_flash(dev, f32, 2, SERVE_PROMPT, h, kv, hd,
                           causal=False, sk=1500, seed=100),
              _check_flash(dev, f32, 1, 300, h, kv, hd, seed=101)]
    cases.append(_check_decode(dev, f32, 2, 303, mh, mkv, mhd, [300, 302],
                               seed=96))
    cases.append(_check_flash(dev, f32, 32, SERVE_PROMPT, h, kv, hd,
                              seed=45))
    cases.append(_check_decode(dev, f32, 32, cache, h, kv, hd,
                               list(range(SERVE_PROMPT, SERVE_PROMPT + 32)),
                               seed=46))
    # a row whose length admits no position gives 0
    q, k, v = _attn_inputs(dev, bf16, 2, cache, h, kv, hd, 47, decode=True)
    lens = torch.tensor([-1, 5], dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    check(bool((got[0] == 0).all()), "decode_attention: no admitted "
          "position gives 0")
    emit("attn_kernel", cases=cases,
         worst_bf16=max(c["max_abs_err"] for c in cases
                        if c["dtype"] == str(bf16)),
         worst_f32=max(c["max_abs_err"] for c in cases
                       if c["dtype"] == str(f32)))
    return out


def _serve_launches() -> dict:
    """The launch counts of every kernel a served model can run."""
    return {"flash_attention": flash_attention.launches,
            "flash_attention_backward": flash_attention.backward_launches,
            "decode_attention": decode_attention.launches,
            "decode_attention_int8": decode_attention_int8.launches,
            "ssd_scan": ssd_scan.launches,
            "ssd_scan_backward": ssd_scan.backward_launches,
            "mla_decode": mla_decode_attention.launches}


def _reset_serve_launches() -> None:
    flash_attention.launches = 0
    flash_attention.backward_launches = 0
    decode_attention.launches = 0
    decode_attention_int8.launches = 0
    ssd_scan.launches = 0
    ssd_scan.backward_launches = 0
    mla_decode_attention.launches = 0


def _launch_counts(**counts) -> dict:
    """``counts``, with every other kernel of ``_serve_launches`` at 0."""
    return {**dict.fromkeys(_serve_launches(), 0), **counts}


def _drop_share(eng, b: int) -> dict:
    """One generate batch of ``b`` with the MoE's routing counted: the
    share of (token, slot) pairs dropped over capacity, prefill and
    decode together."""
    route = moe_module._route
    counts = [0, 0]

    def counted(logits, moe, capacity):
        out = route(logits, moe, capacity)
        counts[0] += out[2].numel()
        counts[1] += int((~out[2]).sum())
        return out

    moe_module._route = counted
    try:
        eng._fns[b](eng.params, eng._make_batch(b))
    finally:
        moe_module._route = route
    return dict(batch=b, routed=counts[0], dropped=counts[1],
                dropped_share=counts[1] / counts[0])


def _serve_model(dev, name: str, argv, per_batch: dict, cfg=None,
                 extra=None) -> dict:
    """``launch.serve``'s run of ``argv`` as a user runs it, on ``cfg``
    in place of ``--arch``'s config where one is given (a depth cut,
    say): every job served with finite latencies, τ^[b] > 0, exactly
    ``per_batch`` launches of each kernel a batch (counted over the run,
    and over one more batch), tokens in the vocabulary, finite logits
    and peak memory under the card's; on a MoE model also a positive
    aux loss and the dropped-token share at b 1 and 32.  ``extra(eng)``
    runs a phase's own gates on the engine and returns their fields."""
    args = serve_cli.parse_args(argv)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_serve_launches()
    t0 = time.perf_counter()
    out = serve_cli.run(args, cfg=cfg)
    seconds = time.perf_counter() - t0
    launches = _serve_launches()
    eng, res = out["engine"], out["result"]
    cfg, batches = eng.cfg, eng.batches_run
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: n * batches for k, n in per_batch.items()}
    check(launches == want, f"{name}: {batches} batches launched "
          f"{launches}, expected {want}")
    check(res.n_jobs == args.jobs and len(res.latencies) == args.jobs
          and int(res.batch_sizes.sum()) >= args.jobs
          and bool(np.all(np.isfinite(res.latencies))
                   and np.all(res.latencies > 0)),
          f"{name}: {len(res.latencies)} of {args.jobs} jobs served")
    check(all(t > 0 for t in out["tau_s"]), f"{name}: positive τ^[b]")
    before = _serve_launches()
    eng.run_batch(eng.max_batch)
    one = {k: n - before[k] for k, n in _serve_launches().items()}
    check(one == per_batch, f"{name}: one batch launched {one}, expected "
          f"{per_batch}")
    fields = {}
    if cfg.moe is not None:
        fields.update(capacity_factor=cfg.moe.capacity_factor,
                      drops=[_drop_share(eng, b)
                             for b in (1, eng.max_batch)])
    batch = eng._make_batch(eng.max_batch)
    toks = eng._fns[eng.max_batch](eng.params, batch)
    check(tuple(toks.shape) == (eng.max_batch, SERVE_GEN)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{name}: generated tokens in the vocabulary")
    with torch.inference_mode():
        logits, aux = eng.bundle.forward(eng.params, batch)
    check(bool(torch.isfinite(logits).all()), f"{name}: finite logits")
    if cfg.moe is not None:
        check(float(aux) > 0, f"{name}: a positive aux loss")
        fields["aux_loss"] = float(aux)
    total = torch.cuda.get_device_properties(dev).total_memory
    check(peak < total, f"{name}: peak {peak} bytes under the card's "
          f"{total}")
    if extra is not None:
        fields.update(extra(eng))
    info = dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
                args=argv, seconds=seconds, buckets=out["buckets"],
                tau_ms=[t * 1e3 for t in out["tau_s"]],
                alpha_ms=out["alpha_s"] * 1e3, tau0_ms=out["tau0_s"] * 1e3,
                r2=out["r2"], lam_per_s=out["lam"],
                mean_latency_ms=res.mean_latency * 1e3,
                phi_ms=out["phi_s"] * 1e3,
                p50_ms=res.latency_p50 * 1e3, p99_ms=res.latency_p99 * 1e3,
                mean_batch=res.mean_batch, utilization=res.utilization,
                jobs=res.n_jobs, served_batches=len(res.batch_sizes),
                batches_run=batches, launches=launches,
                launches_per_batch=per_batch, peak_mem_bytes=peak,
                device_mem_bytes=total, **fields)
    emit(name, **info)
    del eng, out, batch, logits
    torch.cuda.empty_cache()
    return info


def phase_serve(dev) -> dict:
    """The port's launch.serve path as a user runs it: 24 B3 and 24 × 4
    B4 launches a batch."""
    n = get_config(SERVE_ARCH).num_layers
    return _serve_model(dev, "serve", SERVE_ARGS, _launch_counts(
        flash_attention=n, decode_attention=n * SERVE_GEN))


def phase_serve_long(dev, jobs: int = 300) -> dict:
    """The served model on a 1,024-token prompt and 32 generated tokens:
    calibrated on batches 1…32, then serving ``jobs`` Poisson requests
    at ρ = 0.5 of the fit, as ``launch.serve`` does."""
    cfg = get_config(SERVE_ARCH)
    eng = InferenceEngine(cfg, workload="generate", seq_len=LONG_PROMPT,
                          gen_tokens=LONG_GEN, max_batch=32)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_serve_launches()
    t0 = time.perf_counter()
    b, tau = eng.calibrate(samples=3)
    model, r2 = fit_service_model(b, tau)
    lam = 0.5 / model.alpha
    res = eng.serve_poisson(lam, n_jobs=jobs, seed=0, warmup=False)
    seconds = time.perf_counter() - t0
    launches = _serve_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    n = cfg.num_layers * eng.batches_run
    want = _launch_counts(flash_attention=n, decode_attention=n * LONG_GEN)
    check(launches == want, f"serve_long: {eng.batches_run} batches "
          f"launched {launches}, expected {want}")
    check(bool(np.all(np.isfinite(tau)) and np.all(tau > 0)),
          "serve_long: positive τ^[b]")
    check(len(res.latencies) == jobs
          and bool(np.all(np.isfinite(res.latencies))),
          "serve_long: every job served, finite latencies")
    info = dict(arch=SERVE_ARCH, dtype=cfg.dtype, prompt=LONG_PROMPT,
                gen_tokens=LONG_GEN, seconds=seconds, buckets=b.tolist(),
                tau_ms=(tau * 1e3).tolist(), alpha_ms=model.alpha * 1e3,
                tau0_ms=model.tau0 * 1e3, r2=r2, lam_per_s=lam,
                mean_latency_ms=res.mean_latency * 1e3,
                phi_ms=float(phi(lam, model.alpha, model.tau0)) * 1e3,
                p50_ms=res.latency_p50 * 1e3, p99_ms=res.latency_p99 * 1e3,
                mean_batch=res.mean_batch, utilization=res.utilization,
                served_batches=len(res.batch_sizes),
                batches_run=eng.batches_run, launches=launches,
                peak_mem_bytes=peak)
    emit("serve_long", **info)
    del eng
    torch.cuda.empty_cache()
    return info


def _consistency(dev, arch: str, prompt: int, extra: int = 3,
                 layers: int = 0, inputs=None) -> dict:
    """``arch`` at full width in float32 from the port's seeded init,
    batch 2 (its first ``layers`` layers when given): the logits of
    prefill(prompt) and ``extra`` decode steps against the forward
    logits of the whole sequence, within 3e-4 (abs + rel).  A MoE
    config runs at capacity factor E / k, where no token is dropped (at
    1.25 the three passes' group sizes give different capacities, and
    so different drops).  ``inputs(cfg, rng)``, drawn after the tokens
    from the same generator, returns the batch's other inputs and the
    positions they take in front of the prompt (a VLM's patch rows)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(5))
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(2, prompt + extra)), device=dev)
    more, front = ({}, 0) if inputs is None else inputs(cfg, rng)
    more = {k: torch.as_tensor(a, device=dev) for k, a in more.items()}
    with torch.inference_mode():
        ref, _ = bundle.forward(params, {"tokens": toks, **more})
        lg, cache = bundle.prefill(params, {"tokens": toks[:, :prompt],
                                            **more}, front + prompt + extra)
        got = [lg[:, 0]]
        lengths = torch.full((2,), front + prompt, dtype=torch.int32,
                             device=dev)
        for t in range(extra):
            lg, cache = bundle.decode_step(
                params, toks[:, prompt + t:prompt + t + 1], cache, lengths)
            got.append(lg[:, 0])
            lengths = lengths + 1
    want = ref[:, front + prompt - 1:]
    got = torch.stack(got, dim=1)
    diff = (got - want).abs()
    tol = 3e-4
    worst = float((diff / (tol + tol * want.abs())).max())
    info = dict(arch=arch, dtype="float32", layers=cfg.num_layers, batch=2,
                prompt=prompt, decode_steps=extra, front_positions=front,
                inputs=sorted(more),
                max_abs_diff=float(diff.max()),
                max_abs_logit=float(want.abs().max()),
                tolerance=f"|diff| <= {tol} + {tol}*|forward|",
                worst_over_tol=worst)
    check(bool(torch.isfinite(got).all()) and worst <= 1.0,
          f"consistency of {arch}: {info}")
    del params, cache, ref
    torch.cuda.empty_cache()
    return info


def phase_model_consistency(dev) -> dict:
    """qwen1.5-0.5b at full width in float32: prefill + decode logits
    against the forward logits of the whole sequence."""
    info = _consistency(dev, SERVE_ARCH, SERVE_PROMPT)
    emit("model_consistency", **info)
    return info


def _ssd_inputs(dev, dtype, b, s, nh, g, hd, ds, seed):
    """tests/test_kernels.py's distributions; B and C are strided slices
    of one (b, s, 2·g·ds) activation, as the model passes them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, s, nh, hd, device=dev, generator=gen) * 0.5
         ).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, nh, device=dev, generator=gen))
    a = -torch.exp(torch.randn(nh, device=dev, generator=gen) * 0.3)
    bc = (torch.randn(b, s, 2 * g * ds, device=dev, generator=gen) * 0.3
          ).to(dtype)
    return (x, dt, a, bc[..., :g * ds].reshape(b, s, g, ds),
            bc[..., g * ds:].reshape(b, s, g, ds))


def _check_ssd(dev, dtype, b, s, *, g=1, seed=0, timed=False,
               model=None) -> dict:
    """B5 against its plain version at ``model``'s SSM widths (default
    mamba2-2.7b's)."""
    model = model or get_config(SSM_ARCH)
    cfg = model.ssm
    nh, hd, ds = cfg.n_heads(model.d_model), cfg.head_dim, cfg.d_state
    args = _ssd_inputs(dev, dtype, b, s, nh, g, hd, ds, seed)
    y, h = ssd_chunked(*args, cfg.chunk_size)
    again = ssd_chunked(*args, cfg.chunk_size)
    want_y, want_h = ssd_scan_plain(*args, cfg.chunk_size)
    api = ssd_scan(*args, chunk=cfg.chunk_size)
    torch.cuda.synchronize()
    err_y = float((y - want_y).abs().max())
    err_state = float((h - want_h).abs().max())
    # the bf16 route splits the time axis at small batch; float32 never
    splits = (ssd_splits(b, s, nh, torch.cuda.get_device_properties(
        dev).multi_processor_count)[0] if dtype == torch.bfloat16 else 1)
    case = dict(kernel="ssd_scan", dtype=str(dtype), batch=b, seq=s,
                heads=nh, groups=g, head_dim=hd, d_state=ds, splits=splits,
                max_abs_err=max(err_y, err_state), err_y=err_y,
                err_state=err_state, max_abs_y=float(want_y.abs().max()),
                max_abs_state=float(want_h.abs().max()))
    check(bool(torch.isfinite(y).all() and torch.isfinite(h).all())
          and case["max_abs_err"] <= SSD_TOL[dtype],
          f"ssd_scan vs plain: {case}")
    check(torch.equal(api, y.to(dtype)),
          f"ssd_scan's y is the model call's, rounded: {case}")
    check(torch.equal(y, again[0]) and torch.equal(h, again[1]),
          f"ssd_scan repeats bitwise (split combine included): {case}")
    if timed:
        elt = torch.finfo(dtype).bits // 8
        x, dt, a, bm, cm = args
        bytes_moved = (elt * (x.numel() + bm.numel() + cm.numel())
                       + 4 * (dt.numel() + a.numel() + y.numel()
                              + h.numel()))
        # the recurrence's two products per step and head: x ⊗ B into
        # the state, and the state against C
        flops = 4 * b * s * nh * hd * ds
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        # both routes run on the tensor cores (float32 as 3xTF32)
        t_ops = flops / FLASH_PEAK_FLOPS[dtype] * 1e3
        case.update(bytes=bytes_moved, flops=flops,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        if dtype == torch.float32:
            case["bound_ms_cuda_cores"] = max(
                t_bytes, flops / PEAK_FLOPS[dtype] * 1e3)
        case["kernel_ms"] = time_ms(lambda: ssd_chunked(*args,
                                                        cfg.chunk_size))
        case["plain_ms"] = time_ms(lambda: ssd_scan_plain(
            *args, cfg.chunk_size), reps=3, warm=1)
        case["library_ms"] = None
        case["library_note"] = ("no single PyTorch call computes the SSD "
                                "scan")
    del args, y, h, again, want_y, want_h, api
    torch.cuda.empty_cache()
    return case


def phase_ssd_kernel(dev) -> dict:
    """B5 against its plain version on the card at the Mamba2 serve
    path's shapes (timed), the batches around the split rule's steps
    (B 1, 2, 4 at S 1,024), ragged lengths split and unsplit, batch 1
    at the serve prompt, float32 (timed, B 4 × 300) and two groups;
    every case twice, bitwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"serve": _check_ssd(dev, bf16, 32, SSM_PROMPT, seed=1,
                               timed=True),
           "long": _check_ssd(dev, bf16, 32, SSM_LONG, seed=2, timed=True),
           "batch1": _check_ssd(dev, bf16, 1, SSM_LONG, seed=3, timed=True)}
    cases = list(out.values()) + [
        _check_ssd(dev, bf16, 32, 1000, seed=4),
        _check_ssd(dev, f32, 4, 300, seed=5, timed=True),
        _check_ssd(dev, bf16, 4, 1000, g=2, seed=6),
        _check_ssd(dev, bf16, 2, SSM_LONG, seed=7),
        _check_ssd(dev, bf16, 4, SSM_LONG, seed=8),
        _check_ssd(dev, bf16, 1, 1000, seed=9),
        _check_ssd(dev, bf16, 1, SSM_PROMPT, seed=10)]
    out["f32"] = cases[4]
    emit("ssd_kernel", cases=cases,
         worst_bf16=max(c["max_abs_err"] for c in cases
                        if c["dtype"] == str(bf16)),
         worst_f32=max(c["max_abs_err"] for c in cases
                       if c["dtype"] == str(f32)),
         splits={f"{c['batch']}x{c['seq']}": c["splits"] for c in cases
                 if c["dtype"] == str(bf16)})
    return out


def phase_serve_ssm(dev) -> dict:
    """The port's launch.serve path on mamba2-2.7b as a user runs it: 64
    B5 launches a batch and no attention launch."""
    n = get_config(SSM_ARCH).num_layers
    return _serve_model(dev, "serve_ssm", SSM_ARGS,
                        _launch_counts(ssd_scan=n))


def phase_ssm_consistency(dev) -> dict:
    """mamba2-2.7b in float32: prefill(300) crosses the 256-token chunk,
    so the kernel's final state carries into the decode steps."""
    info = _consistency(dev, SSM_ARCH, 300)
    emit("ssm_consistency", **info)
    return info


# ---------------------------------------------------------------------------
# the continuous engine, the MoE family and the int8 KV cache
# ---------------------------------------------------------------------------

def _check_decode_int8(dev, dtype, b, s, h, kv, hd, lengths, *, window=0,
                       seed=0, timed=False) -> dict:
    """B4 over an int8 cache (codes and scales from ``quantize_kv`` of
    random K/V) against its plain version, launched twice."""
    q, k, v = _attn_inputs(dev, torch.float32, b, s, h, kv, hd, seed,
                           decode=True)
    q = q.to(dtype)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    got = decode_attention_int8(q, kq, ks, vq, vs, lens, window=window)
    again = decode_attention_int8(q, kq, ks, vq, vs, lens, window=window)
    want = decode_attention_int8_plain(q, kq, ks, vq, vs, lens,
                                       window=window)
    # the plain version's float32 result before the output's rounding
    exact = decode_attention_int8_plain(q.float(), kq, ks, vq, vs, lens,
                                        window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    rel, floor = INT8_TOL[dtype]
    over = float(((got.float() - exact).abs()
                  / (rel * exact.abs() + floor)).max())
    splits = decode_splits(b, kv, s, hd, torch.cuda.get_device_properties(
        dev).multi_processor_count)[0]
    case = dict(kernel="decode_attention_int8", dtype=str(dtype), batch=b,
                cache=s, heads=h, kv_heads=kv, head_dim=hd, window=window,
                lengths=[min(lengths), max(lengths)], splits=splits,
                max_abs_err=err,
                max_abs_err_vs_f32=float((got.float() - exact).abs().max()),
                tolerance=f"|out - f32 plain| <= {rel} * |f32 plain| "
                          f"+ {floor}", worst_over_tol=over)
    check(bool(torch.isfinite(got).all()) and over <= 1.0,
          f"decode_attention_int8 vs plain: {case}")
    check(torch.equal(got, again),
          f"decode_attention_int8 repeats bitwise (split merge): {case}")
    empty = [i for i, n in enumerate(lengths) if n < 0]
    check(bool((got[empty] == 0).all()),
          f"decode_attention_int8: a row of length -1 gives 0: {case}")
    if timed:
        admitted = [max(0, min(s, n + 1) - (max(0, n - window + 1)
                                            if window else 0))
                    for n in lengths]
        # the admitted codes and scales read once, q read, out written
        elt = torch.finfo(dtype).bits // 8
        bytes_moved = (2 * sum(admitted) * kv * (hd + 4)
                       + 2 * elt * q.numel() + 4 * b)
        flops = 4 * hd * sum(admitted) * h
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        case.update(bytes=bytes_moved, flops=flops,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        case["kernel_ms"] = time_ms(lambda: decode_attention_int8(
            q, kq, ks, vq, vs, lens, window=window))
        case["plain_ms"] = time_ms(lambda: decode_attention_int8_plain(
            q, kq, ks, vq, vs, lens, window=window))
        # the bf16-cache B4 at the same shape
        kb, vb = k.to(dtype), v.to(dtype)
        case["float_cache_ms"] = time_ms(lambda: decode_attention(
            q, kb, vb, lens, window=window))
        # SDPA over a cache dequantized beforehand: not the same function
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= lens.long()[:, None])[:, None, None, :]
        kt, vt = ((c.float() * sc).to(dtype).transpose(1, 2).contiguous()
                  for c, sc in ((kq, ks), (vq, vs)))
        qt = q[:, :, None, :]
        # no PyTorch call reads an int8 cache with its scales
        case["library_ms"] = None
        case["sdpa_dequantized_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        case["library_note"] = ("none; sdpa_dequantized_ms, not the same "
                                "function, is scaled_dot_product_attention "
                                "over (B, KV, S, hd) copies of the cache "
                                "dequantized beforehand, with a boolean "
                                "length mask")
    return case


def phase_kv_int8_kernel(dev) -> dict:
    """B4's int8 form against its plain version at serve_int8's shapes
    (every batch bucket over its 37-position cache; batch 32 timed), at
    the continuous pool's shape and the long and batch-1 shapes (timed,
    off the int8 path), ragged lengths past both ends of the cache, GQA
    heads with a window, and float32 q."""
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(SERVE_ARCH)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache = SERVE_PROMPT + SERVE_GEN + 1
    pool = CONT_PROMPT + CONT_GEN + 1
    long_cache = LONG_PROMPT + LONG_GEN + 1
    cases = [_check_decode_int8(dev, bf16, b, cache, h, kv, hd,
                                [SERVE_PROMPT + i % SERVE_GEN
                                 for i in range(b)], seed=56 + b)
             for b in (1, 2, 4, 8, 16)]
    out = {"serve": _check_decode_int8(dev, bf16, 32, cache, h, kv, hd,
                                       [SERVE_PROMPT + SERVE_GEN - 1] * 32,
                                       seed=49, timed=True),
           "pool": _check_decode_int8(dev, bf16, CONT_CAP, pool, h, kv, hd,
                                      [pool - 1] * CONT_CAP, seed=50,
                                      timed=True),
           "long": _check_decode_int8(dev, bf16, 32, long_cache, h, kv, hd,
                                      [long_cache - 1] * 32, seed=51,
                                      timed=True),
           "batch1": _check_decode_int8(dev, bf16, 1, long_cache, h, kv, hd,
                                        [long_cache - 1], seed=52,
                                        timed=True)}
    phi4 = get_config("phi4-mini-3.8b")
    cases += list(out.values()) + [
        _check_decode_int8(dev, bf16, 6, pool, h, kv, hd,
                           [-1, 0, 63, pool - 1, pool, pool + 5], seed=53),
        _check_decode_int8(dev, bf16, 8, 523, phi4.num_heads,
                           phi4.num_kv_heads, phi4.head_dim,
                           [0, 1, 250, 299, 511, 300, 17, 400], window=100,
                           seed=54),
        _check_decode_int8(dev, f32, 32, cache, h, kv, hd,
                           [SERVE_PROMPT + i % SERVE_GEN for i in range(32)],
                           seed=48),
        _check_decode_int8(dev, f32, CONT_CAP, pool, h, kv, hd,
                           list(range(CONT_PROMPT, CONT_PROMPT + CONT_CAP)),
                           seed=55),
        _check_decode_int8(dev, f32, 6, pool, h, kv, hd,
                           [-1, 0, 63, pool - 1, pool, pool + 5], seed=56)]
    emit("kv_int8_kernel", cases=cases,
         worst_bf16=max(c["max_abs_err"] for c in cases
                        if c["dtype"] == str(bf16)),
         worst_bf16_over_tol=max(c["worst_over_tol"] for c in cases
                                 if c["dtype"] == str(bf16)),
         worst_f32=max(c["max_abs_err"] for c in cases
                       if c["dtype"] == str(f32)))
    return out


def _slot_isolation(dev, layers: int = 8, prompt: int = 32,
                    steps: int = 3) -> dict:
    """The continuous pool in float32 at ``layers`` layers: four prompts
    admitted into slots 0, 5, 2 and 7 of 8 at steps 0, 1, 1 and 3 (the
    idle slots decoding beside them), each one's first ``steps`` decode
    logits in the pool against its solo prefill + decode, fed the same
    tokens."""
    cfg = dataclasses.replace(get_config(SERVE_ARCH), dtype="float32",
                              num_layers=layers)
    eng = ContinuousEngine(cfg, prompt_len=prompt, gen_tokens=8,
                           max_active=8, seed=3)
    bundle, params = eng.bundle, eng.params
    rng = np.random.default_rng(3)
    admit = {0: [(0, 0)], 1: [(5, 1), (2, 2)], 3: [(7, 3)]}
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            size=(1, prompt)), device=dev)
               for _ in range(4)]
    pool_logits = {r: [] for r in range(4)}
    fed = {r: [] for r in range(4)}
    slot_of = {}
    with torch.inference_mode():
        for step in range(6):
            for slot, req in admit.get(step, []):
                tok, cache = eng._prefill(params, prompts[req])
                eng._write_slot(slot, cache, tok)
                slot_of[req] = slot
            tok_in = eng._pool_tok.clone()
            lg, _ = bundle.decode_step(params, eng._pool_tok,
                                       eng._pool_cache, eng._pool_len)
            eng._pool_tok = torch.argmax(lg, dim=-1)
            eng._pool_len += 1
            for req, slot in slot_of.items():
                if len(pool_logits[req]) < steps:
                    pool_logits[req].append(lg[slot, 0].clone())
                    fed[req].append(tok_in[slot:slot + 1].clone())
        worst = 0.0
        for req in range(4):
            _, cache = bundle.prefill(params, {"tokens": prompts[req]},
                                      eng.cache_len)
            lens = torch.full((1,), prompt, dtype=torch.int32, device=dev)
            for t in range(steps):
                lg, cache = bundle.decode_step(params, fed[req][t], cache,
                                               lens)
                lens = lens + 1
                worst = max(worst, float((lg[0, 0] - pool_logits[req][t])
                                         .abs().max()))
    info = dict(layers=layers, dtype="float32", slots=8, prompt=prompt,
                requests=4, decode_steps=steps, max_abs_diff=worst,
                tolerance=1e-4)
    check(worst <= 1e-4, f"continuous slot isolation: {info}")
    del eng, bundle, params
    torch.cuda.empty_cache()
    return info


def phase_continuous_serve(dev) -> dict:
    """The port's ContinuousEngine as a user runs it, on qwen1.5-0.5b at
    full width and depth."""
    cfg = get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ContinuousEngine(cfg, prompt_len=CONT_PROMPT, gen_tokens=CONT_GEN,
                           max_active=CONT_CAP)
    # warm-up: the prefill of one prompt and the pool's decode step, on a
    # copy of the pool
    eng.warmup()
    with torch.inference_mode():
        scratch = [{k: t.clone() for k, t in c.items()}
                   for c in eng._pool_cache]
    pre = [eng._timed(eng._prefill, eng.params, eng._prompt())[1]
           for _ in range(3)]
    step = [eng._timed(eng._decode, eng.params, eng._pool_tok, scratch,
                       eng._pool_len)[1] for _ in range(3)]
    del scratch
    eng._rng = np.random.default_rng(0)
    p_s, s_s = float(np.median(pre)), float(np.median(step))
    # the pool serves max_active / gen_tokens requests a step at best;
    # each admission's prefill holds the pool for p_s
    capacity = 1.0 / (p_s + CONT_GEN * s_s / CONT_CAP)
    lam = 0.5 * capacity
    # count admissions and steps, and time each step beside its active
    # count, as the engine sees them
    remaining = [0] * CONT_CAP
    steps_log, prefill_dts = [], []
    write, timed = eng._write_slot, eng._timed

    def counted_write(slot, cache_one, tok_one):
        remaining[slot] = CONT_GEN
        write(slot, cache_one, tok_one)

    def counted_timed(fn, *args):
        out, dt = timed(fn, *args)
        if fn == eng._decode:
            active = sum(r > 0 for r in remaining)
            steps_log.append((active, dt))
            for i, r in enumerate(remaining):
                remaining[i] = max(0, r - 1)
        else:
            prefill_dts.append(dt)
        return out, dt

    eng._write_slot, eng._timed = counted_write, counted_timed
    _reset_serve_launches()
    t0 = time.perf_counter()
    res = eng.serve_poisson(lam, n_jobs=CONT_JOBS, seed=0)
    seconds = time.perf_counter() - t0
    launches = _serve_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    n_pre, n_dec = len(prefill_dts), len(steps_log)
    want = _launch_counts(flash_attention=cfg.num_layers * n_pre,
                          decode_attention=cfg.num_layers * n_dec)
    check(launches == want, f"continuous_serve: {n_pre} prefills and "
          f"{n_dec} steps launched {launches}, expected {want}")
    check(res.n_jobs == CONT_JOBS and len(res.latencies) == CONT_JOBS
          and bool(np.all(np.isfinite(res.latencies))
                   and np.all(res.latencies > 0)),
          f"continuous_serve: {res.n_jobs} of {CONT_JOBS} jobs served")
    check(1 <= res.mean_active <= CONT_CAP,
          f"continuous_serve: mean_active {res.mean_active}")
    # the warm-up's prefill and step, then one per admission and step
    check(n_pre == CONT_JOBS + 1 and n_dec == res.steps + 1,
          f"continuous_serve: {n_pre} prefills, {n_dec} steps for "
          f"{res.steps} served steps")
    lens = eng._pool_len.cpu().numpy()
    check(int(lens.max()) > eng.cache_len,
          f"continuous_serve: no idle slot passed the cache "
          f"({int(lens.max())} <= {eng.cache_len})")
    served = steps_log[1:]
    act = np.array([a for a, _ in served], float)
    dts = np.array([d for _, d in served]) * 1e3
    slope, icept = np.polyfit(act, dts, 1) if len(set(act)) > 1 else (0, 0)
    by_active = {}
    for lo in range(1, CONT_CAP + 1, 8):
        sel = (act >= lo) & (act < lo + 8)
        if sel.any():
            by_active[f"{lo}-{lo + 7}"] = dict(
                steps=int(sel.sum()), mean_ms=float(dts[sel].mean()),
                p50_ms=float(np.median(dts[sel])))
    info = dict(arch=SERVE_ARCH, dtype=cfg.dtype, prompt=CONT_PROMPT,
                gen_tokens=CONT_GEN, max_active=CONT_CAP, jobs=CONT_JOBS,
                warmup_prefill_ms=p_s * 1e3, warmup_step_ms=s_s * 1e3,
                capacity_per_s=capacity,
                capacity_without_prefill_per_s=CONT_CAP / (CONT_GEN * s_s),
                lam_per_s=lam, seconds=seconds,
                mean_latency_ms=res.mean_latency * 1e3,
                p50_ms=res.latency_p50 * 1e3, p99_ms=res.latency_p99 * 1e3,
                mean_active=res.mean_active, utilization=res.utilization,
                steps=res.steps,
                prefill_ms_per_admission=float(np.mean(prefill_dts[1:]))
                * 1e3,
                step_ms=dict(mean=float(dts.mean()),
                             p50=float(np.median(dts)),
                             p99=float(np.percentile(dts, 99)),
                             slope_ms_per_active=float(slope),
                             intercept_ms=float(icept),
                             by_active=by_active),
                max_slot_length=int(lens.max()), cache_len=eng.cache_len,
                launches=launches, prefills=n_pre, decode_steps=n_dec,
                peak_mem_bytes=peak)
    del eng
    torch.cuda.empty_cache()
    info["slot_isolation"] = _slot_isolation(dev)
    emit("continuous_serve", **info)
    return info


def phase_serve_moe(dev) -> dict:
    """The port's launch.serve path on olmoe-1b-7b as a user runs it: 16
    B3 and 16 × 4 B4 launches a batch."""
    n = get_config(MOE_ARCH).num_layers
    return _serve_model(dev, "serve_moe", MOE_ARGS, _launch_counts(
        flash_attention=n, decode_attention=n * SERVE_GEN))


def phase_moe_consistency(dev) -> dict:
    """olmoe-1b-7b in float32 at capacity factor E / k: prefill(300) + 3
    decode steps against forward(303)."""
    info = _consistency(dev, MOE_ARCH, 300)
    emit("moe_consistency", **info)
    return info


def phase_serve_int8(dev) -> dict:
    """``serve``'s command with the int8 KV cache (REPRO_KV_INT8=1 for
    this phase only): 24 B3 and 24 × 4 int8 B4 launches a batch and no
    float B4, the cache's bytes exact, and the first decode step's
    logits against the bf16 cache's."""
    cfg = get_config(SERVE_ARCH)

    def int8_gates(eng) -> dict:
        # the cache's bytes, counted exactly against the bf16 cache's
        b, s = eng.max_batch, SERVE_PROMPT + SERVE_GEN + 1
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        cache = eng.bundle.init_cache(b, s, device=dev)
        int8_bytes = sum(t.numel() * t.element_size() for c in cache
                         for t in c.values())
        want_bytes = cfg.num_layers * 2 * b * s * kv * (hd + 4)
        bf16_bytes = cfg.num_layers * 2 * b * s * kv * hd * 2
        check(int8_bytes == want_bytes
              and all(c["k"].dtype == torch.int8 for c in cache),
              f"serve_int8: cache of {int8_bytes} bytes, expected "
              f"{want_bytes}")
        del cache
        batch = eng._make_batch(b)
        lens = torch.full((b,), SERVE_PROMPT, dtype=torch.int32, device=dev)
        first = {}
        with torch.inference_mode():
            for mode in ("int8", "bf16"):
                if mode == "bf16":
                    del os.environ["REPRO_KV_INT8"]
                lg, c = eng.bundle.prefill(eng.params, batch, s)
                tok = torch.argmax(lg[:, -1:], dim=-1)
                lg, _ = eng.bundle.decode_step(eng.params, tok, c, lens)
                first[mode] = lg[:, 0].float()
        dlogit = float((first["int8"] - first["bf16"]).abs().max())
        top1 = float((first["int8"].argmax(-1) == first["bf16"].argmax(-1))
                     .float().mean())
        # the reference's gate on the int8 cache against the float one
        check(dlogit < 0.1, f"serve_int8: first-step max |dlogit| {dlogit} "
              f"against the bf16 cache (top-1 agreement {top1}), gate 0.1")
        return dict(kv_cache="int8", cache_bytes_int8=int8_bytes,
                    cache_bytes_bf16=bf16_bytes,
                    cache_ratio=int8_bytes / bf16_bytes,
                    first_step_max_abs_dlogit=dlogit,
                    first_step_top1_agreement=top1,
                    max_abs_logit=float(first["bf16"].abs().max()))

    n = cfg.num_layers
    os.environ["REPRO_KV_INT8"] = "1"
    try:
        return _serve_model(dev, "serve_int8", SERVE_ARGS, _launch_counts(
            flash_attention=n, decode_attention_int8=n * SERVE_GEN),
            extra=int8_gates)
    finally:
        os.environ.pop("REPRO_KV_INT8", None)


# ---------------------------------------------------------------------------
# Jamba's hybrid interleave and DeepSeek-V2-Lite's MLA
# ---------------------------------------------------------------------------

def _worst(cases) -> dict:
    """The largest error by dtype (an MLA decode case's: its cache's)."""
    out = {}
    for c in cases:
        d = c.get("dtype") or c["cache_dtype"]
        out[d] = max(out.get(d, 0.0), c["max_abs_err"])
    return out


def phase_hybrid_kernels(dev) -> dict:
    """B5 at Jamba's widths (128 heads of 64, d_state 16, one group)
    against its plain version: the serve shape, the long shape and batch
    1 at S 1,024 (split) timed, ragged S 1,000 at B 4 and B 1, float32
    at the serve shape and ragged B 2 × 300 (timed); every case twice,
    bitwise.  B3 and B4 at Jamba's attention heads
    (32 over 8 kv heads of 128) at the serve path's batches, batch 32
    timed, and in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    model = hybrid_config()
    out = {"ssd_serve": _check_ssd(dev, bf16, 32, SSM_PROMPT, seed=101,
                                   timed=True, model=model),
           "ssd_long": _check_ssd(dev, bf16, 32, SSM_LONG, seed=102,
                                  timed=True, model=model),
           "ssd_batch1": _check_ssd(dev, bf16, 1, SSM_LONG, seed=103,
                                    timed=True, model=model)}
    cases = list(out.values()) + [
        _check_ssd(dev, bf16, 4, 1000, seed=104, model=model),
        _check_ssd(dev, bf16, 1, 1000, seed=105, model=model),
        _check_ssd(dev, f32, 32, SSM_PROMPT, seed=106, model=model,
                   timed=True),
        _check_ssd(dev, f32, 2, 300, seed=107, model=model, timed=True)]
    out["ssd_f32_serve"], out["ssd_f32"] = cases[-2], cases[-1]
    h, kv, hd = model.num_heads, model.num_kv_heads, model.head_dim
    cache = SERVE_PROMPT + SERVE_GEN + 1
    for b in (1, 2, 4, 8, 16):
        cases.append(_check_flash(dev, bf16, b, SERVE_PROMPT, h, kv, hd,
                                  seed=110 + b))
        cases.append(_check_decode(dev, bf16, b, cache, h, kv, hd,
                                   [SERVE_PROMPT + i % SERVE_GEN
                                    for i in range(b)], seed=110 + b))
    out["flash_serve"] = _check_flash(dev, bf16, 32, SERVE_PROMPT, h, kv, hd,
                                      seed=132, timed=True)
    out["decode_serve"] = _check_decode(
        dev, bf16, 32, cache, h, kv, hd, [SERVE_PROMPT + SERVE_GEN - 1] * 32,
        seed=132, timed=True)
    cases += [out["flash_serve"], out["decode_serve"],
              _check_flash(dev, f32, 2, 303, h, kv, hd, seed=133),
              _check_decode(dev, f32, 2, 303, h, kv, hd, [300, 302],
                            seed=134)]
    emit("hybrid_kernels", arch=HYBRID_ARCH, cases=cases,
         worst=_worst(cases),
         ssd_splits={f"{c['batch']}x{c['seq']}": c["splits"] for c in cases
                     if c["kernel"] == "ssd_scan"
                     and c["dtype"] == str(bf16)})
    return out


MLA_SCALE = 192 ** -0.5      # (qk_nope 128 + qk_rope 64) ** -0.5


def _mla_inputs(dev, dtype, b, s, seed):
    """q_abs, q_pe (float32) and a c_kv, k_pe cache (``dtype``) at
    DeepSeek-V2-Lite's widths."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, 16, 512, device=dev, generator=gen),
            torch.randn(b, 16, 64, device=dev, generator=gen),
            torch.randn(b, s, 512, device=dev, generator=gen).to(dtype),
            torch.randn(b, s, 64, device=dev, generator=gen).to(dtype))


def _check_mla_decode(dev, dtype, b, s, lengths, *, window=0, seed=0,
                      timed=False) -> dict:
    """The MLA decode kernel against its plain version (float32 context
    within ``MLA_TOL``), twice bitwise, a row of length -1 exactly 0."""
    args = _mla_inputs(dev, dtype, b, s, seed)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    got = mla_decode_attention(*args, lens, scale=MLA_SCALE, window=window)
    again = mla_decode_attention(*args, lens, scale=MLA_SCALE, window=window)
    want = mla_decode_attention_plain(*args, lens, scale=MLA_SCALE,
                                      window=window)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    splits = mla_splits(b, s, torch.cuda.get_device_properties(
        dev).multi_processor_count)[0]
    case = dict(kernel="mla_decode", cache_dtype=str(dtype), batch=b,
                cache=s, heads=16, rank=512, rope=64, window=window,
                lengths=[min(lengths), max(lengths)], splits=splits,
                max_abs_err=err, max_abs_ctx=float(want.abs().max()))
    check(bool(torch.isfinite(got).all()) and err <= MLA_TOL,
          f"mla_decode vs plain: {case}")
    check(torch.equal(got, again),
          f"mla_decode repeats bitwise (split merge): {case}")
    empty = [i for i, n in enumerate(lengths) if n < 0]
    check(bool((got[empty] == 0).all()),
          f"mla_decode: a row of length -1 gives 0: {case}")
    if timed:
        q_abs, q_pe, c_kv, k_pe = args
        admitted = [max(0, min(s, n + 1) - (max(0, n - window + 1)
                                            if window else 0))
                    for n in lengths]
        elt = torch.finfo(dtype).bits // 8
        # the admitted latent rows read once; q read and the context
        # written once; a score (576) and a p·v (512) multiply-add per
        # head and admitted position
        bytes_moved = (elt * 576 * sum(admitted) + 4 * (
            q_abs.numel() + q_pe.numel() + got.numel()) + 4 * b)
        flops = 2 * 16 * (576 + 512) * sum(admitted)
        # the products run on the tensor cores: a float32 cache's at
        # 3xTF32's rate (the CUDA cores' 67 TFLOP/s figure beside, as
        # bound_ms_cuda_cores)
        case.update(_bound(bytes_moved, flops, dtype, FLASH_PEAK_FLOPS))
        case["kernel_ms"] = time_ms(lambda: mla_decode_attention(
            *args, lens, scale=MLA_SCALE, window=window))
        case["plain_ms"] = time_ms(lambda: mla_decode_attention_plain(
            *args, lens, scale=MLA_SCALE, window=window))
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= lens.long()[:, None])[:, None, None, :]
        qt = torch.cat([q_abs, q_pe], -1).to(dtype)[:, :, None, :]
        kt = torch.cat([c_kv, k_pe], -1)[:, None]
        vt = c_kv[:, None]
        case["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=MLA_SCALE,
                enable_gqa=True))
        case["library_note"] = (
            "scaled_dot_product_attention(enable_gqa, scale 192^-0.5) of "
            "[q_abs ‖ q_pe] in the cache's dtype over [c_kv ‖ k_pe] "
            "against c_kv with a length mask, copies made beforehand")
    return case


def mla_decode_cases() -> tuple:
    """The mla_kernel phase's MLA decode checks as (cache dtype, batch,
    cache, lengths, window, seed): the timed ones by name (serve_mla's
    last decode step, the long cache in bf16 and float32, batch 1 over
    it), then the rest: the serve path's batches, windowed and ragged,
    and the lengths -1, 0, 63, S - 1, S + 5 in both cache dtypes."""
    bf16, f32 = torch.bfloat16, torch.float32
    cache = SERVE_PROMPT + SERVE_GEN + 1
    long_cache = LONG_PROMPT + LONG_GEN + 1
    last = LONG_PROMPT + LONG_GEN - 1
    timed = {"serve": (bf16, 32, cache, [SERVE_PROMPT + SERVE_GEN - 1] * 32,
                       0, 232),
             "long": (bf16, 32, long_cache, [last] * 32, 0, 233),
             "batch1": (bf16, 1, long_cache, [last], 0, 234),
             "long_f32": (f32, 32, long_cache, [last] * 32, 0, 235)}
    rest = [(bf16, b, cache, [SERVE_PROMPT + i % SERVE_GEN
                              for i in range(b)], 0, 200 + b)
            for b in (1, 2, 4, 8, 16)]
    ragged = [0, 1, 250, 299, 511, 300, 17, 400]
    edges = [-1, 0, 63, long_cache - 1, long_cache + 5]
    for dt in (bf16, f32):
        rest.append((dt, 8, 523, ragged, 100, 242))
        rest += [(dt, 1, long_cache, [n], 0, 250 + i)
                 for i, n in enumerate(edges)]
        rest.append((dt, 6, long_cache, edges + [500], 0, 256))
        rest.append((dt, 32, long_cache,
                     [(37 * i) % (long_cache + 6) - 1 for i in range(32)], 0,
                     257))
    return timed, rest


def phase_mla_kernel(dev) -> dict:
    """B3 at MLA's (192, 128) pair and the MLA decode kernel against
    their plain versions at DeepSeek-V2-Lite's shapes: the serve path's
    batches, batch 32 at the serve and the long shapes (bf16 and float32
    caches) and batch 1 at the long one timed; windowed, ragged, lengths
    -1, 0, 63, S - 1, S + 5; a bf16 and a float32 cache; every case
    twice, bitwise (``mla_decode_cases``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    h, qd, vd = 16, 192, 128
    cases = [_check_flash(dev, bf16, b, SERVE_PROMPT, h, h, qd, hdv=vd,
                          seed=200 + b) for b in (1, 2, 4, 8, 16)]
    out = {
        "flash_serve": _check_flash(dev, bf16, 32, SERVE_PROMPT, h, h, qd,
                                    hdv=vd, seed=232, timed=True),
        "flash_long": _check_flash(dev, bf16, 32, LONG_PROMPT, h, h, qd,
                                   hdv=vd, seed=233, timed=True),
        "flash_batch1": _check_flash(dev, bf16, 1, LONG_PROMPT, h, h, qd,
                                     hdv=vd, seed=234, timed=True)}
    timed, rest = mla_decode_cases()
    for name, (dt, b, s, lengths, window, seed) in timed.items():
        out[f"decode_{name}"] = _check_mla_decode(
            dev, dt, b, s, lengths, window=window, seed=seed, timed=True)
    cases += list(out.values())
    cases += [_check_mla_decode(dev, dt, b, s, lengths, window=window,
                                seed=seed)
              for dt, b, s, lengths, window, seed in rest]
    for dt in (bf16, f32):
        cases.append(_check_flash(dev, dt, 2, 200, h, h, qd, hdv=vd,
                                  window=64, seed=240))
        cases.append(_check_flash(dev, dt, 2, 303, h, h, qd, hdv=vd,
                                  seed=241))
    cases.append(_check_flash(dev, f32, 32, SERVE_PROMPT, h, h, qd, hdv=vd,
                              seed=260))
    emit("mla_kernel", arch=MLA_ARCH, cases=cases, worst=_worst(cases),
         decode_splits={k: out[k]["splits"] for k in out
                        if k.startswith("decode")})
    return out


def phase_serve_mla(dev) -> dict:
    """``launch.serve --arch deepseek-v2-lite-16b --full --workload
    generate``: 27 B3 (at (192, 128)) and 27 × 4 MLA decode launches a
    batch, no B4 and no B5."""
    n = get_config(MLA_ARCH).num_layers
    return _serve_model(dev, "serve_mla", MLA_ARGS, _launch_counts(
        flash_attention=n, mla_decode=n * SERVE_GEN))


def phase_mla_consistency(dev) -> dict:
    """deepseek-v2-lite-16b in float32, its first 8 layers (the dense
    lead and 7 MoE layers; all 27 would be ≈ 63 GB), at capacity factor
    E / k: prefill(300) + 3 decode steps against forward(303)."""
    info = _consistency(dev, MLA_ARCH, 300, layers=8)
    emit("mla_consistency", **info)
    return info


def phase_serve_hybrid(dev) -> dict:
    """``launch.serve``'s run on jamba-v0.1-52b at full width, its first
    16 layers, bf16: 2 B3, 2 × 4 B4 and 14 B5 launches a batch."""
    cfg = hybrid_config()
    kinds = cfg.layer_kinds()
    n_attn = kinds.count("attn")
    return _serve_model(dev, "serve_hybrid", HYBRID_ARGS, _launch_counts(
        flash_attention=n_attn, decode_attention=n_attn * SERVE_GEN,
        ssd_scan=kinds.count("ssm")), cfg=cfg)


def phase_hybrid_consistency(dev) -> dict:
    """jamba-v0.1-52b in float32, its first 8 layers (one period:
    attention at 4, MoE at 1, 3, 5, 7; ≈ 53 GB), at capacity factor
    E / k: prefill(300), which crosses the 256 chunk, + 3 decode steps
    against forward(303)."""
    info = _consistency(dev, HYBRID_ARCH, 300, layers=8)
    emit("hybrid_consistency", **info)
    return info


def phase_encdec_kernels(dev) -> dict:
    """B3 and B4 at the enc-dec and VLM paths' shapes against their
    plain versions, every case twice, bitwise: whisper's encoder (B3
    unmasked at S 1,500, 16 heads of 64, float32 as the engine runs it;
    batch 32 and 1 timed against SDPA), its cross-attention prefill (B3
    with 32 queries over 1,500 keys, batch 32 and 1 timed, and a ragged
    7 over 1,499) and decode (B4 over the 1,500-row cross cache at
    lengths 1,499, so every key; batch 32 and 1 timed against SDPA with
    no mask; batch 1 splits the cache), InternVL2's prefill (B3 causal
    at S 256 + 32 = 288, 14 query heads over 2 kv heads) and decode (B4
    at group 7 over its 293-slot cache, batch 32 timed, ragged lengths
    -1…S+5); bf16 where the path runs bf16, float32 where the
    consistency runs do; and B3's refusal of ``causal`` with a key
    length of its own."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    audio, vlm = get_config(AUDIO_ARCH), get_config(VLM_ARCH)
    h, hd, n_ctx = audio.num_heads, audio.head_dim, audio.encoder.n_ctx
    vh, vkv, vhd = vlm.num_heads, vlm.num_kv_heads, vlm.head_dim
    front = vlm.encoder.n_ctx + SERVE_PROMPT
    vcache = front + SERVE_GEN + 1
    full = [n_ctx - 1]
    out = {
        "audio_encoder": _check_flash(dev, f32, 32, n_ctx, h, h, hd,
                                      causal=False, seed=300, timed=True),
        "audio_encoder_batch1": _check_flash(dev, f32, 1, n_ctx, h, h, hd,
                                             causal=False, seed=301,
                                             timed=True),
        "audio_cross": _check_flash(dev, f32, 32, SERVE_PROMPT, h, h, hd,
                                    causal=False, sk=n_ctx, seed=302,
                                    timed=True),
        "audio_cross_batch1": _check_flash(dev, f32, 1, SERVE_PROMPT, h, h,
                                           hd, causal=False, sk=n_ctx,
                                           seed=303, timed=True),
        "audio_cross_batch2": _check_flash(dev, f32, 2, SERVE_PROMPT, h, h,
                                           hd, causal=False, sk=n_ctx,
                                           seed=317, timed=True),
        "audio_cross_batch4": _check_flash(dev, f32, 4, SERVE_PROMPT, h, h,
                                           hd, causal=False, sk=n_ctx,
                                           seed=318, timed=True),
        "audio_cross_decode": _check_decode(dev, f32, 32, n_ctx, h, h, hd,
                                            full * 32, seed=304, timed=True,
                                            unmasked=True),
        "audio_cross_decode_batch1": _check_decode(
            dev, f32, 1, n_ctx, h, h, hd, full, seed=305, timed=True,
            unmasked=True),
        "vlm_prefill": _check_flash(dev, bf16, 32, front, vh, vkv, vhd,
                                    seed=306, timed=True),
        "vlm_prefill_batch1": _check_flash(dev, bf16, 1, front, vh, vkv, vhd,
                                           seed=307, timed=True),
        "vlm_decode": _check_decode(dev, bf16, 32, vcache, vh, vkv, vhd,
                                    [front + SERVE_GEN - 1] * 32, seed=308,
                                    timed=True)}
    cases = list(out.values())
    # the split cross prefill (under one wave of query blocks the keys
    # are cut into pieces and merged), also asked for lse
    for b in (1, 2, 4):
        cases.append(_check_flash_lse(dev, f32, b, SERVE_PROMPT, h, h, hd,
                                      causal=False, sk=n_ctx, seed=320 + b))
        check(cases[-1]["splits"] > 1, f"the cross prefill at B {b} "
              f"splits its keys: {cases[-1]}")
    for dt in (bf16, f32):
        cases.append(_check_flash(dev, dt, 2, 7, h, h, hd, causal=False,
                                  sk=n_ctx - 1, seed=310))
        cases.append(_check_flash(dev, dt, 2, n_ctx, h, h, hd, causal=False,
                                  seed=311))
        cases.append(_check_decode(dev, dt, 3, n_ctx, h, h, hd, full * 3,
                                   seed=312))
        cases.append(_check_decode(dev, dt, 8, vcache, vh, vkv, vhd,
                                   [-1, 0, 1, 255, front, vcache - 1, vcache,
                                    vcache + 5], seed=313))
    # the float32 consistency runs' shapes: whisper's cross prefill and
    # InternVL2's forward over 256 + 303 positions
    cases.append(_check_flash(dev, f32, 2, 300, h, h, hd, causal=False,
                              sk=n_ctx, seed=314))
    cases.append(_check_flash(dev, f32, 2, vlm.encoder.n_ctx + 303, vh, vkv,
                              vhd, seed=315))
    q, k, v = _attn_inputs(dev, bf16, 1, 8, h, h, hd, 316, sk=16)
    try:
        flash_attention(q, k, v, causal=True)
        refused = False
    except ValueError:
        refused = True
    check(refused, "flash_attention refuses causal with S_k != S")
    emit("encdec_kernels", archs=[AUDIO_ARCH, VLM_ARCH], cases=cases,
         worst=_worst(cases),
         decode_splits={k: out[k]["splits"] for k in out
                        if "decode" in k})
    return out


def _encoder_share(eng, b: int, samples: int = 3) -> dict:
    """Whisper's encoder in a batch of ``b``: the median host-clock
    time of ``transformer.encode`` (synchronised on both sides) inside
    ``samples`` runs of the batch, and its share of the median batch."""
    encode = transformer.encode
    spent = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    transformer.encode = timed
    try:
        walls = [eng.run_batch(b) for _ in range(samples)]
    finally:
        transformer.encode = encode
    wall, enc = float(np.median(walls)), float(np.median(spent))
    return dict(batch=b, batch_ms=wall * 1e3, encoder_ms=enc * 1e3,
                encoder_share=enc / wall)


def phase_serve_audio(dev) -> dict:
    """``launch.serve --arch whisper-medium --full --workload generate``:
    72 B3 (24 encoder, 24 self, 24 cross) and 192 B4 (24 × 4 self, 24 ×
    4 cross) launches a batch, no B5, MLA decode or int8 B4; the
    encoder's share of a batch at b 1 and 32."""
    cfg = get_config(AUDIO_ARCH)
    n, e = cfg.num_layers, cfg.encoder.num_layers
    return _serve_model(
        dev, "serve_audio", AUDIO_ARGS,
        _launch_counts(flash_attention=e + 2 * n,
                       decode_attention=2 * n * SERVE_GEN),
        extra=lambda eng: {"encoder": [_encoder_share(eng, b)
                                       for b in (1, eng.max_batch)]})


def phase_serve_vlm(dev) -> dict:
    """``launch.serve --arch internvl2-1b --full --workload generate``:
    the 256 patch rows in front of the 32-token prompt, decoding from
    position 288 over a 293-slot cache: 24 B3 and 24 × 4 B4 a batch."""
    n = get_config(VLM_ARCH).num_layers
    return _serve_model(dev, "serve_vlm", VLM_ARGS, _launch_counts(
        flash_attention=n, decode_attention=n * SERVE_GEN))


def _frames(cfg, rng) -> tuple:
    """Whisper's encoder input: standard normal frames."""
    return {"frames": rng.standard_normal(
        (2, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)}, 0


def _patches(cfg, rng) -> tuple:
    """InternVL2's patch embeddings at the token table's init scale, in
    front of the prompt."""
    n = cfg.encoder.n_ctx
    return {"patch_embeds": 0.02 * rng.standard_normal(
        (2, n, cfg.d_model)).astype(np.float32)}, n


def phase_audio_consistency(dev) -> dict:
    """whisper-medium whole in float32 with frames: prefill(300) + 3
    decode steps against forward(303)."""
    info = _consistency(dev, AUDIO_ARCH, 300, inputs=_frames)
    emit("audio_consistency", **info)
    return info


def phase_vlm_consistency(dev) -> dict:
    """internvl2-1b whole in float32 with its 256 patch rows in front:
    prefill(300) + 3 decode steps from position 556 against
    forward(303)."""
    info = _consistency(dev, VLM_ARCH, 300, inputs=_patches)
    emit("vlm_consistency", **info)
    return info


def _admitted(s: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head's mask admits."""
    pq = torch.arange(s)[:, None]
    pk = torch.arange(sk)[None, :]
    adm = torch.ones(s, sk, dtype=torch.bool)
    if causal:
        adm &= pk <= pq
    if window:
        adm &= pq - pk < window
    return int(adm.sum())


def _sdpa_mask(dev, s, sk, causal, window):
    """SDPA's arguments for B3's mask: ``is_causal`` alone, or a boolean
    mask for a window, or nothing when every key is admitted."""
    if window:
        pq = torch.arange(s, device=dev)[:, None]
        pk = torch.arange(sk, device=dev)[None, :]
        adm = pq - pk < window
        if causal:
            adm &= pk <= pq
        return {"attn_mask": adm}
    return {"is_causal": causal}


def _check_flash_backward(dev, dtype, b, s, h, kv, hd, *, causal=True,
                          window=0, seed=0, timed=False, hdv=None,
                          sk=None) -> dict:
    """B3's backward on the forward kernel's own ``out`` and ``lse``:
    against its plain version and autograd of the plain forward, dq, dk
    and dv apart, launched twice and held bitwise; ``timed``: kernel,
    plain, SDPA forward + backward, SDPA backward alone and bound
    times."""
    q, k, v = _attn_inputs(dev, dtype, b, s, h, kv, hd, seed, hdv=hdv,
                           sk=sk)
    sk, hdv = k.shape[1], v.shape[3]
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    do = torch.randn(b, s, h, hdv, device=dev, generator=gen).to(dtype)
    mode = dict(causal=causal, window=window)
    out, lse = flash_attention_with_lse(q, k, v, **mode)
    got = flash_attention_backward(q, k, v, out, lse, do, **mode)
    again = flash_attention_backward(q, k, v, out, lse, do, **mode)
    want = flash_attention_backward_plain(q, k, v, out, lse, do, **mode)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention_plain(*leaves, **mode).backward(do)
    torch.cuda.synchronize()
    case = dict(kernel="flash_attention_backward", dtype=str(dtype),
                batch=b, seq=s, heads=h, kv_heads=kv, head_dim=hd,
                value_dim=hdv, causal=causal, window=window)
    if sk != s:
        case["key_seq"] = sk
    worst = 0.0
    for name, x, y, w, leaf in zip(("dq", "dk", "dv"), got, again, want,
                                   leaves):
        scale = max(float(w.float().abs().max()), 1e-6)
        err = float((x.float() - w.float()).abs().max())
        auto = float((x.float() - leaf.grad.float()).abs().max())
        case.update({f"{name}_max_abs_err": err, f"{name}_scale": scale,
                     f"{name}_vs_autograd": auto})
        worst = max(worst, err / (BWD_TOL[dtype] * scale))
        check(bool(torch.isfinite(x).all()) and x.dtype == dtype
              and err <= BWD_TOL[dtype] * scale
              and auto <= BWD_AUTOGRAD_TOL[dtype] * scale,
              f"flash_attention_backward {name} vs plain: {case}")
        check(torch.equal(x, y),
              f"flash_attention_backward repeats bitwise: {case}")
    case["max_abs_err"] = max(case[f"{n}_max_abs_err"]
                              for n in ("dq", "dk", "dv"))
    case["worst_over_tol"] = worst
    if timed:
        pairs = b * h * _admitted(s, sk, causal, window)
        elt = torch.finfo(dtype).bits // 8
        nbytes = (elt * (2 * (q.numel() + k.numel() + v.numel())
                         + 2 * out.numel()) + 4 * lse.numel())
        flops = 2.5 * 4 * (hd + hdv) / 2 * pairs
        case.update(_bound(nbytes, flops, dtype, FLASH_PEAK_FLOPS))
        case["kernel_ms"] = time_ms(
            lambda: flash_attention_backward(q, k, v, out, lse, do, **mode))
        case["plain_ms"] = time_ms(
            lambda: flash_attention_backward_plain(q, k, v, out, lse, do,
                                                   **mode), reps=3, warm=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        extra = _sdpa_mask(dev, s, sk, causal, window)
        if h != kv:
            extra["enable_gqa"] = True

        def library():
            o = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, **extra)
            torch.autograd.grad(o, (qt, kt, vt), dot)

        case["library_ms"] = time_ms(library)
        case["library_note"] = (
            "scaled_dot_product_attention forward + backward ("
            + ", ".join(sorted(k for k in extra)) + ") on (B, H, S, hd) "
            "copies made beforehand")
        # SDPA's backward alone, on the saved state of one forward
        o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                             **extra)
        case["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True))
        case["library_bwd_note"] = (
            "scaled_dot_product_attention's backward alone: "
            "autograd.grad of one forward's output, its graph retained")
        del o
    return case


def phase_attn_backward(dev) -> dict:
    """B3's backward kernels against their plain version at the training
    path's shapes and every mode the forward takes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(TRAIN_ARCH)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"train": _check_flash_backward(dev, bf16, TRAIN_B, TRAIN_S, h, kv,
                                          hd, seed=70, timed=True),
           "long": _check_flash_backward(dev, bf16, 1, 4096, h, kv, hd,
                                         seed=71, timed=True),
           "batch1": _check_flash_backward(dev, bf16, 1, TRAIN_S, h, kv, hd,
                                           seed=72, timed=True),
           "f32": _check_flash_backward(dev, f32, TRAIN_B, TRAIN_S, h, kv, hd,
                                        seed=73, timed=True)}
    moe = get_config(MOE_ARCH)
    timed = dict(timed=True)
    cases = list(out.values()) + [
        _check_flash_backward(dev, bf16, 2, 300, 32, 8, 128, window=64,
                              seed=74, **timed),
        _check_flash_backward(dev, bf16, 2, TRAIN_S, moe.num_heads,
                              moe.num_kv_heads, moe.head_dim, seed=75,
                              **timed),
        _check_flash_backward(dev, bf16, 2, 300, 16, 16, 192, hdv=128,
                              seed=76, **timed),
        _check_flash_backward(dev, f32, 2, 300, 16, 16, 192, hdv=128,
                              seed=77, **timed),
        _check_flash_backward(dev, f32, 2, 300, 32, 8, 128, window=64,
                              seed=82, **timed),
        _check_flash_backward(dev, f32, 2, 32, h, kv, hd, causal=False,
                              sk=1500, seed=78, **timed),
        _check_flash_backward(dev, bf16, 2, 500, h, kv, hd, seed=79,
                              **timed),
        _check_flash_backward(dev, f32, 1, 1023, 6, 2, 32, seed=80,
                              **timed)]
    # the forward the training step runs: B3 with lse, at its shape
    fwd = _check_flash(dev, bf16, TRAIN_B, TRAIN_S, h, kv, hd, seed=81,
                       timed=True)
    q, k, v = _attn_inputs(dev, bf16, TRAIN_B, TRAIN_S, h, kv, hd, 81)
    fwd["lse_ms"] = time_ms(lambda: flash_attention_with_lse(q, k, v))
    out["forward"] = fwd
    emit("attn_backward", cases=cases, forward=fwd,
         worst_over_tol=max(c["worst_over_tol"] for c in cases))
    return out


def _check_train_run(name: str, res: dict, want: dict, launches: dict,
                     total: int, falling: bool = True) -> None:
    """A train run's gates: exactly ``want`` launches, finite losses
    (the last under the first when ``falling``), finite positive grad
    norms, the peak under the card's ``total`` bytes."""
    check(launches == want, f"{name}: {res['steps']} steps launched "
          f"{launches}, expected {want}")
    losses, norms = res["losses"], res["grad_norms"]
    check(bool(np.all(np.isfinite(losses)))
          and (not falling or losses[-1] < losses[0]),
          f"{name}: finite losses{' that fall' if falling else ''}: "
          f"{losses}")
    check(bool(np.all(np.isfinite(norms))) and min(norms) > 0,
          f"{name}: finite positive grad norms: {norms}")
    check(res["peak_bytes"] < total, f"{name}: peak {res['peak_bytes']} "
          f"bytes under the card's {total}")


def _train_model(dev, name: str, argv, per_step: dict, cfg=None,
                 remat_per_step=None, falling: bool = True) -> dict:
    """``launch.train``'s ``run`` of ``argv`` as a user runs it (on
    ``cfg`` in place of ``--arch``'s config where one is given: a depth
    cut), with ``_check_train_run``'s gates and exactly ``per_step``
    launches of each kernel a step; then, where ``remat_per_step`` is
    given, one ``--remat`` step with those launches and the same first
    loss (rel 1e-6)."""
    args = train_cli.parse_args(argv)
    total = torch.cuda.get_device_properties(dev).total_memory
    _reset_serve_launches()
    t0 = time.perf_counter()
    res = train_cli.run(args, cfg=cfg, device=dev, log=False)
    seconds = time.perf_counter() - t0
    launches = _serve_launches()
    want = {k: n * args.steps for k, n in per_step.items()}
    _check_train_run(name, res, want, launches, total, falling)
    step_ms = float(np.median(res["step_ms"][1:]))
    info = dict(arch=res["arch"], layers=res["layers"], dtype=res["dtype"],
                args=argv, seconds=seconds, losses=res["losses"],
                grad_norms=res["grad_norms"], step_ms=res["step_ms"],
                step_ms_warm_median=step_ms,
                tokens_per_s=res["tokens_per_step"] / (step_ms / 1e3),
                peak_bytes=res["peak_bytes"], device_mem_bytes=total,
                launches=launches,
                launches_per_step={k: v // args.steps
                                   for k, v in launches.items()})
    if remat_per_step is not None:
        _reset_serve_launches()
        i = argv.index("--steps")
        rargs = train_cli.parse_args(argv[:i] + ["--steps", "1"]
                                     + argv[i + 2:] + ["--remat"])
        remat = train_cli.run(rargs, cfg=cfg, device=dev, log=False)
        rlaunch = _serve_launches()
        check(rlaunch == remat_per_step, f"{name} --remat: one step "
              f"launched {rlaunch}, expected {remat_per_step}")
        diff = abs(remat["losses"][0] - res["losses"][0])
        check(diff <= 1e-6 * abs(res["losses"][0]), f"{name} --remat: "
              f"first loss {remat['losses'][0]} against {res['losses'][0]}")
        info.update(remat_launches=rlaunch, remat_first_loss_diff=diff,
                    remat_step_ms=remat["step_ms"][0],
                    remat_peak_bytes=remat["peak_bytes"])
    emit(name, **info)
    torch.cuda.empty_cache()
    return info


def phase_train(dev) -> dict:
    """``launch.train`` on qwen1.5-0.5b at full width as a user runs it:
    24 B3 forward and backward calls a step, the loss falling; then one
    step with ``--remat``: 48 forward calls, the same first loss."""
    n = get_config(TRAIN_ARCH).num_layers
    return _train_model(
        dev, "train", TRAIN_ARGS,
        _launch_counts(flash_attention=n, flash_attention_backward=n),
        remat_per_step=_launch_counts(flash_attention=2 * n,
                                      flash_attention_backward=n))


def _plain_attention(q, k, v, *, causal=True, window=0):
    """B3's plain version, which autograd differentiates as it is."""
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def _plain_ssd(x, dt, A, B, C, chunk):
    """B5's plain version, which autograd differentiates as it is."""
    return ssd_scan_plain(x, dt, A, B, C, chunk)


def _zero_moments(model) -> train_opt.AdamWState:
    """``init_state``'s zero moments as stride-0 views of one zero: the
    same first AdamW step (β·0 + (1 − β)·g is (1 − β)·g bit for bit)
    without 8 bytes a parameter that AdamW, which builds its new moments
    beside the old, would otherwise hold twice."""
    zero = torch.zeros((), dtype=torch.float32, device=model.embed.device)
    moments = {n: zero.expand(p.shape) for n, p in model.named_parameters()}
    return train_opt.AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=zero.device),
        mu=moments, nu=dict(moments))


def _step_consistency(dev, name: str, cfg, swap, want_kernel: dict,
                      want_plain: dict) -> dict:
    """One train step of ``cfg`` (float32, batch 2 × ``TRAIN_S``, TF32
    off) through the kernels against the same step with ``swap = (module,
    attribute, plain)`` in place, the plain version that autograd
    differentiates on the card: the loss at rel 1e-6; every gradient at
    max|Δg| <= 1e-4 · max|g| + 1e-6; the parameters after AdamW at the
    same bound where the gradient is resolved (|g| >= 1e-6), and every
    parameter within twice the step's learning rate; exactly
    ``want_kernel`` and ``want_plain`` launches.  The kernel run's
    gradients and parameters wait on the host while the plain run takes
    the card (Jamba's 2.7 B float32 parameters: 21.6 GB of them), and
    the optimizer starts from ``_zero_moments``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = next(SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_S, global_batch=2,
        seed=5)).batches())
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
             for k, v in batch.items()}
    # launch.train's optimizer at its 20 steps (warm-up 2)
    o = train_opt.AdamWConfig(total_steps=20, warmup_steps=2)
    lr = float(train_opt.schedule(o, torch.tensor(0)))
    real = train_loop.apply_updates
    module, attr, plain = swap
    kernel = getattr(module, attr)
    runs = {}
    for label in ("kernel", "plain"):
        model = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(5))
        grads = {}

        home = "cpu" if label == "kernel" else dev

        def captured(c, params, g, state, decay):
            grads.update({n: t.detach().to(home, copy=True)
                          for n, t in g.items()})
            return real(c, params, g, state, decay)

        train_loop.apply_updates = captured
        if label == "plain":
            setattr(module, attr, plain)
        try:
            _reset_serve_launches()
            model, _, m = train_loop.make_train_step(cfg, o)(
                model, _zero_moments(model), batch)
            torch.cuda.synchronize()
            launches = _serve_launches()
        finally:
            train_loop.apply_updates = real
            setattr(module, attr, kernel)
        runs[label] = (float(m["loss"]), grads,
                       {n: p.detach().to(home)
                        for n, p in model.named_parameters()}, launches)
        del model, m
        torch.cuda.empty_cache()
    (lk, gk, pk, nk), (lp, gp, pp, np_) = runs["kernel"], runs["plain"]
    check(nk == want_kernel and np_ == want_plain,
          f"{name}: launches {nk} (kernels), {np_} (plain)")
    loss_worst = abs(lk - lp) / (1e-6 * abs(lp))
    grad_worst = param_worst = 0.0
    worst_grad = ""
    unresolved = far = 0
    for n, g in gp.items():
        tol = 1e-4 * float(g.abs().max()) + 1e-6
        w = float((gk[n].to(dev) - g).abs().max()) / tol
        if w > grad_worst:
            grad_worst, worst_grad = w, n
        diff = (pk[n].to(dev) - pp[n]).abs()
        firm = g.abs() >= 1e-6
        unresolved += int((~firm).sum())
        if firm.any():
            ptol = 1e-4 * float(pp[n].abs().max()) + 1e-6
            param_worst = max(param_worst, float(diff[firm].max()) / ptol)
        far = max(far, float(diff.max()) / (2 * lr))
    info = dict(arch=cfg.name, dtype="float32", layers=cfg.num_layers,
                batch=2, seq=TRAIN_S, loss_kernel=lk, loss_plain=lp,
                loss_worst_over_tol=loss_worst,
                grad_worst_over_tol=grad_worst, worst_grad=worst_grad,
                param_worst_over_tol=param_worst,
                unresolved_elements=unresolved,
                unresolved_worst_over_2lr=far, lr=lr,
                tolerance="loss rel 1e-6; grads and resolved params "
                          "max|diff| <= 1e-4*max|x| + 1e-6; all params "
                          "within 2 lr",
                launches_kernel=nk)
    check(loss_worst <= 1.0 and grad_worst <= 1.0 and param_worst <= 1.0
          and far <= 1.0, f"{name}: {info}")
    del runs, gk, gp, pk, pp
    torch.cuda.empty_cache()
    return info


def phase_train_consistency(dev) -> dict:
    """One train step of qwen1.5-0.5b whole in float32 through B3's
    kernels against the same step with B3 replaced by its plain version
    (autograd through it) on the card."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    n = cfg.num_layers
    info = _step_consistency(
        dev, "train_consistency", cfg,
        (attn_module, "flash_attention", _plain_attention),
        _launch_counts(flash_attention=n, flash_attention_backward=n),
        _launch_counts())
    emit("train_consistency", **info)
    return info


# ---------------------------------------------------------------------------
# SSM and hybrid training: B5's backward
# ---------------------------------------------------------------------------

def _check_ssd_backward(dev, dtype, b, s, *, g=1, seed=0, timed=False,
                        with_dh=False, model=None, heads=None) -> dict:
    """B5's backward against its plain version at ``model``'s SSM widths
    (default mamba2-2.7b's; ``heads`` to cut the head count), each
    gradient apart against its own tolerance: 1e-4 of its largest
    magnitude in float32, 2^-7 where it is returned in bf16 (both
    compute in float32; a bf16 gradient is rounded once); twice,
    bitwise; ``timed``: kernel, plain and bound times."""
    model = model or get_config(SSM_ARCH)
    cfg = model.ssm
    nh = heads or cfg.n_heads(model.d_model)
    hd, ds = cfg.head_dim, cfg.d_state
    x, dt, a, bm, cm = _ssd_inputs(dev, dtype, b, s, nh, g, hd, ds, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    dy = torch.randn(b, s, nh, hd, device=dev, generator=gen)
    dh = (torch.randn(b, nh, hd, ds, device=dev, generator=gen)
          if with_dh else None)
    args = (x, dt, a, bm, cm, dy, dh, cfg.chunk_size)
    got = ssd_scan_backward(*args)
    again = ssd_scan_backward(*args)
    want = ssd_scan_backward_plain(*args)
    torch.cuda.synchronize()
    grads = {}
    for name, k, k2, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, again,
                              want):
        tol = (2.0 ** -7 if k.dtype == torch.bfloat16 else 1e-4) * max(
            float(w.float().abs().max()), 1e-30)
        err = float((k.float() - w.float()).abs().max())
        grads[name] = dict(dtype=str(k.dtype), max_abs_err=err,
                           max_abs=float(w.float().abs().max()),
                           worst_over_tol=err / tol)
        check(bool(torch.isfinite(k).all()) and k.shape == w.shape
              and err <= tol, f"ssd_scan_backward {name} vs plain at "
              f"{dtype} {b}x{s}: {grads[name]}")
        check(torch.equal(k, k2), f"ssd_scan_backward {name} repeats "
              f"bitwise at {dtype} {b}x{s}")
    case = dict(kernel="ssd_scan_backward", dtype=str(dtype), batch=b,
                seq=s, heads=nh, groups=g, head_dim=hd, d_state=ds,
                dh_end=with_dh, grads=grads,
                max_abs_err=max(v["max_abs_err"] for v in grads.values()),
                worst_over_tol=max(v["worst_over_tol"]
                                   for v in grads.values()))
    if timed:
        elt = torch.finfo(dtype).bits // 8
        # x, B, C in and dx, dB, dC out in the inputs' type; dt, dy in
        # and ddt out in float32 (dA and A are nh floats)
        bytes_moved = (2 * elt * (x.numel() + bm.numel() + cm.numel())
                       + 4 * (2 * dt.numel() + dy.numel() + 2 * nh))
        # the recurrence's backward: dh B, xᵀ dh, dyᵀ h and dy ⊗ C, two
        # flops a multiply-add, a step and head
        flops = 8 * b * s * nh * hd * ds
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        # both routes run on the tensor cores (float32 as 3xTF32)
        t_ops = flops / FLASH_PEAK_FLOPS[dtype] * 1e3
        case.update(bytes=bytes_moved, flops=flops,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        if dtype == torch.float32:
            case["bound_ms_cuda_cores"] = max(
                t_bytes, flops / PEAK_FLOPS[dtype] * 1e3)
        case["kernel_ms"] = time_ms(lambda: ssd_scan_backward(*args))
        case["plain_ms"] = time_ms(lambda: ssd_scan_backward_plain(*args),
                                   reps=3, warm=1)
        case["library_ms"] = None
        case["library_note"] = ("no single PyTorch call computes the SSD "
                                "scan's gradients")
    del x, dt, a, bm, cm, dy, dh, got, again, want
    torch.cuda.empty_cache()
    return case


def phase_ssd_backward(dev) -> dict:
    """B5's backward kernels against their plain version at mamba2-2.7b's
    training shape (B 2 × 512) in bf16 and float32, at B 1 × 4,096 and at
    Jamba's (64, 16) (all timed), on a ragged grouped (32, 16) case and
    with a non-zero gradient of the final state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"train": _check_ssd_backward(dev, bf16, 2, 512, seed=90,
                                        timed=True),
           "f32": _check_ssd_backward(dev, f32, 2, 512, seed=91,
                                      timed=True),
           "long": _check_ssd_backward(dev, bf16, 1, 4096, seed=92,
                                       timed=True),
           "hybrid": _check_ssd_backward(dev, bf16, 2, 512, seed=93,
                                         timed=True,
                                         model=get_config(HYBRID_ARCH))}
    cases = list(out.values()) + [
        _check_ssd_backward(dev, bf16, 1, 1023, g=2, seed=94, heads=8,
                            model=reduce_config(get_config(SSM_ARCH))),
        _check_ssd_backward(dev, f32, 2, 300, seed=95, with_dh=True),
        _check_ssd_backward(dev, bf16, 2, 300, seed=96, with_dh=True,
                            model=get_config(HYBRID_ARCH))]
    emit("ssd_backward", cases=cases,
         worst_over_tol=max(c["worst_over_tol"] for c in cases))
    return out
def phase_train_ssm(dev) -> dict:
    """``launch.train`` on mamba2-2.7b whole (64 layers, full width,
    bf16) as a user runs it: exactly 64 B5 forward and 64 B5 backward
    calls a step and no other kernel, the loss falling; then one
    ``--remat`` step: 128 forward calls, 64 backward, the same first
    loss."""
    n = get_config(SSM_ARCH).num_layers
    return _train_model(
        dev, "train_ssm", TRAIN_SSM_ARGS,
        _launch_counts(ssd_scan=n, ssd_scan_backward=n),
        remat_per_step=_launch_counts(ssd_scan=2 * n, ssd_scan_backward=n))


def hybrid_train_config(dtype: str = "bfloat16"):
    """Jamba at full width without its experts, one period of 8 layers:
    7 Mamba2 layers and the attention layer at offset 4."""
    return dataclasses.replace(get_config(HYBRID_ARCH), moe=None,
                               num_layers=HYBRID_TRAIN_LAYERS, dtype=dtype)


def phase_train_hybrid(dev) -> dict:
    """Jamba's interleave trained at full width through ``launch.train``'s
    ``run`` on ``hybrid_train_config()``: 7 B5 forward and backward calls
    and 1 B3 forward and backward call a step."""
    kinds = hybrid_train_config().layer_kinds()
    n_ssm, n_attn = kinds.count("ssm"), kinds.count("attn")
    check((n_ssm, n_attn) == (7, 1), f"train_hybrid: layer kinds {kinds}")
    return _train_model(
        dev, "train_hybrid", TRAIN_HYBRID_ARGS,
        _launch_counts(ssd_scan=n_ssm, ssd_scan_backward=n_ssm,
                       flash_attention=n_attn,
                       flash_attention_backward=n_attn),
        cfg=hybrid_train_config(), falling=False)


def phase_train_ssm_consistency(dev) -> dict:
    """One float32 train step through B5's kernels against the same step
    with ``ssd_chunked`` replaced by ``ssd_scan_plain`` (autograd through
    it) on the card: mamba2-2.7b at full width (its first 8 of 64
    layers), then ``train_hybrid``'s Jamba config (whose attention layer
    runs B3's kernels in both runs)."""
    swap = (mamba2_module, "ssd_chunked", _plain_ssd)
    cfg = dataclasses.replace(get_config(SSM_ARCH), dtype="float32",
                              num_layers=SSM_CONSISTENCY_LAYERS)
    n = cfg.num_layers
    ssm = _step_consistency(
        dev, "train_ssm_consistency", cfg, swap,
        _launch_counts(ssd_scan=n, ssd_scan_backward=n), _launch_counts())
    cfg = hybrid_train_config("float32")
    kinds = cfg.layer_kinds()
    attn = dict(flash_attention=kinds.count("attn"),
                flash_attention_backward=kinds.count("attn"))
    hybrid = _step_consistency(
        dev, "train_ssm_consistency", cfg, swap,
        _launch_counts(ssd_scan=kinds.count("ssm"),
                       ssd_scan_backward=kinds.count("ssm"), **attn),
        _launch_counts(**attn))
    info = dict(ssm=ssm, hybrid=hybrid,
                worst_over_tol=max(v for r in (ssm, hybrid)
                                   for k, v in r.items()
                                   if k.endswith("_worst_over_tol")))
    emit("train_ssm_consistency", **info)
    return info


def _attention_calls(cfg) -> int:
    """B3 calls of one forward: each attention layer's self-attention,
    and on an enc-dec model the encoder's layers and each decoder
    layer's cross-attention."""
    n = cfg.layer_kinds().count("attn")
    if cfg.family == "audio":
        n += cfg.encoder.num_layers + cfg.num_layers
    return n


def phase_train_families(dev, steps: int = 2, b: int = 2,
                         s: int = 256) -> dict:
    """Two train steps of each family ``train`` does not cover, at ``b``
    × ``s`` (bf16, seeded weights, the synthetic corpus through
    ``device_batch``: whisper's zero frames, as the reference trainer
    feeds them): exact B3 forward and backward counts from the config,
    finite losses and grad norms, the peak under the card's.  The MoE
    models are cut in depth so that bf16 weights and gradients and
    float32 moments (12 bytes a parameter) fit 80 GB; whisper-medium and
    internvl2-1b run whole.  InternVL2's patch rows are 0.02 · N(0, 1)
    from a seeded generator, as ``tests/test_torch_train.py`` draws
    them: on the reference trainer's zero rows every one of its 48
    RMSNorms multiplies those rows' gradient by rsqrt(1e-6) = 1,000,
    which overflows float32 and leaves NaN weight gradients, in the
    reference as in the port (ROADMAP C-R5).  Then whisper-medium whole
    through ``launch.train`` (``TRAIN_AUDIO_ARGS``), whose batches carry
    the zero frames (``launch_batch``; C-R6): 72 B3 forward and backward
    calls a step."""
    total = torch.cuda.get_device_properties(dev).total_memory
    out = {}
    for arch, layers in TRAIN_FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        n = _attention_calls(cfg)
        want = _launch_counts(flash_attention=n * steps,
                              flash_attention_backward=n * steps)
        torch.cuda.reset_peak_memory_stats(dev)
        model = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))
        state = train_opt.init_state(model)
        step = train_loop.make_train_step(cfg, train_opt.AdamWConfig(
            total_steps=steps, warmup_steps=1))
        data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=s, global_batch=b))
        _reset_serve_launches()
        losses, norms, step_ms = [], [], []
        gen = torch.Generator(device=dev).manual_seed(7)
        for _, batch in zip(range(steps), data.batches()):
            batch = train_loop.device_batch(cfg, batch, dev)
            if cfg.family == "vlm":
                batch["patch_embeds"] = 0.02 * torch.randn(
                    batch["patch_embeds"].shape, generator=gen, device=dev)
            t0 = time.perf_counter()
            model, state, m = step(model, state, batch)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(m["grad_norm"]))
        res = dict(steps=steps, losses=losses, grad_norms=norms,
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
        launches = _serve_launches()
        _check_train_run(f"train_families {arch}", res, want, launches,
                         total, falling=False)
        params = sum(p.numel() for p in model.parameters())
        out[arch] = dict(layers=cfg.num_layers,
                         of_layers=get_config(arch).num_layers,
                         params=params, batch=b, seq=s, losses=losses,
                         grad_norms=norms, step_ms=step_ms,
                         peak_bytes=res["peak_bytes"],
                         attention_calls_per_step=n, launches=launches,
                         aux=float(m["aux"]))
        del model, state, m
        torch.cuda.empty_cache()
    # whisper through the launcher as a user runs it: its batches carry
    # the reference trainer's zero frames (launch_batch)
    n = _attention_calls(get_config(AUDIO_ARCH))
    launcher = _train_model(
        dev, "train_families launch.train whisper", TRAIN_AUDIO_ARGS,
        _launch_counts(flash_attention=n, flash_attention_backward=n),
        falling=False)
    out["whisper_launcher"] = launcher
    emit("train_families", device_mem_bytes=total, runs=out)
    return out


def _kernel_row(name: str, path: str, launches: int, k: dict,
                **extra) -> dict:
    source, replaces, tpu_ref = KERNELS[name]
    return {"name": name, "path": path, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_ref": tpu_ref, "impl": "cuda",
            "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k.get("bound_by", "bytes"),
            "library_ms": k["library_ms"],
            "matches_plain": True, **extra}


def _path_keys(k: dict) -> dict:
    """A path block's numbers for the ``kernels`` line."""
    keys = {"path_ms": k["kernel_ms"], "path_plain_ms": k["plain_ms"],
            "path_bound_ms": k["bound_ms"],
            "path_library_ms": k["library_ms"]}
    if "bound_ms_bytes4" in k:
        keys["path_bound_ms_bytes4"] = k["bound_ms_bytes4"]
    return keys


def path_hist(dev, captured, block: str) -> dict:
    """hist_update on a path block from ``capture_blocks``."""
    args, kw = captured
    return hist_report(dev, *args, n_bins=kw["n_bins"],
                       sketch=kw.get("sketch", False), block=block,
                       emit_as="path_kernel")


# the continuous points of gen_user_size held against the exact numpy
# loop: (ρ, generated tokens, max_active)
GEN_CONT_POINTS = ((GEN_RHOS[7], 32, 64), (GEN_RHOS[13], 8, 16))
# the host mirrors' seed ladders the contracts phases gate on: kind →
# configs (three seeds each); they run in worker processes beside the
# card's phases (numpy loops, no device), started after the build
HOST_LADDERS = {"gen_continuous": len(GEN_CONT_POINTS),
                "loss_sweep": len(SW_CFG), "loss_gen": len(GEN_CFG),
                "fail_sweep": len(FAIL_SW_CFG), "fail_gen": len(FAIL_GEN_CFG),
                "fleet_jsq": 1, "fleet_loss": len(FLEET_BP_CFG),
                "fleet_fail": len(FLEET_FAIL_CFG)}
_LADDERS: dict = {}
_POOLS: list = []


def mirror_ladder(kind: str, ci: int) -> list:
    """The three seeds of the host mirror behind config ``ci`` of
    ``kind``'s seed ladder, as the phase that gates on them used to
    compute them inline."""
    m = GEN_MODEL
    if kind == "gen_continuous":
        rho, gen, cap = GEN_CONT_POINTS[ci]
        lam = float(gen_grid().lam[gen_index(rho, gen, cap, "continuous")])
        return [simulate_continuous_numpy(
            lam, m, prompt_len=GEN_PROMPT, gen_tokens=gen, max_active=cap,
            n_jobs=60_000, seed=s).mean_latency for s in range(3)]
    if kind == "loss_sweep":
        qm, dl, ov, rate, lam = SW_CFG[ci]
        return [simulate_loss_numpy(lam, MODEL_BP, 8, q_max=qm, deadline=dl,
                                    overflow=ov, retry_rate=rate, q_cap=64,
                                    r_cap=64, n_batches=20_000, seed=s)
                for s in range(3)]
    if kind == "loss_gen":
        disc, ov, qm, dl, rate = GEN_CFG[ci]
        return [simulate_gen_loss_numpy(
            GEN_BP_LAM, m, prompt_len=GEN_PROMPT, gen_tokens=32,
            max_active=64, discipline=disc, q_max=qm, deadline=dl,
            overflow=ov, retry_rate=rate, q_cap=64, r_cap=64,
            n_steps=20_000, seed=s) for s in range(3)]
    if kind == "fail_sweep":
        disc, mtbf, mttr, thr, lam = FAIL_SW_CFG[ci]
        return [simulate_loss_numpy(lam, MODEL_BP, 8, mtbf=mtbf, mttr=mttr,
                                    fail_disc=disc, throttle=thr, q_cap=64,
                                    r_cap=64, n_batches=15_000, seed=s)
                for s in range(3)]
    if kind == "fail_gen":
        disc, mtbf, mttr = FAIL_GEN_CFG[ci]
        return [simulate_gen_loss_numpy(
            FAIL_GEN_LAM, m, prompt_len=GEN_PROMPT, gen_tokens=32,
            max_active=64, mtbf=mtbf, mttr=mttr, fail_disc=disc, q_cap=96,
            r_cap=64, n_steps=20_000, seed=s) for s in range(3)]
    if kind == "fleet_jsq":
        return [simulate_jsq_numpy(4 * FLEET_LAM1, LinearServiceModel(*V100),
                                   4, n_jobs=40_000, seed=sd)
                for sd in range(3)]
    if kind == "fleet_loss":
        route, ov, qm, dl, rr = FLEET_BP_CFG[ci]
        lb, kb, bb = FLEET_BP
        return [simulate_fleet_loss_numpy(
            lb, MODEL_BP, bb, k=kb, routing=route, q_max=qm, deadline=dl,
            overflow=ov, retry_rate=rr, q_cap=64, r_cap=64,
            n_events=25_000, seed=sd) for sd in range(3)]
    if kind == "fleet_fail":
        disc, route = FLEET_FAIL_CFG[ci]
        lf, kf, bf, mtbf, mttr = FLEET_FAIL
        return [simulate_fleet_loss_numpy(
            lf, MODEL_BP, bf, k=kf, routing=route, mtbf=mtbf, mttr=mttr,
            fail_disc=disc, q_cap=64, r_cap=64, n_events=25_000, seed=sd)
            for sd in range(3)]
    raise KeyError(kind)


def start_host_ladders(workers: int = 3) -> None:
    """Every ``HOST_LADDERS`` task on a pool of ``workers`` spawned
    processes (the card's context is not forked), in the order the
    phases read them."""
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    _POOLS.append(pool)
    for kind, n in HOST_LADDERS.items():
        for ci in range(n):
            _LADDERS[kind, ci] = pool.submit(mirror_ladder, kind, ci)


def host_ladder(kind: str, ci: int) -> list:
    """``mirror_ladder(kind, ci)``'s result from the pool."""
    return _LADDERS[kind, ci].result()


def start_dryruns():
    """``launch.dryrun``'s ``main`` for each of ``DRYRUNS`` in turn, in
    one process with the GPU hidden from it, each combo's records
    appended to a file of its own; returns the process and the (combo,
    file) list."""
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    runs = [((arch, shape), out / f"{arch}_{shape}.jsonl")
            for arch, shape in DRYRUNS]
    argvs = [["--arch", arch, "--shape", shape, "--mesh", "both", "--out",
              str(path)] for (arch, shape), path in runs]
    proc = subprocess.Popen(
        [sys.executable, "-c", "import json, sys; from repro_torch.launch "
         "import dryrun; [dryrun.main(a) for a in json.loads(sys.argv[1])]",
         json.dumps(argvs)], env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(proc)
    return proc, runs


def phase_dryrun(dry, timeout: float = 900.0) -> dict:
    """Wait for ``start_dryruns``' process and gate its records."""
    proc, runs = dry
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"dryrun: past {timeout} s")
    check(proc.returncode == 0, f"dryrun: exit {proc.returncode}: "
          f"{err[-2000:]}")
    records = []
    for (arch, shape), path in runs:
        got = [json.loads(line) for line in path.read_text().splitlines()]
        check([r["mesh"] for r in got] == ["16x16", "2x16x16"],
              f"dryrun {arch} {shape}: records {[r['mesh'] for r in got]}")
        for rec in got:
            check(rec["ok"], f"dryrun {arch} {shape} {rec['mesh']}: "
                  f"{rec.get('error')}\n{rec.get('traceback', '')}")
            if shape == "decode_32k":
                mem = rec["memory"]
                ranks = 256 if rec["mesh"] == "16x16" else 512
                check(mem["cache_size_in_bytes"] * ranks
                      == mem["cache_total_bytes"],
                      f"dryrun {arch} {shape} {rec['mesh']}: cache "
                      f"{mem['cache_size_in_bytes']} bytes a device of "
                      f"{mem['cache_total_bytes']}")
            emit("dryrun", **rec)
            records.append(rec)
    return {"records": len(records)}


def _train_launch_counts(cfg) -> dict:
    """One train step's launches: B3 forward and backward on each
    attention call, B5 forward and backward on each Mamba2 layer."""
    n_attn = _attention_calls(cfg)
    n_ssm = cfg.layer_kinds().count("ssm")
    return _launch_counts(flash_attention=n_attn,
                          flash_attention_backward=n_attn, ssd_scan=n_ssm,
                          ssd_scan_backward=n_ssm)


def _mesh_train_runs() -> list:
    """mesh_train's (name, argv, cfg) runs: qwen whole and mamba2-2.7b's
    first 8 layers, then the other families at train_families' sizes."""
    runs = [("qwen", MESH_TRAIN_ARGS, None),
            ("mamba2", MESH_TRAIN_SSM_ARGS,
             dataclasses.replace(get_config(SSM_ARCH),
                                 num_layers=MESH_TRAIN_SSM_LAYERS))]
    for arch, layers in TRAIN_FAMILIES[:2]:
        runs.append((arch, ["--arch", arch] + MESH_TRAIN_FAMILY_ARGS,
                     dataclasses.replace(get_config(arch),
                                         num_layers=layers)))
    runs.append((HYBRID_ARCH, ["--arch", HYBRID_ARCH]
                 + MESH_TRAIN_FAMILY_ARGS, hybrid_train_config()))
    for arch in (AUDIO_ARCH, VLM_ARCH):
        runs.append((arch, ["--arch", arch] + MESH_TRAIN_FAMILY_ARGS, None))
    return runs


def _mesh_decode(dev, name: str, cfg) -> dict:
    """One ``prefill`` and one ``decode_step`` of ``cfg`` (bf16, seeded
    weights, a whisper's frames N(0, 1) in float32) on the one-rank NCCL
    host mesh against the plain pair: the mesh's cache re-placed by
    ``cache_specs`` before the step, logits bitwise, the launches of each
    exact (the prefill's B3 calls, the decode's one a layer: MLA decode
    on DeepSeek, B4 over the self and the cross cache on whisper)."""
    b, s, cache_len = MESH_DECODE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(b, cfg.encoder.n_ctx, cfg.d_model,
                                      generator=gen, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                        device=dev)
    lengths = torch.tensor([s, s - 23], dtype=torch.int32, device=dev)
    n_dec = cfg.layer_kinds().count("attn")
    want_pre = _launch_counts(flash_attention=_attention_calls(cfg))
    want_dec = (_launch_counts(mla_decode=n_dec) if cfg.mla is not None
                else _launch_counts(decode_attention=n_dec * (
                    2 if cfg.family == "audio" else 1)))

    def fresh():
        return transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))

    runs = {}
    for mode in ("plain", "mesh"):
        with owned_group():
            model = fresh()
            mb, mt, ml = batch, tok, lengths
            if mode == "mesh":
                mesh = make_host_mesh(device_type=dev.type)
                dst.shard_model(model, mesh, shd.param_specs(cfg, model,
                                                             mesh))
                mb = dst.shard_batch(batch, mesh, {
                    k: shd.P(shd.batch_axes(mesh), *[None] * (v.dim() - 1))
                    for k, v in batch.items()})
                mt = dst.distribute(tok, mesh, shd.P("data", None))
                ml = dst.distribute(lengths, mesh, shd.P("data"))
            else:
                mesh = None
            with torch.no_grad(), dst.step_scope(mesh):
                _reset_serve_launches()
                pre, cache = transformer.prefill(cfg, model, mb, cache_len)
                pre_launches = _serve_launches()
                if mesh is not None:
                    cache = [{k: dst.full(t) for k, t in c.items()}
                             for c in cache]
                    cache = dst.shard_cache(cache, mesh, shd.cache_specs(
                        cfg, cache, mesh))
                _reset_serve_launches()
                logits, _ = transformer.decode_step(cfg, model, mt, cache,
                                                    ml)
                dec_launches = _serve_launches()
            check(pre_launches == want_pre, f"mesh_train {name} {mode} "
                  f"prefill: launched {pre_launches}, expected {want_pre}")
            check(dec_launches == want_dec, f"mesh_train {name} {mode} "
                  f"decode: launched {dec_launches}, expected {want_dec}")
            runs[mode] = (dst.full(pre).float().cpu(),
                          dst.full(logits).float().cpu())
            del model, cache
            torch.cuda.empty_cache()
    (pre_p, dec_p), (pre_m, dec_m) = runs["plain"], runs["mesh"]
    check(bool(torch.isfinite(dec_p).all()),
          f"mesh_train {name}: non-finite decode logits")
    check(torch.equal(pre_m, pre_p), f"mesh_train {name}: prefill logits "
          f"differ by {float((pre_m - pre_p).abs().max())}")
    check(torch.equal(dec_m, dec_p), f"mesh_train {name}: decode logits "
          f"differ by {float((dec_m - dec_p).abs().max())}")
    info = dict(arch=cfg.name, layers=cfg.num_layers, batch=b, prompt=s,
                cache_len=cache_len, prefill_launches=want_pre,
                decode_launches=want_dec, logits_bitwise=True)
    emit("mesh_decode", **info)
    return info


def phase_mesh_train(dev, smi: str) -> dict:
    """``launch.train`` on the one-rank NCCL host mesh (every tensor a
    DTensor) against the plain run: losses and grad norms bitwise, the
    same launches a step; then ``_mesh_decode`` for DeepSeek and
    whisper."""
    out = {}
    for name, argv, cfg in _mesh_train_runs():
        args = train_cli.parse_args(argv)
        per_step = _train_launch_counts(cfg or get_config(args.arch))
        runs = {}
        for mode in ("plain", "mesh"):
            _reset_serve_launches()
            res = train_cli.run(args, cfg=cfg, device=dev, log=False,
                                distribute=mode == "mesh")
            launches = _serve_launches()
            want = {k: v * args.steps for k, v in per_step.items()}
            check(launches == want, f"mesh_train {name} {mode}: launched "
                  f"{launches}, expected {want}")
            check(bool(np.all(np.isfinite(res["losses"]))),
                  f"mesh_train {name} {mode}: losses {res['losses']}")
            runs[mode] = dict(res, launches=launches)
            torch.cuda.empty_cache()
        plain, mesh = runs["plain"], runs["mesh"]
        check(mesh["mesh"] == {"data": 1, "model": 1},
              f"mesh_train {name}: mesh {mesh['mesh']}")
        check(mesh["losses"] == plain["losses"],
              f"mesh_train {name}: losses {mesh['losses']} against "
              f"{plain['losses']}")
        check(mesh["grad_norms"] == plain["grad_norms"],
              f"mesh_train {name}: grad norms {mesh['grad_norms']} against "
              f"{plain['grad_norms']}")
        info = {
            "arch": mesh["arch"], "layers": mesh["layers"],
            "dtype": mesh["dtype"], "args": argv, "mesh": mesh["mesh"],
            "losses": mesh["losses"], "grad_norms": mesh["grad_norms"],
            "launches_per_step": {k: v // args.steps
                                  for k, v in mesh["launches"].items()},
            "step_ms_warm_median": float(np.median(mesh["step_ms"][1:])),
            "plain_step_ms_warm_median": float(np.median(
                plain["step_ms"][1:])),
            "step_ms": mesh["step_ms"], "plain_step_ms": plain["step_ms"],
            "peak_bytes": mesh["peak_bytes"],
            "plain_peak_bytes": plain["peak_bytes"], "nvidia_smi": smi}
        print(f"mesh_train {name}: median warm step "
              f"{info['step_ms_warm_median']:.1f} ms on the 1 x 1 DTensor "
              f"mesh, {info['plain_step_ms_warm_median']:.1f} ms plain "
              f"({smi})", flush=True)
        emit("mesh_train", **info)
        out[name] = info
    mla = dataclasses.replace(get_config(TRAIN_FAMILIES[1][0]),
                              num_layers=TRAIN_FAMILIES[1][1])
    out["decode"] = {cfg.name: _mesh_decode(dev, cfg.name, cfg)
                     for cfg in (mla, get_config(AUDIO_ARCH))}
    return out


def main() -> int:
    try:
        return _main()
    finally:
        for pool in _POOLS:
            pool.shutdown(wait=True, cancel_futures=True)
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    seconds = {}

    def phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    smi = phase("build", phase_build)
    # the dry runs need no GPU: they run beside the phases below
    dry = start_dryruns()
    start_host_ladders()
    grid = gen_grid()
    # each path's own hist_update block: the sweep's 32 × 768 and the
    # generate sweep's 16 × s_cap (one 16-step superstep, hist_every=1)
    full = phase("kernel", phase_kernel, dev, sketch=False)
    sketch = phase("kernel_sketch", phase_kernel, dev, sketch=True)
    gen_block = phase("kernel_gen", phase_kernel, dev, sketch=False,
                      p=len(grid), rows=16,
                      width=int(grid.max_active.max()), block="gen")
    thin = phase("kernel_thinned", phase_kernel, dev, sketch=False,
                 p=len(grid), rows=len(thinned_rows(16, 3)), width=63,
                 block="gen_thinned")
    compact = phase("fifo_compact", phase_fifo_compact, dev)
    phase("hist_cases", phase_hist_cases, dev)
    phase("contracts", phase_contracts, dev)
    phase("main", phase_main, dev)
    sweep_launches, captured = phase("user_size", phase_user_size, dev)
    # the sweep's own block, captured mid-run: the kernel on the data
    # the path hands it
    sweep_path = path_hist(dev, captured, "sweep_path")
    phase("gen_contracts", phase_gen_contracts, dev)
    gen, blocks, gen_base = phase("gen_user_size", phase_gen_user_size,
                                  dev, grid)
    gen_path = path_hist(dev, blocks["hist_update"], "gen_path")
    compact_path = compact_report(dev, *blocks["fifo_compact"][0],
                                  "gen_path", emit_as="path_kernel")
    del captured, blocks
    torch.cuda.empty_cache()
    phase("loss_contracts", phase_loss_contracts, dev)
    _, loss_launches, captured = phase("loss_user_size",
                                       phase_loss_user_size, dev)
    loss_path = path_hist(dev, captured, "sweep_loss_path")
    gen_loss, blocks = phase("gen_loss_user_size", phase_gen_loss_user_size,
                             dev, grid, gen_base)
    gen_loss_path = path_hist(dev, blocks["hist_update"], "gen_loss_path")
    compact_loss_path = compact_report(dev, *blocks["fifo_compact"][0],
                                       "gen_loss_path",
                                       emit_as="path_kernel")
    del captured, blocks, gen_base
    torch.cuda.empty_cache()
    phase("fail_contracts", phase_fail_contracts, dev)
    _, fail_launches, captured = phase("fail_user_size",
                                          phase_fail_user_size, dev)
    fail_path = path_hist(dev, captured, "sweep_fail_path")
    gen_fail, blocks = phase("gen_fail_user_size", phase_gen_fail_user_size,
                             dev, grid)
    gen_fail_path = path_hist(dev, blocks["hist_update"], "gen_fail_path")
    compact_fail_path = compact_report(dev, *blocks["fifo_compact"][0],
                                       "gen_fail_path",
                                       emit_as="path_kernel")
    del captured, blocks
    torch.cuda.empty_cache()
    phase("fleet_contracts", phase_fleet_contracts, dev)
    _, fleet_launches, captured = phase("fleet_user_size",
                                        phase_fleet_user_size, dev)
    fleet_path = path_hist(dev, captured, "fleet_path")
    _, fleet_fail_launches, captured = phase(
        "fleet_fail_user_size", phase_fleet_fail_user_size, dev)
    fleet_fail_path = path_hist(dev, captured, "fleet_fail_path")
    del captured
    torch.cuda.empty_cache()
    phase("chain_grid", phase_chain_grid, dev)
    fold = phase("campaign_fold", phase_campaign_fold, dev)
    phase("campaign_contracts", phase_campaign_contracts, dev)
    camp, captured = phase("campaign_user_size", phase_campaign_user_size,
                           dev)
    camp_path = path_hist(dev, captured, "campaign_path")
    del captured
    torch.cuda.empty_cache()
    attn = phase("attn_kernel", phase_attn_kernel, dev)
    served = phase("serve", phase_serve, dev)
    phase("serve_long", phase_serve_long, dev)
    phase("model_consistency", phase_model_consistency, dev)
    ssd = phase("ssd_kernel", phase_ssd_kernel, dev)
    served_ssm = phase("serve_ssm", phase_serve_ssm, dev)
    phase("ssm_consistency", phase_ssm_consistency, dev)
    int8 = phase("kv_int8_kernel", phase_kv_int8_kernel, dev)
    cont = phase("continuous_serve", phase_continuous_serve, dev)
    served_moe = phase("serve_moe", phase_serve_moe, dev)
    phase("moe_consistency", phase_moe_consistency, dev)
    served_int8 = phase("serve_int8", phase_serve_int8, dev)
    hybrid = phase("hybrid_kernels", phase_hybrid_kernels, dev)
    mla = phase("mla_kernel", phase_mla_kernel, dev)
    served_mla = phase("serve_mla", phase_serve_mla, dev)
    phase("mla_consistency", phase_mla_consistency, dev)
    served_hybrid = phase("serve_hybrid", phase_serve_hybrid, dev)
    phase("hybrid_consistency", phase_hybrid_consistency, dev)
    encdec = phase("encdec_kernels", phase_encdec_kernels, dev)
    served_audio = phase("serve_audio", phase_serve_audio, dev)
    served_vlm = phase("serve_vlm", phase_serve_vlm, dev)
    phase("audio_consistency", phase_audio_consistency, dev)
    phase("vlm_consistency", phase_vlm_consistency, dev)
    bwd = phase("attn_backward", phase_attn_backward, dev)
    trained = phase("train", phase_train, dev)
    phase("train_consistency", phase_train_consistency, dev)
    ssd_bwd = phase("ssd_backward", phase_ssd_backward, dev)
    trained_ssm = phase("train_ssm", phase_train_ssm, dev)
    phase("train_hybrid", phase_train_hybrid, dev)
    phase("train_ssm_consistency", phase_train_ssm_consistency, dev)
    phase("train_families", phase_train_families, dev)
    phase("mesh_train", phase_mesh_train, dev, smi)
    phase("dryrun", phase_dryrun, dry)
    emit("phase_seconds", **seconds)
    long_keys = ("kernel_ms", "plain_ms", "bound_ms", "library_ms",
                 "max_abs_err")
    batch1_keys = (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                   ("bound_ms", "bound_ms"), ("library_ms", "library_ms"),
                   ("max_abs_err", "max_abs_err"))
    print(json.dumps({"kernels": [
        _kernel_row(
            "hist_update", "gen_user_size", gen["launches"]["hist_update"],
            gen_block,
            max_abs_err=max(gen_block["max_abs_err"], thin["max_abs_err"],
                            gen_path["max_abs_err"]),
            bound_ms_bytes4=gen_block["bound_ms_bytes4"],
            thinned_ms=thin["kernel_ms"], thinned_plain_ms=thin["plain_ms"],
            thinned_bound_ms=thin["bound_ms"],
            thinned_bound_ms_bytes4=thin["bound_ms_bytes4"],
            thinned_library_ms=thin["library_ms"],
            **_path_keys(gen_path)),
        _kernel_row(
            "hist_update", "sweep_user_size", sweep_launches, full,
            max_abs_err=max(full["max_abs_err"], sketch["max_abs_err"],
                            sweep_path["max_abs_err"]),
            bound_ms_bytes4=full["bound_ms_bytes4"],
            sketch_ms=sketch["kernel_ms"], sketch_plain_ms=sketch["plain_ms"],
            sketch_bound_ms=sketch["bound_ms"],
            sketch_bound_ms_bytes4=sketch["bound_ms_bytes4"],
            sketch_library_ms=sketch["library_ms"],
            **_path_keys(sweep_path)),
        _kernel_row("fifo_compact", "gen_user_size",
                    gen["launches"]["fifo_compact"], compact,
                    max_abs_err=max(compact["max_abs_err"],
                                    compact_path["max_abs_err"]),
                    **_path_keys(compact_path)),
        # the loss paths, timed on their own captured blocks
        _kernel_row("hist_update", "sweep_loss_user_size", loss_launches,
                    loss_path, bound_ms_bytes4=loss_path["bound_ms_bytes4"],
                    **_path_keys(loss_path)),
        _kernel_row("hist_update", "gen_loss_user_size",
                    gen_loss["launches"]["hist_update"], gen_loss_path,
                    bound_ms_bytes4=gen_loss_path["bound_ms_bytes4"],
                    **_path_keys(gen_loss_path)),
        _kernel_row("fifo_compact", "gen_loss_user_size",
                    gen_loss["launches"]["fifo_compact"], compact_loss_path,
                    **_path_keys(compact_loss_path)),
        # the failure paths, timed on their own captured blocks
        _kernel_row("hist_update", "sweep_fail_user_size", fail_launches,
                    fail_path, bound_ms_bytes4=fail_path["bound_ms_bytes4"],
                    **_path_keys(fail_path)),
        _kernel_row("hist_update", "gen_fail_user_size",
                    gen_fail["launches"]["hist_update"], gen_fail_path,
                    bound_ms_bytes4=gen_fail_path["bound_ms_bytes4"],
                    **_path_keys(gen_fail_path)),
        _kernel_row("fifo_compact", "gen_fail_user_size",
                    gen_fail["launches"]["fifo_compact"], compact_fail_path,
                    **_path_keys(compact_fail_path)),
        # the fleet paths, timed on their own captured blocks
        _kernel_row("hist_update", "fleet_user_size", fleet_launches,
                    fleet_path, bound_ms_bytes4=fleet_path["bound_ms_bytes4"],
                    **_path_keys(fleet_path)),
        _kernel_row("hist_update", "fleet_fail_user_size",
                    fleet_fail_launches, fleet_fail_path,
                    bound_ms_bytes4=fleet_fail_path["bound_ms_bytes4"],
                    **_path_keys(fleet_fail_path)),
        # the campaign path, timed on its own captured block
        _kernel_row("hist_update", "campaign_user_size",
                    camp["launches"]["hist_update"], camp_path,
                    bound_ms_bytes4=camp_path["bound_ms_bytes4"],
                    **_path_keys(camp_path)),
        # a kernel of the port with no TPU counterpart: the reference
        # folds a chunk with a jitted lax.scan
        _kernel_row("campaign_fold", "campaign_user_size",
                    camp["launches"]["campaign_fold"], fold["loss"],
                    note="no TPU kernel: replaces the reference's lax.scan "
                         "fold", shape=[fold["loss"]["m"],
                                        fold["loss"]["n_bins"]],
                    chain_floor_ms=fold["loss"]["chain_floor_ms"],
                    **{f"{case}_{k}": fold[case][key]
                       for case in ("full", "sketch", "full_loss_nan")
                       for k, key in (("ms", "kernel_ms"),
                                      ("plain_ms", "plain_ms"),
                                      ("bound_ms", "bound_ms"))}),
        *(_kernel_row(
            name, "serve", served["launches"][name], attn[f"{short}_serve"],
            **{f"long_{k}": attn[f"{short}_long"][k] for k in long_keys},
            long_bound_by=attn[f"{short}_long"]["bound_by"],
            **{f"batch1_{k}": attn[f"{short}_batch1"][key]
               for k, key in batch1_keys},
            batch1_bound_by=attn[f"{short}_batch1"]["bound_by"],
            continuous_launches=cont["launches"][name],
            **{f"continuous_{k}": attn[f"{short}_continuous"][key]
               for k, key in batch1_keys},
            continuous_bound_by=attn[f"{short}_continuous"]["bound_by"],
            moe_launches=served_moe["launches"][name],
            **{f"moe_{k}": attn[f"{short}_moe"][key]
               for k, key in batch1_keys},
            moe_bound_by=attn[f"{short}_moe"]["bound_by"],
            # Jamba-16's attention layers, timed at their serve shape
            hybrid_launches=served_hybrid["launches"][name],
            **{f"hybrid_{k}": hybrid[f"{short}_serve"][key]
               for k, key in batch1_keys},
            hybrid_bound_by=hybrid[f"{short}_serve"]["bound_by"],
            # whisper's and InternVL2's serve runs, and their shapes
            audio_launches=served_audio["launches"][name],
            vlm_launches=served_vlm["launches"][name],
            **{f"{shape}_{k}": encdec[shape][key]
               for shape in shapes
               for k, key in batch1_keys + (("bound_by", "bound_by"),)},
            **extra)
          for name, short, shapes, extra in (
              ("flash_attention", "flash",
               ("audio_encoder", "audio_encoder_batch1", "audio_cross",
                "audio_cross_batch1", "audio_cross_batch2",
                "audio_cross_batch4", "vlm_prefill", "vlm_prefill_batch1"), {
                  # the float32 shapes' bound at the CUDA cores' rate,
                  # beside their 3xTF32 bound_ms; their key-axis splits
                  **{f"{shape}_{k}": encdec[shape][k]
                     for shape in ("audio_encoder", "audio_encoder_batch1",
                                   "audio_cross", "audio_cross_batch1",
                                   "audio_cross_batch2", "audio_cross_batch4")
                     for k in ("bound_ms_cuda_cores", "splits")},
                  # MLA's (192, 128) pair on serve_mla
                  "mla_launches": served_mla["launches"]["flash_attention"],
                  **{f"mla_{case}{k}": mla[f"flash_{shape}"][key]
                     for case, shape in (("", "serve"), ("long_", "long"),
                                         ("batch1_", "batch1"))
                     for k, key in batch1_keys + (("bound_by",
                                                   "bound_by"),)},
                  "mla_library_note": mla["flash_serve"]["library_note"],
                  # the training path: the forward with lse at its shape
                  "train_launches": trained["launches"]["flash_attention"],
                  "train_ms": bwd["forward"]["lse_ms"],
                  "train_no_lse_ms": bwd["forward"]["kernel_ms"],
                  **{f"train_{k}": bwd["forward"][key]
                     for k, key in (("plain_ms", "plain_ms"),
                                    ("bound_ms", "bound_ms"),
                                    ("library_ms", "library_ms"),
                                    ("bound_by", "bound_by"),
                                    ("max_abs_err", "max_abs_err"))}}),
              ("decode_attention", "decode",
               ("audio_cross_decode", "audio_cross_decode_batch1",
                "vlm_decode"),
               {"splits": {**{k: attn[f"decode_{k}"]["splits"]
                              for k in ("serve", "long", "batch1",
                                        "continuous", "moe")},
                           **{k: encdec[k]["splits"]
                              for k in ("audio_cross_decode",
                                        "audio_cross_decode_batch1",
                                        "vlm_decode")}}}))),
        # B4 over the int8 cache, timed at serve_int8's largest batch;
        # the pool_*, long_* and batch1_* shapes run on no int8 path
        _kernel_row(
            "decode_attention_int8", "serve_int8",
            served_int8["launches"]["decode_attention_int8"], int8["serve"],
            max_abs_err=max(int8[k]["max_abs_err"] for k in int8),
            worst_over_tol=max(int8[k]["worst_over_tol"] for k in int8),
            library_note=int8["serve"]["library_note"],
            float_cache_ms=int8["serve"]["float_cache_ms"],
            sdpa_dequantized_ms=int8["serve"]["sdpa_dequantized_ms"],
            off_path_note="pool_*, long_*, batch1_*: shapes no int8 path "
                          "runs (continuous_serve uses the bf16 cache)",
            **{f"{case}_{k}": int8[case][key]
               for case in ("pool", "long", "batch1")
               for k, key in batch1_keys + (("float_cache_ms",
                                             "float_cache_ms"),
                                            ("bound_by", "bound_by"))},
            splits={k: int8[k]["splits"] for k in int8}),
        _kernel_row(
            "ssd_scan", "serve_ssm", served_ssm["launches"]["ssd_scan"],
            ssd["serve"], library_note=ssd["serve"]["library_note"],
            **{f"long_{k}": ssd["long"][k] for k in long_keys},
            long_bound_by=ssd["long"]["bound_by"],
            **{f"batch1_{k}": ssd["batch1"][key] for k, key in batch1_keys},
            batch1_bound_by=ssd["batch1"]["bound_by"],
            splits={k: ssd[k]["splits"] for k in ("serve", "long",
                                                   "batch1")},
            # Jamba-16's Mamba2 layers at (64, 16)
            hybrid_launches=served_hybrid["launches"]["ssd_scan"],
            **{f"hybrid_{case}{k}": hybrid[f"ssd_{shape}"][key]
               for case, shape in (("", "serve"), ("long_", "long"),
                                   ("batch1_", "batch1"))
               for k, key in batch1_keys + (("bound_by", "bound_by"),)},
            hybrid_splits={k: hybrid[f"ssd_{k}"]["splits"]
                           for k in ("serve", "long", "batch1")},
            # float32 (3xTF32 tensor-core tiles): ssd_kernel's B 4 × 300
            # and Jamba's serve and ragged shapes
            **{f"{case}{k}": src[key]
               for case, src in (("f32_", ssd["f32"]),
                                 ("hybrid_f32_", hybrid["ssd_f32_serve"]),
                                 ("hybrid_f32_ragged_", hybrid["ssd_f32"]))
               for k, key in batch1_keys + (
                   ("bound_by", "bound_by"),
                   ("bound_ms_cuda_cores", "bound_ms_cuda_cores"))}),
        # a kernel of the port with no TPU counterpart: the reference
        # trains through jax.grad of its sdpa; timed at the training
        # shape, with the long, batch-1 and float32 shapes beside
        _kernel_row(
            "flash_attention_backward", "train",
            trained["launches"]["flash_attention_backward"], bwd["train"],
            note="no TPU kernel: replaces jax.grad through the reference's "
                 "sdpa",
            train_launches=trained["launches"]["flash_attention_backward"],
            launches_per_step=trained["launches_per_step"][
                "flash_attention_backward"],
            library_note=bwd["train"]["library_note"],
            library_bwd_ms=bwd["train"]["library_bwd_ms"],
            library_bwd_note=bwd["train"]["library_bwd_note"],
            **{f"{case}_{k}": bwd[case][key]
               for case in ("long", "batch1", "f32")
               for k, key in batch1_keys + (("bound_by", "bound_by"),
                                            ("library_bwd_ms",
                                             "library_bwd_ms"))},
            f32_bound_ms_cuda_cores=bwd["f32"]["bound_ms_cuda_cores"]),
        # a kernel of the port with no TPU counterpart: the reference
        # trains Mamba2 through jax.grad of its _ssd_chunked; timed at
        # mamba2-2.7b's training shape, with the float32, long and
        # Jamba shapes beside
        _kernel_row(
            "ssd_scan_backward", "train_ssm",
            trained_ssm["launches"]["ssd_scan_backward"], ssd_bwd["train"],
            note="no TPU kernel: replaces jax.grad through the reference's "
                 "_ssd_chunked",
            launches_per_step=trained_ssm["launches_per_step"][
                "ssd_scan_backward"],
            library_note=ssd_bwd["train"]["library_note"],
            worst_over_tol=max(ssd_bwd[k]["worst_over_tol"]
                               for k in ssd_bwd),
            **{f"{case}_{k}": ssd_bwd[case][key]
               for case in ("f32", "long", "hybrid")
               for k, key in batch1_keys + (("bound_by", "bound_by"),)},
            f32_bound_ms_cuda_cores=ssd_bwd["f32"]["bound_ms_cuda_cores"]),
        # a kernel of the port with no TPU counterpart: the reference's
        # float32 einsum chain of MLA decode, timed at serve_mla's last
        # decode step (B 32 over the 37-slot cache)
        _kernel_row(
            "mla_decode", "serve_mla",
            served_mla["launches"]["mla_decode"], mla["decode_serve"],
            note="no TPU kernel: replaces the reference's einsum chain",
            library_note=mla["decode_serve"]["library_note"],
            **_path_keys(mla["decode_serve"]),
            **{f"{case}{k}": mla[f"decode_{shape}"][key]
               for case, shape in (("long_", "long"), ("batch1_", "batch1"),
                                   ("long_f32_", "long_f32"))
               for k, key in batch1_keys + (("bound_by", "bound_by"),)},
            long_f32_bound_ms_cuda_cores=mla["decode_long_f32"][
                "bound_ms_cuda_cores"],
            splits={k: mla[f"decode_{k}"]["splits"]
                    for k in ("serve", "long", "batch1", "long_f32")}),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
