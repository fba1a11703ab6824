#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --only distributed   # phases 15-18 alone
    python3 chip_smoke.py --only ladder        # K3's and K2's times
    python3 chip_smoke.py --only k6            # K6's six passes' times
    python3 chip_smoke.py --only k8            # K8's time and a prefill's
    python3 chip_smoke.py --only k9            # K9's times and a prefill's
    python3 chip_smoke.py --only stencil_serving   # phases 19-20 alone
    python3 chip_smoke.py --only distributed_spec  # phase 21 alone
    python3 chip_smoke.py --only recovery          # phases 22-23 alone
    python3 chip_smoke.py --only families          # phases 24-28 alone
    python3 chip_smoke.py --only train             # phases 29-31 alone
    python3 chip_smoke.py --only analysis          # phases 32-34 alone
    python3 chip_smoke.py --only bf16              # phases 35-43 alone
    python3 chip_smoke.py --only spec_codegen      # phases 43, 54, 44-46
    python3 chip_smoke.py --only bf16_round        # phases 47-49 alone
    python3 chip_smoke.py --only bf16_times        # phase 49's times alone
    python3 chip_smoke.py --only sharding          # phase 50 alone
    python3 chip_smoke.py --only chunking          # phase 51 alone
    python3 chip_smoke.py --only dryrun            # phase 52 alone
    python3 chip_smoke.py --only nemotron          # phase 53 alone
    python3 chip_smoke.py --only spec_math         # phases 54, 44-46
    python3 chip_smoke.py --only host_train        # phase 55 alone

Builds the port's CUDA kernels from `src/repro_torch/csrc/` with nvcc, then:

1. holds each kernel against its plain PyTorch version on the card at small
   shapes: fused ring == plain (bitwise), tiled == untiled, x/y interior
   masks, batched (per-slot params and masks, one padded smaller request)
   == sequential, T beyond K1's build (several passes) and rows cut into z
   chunks == plain (bitwise), finite-guard flags with planted NaN/Inf,
   guarded == unguarded outputs, and the fused ring against the f64
   oracle; then the
   v1-v3 rungs: blocked (K3) and dataflow (K2) == plain for sources and
   `fuse_update`, each on its own plan (`rung_launch_plan`, y_tile None)
   and at given tiles, tiled == untiled, K2 == K3, host tiling == grid for
   every rung and the fused ring, wide == dataflow, x chunks of 1-3 slices,
   plans with x-chunk and y sub-tile remainders and a given tile the plan
   splits (`RUNG_PLAN_CASES`), Z = 10 and 12 on the 4-byte cp.async path,
   fields that start 4 bytes past an allocation (blocked and dataflow),
   (3, 1024, 64) untiled and at y_tile 99 (once refused for shared
   memory), wide's refusal at Z = 10;
2. drives the main path at the paper's 67M grid (1024, 1024, 64):
   `AdvectionDomain(variant="fused", fuse_T=4).advance(..., 16)` (four
   fused launches, each on K1's own launch plan, printed with the card's
   registers, spills and resident blocks for it) and `finite_guard` on the
   result, with the launch counts set to 0 just before and read just after;
   checks the result against the plain version on the card (bitwise), the
   frozen boundary planes and the guard flags;
3. drives the Fig. 3 ladder path at the same grid: for each of `blocked`,
   `dataflow` and `wide`, with and without `fuse_update`,
   `AdvectionDomain(variant=...).advance(..., 4)` (the domain's y_tile 64,
   which each rung's plan runs as its own sub-tiles; the plan printed with
   the card's registers, spills and resident blocks), the counts set to 0
   just before and read just after (the rung's kernel launched 4 times, no
   other kernel), the result == the plain version bitwise, boundary frozen;
4. holds the spec ring (K6, `stencil_fused`) against its plain version at
   small shapes for the six shipped operator x integrator pairs (PW,
   tracer, diffusion x euler, rk2) over T, y_tile and interior masks:
   K6 == plain and PW-spec K6 == K1 (bitwise), the tracer's u, v, w == the
   PW spec's, batched == sequential, boundary frozen, the f64 oracle, the
   refusal of a spec outside the CUDA table, and K6's reach: PW and tracer
   rk2 at T = 4 (which the shared-memory ring refused) == plain and within
   `ORACLE_TOL` of the f64 oracle, T beyond a build's levels as passes of
   whole steps, given plans with x and z chunk remainders, and y_tile 1024
   == K6's own plan == y_tile 3, all == plain bitwise;
5. drives the spec path at the same 67M grid: one `stencil_fused` call per
   operator (PW and tracer at T = 4 euler, T = 2 rk2; diffusion at T = 4)
   on K6's own launch plan (`spec_launch_plan`, printed per pass with the
   card's registers, spills and resident blocks), the counts set to 0 just
   before and read just after (`stencil_fused` launched once a pass, no
   other kernel), == plain bitwise, PW == K1, tracer velocities == PW,
   within `ORACLE_TOL` of the f64 oracle; then PW and tracer rk2 at T = 4
   (`SPEC_DEEP`), == plain and within `ORACLE_TOL`;
6. times each kernel with CUDA events (median of 20 after warm-up) beside
   its bound, the least time the card could take for the same work (each
   v1-v3 rung on its own plan, with its device time by `torch.profiler`,
   registers, spills and resident blocks per SM), each rung's Euler step
   through the domain beside K1's pass over T (and whether the fused rung's
   step beats v2's), a short sweep of K1's launch plans at 67M (y-tiles x
   x-chunks, each output == the planned one bitwise), a sweep of the
   rungs' plans (`RUNG_SWEEP_TILES` x `RUNG_SWEEP_CHUNKS`, each output ==
   the planned one bitwise), and each spec
   operator's call
   ("spec path on the card"
   lines: events and `torch.profiler` device time) with each K6 build's
   registers, spills, shared bytes and resident blocks per SM;
7. holds flash attention (K8) against its plain version at small shapes:
   the reference's `CASES` and block shapes, bf16 (the tensor-core kernel,
   `csrc/flash_attention_tc.cu`) and f32 (the SIMT kernel), causal and
   not, Sq != Skv both ways, the serving path's prompt lengths and head
   dims 192 and 256, within `attention.bf16_bound` (bf16) or 1e-5 (f32),
   and against `mha_ref` where Sq == Skv; 256 x 256 blocks, once refused
   for shared memory, run == plain; and its refusals (`ValueError`, no
   launch);
8. drives the token-serving path at the full width and depth of
   `qwen2.5-14b` (f32 weights drawn on the card, bf16 compute,
   `attention_impl="pallas"`): `ServingEngine.run` on serve.py's default
   traffic (8 requests of 4-23 tokens, batch 4, max_len 128, max_new 16),
   the counts set to 0 just before and read just after (K8 launched 48
   times per prefill, each on the tensor-core kernel, no other kernel);
   prints the tokens, ms per decode step, tokens/s and peak memory;
9. gates `pallas` against `chunked` prefill logits on one 2048-token
   prompt: f32 compute at all 48 layers (within `PREFILL_F32_TOL`) and
   bf16 at the first 2 (the
   tolerances and their basis are in PERF.md); bf16 at 48 layers is
   printed only, with its reason; prints each pallas forward's wall time;
10. times K8 at q (1, 40, 2048, 128), k/v (1, 8, 2048, 128) bf16 causal
   (events, device time by `torch.profiler`, host time to enqueue) beside
   its plain version, `scaled_dot_product_attention` (the library
   yardstick, timed here and used nowhere in the port) and its bound, and prints each tensor-core build's registers, spills, shared
   bytes and resident blocks per SM;
11. holds the selective scan (K9) against its plain version at small
   shapes: the reference's `CASES`, bf16 x, B, C with f32 or bf16 dt,
   nonzero h0 and two chained half-length scans against one full scan,
   the serving path's prompt lengths (S = 4-23, chunk = S, D 8192), D not
   a multiple of the kernel's d-tile, within 1e-4 of the larger of 1 and
   the plain version's largest value; the edge cases of `SCAN_EDGE_CASES`
   (chunk below, at and above the plan's tile, S not a multiple of it, dt
   large and tiny, D 37 and 8200, N 5 and 40) against plain and f64 in f32
   and bf16; a chunk of 1024 steps that the old kernel refused for shared
   memory; and its refusals (`ValueError`, no launch);
12. drives the ssm serving path at the full width and depth of
   `falcon-mamba-7b` (f32 weights drawn on the card after qwen's are
   freed, bf16 compute, `attention_impl="pallas"`) on the same traffic,
   the counts set to 0 just before and read just after (K9 launched 64
   times per prefill, no other kernel);
13. gates `pallas` (K9) against `chunked` on one 2048-token prompt: in
   f32 at each of the 64 layers (both routes fed the same input, the
   mamba mixer's output within `SSM_LAYER_F32_REL_TOL` of its largest
   value); on the prefill logits in f32 at 64 layers within
   `SSM_F32_WITNESS_K` times how far `chunked` at one chunk of the whole
   prompt (another association order of the same sums) lands from
   `chunked`, since this random init amplifies f32 rounding about
   1e6-fold over the stack; and in bf16 at the first 2 layers
   (tolerances and basis in PERF.md); bf16 at 64 layers is printed only;
14. prints each K9 build's registers, spills, shared bytes and resident
   blocks per SM and the plans of its two timed shapes; times K9 (events,
   device time by `torch.profiler`) at xc (1, 2048, 8192) bf16, dt f32,
   B/C (1, 2048, 16) bf16 beside the launches of one 2048-token prefill,
   and at a serving prompt's (1, 16, 8192, 16) beside the serving path's
   launches, each beside its plain version and its bound (no single
   PyTorch call computes the scan, so no library time); then a sweep of
   K9's lanes and steps at the first shape, each == the planned one;
15. holds the band exchange (K7) against its plain version on loopback
   meshes of the one card (`BAND_CASES`: (1, 2), (2, 1), (2, 2), (1, 4),
   (3, 1); dims 0 and 1; depth 1 to three hops a side): four blocks in a
   row on the same extended buffers, tables and counters, both slots (the
   last two passing the slot's interior views, so that only the bands
   move), every buffer == plain bitwise, interior included, the slot block
   0 did not write untouched, one put per card and exchange, error words
   0;
16. drives the distributed path at the 67M grid over a (2, 2) loopback
   mesh on cuda:0: `make_distributed_run(n_blocks=4, T=4, dt=DT,
   local_kernel="fused", overlap=True)`, 16 Euler substeps, with each
   engine, the counts set to 0 just before and read just after (with
   `remote_dma` K7 once per card, phase and block, 8, with no enter or
   wait kernel, and K1 twice per shard and block, 32; with `collective`
   K1 alone), `remote_dma` == `collective` == the main path's single-card
   `advance(16)`, bitwise;
17. times K7 per phase at the path's shapes: the bands alone (events, host
   enqueue, device time) beside their bound, and the extend pass the block
   runs (K7 landing each shard and its bands in the extended slab K1
   reads; events and device time) beside its bound (bytes read and written
   once in the card's memory), its plain version and the collective engine
   for the same exchange (its band copies, and its extend pass with the
   concatenation: the library time); then each engine's ms per block of
   the run;
18. where the machine has two or more cards, repeats 15-17 on a mesh of
   distinct cards (peer stores over NVLink), bitwise equal to the
   loopback run; with one card it prints that it skipped.

19. drives the stencil serving tier on serve.py's own traffic at its full
   shape: `StencilServingEngine` over slots of (64, 256, 64), T = 4, dt
   0.005, batch 4, 8 requests of extents in [4, 64] x [4, 256] and 1-16
   fused steps drawn as `launch.serve.stencil_requests` draws them; clean,
   then under `SERVE_FAULT_PLAN` (a NaN poison that quarantines its slot, a
   device loss that reshards 4 -> 1), the counts set to 0 just before each
   run and read just after (K5, `advect_fused_batched` on K1's kernel, and
   K4 once a mega-step each, no other kernel); every job's streamed states
   and output == a sequential `advect_fused` of its unpadded fields on the
   card, the faulted run's == the clean run's, bitwise; the health counters
   and cache stats == a CPU run of the same jobs and plan (cropped to
   `SERVE_MIRROR` slots: the fault logic depends on the schedule alone);
20. the same on slots of the paper's Figs. 3 and 5 grid (512, 512, 64), 8
   requests of extents in [256, 512] x [256, 512] and 1-4 fused steps (one
   mega-launch covers 67M cells, as a main-path K1 pass); then times, at
   batch 4: the mega-step (K5 + K4) by events, K5's and K4's device time
   by `torch.profiler` beside their bounds, the host time to enqueue a
   mega-step (`roofline.SERVING_LAUNCH_OVERHEAD_S`), the time to stream
   the batch's states back, K5's plain version, `run()`'s wall time,
   domains/s and domain-steps/s against the model, and the device's busy
   share of a profiled `run()`;
21. drives the spec-driven distributed run at the 67M grid over a (2, 2)
   loopback mesh of cuda:0: for each pass of `SPEC_PATH`,
   `make_distributed_run(n_blocks=2, local_kernel="fused", overlap=True,
   exchange="collective", spec=...)` (diffusion at
   `DIFFUSION_RESOLVED_DT`), the counts set to 0 just before and read just
   after (K6 twice per shard, pass and block, no other kernel), == two
   single-card `stencil_fused` calls bitwise; PW euler also == the legacy
   run (K1 only) == `AdvectionDomain.advance(8)`; `spec=` with
   `remote_dma` on the CUDA mesh refused at build time with no launch;
   prints ms per block beside the single-card pass, and K6's time at a
   shard's extended slab beside its bound;
22. the checkpointed run on K1 and K7 over the (2, 2) loopback mesh:
   `make_distributed_run(n_blocks=4, T=4, checkpoint_every=2,
   checkpoint_dir=...)` == phase 16's uninterrupted run, and a run stopped
   at block 3 then `resume_distributed_run` to block 4 == the same,
   bitwise, also with `collective` and `verify_integrity=True` (flags sum
   to 0); the counts of each run; a checkpoint's write and restore (each
   805 MB) timed beside ms per block; the directories deleted;
23. `resilient_distributed_run` on K1 over a (1, 4) loopback mesh,
   n_blocks 4, T 4: a clean plan, twice (the first run also pays the
   first use of its shapes), == `make_distributed_run` (K1 once per
   shard and block, K7 once per block); a stall, a NaN poison, an
   eviction and a 4 -> 2 -> 4 reshard on the one card, and a wire
   corruption on the `collective` rung (verified), each == the clean run
   bitwise; a persistent poison raises `RecoveryExhausted`; each run's
   `health()` == a CPU run of the same plan on a small grid; prints each
   run's wall seconds and the share spent in snapshots.

24. drives the hybrid family at the full width and depth of
   `recurrentgemma-9b` (38 layers, 38.5 GB of f32 weights drawn on the
   card, bf16 compute, `attention_impl="pallas"`): serve.py's traffic on
   rings of min(window, max_len) = 128 slots, no kernel launched (the
   window takes its attention to `attn_local`, ahead of `pallas`, and the
   RG-LRU has no kernel); then a 3072-token prompt in f32 (past the window
   of 2048; `attn_local` pads to 4096) and 16 greedy decode steps on a
   ring of 2048, each step's logits == a full forward over prompt + fed
   tokens within `RG_DECODE_F32_TOL`;
25. drives the moe family at full width with bf16 weights, cut in depth
   to fit the card: `llama4-maverick-400b-a17b` at 2 layers (dense + MoE)
   and `arctic-480b` at 1: serve.py's traffic (K8 once per layer per
   prefill), then a 2048-token bf16 prefill under `pallas` and `chunked`:
   K8 once per layer on the pallas route only; how many tokens the two
   routes route differently (expert choices or capacity drops); the
   logits of the others within `MOE_BF16_REL_TOL` x max |logit|, with at
   least `MOE_MIN_ALIKE` of the tokens routed alike; argmax agreement
   printed;
26. drives `qwen2-vl-72b` at full width, 4 of 80 layers (f32 weights):
   phase 9's gate on 2048 embeddings drawn on the card, with the M-RoPE
   positions of a 1 x 32 x 32 patch grid then 1024 text positions, then 16
   decode steps with embeddings (no kernel);
27. drives `whisper-large-v3` at full width and depth (32 + 32 layers,
   f32 weights): an encoder over 1500 frames drawn on the card and a
   decoder prompt of 384 tokens, f32, `pallas` against `chunked` decoder
   logits (K8 once per decoder layer, never in the encoder or
   cross-attention) within the larger of `PREFILL_F32_TOL` and
   `WHISPER_F32_WITNESS_K` x the drift of `chunked` at attn_chunk 128;
   then in bf16 a prefill and greedy decode to position 447;
28. holds K8 against its plain version and times it beside SDPA and its
   bound at the families' prefill shapes (`ATTN_FAMILY_TIMED`: arctic's
   56/8 heads and qwen2-vl's 64/8 at 2048 tokens, whisper's 20/20 of 64
   at 384), one kernel record each;
29. trains `qwen3-32b` at full width, cut to 4 of 64 layers (3.51 B
   params; f32 params and AdamW moments, 56 GB of state; bf16 compute,
   `attention_impl="flash"`, `remat="full"`, weights drawn on the card
   from seed 0) through `launch.train.train_loop` at train.py's defaults
   (batch 8, seq 128, Markov data, lr 3e-3): 20 steps, every one good and
   the last loss below the first, then a poisoned 21st that the NaN guard
   skips and counts; none of the port's kernels launched (the reference's
   training path runs no Pallas kernel); then a step's ms by events,
   tokens/s, its share of the bf16 peak by `roofline.model_flops`, the
   device's busy share (`torch.profiler`), the peak memory, and a
   poisoned step leaving the state's digest unchanged;
30. at the same width in f32, batch 1, seq 2048 (two flash chunks):
   remat "none" and "dots" and scan_group 2 == remat "full", loss and
   every gradient bitwise; `chunked` against `flash` within
   `FLASH_GRAD_REL`; grad_accum 2 against 1 at 2 x 1024 at the reference
   test's tolerances; K8's and K9's routes raising under grad on the card;
31. one train step of each other family at smoke width (f32, flash; the
   hybrid at 7 layers, pattern-grouped) on the card against the CPU: loss
   and gradients within `ORDER_GRAD_REL`, the card's gradients repeating
   bitwise, the step == its update by hand on the card bitwise and within
   1e-6 of the CPU's update from the same gradients; a checkpointed
   `train_loop` of the
   4-layer smoke `qwen3-32b` (scan_group 2) killed after step 3 (its last
   checkpoint incomplete) and resumed from step 2 to 6 == the
   uninterrupted run, bitwise; `serve.py --ckpt-dir` serving 4 requests
   from a trainer's checkpoint with an engine's tokens over the trained
   params; the directories deleted.

32. the movement ledger live on the card (`analysis.ledger`, every hand
   kernel a `repro_torch` op, `kernels.library`): `advance(16)` at the 67M
   grid, T = 4, then K4; the (2, 2) loopback `make_distributed_run` at
   `n_blocks=4` under both engines and the verified `collective` exchange;
   the serving mega-step at 4 x (512, 512, 64); the bf16 `advance(16)`
   and serving mega-step (`pallas_hbm` half f32's); the spec path's six
   passes; one K8 call at q (1, 40, 2048, 128) bf16 and one K9 call at
   (1, 2048, 8192) bf16 (`analysis.programs`). Each category == its model
   exactly (per shard and block on the distributed runs),
   `check_model_coverage` passes with `pallas_control` unpriced, the live
   ledger == a fake trace of the same program category by category, and
   each kernel op's count == its `LAUNCHES` delta;
33. the tiling linter over every op phase 32 launched (no error, at the
   card's SM count), each kernel's planned shared bytes (`analysis.smem`)
   == the bytes its launch asked for (`LAUNCHED_SHARED`; K8's tensor-core
   build by its attrs call; the bf16 ring and rungs too), and an oversized
   plan raising with its largest
   buffer named;
34. the retrace detector on the card: each engine's distributed block at
   block indices 2-5 (one stream, no launch cache growing), `n_blocks` 3
   and 5 sharing their last block's stream, `y_tile` changing it; the red fixture
   flagged and the green one clean. Then the op layer's host cost: the
   host milliseconds of one call before its launch returns, through the
   op and through the bare launch function, for K1, K7 and K8.

35. the bf16 PW path at small shapes, with f32 and with bf16 coefficients
   (`AdvectionDomain(dtype="bfloat16")`'s): K1 == plain bitwise at T 1-4
   and T = 10 (passes), tiled == untiled at y_tile 4, 5, 7, x/y masks,
   guarded == unguarded; K5 with per-slot coefficients and masks and a
   padded request == sequential == plain; K4 clean and with a NaN and an
   inf, on the 16-byte and the 1-cell path; K3, K2 and `wide` (8 cells a
   16-byte move) == plain for sources and `fuse_update`, tiled, x chunks,
   host tiling, their pair build (even Z) and one-cell build (odd Z, and
   fields 2 bytes past an allocation); `wide`'s refusal of Z % 8 != 0,
   and K6 on bf16 fields == K1 bf16;
36. the bf16 main path: `AdvectionDomain(1024, 1024, 64, variant="fused",
   dtype="bfloat16").advance(16)` and K4, counted (4 K1 launches, 1 K4),
   == plain bitwise, within `bf16_oracle_bound` of the f64 oracle, edges
   frozen;
37. the bf16 ladder: `blocked`, `dataflow` and `wide`, `fuse_update` False
   and True, `advance(4)` on bf16 domains, counted, == plain bitwise;
38. the bf16 serving tier: `SERVE_PAPER_SLOT` slots at batch 4, clean and
   under `SERVE_FAULT_PLAN`, with disk snapshots (written under
   `build/bf16_snapshots`, then deleted): batched == sequential and
   rolled back == clean, bitwise, K4 over the batch; K5's time;
39. the bf16 kernels' times at the 67M grid (events and device time, their
   bounds, registers and spills);
40. K6 in bf16: at small shapes (unit spacings, where updates resolve in
   bf16), the six operator x integrator pairs with f32 and with bf16
   coefficients == plain bitwise (T 1-3, tiled == untiled, masks, x and z
   chunks with remainders on given plans, T = 5 as passes), the PW spec
   == K1 bf16, batched == sequential; at the 67M grid the six passes on
   bf16 fields and coefficients == plain bitwise and within
   `TOL_REL_BF16` of the f64 oracle's scale, then timed (events, device
   time) beside their bounds;
41. the bf16 distributed run: K7 bf16 at small shapes == plain; the 67M
   grid over the (2, 2) loopback mesh, `make_distributed_run(n_blocks=4,
   T=4, fused)`, overlap False and True: remote_dma (K7 bf16 8 puts, K1
   bf16) == collective == the single-card bf16 `advance(16)`, bitwise, and
   within `DIST_BF16_TOL` of `reference_global_step`; K7 bf16 timed per
   phase (the bands alone, the extend pass);
42. the bf16 `spec=` runs on `collective` (K6 bf16) == single-card K6 ==
   the plain spec loop, bitwise; a checkpointed bf16 run and its resume ==
   the clean run, bitwise (checkpoints under `build/ckpt_bf16_*`, then
   deleted);
43. user-written specs (a Laplacian with its own x, y and z coefficients,
   a y-z cross derivative reading the centre plane's diagonals, Gray-Scott
   reaction-diffusion of two fields), each on the functor generated from
   its callback (`stencil.spec_cuda`) in f32 and bf16, euler and rk2, at
   small shapes and at the 67M grid == the callback's plain version,
   bitwise; their 12 builds made at once and timed, and again from the
   cache; the analyzer's live ledger == fake == model for one of them;
44. every spec shape the reference's kernel runs, through seven user specs
   (`tests/_spec_shapes.py`: `hyperdiff4` radius 2, `smag_cross` reading
   x-diagonals, `moist6` six fields, `tvd_vl` radius 2 with division,
   abs, minimum, maximum and where on comparisons; the cloud-model specs
   of the math nodes, `satadj3` exp and division by traced values,
   `sponge_log` log, tanh, clamp, a generic power and `t[-1]`,
   `wrap_phase` `%`, `//`, sin and comparisons as numbers), a sqrt/division
   check and a z slice with a positive stop: their builds at once, then
   each spec in f32 and bf16 with bf16 coefficients (the math specs also
   with f32 ones) at small shapes (T 1-3, y_tile None and 3, masks, one
   build for every Z, x and z chunks on given plans, batched ==
   sequential) == the plain version on the card, bitwise; the positive
   stop == plain where it lines up with z, refused before any launch where
   not;
45. the seven at the 67M grid, euler and rk2, in their storages, T = 4 in
   passes, each pass's plan printed with the card's registers and spills
   (none for the four; a math spec's spill is a finding): == plain
   bitwise, one launch a pass, analyzer plan == launch plan == launched
   shared bytes, an explicit y_tile and two batched slots alike, within
   `ORACLE_TOL` x max(1, max |field|) of one f64 oracle field by field
   (f32) or a per-field bound that fails a no-op (bf16); `collective`
   (2, 2) runs of hyperdiff4, moist6 and satadj3 == single-card T = 16
   bitwise, `remote_dma` refused; each spec's ledger live == fake ==
   model;
46. each spec's pass timed (events, device time per launch seen) beside
   its bound, with its build's registers, spills and shared bytes;
47. each bf16 rounding route of `csrc/bf16_round.cu` alone (K1/K5, K6 and
   the rungs' one-cell build round by "pack_hi", `rpk` of
   `csrc/cells.cuh`: one `cvt.rn.bf16x2.f32` of the value and 0.0f a
   round): its rounds a clock per SM and all 2^32 f32 bit patterns against
   `__float2bfloat16_rn`, the same bits or NaN to NaN; and each bf16x2 op
   the rungs' pair build computes with (add, sub, mul): its ops a clock
   per SM and all 2^32 pairs of bf16 operands against `rpk` of the f32
   op, the same bits (the sign of zero included) or NaN to NaN;
48. K1 bf16 (f32 and bf16 coefficients, T 1, 2, 4), K5 bf16 (B = 2), K6
   bf16 (PW, tracer, diffusion, euler and rk2), `tvd_vl`, and K3, K2
   `dataflow` and `wide` (f32 and bf16 coefficients, `fuse_update` False
   and True; the pair build, and the one-cell build on fields 2 bytes past
   an allocation) on fields that span f32 subnormals, values near 2^111
   and bf16's largest, +-0, +-Inf and NaN (mixed, tiny and huge fields):
   == plain on the card, the same bits where not NaN and NaN at the same
   cells;
49. the times the rounding moves: K1 bf16's pass at 67M (both coefficient
   storages), K5 bf16 at 4 x (512, 512, 64), K6 bf16's six spec passes,
   the four spec shapes of phases 44-46 in bf16, the bf16 rungs K3, K2
   `dataflow` and `wide` at 67M (both coefficient storages, `fuse_update`
   False and True, each on its own plan), and the f32 K1 and K6 PW passes
   and f32 rungs as controls, each build's registers, spills and resident
   blocks, none of which may spill.

50. the sharding layer (`distributed.sharding`: the logical-axis rules as
   DTensor placements). 50a, on one card, a (1, 1) `DeviceMesh` over a
   single-rank NCCL group: the full-width `qwen2.5-14b` bf16 `pallas`
   prefill of phase 9's prompt through `make_prefill_step(cfg, layout,
   rules, mesh)` == the plain step bitwise (last-position logits, caches),
   K8 48 times, each call's host and wall time (DTensor's dispatch cost),
   then K8 timed again for the kernels line with the sharded prefill's
   launches; `train_loop` on `qwen3-32b` at full width, 2 of 64 layers,
   `flash`, remat, 3 steps of 8 x 128, plain and then under the rules on
   the mesh (each run freed before the next): losses, gradient norms and
   final params bitwise; then one f32 step plain, 50b's reference. 50b,
   with two or more cards, one NCCL rank a card
   (`torch.multiprocessing.spawn`): `qwen2.5-14b` prefills at tp = 2 (4 kv
   groups a rank; f32 at 48 layers within `PREFILL_F32_TOL` of 50a's tp =
   1 logits, bf16 at 2 layers within `PREFILL_BF16_REL_TOL`, bf16 at 48
   printed; K8 once a layer on every rank), 50a's f32 `qwen3-32b` train
   step (2 layers, 8 x 128) at tp = 2 through the vocab-parallel loss
   within 2e-5 of one card's loss and gradient norm, `pipeline_apply`
   over the ranks == the sequential stack bitwise, `compressed_psum` == a
   host recomputation (residuals bitwise, means within the CPU test's
   bound);
   with one card it prints "sharding across cards: skipped, 1 card
   visible".

Phases 51-53 (after phase 23, after phase 9 and after phase 10): 51, the
paper's §IV chunked host-to-card streaming (`core.chunking.ChunkScheduler`,
a copy-in, a compute and a copy-out stream over pinned staging buffers) of
the 268M grid cut in x into 64 chunks, K2 (`pw_advect(variant="wide")`) a
chunk: overlapped == serial bitwise, each chunk == K2 on it resident, 64 K2
launches a run; serial and overlapped seconds, the host link's rates each
way from pinned memory, the host's copies into the staging buffers and out
of them into new numpy arrays, each alone, K2's time a chunk, `overlap_model` beside the measured time, depth 1, 2, 4 and 8. 52,
`core.profiler.wallclock` on K1 beside the events median, and the dry run's
trace (`launch.dryrun.trace_cell`, a (1, 1) fake mesh) of phase 9's
`qwen2.5-14b` bf16 prefill against the same prefill live on the card under
`FlopCounterMode`: FLOPs equal, traced resident bytes against the measured
peak. 53, `nemotron-4-15b` at full width and depth and `nemotron-4-340b` at
full width, 1 of 96 layers (f32 weights), each a bf16 `pallas` prefill of
2048 tokens against `flash` on the card, K8 once a layer (D 192 for 340b).

Phase 54 (before phase 44): every new node of the tracer
(`spec_cuda.probe_cases`: the math functions, the powers and their
special exponents, clamps, floor division and remainder by values, by
numbers and of numbers, comparisons as numbers, `&` in a select), emitted
as in a functor into one probe (`_build.load_probe`, the generated builds'
flags), == torch's op on the card (the case's callback) over every f32
bit pattern and every bf16 one (one operand), every pair of bf16 patterns
and 2^28 random f32 pairs with the special values' pairs (two): the same
bits, or NaN for NaN.

Phase 55 (last): training on every card of the host (`launch.ranks`,
`train_loop` under a process group, the leaf-by-leaf checkpoint). 55a, on
one card: `train_loop` on a (1, 1) `DeviceMesh` over a one-rank NCCL
group, `qwen3-32b` at full width, 2 of 64 layers (30.4 GB of state),
`flash`, remat, 4 steps of 8 x 128 straight, then 2 steps with a
checkpoint at step 2 (leaf by leaf) and a resume to 4: losses, gradient
norms and the final state by digest bitwise; the device peak during the
save and the restore against the state plus its largest leaf; then
`python -m repro_torch.launch.train --arch qwen3-32b --smoke --steps 3` as
a child: exit 0, one log. 55b, with two or more cards: `python -m
repro_torch.launch.train --arch falcon-mamba-7b --steps 6 --batch 8 --seq
128 --ckpt-every 4` (whole: 84.1 GB of state, one NCCL rank a card) killed
once step 4's checkpoint is published, the same command resumed to step 6,
then `--ckpt-every 6` into a second directory straight: the two step-6
archives equal bitwise and so the printed losses, each card's
memory.used peak, the runs' seconds (checkpoints in memory, in a directory
of this run's own under `/dev/shm`, the host's available memory checked
first, removed at the phase's end); `qwen3-32b` at 16 of 64 layers
(112.3 GB) through `train_loop` on (world, 1), 3 steps, losses finite and
the same on every rank, each card's device peak; the elastic restart (f32,
2 layers, written at step 2 on (world, 1)), resumed on (world / 2, 2) at
tp = 2 and on one card, each within 2e-5 of the straight run's losses and
gradient norms. With one card 55b prints "host_train across cards:
skipped, 1 card visible".

Each phase prints its seconds.

`--only chunking`, `--only dryrun` and `--only nemotron` run phases 51, 52
(drawing `qwen2.5-14b` first) and 53 alone; their kernels lines hold K2 on
the chunked path and K8 at D 192.

`--only host_train` runs phase 55 alone, without building the kernels
(its kernels line is empty: training launches none); on four cards it
runs 55b after 55a, and `--only host_train_cards` runs 55b alone.

`--only sharding` runs phase 50 alone (its kernels line holds K8 with the
sharded prefill's launches); on four cards it is the call that runs 50b.

`--only bf16_round` runs phases 47-49 alone; `--only bf16_times` phase 49
alone, with entry points the port has had since phases 44-46 came, so
that a copy of the script in an older checkout times that checkout the
same way.

`--only bf16` runs phases 35-43 alone (its kernels line holds the bf16
kernels and the generated K6); `--only spec_codegen` phases 43, 54 and
44-46; `--only spec_math` phases 54 and 44-46.

`--only analysis` runs phases 32-34 and the host-cost lines alone.

`--only train` runs phases 29-31 alone (its kernels line is empty: the
training path launches none).

`--only families` runs phases 24-28 alone (its kernels line holds K8 at
the families' shapes).

`--only distributed` runs phases 15-18 alone, then K7 at small shapes,
the distributed path and K7's times, and the cross-card phase again in
bf16 (the call to make on four cards). `--only stencil_serving`
runs phases 19-20 alone, `--only distributed_spec` phase 21 (its kernels
line holds K6 at a shard's extended slab) and `--only recovery` phases
22-23 (its kernels line holds K1 there). A copy of the script in a
checkout from before K7's extended route skips phase 15 and times that
checkout's K7, recv slabs and concatenation through the same entry points,
so parent and change compare in one call.

`--only ladder` times K3, K2 `dataflow` and K2 `wide` at the 67M grid with
`fuse_update` False and True (events and device time by `torch.profiler`),
at y_tile 64 and, where the package plans its own (`rung_launch_plan`), at
y_tile None, beside K1's pass over T, with entry points the port has had
since the rungs were ported, so a copy of the script in an older checkout
times that checkout the same way.

`--only k6` times the six passes of the spec path at the 67M grid (events
and device time) at the tile `largest_fitting_y_tile` gives with
`spec_ring_knobs`, and at K6's own plan where the package has one, beside
K1's pass, with entry points the port has had since K6 was ported, so a
copy of the script in an older checkout times that checkout the same way.

`--only k8` times K8 at phase 10's shape and a bf16 `qwen2.5-14b` prefill
of 2048 tokens through the package beside the script, with entry points
that the port has had since K8 was ported, so a copy of the script in an
older checkout times that checkout the same way.

`--only k9` times K9 at phase 14's two shapes and a bf16 `falcon-mamba-7b`
prefill of 2048 tokens the same way, with entry points the port has had
since K9 was ported.

Prints the card's name and power limit, one JSON line of kernel records and,
last, `{"ok": true, "device": {...}}`. Any failed check exits nonzero
without that last line, as does a machine without a CUDA device.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path
ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import _build  # noqa: E402
from repro_torch import analysis as AN  # noqa: E402
from repro_torch.analysis import programs as PR  # noqa: E402
from repro_torch.analysis import smem as SM  # noqa: E402
from repro_torch.analysis import trace as TR  # noqa: E402
from repro_torch.core import profiler as PF  # noqa: E402
from repro_torch.core.chunking import ChunkScheduler, overlap_model  # noqa: E402
from repro_torch.kernels.advection import ops as AOPS  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch import specs as LSP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import roofline as R  # noqa: E402
from repro_torch.kernels.advection import advection as K  # noqa: E402
from repro_torch.kernels.advection import ref as REF  # noqa: E402
from repro_torch.kernels.attention import attention as A  # noqa: E402
from repro_torch.kernels.attention.ref import mha_ref  # noqa: E402
from repro_torch.kernels.ssm import ssm as SS  # noqa: E402
from repro_torch.launch.serve import (STENCIL_DT,  # noqa: E402
                                      STENCIL_SHAPES, random_params,
                                      random_requests, stencil_requests)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import blocks as BL  # noqa: E402
from repro_torch.models.blocks import Ctx  # noqa: E402
from repro_torch.pspec import tree_map  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    ServingEngine, prefill_to_decode_cache)
from repro_torch.serving.stencil_engine import (  # noqa: E402
    StencilRequest, StencilServingEngine)
from repro_torch.launch.mesh import make_stencil_mesh  # noqa: E402
from repro_torch import pspec as PS  # noqa: E402
from repro_torch.config import RunShape  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import synth_batch, to_device  # noqa: E402
from repro_torch.launch import serve as SERVE  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import step as TS  # noqa: E402
from repro_torch.stencil import distributed as D  # noqa: E402
from repro_torch.stencil import spec as SP  # noqa: E402
from repro_torch.stencil import spec_cuda as G  # noqa: E402
from repro_torch.stencil.advection import (PAPER_GRIDS,  # noqa: E402
                                           AdvectionDomain, stratus_fields)
import _spec_shapes as SHAPES  # noqa: E402

DT = 0.01
MAIN_GRID = "67M"
MAIN_T = 4
MAIN_SUBSTEPS = 16
LADDER_SUBSTEPS = 4
SMALL_SHAPES = ((6, 10, 12), (5, 17, 12), (8, 12, 10))
TIMED_RUNS, WARMUP = 20, 3
ORACLE_TOL = 1e-4       # f32 fused ring vs the f64 oracle (the JAX suite's)
SPEC_TOL_REL = 2e-5     # f32 spec ring vs the f64 oracle, relative to the
                        # field scale (the reference's TOL_REL["float32"])
SPEC_FACTORIES = {"pw": SP.pw_advection_spec,
                  "tracer": SP.tracer_advection_spec,
                  "diffusion": SP.diffusion_spec}
SPEC_DT = {"pw": DT, "tracer": DT, "diffusion": 1e-3}
DIFFUSION_RESOLVED_DT = 1.0   # moves phi ~ 300 by more than an f32 ulp;
                              # explicit-stable (dt * 2(kx+ky+kz) < 1)
# dt of the small-shape phase: at SPEC_DT's 1e-3 diffusion moves phi ~ 300
# by less than the f32 oracle tolerance, which could then not fail it
SMALL_DT = dict(SPEC_DT, diffusion=DIFFUSION_RESOLVED_DT)
# (operator, integrator, T) of the spec path at the 67M grid
SPEC_PATH = (("pw", "euler", 4), ("pw", "rk2", 2), ("tracer", "euler", 4),
             ("tracer", "rk2", 2), ("diffusion", "euler", 4),
             ("diffusion", "rk2", 4))
# PW and tracer at rk2 T = 4: the reference's depth, which the old K6 refused
# (its ring did not fit one block's shared memory); run and checked at 67M
SPEC_DEEP = (("pw", "rk2", 4), ("tracer", "rk2", 4))
RUNGS = {"advect_blocked": "blocked", "advect_dataflow": "dataflow",
         "advect_wide": "wide"}
# the kernel each rung launches, as `torch.profiler` names it (wide is K2's
# 16-byte build)
RUNG_KERNEL = {"advect_blocked": "advect_blocked_kernel",
               "advect_dataflow": "advect_dataflow_kernel",
               "advect_wide": "advect_dataflow_kernel"}
# the rungs' plans at small shapes: a given tile the plan splits into equal
# sub-tiles (64 at Z = 64; 40 of 97 rows), x chunks that leave a remainder
RUNG_PLAN_CASES = (  # shape, y_tile, x_chunk
    ((7, 150, 64), 64, 3), ((9, 97, 64), 40, 4), ((5, 41, 12), 13, 2),
    ((6, 23, 8), 30, 5), ((5, 150, 64), 64, None))
# the rungs' plan sweep at the main grid: y-tiles by x chunks (None: the
# plan's own), each distinct plan once
RUNG_SWEEP_TILES = (None, 8, 16, 32)
RUNG_SWEEP_CHUNKS = (None, 32)
SOURCE = {"advect_fused": "src/repro_torch/csrc/advect_fused.cuh",
          "finite_guard": "src/repro_torch/csrc/finite_guard.cu",
          "advect_blocked": "src/repro_torch/csrc/advect_blocked.cu",
          "advect_dataflow": "src/repro_torch/csrc/advect_dataflow.cu",
          "advect_wide": "src/repro_torch/csrc/advect_dataflow.cu",
          "stencil_fused": "src/repro_torch/csrc/stencil_fused.cuh",
          "stencil_generated": "src/repro_torch/csrc/stencil_generated.cu",
          **{f"stencil_generated_{n}":
             "src/repro_torch/csrc/stencil_generated.cu"
             for n in ("hyperdiff4", "smag_cross", "moist6", "tvd_vl",
                       "satadj3", "sponge_log", "wrap_phase")},
          "flash_attention": "src/repro_torch/csrc/flash_attention_tc.cu",
          "selective_scan": "src/repro_torch/csrc/selective_scan.cu",
          "band_exchange": "src/repro_torch/csrc/band_exchange.cu"}
REPLACES = {"advect_fused": "src/repro/kernels/advection/advection.py:404",
            "finite_guard": "src/repro/kernels/advection/advection.py:469",
            "advect_blocked": "src/repro/kernels/advection/advection.py:214",
            "advect_dataflow": "src/repro/kernels/advection/advection.py:272",
            "advect_wide": "src/repro/kernels/advection/advection.py:367",
            "stencil_fused": "src/repro/kernels/advection/advection.py:677",
            "stencil_generated":
                "src/repro/kernels/advection/advection.py:677",
            **{f"stencil_generated_{n}":
               "src/repro/kernels/advection/advection.py:677"
               for n in ("hyperdiff4", "smag_cross", "moist6", "tvd_vl",
                         "satadj3", "sponge_log", "wrap_phase")},
            "flash_attention": "src/repro/kernels/attention/attention.py:31",
            "selective_scan": "src/repro/kernels/ssm/ssm.py:39",
            "band_exchange": "src/repro/kernels/advection/advection.py:939",
            "advect_fused_batched":
                "src/repro/kernels/advection/advection.py:602"}
# flash attention (K8): the reference's cases and block shapes
# (tests/test_flash_attention.py), then Sq != Skv both ways and the serving
# path's prompt shapes (40 q heads over 8 kv heads of 128)
ATTN_CASES = (  # B, H, Hkv, Sq, Skv, D, causal, dtype, block_q, block_k
    (2, 4, 2, 256, 256, 64, True, torch.float32, 128, 128),
    (1, 8, 1, 128, 128, 32, True, torch.bfloat16, 128, 128),
    (2, 4, 4, 512, 512, 64, False, torch.float32, 128, 128),
    (1, 2, 2, 384, 384, 128, True, torch.float32, 128, 128),
    (1, 6, 2, 256, 256, 64, True, torch.bfloat16, 128, 128),
    (1, 2, 2, 256, 256, 64, True, torch.float32, 64, 64),
    (1, 2, 2, 256, 256, 64, True, torch.float32, 128, 64),
    (1, 2, 2, 256, 256, 64, True, torch.float32, 64, 128),
    (1, 4, 2, 128, 256, 64, True, torch.float32, 64, 64),
    (1, 4, 2, 256, 128, 64, True, torch.float32, 64, 64),
    (1, 4, 2, 128, 256, 64, True, torch.bfloat16, 64, 128),
    (1, 4, 2, 256, 128, 64, True, torch.bfloat16, 128, 64),
    (1, 4, 2, 128, 384, 64, False, torch.bfloat16, 64, 128),
    (1, 40, 8, 13, 13, 128, True, torch.bfloat16, 128, 128),
    (1, 40, 8, 23, 23, 128, True, torch.bfloat16, 128, 128),
    (4, 40, 8, 4, 4, 128, True, torch.float32, 128, 128),
    (1, 8, 2, 256, 256, 192, True, torch.bfloat16, 128, 128),
    (2, 8, 8, 77, 77, 192, False, torch.bfloat16, 128, 128),
    (1, 4, 2, 256, 256, 192, True, torch.float32, 128, 128),
    (1, 4, 1, 256, 256, 256, True, torch.bfloat16, 128, 128),
    (1, 8, 1, 23, 23, 256, True, torch.bfloat16, 128, 128),
    (1, 4, 2, 128, 128, 256, False, torch.float32, 128, 128),
)
# blocks once refused for shared memory: they run and == plain
ATTN_BIG_BLOCKS = (  # B, H, Hkv, S, D, dtype, block
    (1, 2, 2, 512, 128, torch.bfloat16, 256),
    (1, 2, 2, 512, 128, torch.float32, 256))
ATTN_F32_TOL = 1e-5          # the reference's f32 tolerance
ATTN_REF_BF16_TOL = 2e-2     # the reference's bf16 tolerance vs mha_ref
SERVE_ARCH = "qwen2.5-14b"
SERVE_TRAFFIC = dict(requests=8, batch_size=4, max_len=128, max_new=16)
PREFILL_TOKENS = 2048
PREFILL_F32_TOL = 1e-2       # PERF.md: written before the first chip run
PREFILL_BF16_REL_TOL = 0.03  # x max |chunked logit|: 3.8x this gate's own
                             # reading on the card (PERF.md)
ATTN_TIMED = (1, 40, 8, 2048, 128)   # B, H, Hkv, S, D: bf16, causal
# phase 51: the paper's §IV on the 268M grid, cut in x into the chunks of
# benchmarks/fig8_gridsize.py's N_CHUNKS
CHUNK_GRID = "268M"
CHUNK_N = 64
CHUNK_SEED = 0
CHUNK_DEPTH = 4              # ChunkScheduler's default kernel pool
CHUNK_DEPTHS = (1, 2, 4, 8)
CHUNK_RUNS = 5               # runs a median of the serial and overlapped
LINK_BYTES = 1 << 30         # one pinned copy each way, alone
# phase 52: PERF.md, written before the first chip run
WALLCLOCK_REL = 0.05         # profiler.wallclock vs the events median
RESIDENT_RATIO = (0.9, 1.1)  # traced resident / measured peak
# phase 53: depth cuts one card forces (f32 weights; PERF.md reckons them)
NEMOTRON = (("nemotron-4-15b", {}), ("nemotron-4-340b", {"n_layers": 1}))
NEMOTRON_GATE_LAYERS = 2     # phase 9 gates bf16 at its first 2 layers
# selective scan (K9): the reference's cases (tests/test_ssm_kernel.py),
# then D not a multiple of the kernel's d-tile of 16, N not a power of two
# and N over 32 (two states per thread)
SCAN_CASES = (  # B, S, D, N, chunk
    (2, 64, 16, 8, 16), (1, 128, 32, 4, 32), (2, 96, 8, 16, 48),
    (1, 64, 16, 16, 64), (1, 48, 37, 16, 16), (2, 32, 8200, 16, 32),
    (1, 24, 20, 5, 8), (1, 32, 16, 40, 32))
SCAN_SERVE_D, SCAN_SERVE_N = 8192, 16   # falcon-mamba's d_inner, d_state
SCAN_TOL = 1e-4     # x max(1, max |plain|): two f32 orders of one
                    # recurrence (the reference's kernel-vs-oracle 1e-4)
SSM_ARCH = "falcon-mamba-7b"
SSM_LAYER_F32_REL_TOL = 1e-5     # x max |chunked mamba mixer output|, per
                                 # layer (PERF.md)
SSM_F32_WITNESS_K = 5.0   # f32 logits at 64 layers: |pallas - chunked| <=
                          # this x |chunked at one chunk - chunked| (PERF.md)
SSM_PREFILL_BF16_REL_TOL = 0.03  # x max |chunked logit|; PERF.md: written
                                 # before the first chip run
SCAN_TIMED = (1, 2048, 8192, 16, 256)   # B, S, D, N, chunk: x, B, C bf16,
                                        # dt f32 (the 2048-token prefill)
SCAN_SERVE_TIMED = (1, 16, 8192, 16, 16)   # a serving prompt's shape
# K9's edge cases, each against plain and f64 in f32 and bf16: chunk below,
# at and above the plan's tile of 64 steps at S = 256; S not a multiple of
# the tile; dt large (a -> 0) and tiny (a -> 1); B = 2 with D = 37 and
# 8200, N = 5 and 40
SCAN_EDGE_CASES = (  # what, B, S, D, N, chunk, dt scale
    ("chunk below the tile", 1, 256, 64, 16, 16, 0.1),
    ("chunk at the tile", 1, 256, 64, 16, 64, 0.1),
    ("chunk above the tile", 1, 256, 64, 16, 256, 0.1),
    ("S not a multiple of the tile", 1, 200, 48, 16, 40, 0.1),
    ("dt large (a -> 0)", 2, 512, 40, 16, 512, 50.0),
    ("dt tiny (a -> 1)", 2, 512, 40, 16, 512, 1e-6),
    ("B 2, D 37, N 5", 2, 96, 37, 5, 32, 0.1),
    ("B 2, D 8200, N 40", 2, 64, 8200, 40, 64, 0.1))
K9_PLAN_SWEEP = ((4, 8), (4, 4), (8, 4), (16, 4), (16, 8), (32, 2))
# the other model families (slice G1c): PERF.md holds the tolerances'
# basis, written before the first chip run
RG_ARCH = "recurrentgemma-9b"
RG_ATTN_LAYER = 2            # the first local-attention layer (rec, rec, attn)
RG_LONG_PROMPT = 3072        # past the window of 2048: attn_local pads to 4096
RG_DECODE_STEPS = 16
RG_DECODE_F32_TOL = 1e-3     # f32: each decode step's logits vs the forward
MOE_ARCHS = (("llama4-maverick-400b-a17b", 2), ("arctic-480b", 1))  # depth
MOE_BF16_REL_TOL = 0.05      # x max |chunked logit|, tokens routed alike
MOE_MIN_ALIKE = 0.9          # share of tokens the two routes route alike
VLM_ARCH, VLM_LAYERS = "qwen2-vl-72b", 4
VLM_GRID = 32                # a 1 x 32 x 32 patch grid, then 1024 text tokens
VLM_DECODE_STEPS = 16
WHISPER_ARCH = "whisper-large-v3"
WHISPER_FRAMES = 1500        # the 30-s window after the (stubbed) conv stem
WHISPER_PROMPT = 384         # a multiple of 128, as K8 requires above 128
WHISPER_F32_WITNESS_K = 5.0
ATTN_FAMILY_TIMED = (        # K8 at the families' prefill shapes
    ("arctic-480b", (1, 56, 8, PREFILL_TOKENS, 128)),
    ("qwen2-vl-72b", (1, 64, 8, PREFILL_TOKENS, 128)),
    ("whisper-large-v3", (1, 20, 20, WHISPER_PROMPT, 64)))
# K1's launch-plan sweep at the main grid: y_tile (None = K1's own) by the
# plan's x chunk and these
K1_SWEEP_TILES = (None, 4, 16)
K1_SWEEP_CHUNKS = (64, 256, 1024)
# the band exchange (K7): loopback meshes on the one card, both dims, depth
# 1 to multi-hop (L = 3 with depth 7: three hops a side)
BAND_CASES = (  # nx, ny, axis, dim, shard shape, depth
    (1, 2, "y", 1, (5, 6, 8), 1), (1, 2, "y", 0, (6, 4, 12), 3),
    (2, 1, "x", 0, (4, 6, 8), 2), (2, 1, "x", 1, (4, 5, 8), 4),
    (2, 2, "x", 0, (4, 6, 8), 4), (2, 2, "y", 1, (12, 4, 12), 4),
    (1, 4, "y", 1, (5, 3, 4), 7), (1, 4, "y", 1, (4, 3, 5), 2),
    (3, 1, "x", 0, (3, 5, 6), 7), (3, 1, "x", 1, (4, 3, 6), 5))
BAND_BLOCKS = 4          # blocks in a row on the same slabs and counters
BAND_FILL = -3.5         # what a recv slot holds before any block writes it
DIST_MESH = (2, 2)       # the distributed path: the 67M grid on 4 shards
DIST_BLOCKS = MAIN_SUBSTEPS // MAIN_T
DIST_SPEC_BLOCKS = 2     # the spec-driven run: two blocks of each pass
# the stencil serving tier: serve.py's traffic at its full shape
# (`STENCIL_SHAPES[False]`, dt `STENCIL_DT`), then slots of the paper's
# Figs. 3 and 5 grid, each clean and under the fault plan below; the CPU
# run each is held to serves the same jobs cropped to `SERVE_MIRROR`
SERVE_FAULT_PLAN = "nan_poison@1:slot=1;device_loss@2:reshard_to=1"
SERVE_BATCH = 4
SERVE_WIDE_BATCH = 8
SERVE_REQUESTS = 8
SERVE_MAX_NEW = 16
SERVE_PAPER_SLOT = (512, 512, 64)
SERVE_PAPER_REQUESTS = 8
SERVE_PAPER_MAX_NEW = 4
SERVE_MIRROR = (12, 16)
TRAIN_ARCH = "qwen3-32b"
TRAIN_DEPTH = 4              # of 64 layers: 3.51 B params, 56.2 GB of state
TRAIN_STEPS = 20             # train.py's defaults otherwise: batch 8, seq 128
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 128, 3e-3
TRAIN_TIMED = 5              # steps timed by events after the loop
GATE_SEQ = 2048              # phase 30: two flash chunks of attn_chunk 1024
GATE_ACCUM = (2, 1024)       # batch, seq of the grad_accum gate
LOSS_REL = 1e-5              # x max(1, |loss|): port against port, f32
FLASH_GRAD_REL = 1e-4        # flash vs chunked, x each leaf's max |grad|;
#                              PERF.md: from a reduced-width CPU rehearsal
ORDER_GRAD_REL = 3e-3        # x each leaf's max |grad|: the same f32 sums
#                              in two orders (card vs CPU, grad_accum 2 vs
#                              1); the CPU tests' port-vs-JAX bound, whose
#                              worst leaf reads 1.4e-3
FAMILY_TRAIN = (("falcon-mamba-7b", {}),
                ("recurrentgemma-9b", dict(n_layers=7, scan_group=1)),
                ("arctic-480b", {}), ("qwen2-vl-72b", {}),
                ("whisper-large-v3", {}))
RESUME_DEPTH, RESUME_STEPS, RESUME_KILL, RESUME_EVERY = 4, 6, 3, 2


class Checks:
    def __init__(self):
        self.failed = []
        self.count = 0

    def __call__(self, ok: bool, label: str) -> None:
        print(f"[{'ok' if ok else 'FAIL'}] {label}", flush=True)
        self.count += 1
        if not ok:
            self.failed.append(label)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rand_fields(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return REF.fields_from_numpy(*(rng.normal(size=shape) for _ in range(3)),
                                 dtype=dtype, device="cuda")


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def plain_fused(u, v, w, p, T, xm=None, ym=None, dt=DT):
    """The plain version on one (X, Y, Z) domain."""
    X, Y = u.shape[0], u.shape[1]
    ones = lambda n: torch.ones(n, device=u.device)  # noqa: E731
    out = K._advect_fused_plain(u[None], v[None], w[None], p, T, dt,
                                ones(X) if xm is None else xm,
                                ones(Y) if ym is None else ym)
    return tuple(o[0] for o in out)


def time_ms(fn, runs=TIMED_RUNS, warmup=WARMUP) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def small_shape_phase(check: Checks) -> None:
    for si, shape in enumerate(SMALL_SHAPES):
        X, Y, Z = shape
        u, v, w = rand_fields(shape, seed=si)
        p = REF.default_params(Z, device="cuda")
        for T in (1, 2, 4):
            plain = plain_fused(u, v, w, p, T)
            full = K.advect_fused(u, v, w, p, T=T, dt=DT)
            torch.cuda.synchronize()
            check(same(full, plain), f"K1 == plain {shape} T={T}")
            for y_tile in (4, 5, 7):
                tiled = K.advect_fused(u, v, w, p, T=T, dt=DT, y_tile=y_tile)
                check(same(tiled, full),
                      f"K1 tiled == untiled {shape} T={T} y_tile={y_tile}")
    # the f64 oracle
    u, v, w = rand_fields((6, 10, 12), seed=0)
    p = REF.default_params(12, device="cuda")
    out = K.advect_fused(u, v, w, p, T=4, dt=DT)
    oracle = REF.pw_multistep_ref_f64(u, v, w, p, 4, DT)
    err = max(float((a.double() - b).abs().max()) for a, b in zip(out, oracle))
    check(err < ORACLE_TOL, f"K1 vs f64 oracle T=4: {err:.3e} < {ORACLE_TOL}")
    # x and y interior masks
    X, Y, Z, T = 8, 12, 10, 3
    u, v, w = rand_fields((X, Y, Z), seed=8)
    p = REF.default_params(Z, device="cuda")
    xm = torch.ones(X, device="cuda")
    xm[:3] = 0.0
    ym = torch.ones(Y, device="cuda")
    ym[7:] = 0.0
    ones = K.advect_fused(u, v, w, p, T=T, dt=DT,
                          x_interior_mask=torch.ones(X, device="cuda"))
    check(same(ones, K.advect_fused(u, v, w, p, T=T, dt=DT)),
          "all-ones x mask is a bitwise no-op")
    masked = K.advect_fused(u, v, w, p, T=T, dt=DT, x_interior_mask=xm,
                            y_interior_mask=ym)
    check(same(masked, plain_fused(u, v, w, p, T, xm, ym)),
          "K1 masked == plain masked loop")
    tiled = K.advect_fused(u, v, w, p, T=T, dt=DT, y_tile=4,
                           x_interior_mask=xm, y_interior_mask=ym)
    check(same(tiled, masked), "K1 masked tiled == untiled")
    # T beyond the build runs as passes; rows too wide for one block, and
    # z chunks forced on a narrow one, run in z windows
    X, Y, Z = SMALL_SHAPES[1]
    u, v, w = rand_fields((X, Y, Z), seed=9)
    p = REF.default_params(Z, device="cuda")
    for T in (10, 14):
        check(same(K.advect_fused(u, v, w, p, T=T, dt=DT, y_tile=5),
                   plain_fused(u, v, w, p, T)),
              f"K1 at T={T} ({K.fused_passes(T)} passes) == plain")
    rest = (K._slot_params(p, 1, Z, "cuda"), 4, DT,
            torch.ones(X, device="cuda"), torch.ones(Y, device="cuda"))
    for CZ in (1, 3, 5):
        plan = K.fused_plan_with_chunks(k1_plan((X, Y, Z), 4, 4), X, Z, 4,
                                        CX=3, CZ=CZ)
        got = K._advect_fused_cuda(u[None], v[None], w[None], *rest,
                                   plan=plan)
        check(same((g[0] for g in got), plain_fused(u, v, w, p, 4)),
              f"K1 in z chunks of {CZ} == plain")
    u, v, w = rand_fields((6, 3, 700), seed=10)
    p = REF.default_params(700, device="cuda")
    check(k1_plan((6, 3, 700), 1).n_cz > 1
          and same(K.advect_fused(u, v, w, p, T=1, dt=DT),
                   plain_fused(u, v, w, p, 1)),
          "K1 on rows of 700 (planned z chunks) == plain")
    batched_phase(check)
    guard_phase(check)
    ladder_small_phase(check)


def ladder_small_phase(check: Checks) -> None:
    """K3 and K2 against their plain version at slice 1's small shapes."""
    for si, shape in enumerate(SMALL_SHAPES):
        u, v, w = rand_fields(shape, seed=50 + si)
        p = REF.default_params(shape[2], device="cuda")
        for fu in (False, True):
            kw = dict(fuse_update=fu, dt=DT)
            plain = K._advect_rung_plain(u, v, w, p, fu, DT)
            k3 = K.advect_blocked(u, v, w, p, **kw)
            k2 = K.advect_dataflow(u, v, w, p, **kw)
            torch.cuda.synchronize()
            tag = f"{shape} fuse_update={fu}"
            check(same(k3, plain), f"K3 blocked on its own plan == plain "
                  f"{tag}")
            check(same(k2, plain), f"K2 dataflow on its own plan == plain "
                  f"{tag}")
            check(same(k2, k3), f"K2 == K3 {tag}")
            for name, fn in (("K3", K.advect_blocked),
                             ("K2", K.advect_dataflow)):
                for y_tile in (3, 4, 5):
                    check(same(fn(u, v, w, p, y_tile=y_tile, **kw), plain),
                          f"{name} tiled == untiled {tag} y_tile={y_tile}")
                    check(same(fn(u, v, w, p, y_tile=y_tile, tiling="host",
                                  **kw), plain),
                          f"{name} host == grid {tag} y_tile={y_tile}")
            for x_chunk in (1, 2, 3):
                got = K._advect_rung_cuda("advect_dataflow", u, v, w, p, 4,
                                          fu, DT, x_chunk=x_chunk)
                check(same(got, plain),
                      f"K2 x-chunks of {x_chunk} == plain {tag}")
        for T in (1, 2, 4):
            grid = K.advect_fused(u, v, w, p, T=T, dt=DT, y_tile=4)
            host = K.advect_fused(u, v, w, p, T=T, dt=DT, y_tile=4,
                                  tiling="host")
            check(same(host, grid), f"K1 host == grid {shape} T={T}")
    for Z in (12, 64):
        shape = (6, 17, Z)
        u, v, w = rand_fields(shape, seed=60 + Z)
        p = REF.default_params(Z, device="cuda")
        for fu in (False, True):
            kw = dict(fuse_update=fu, dt=DT)
            k2 = K.advect_dataflow(u, v, w, p, **kw)
            tag = f"{shape} fuse_update={fu}"
            check(same(K.advect_wide(u, v, w, p, **kw), k2),
                  f"K2 wide == dataflow {tag}")
            for y_tile in (3, 4, 5):
                check(same(K.advect_wide(u, v, w, p, y_tile=y_tile, **kw),
                           k2), f"K2 wide tiled == untiled {tag} "
                      f"y_tile={y_tile}")
            for x_chunk in (1, 2, 3):
                got = K._advect_rung_cuda("advect_wide", u, v, w, p, 5, fu,
                                          DT, x_chunk=x_chunk)
                check(same(got, k2), f"K2 wide x-chunks of {x_chunk} == "
                      f"dataflow {tag}")
    u, v, w = rand_fields((6, 10, 10), seed=70)
    try:
        K.advect_wide(u, v, w, REF.default_params(10, device="cuda"))
        refused = False
    except ValueError as err:
        refused = "multiple of 16" in str(err)
    check(refused, "wide refuses Z = 10 (a row of 40 B), naming the rule")
    rung_plan_small_phase(check)


def rung_plan_small_phase(check: Checks) -> None:
    """The rungs' own plans and given plans at small shapes, == plain
    bitwise: sub-tiles and x remainders, fields 4 bytes past an allocation
    (the 4-byte cp.async path takes any 4-byte-aligned field), the shape
    the old slab refused."""
    for si, (shape, y_tile, x_chunk) in enumerate(RUNG_PLAN_CASES):
        X, Y, Z = shape
        u, v, w = rand_fields(shape, seed=80 + si)
        p = REF.default_params(Z, device="cuda")
        for name in RUNGS:
            if name == "advect_wide" and Z % 4:
                continue
            plan = K.rung_device_plan("cuda:0", name, X, Y, Z, y_tile,
                                      x_chunk)
            given = K._grid_geometry(Y, y_tile, 1)[0]
            what = (f"{name} {shape} y_tile={y_tile} (plan TY={plan.TY}"
                    f"{', sub-tiles' if plan.TY < given else ''}) "
                    f"x_chunk={x_chunk} (CX={plan.CX}, {X % plan.CX} over)")
            for fu in (False, True):
                got = K._advect_rung_cuda(name, u, v, w, p, y_tile, fu, DT,
                                          x_chunk=x_chunk)
                check(same(got, K._advect_rung_plain(u, v, w, p, fu, DT)),
                      f"{what} fuse_update={fu} == plain")
    for shape in ((6, 10, 12), (5, 17, 12), (8, 12, 10), (7, 9, 64)):
        X, Y, Z = shape
        u, v, w = rand_fields(shape, seed=90 + Z)
        p = REF.default_params(Z, device="cuda")
        n = X * Y * Z
        bufs = [torch.empty(n + 1, device="cuda") for _ in range(3)]
        off = [b[1:].view(shape) for b in bufs]   # 4 bytes past the start
        for o, f in zip(off, (u, v, w)):
            o.copy_(f)
        for name in ("advect_blocked", "advect_dataflow"):
            for fu in (False, True):
                got = getattr(K, name)(*off, p, fuse_update=fu, dt=DT)
                check(same(got, K._advect_rung_plain(u, v, w, p, fu, DT)),
                      f"{name} {shape} on fields 4 bytes past an allocation"
                      f" fuse_update={fu} == plain")
    u, v, w = rand_fields((3, 1024, 64), seed=95)
    p = REF.default_params(64, device="cuda")
    for name in RUNGS:
        for y_tile in (None, 99):
            plan = K.rung_device_plan("cuda:0", name, 3, 1024, 64, y_tile)
            got = getattr(K, name)(u, v, w, p, y_tile=y_tile,
                                   fuse_update=True, dt=DT)
            check(same(got, K._advect_rung_plain(u, v, w, p, True, DT)),
                  f"{name} (3, 1024, 64) y_tile={y_tile} on its plan "
                  f"(TY={plan.TY}, {plan.shared_bytes} B) == plain")


LEAF_BASE_NDIM = {"tcx": 0, "tcy": 0, "tzc1": 1, "tzc2": 1}


def slot_params(p, b):
    """Slot b's own params out of batched ones: a leaf with the slot axis is
    indexed, a shared leaf is kept."""
    return REF.AdvectParams(**{
        n: getattr(p, n)[b] if getattr(p, n).ndim > nd else getattr(p, n)
        for n, nd in LEAF_BASE_NDIM.items()})


def batched_phase(check: Checks) -> None:
    """B = 3 slots with per-slot params and masks; slot 2 carries a smaller
    (4, 11, Z) request padded into the slot shape. Then each single leaf of
    the params per-slot with the others shared, the kernel reading one
    parameter table for all four."""
    B, X, Y, Z, T = 3, 5, 17, 12, 2
    Xr, Yr = 4, 11
    fields = [rand_fields((X, Y, Z), seed=20 + b) for b in range(B)]
    small = rand_fields((Xr, Yr, Z), seed=30)
    for f, s in zip(fields[2], small):
        f.zero_()
        f[:Xr, :Yr] = s
    u, v, w = (torch.stack([fl[i] for fl in fields]) for i in range(3))
    base = REF.default_params(Z, device="cuda")
    scale = torch.tensor([1.0, 1.5, 0.5], device="cuda")
    p = REF.AdvectParams(base.tcx * scale, base.tcy * scale,
                         base.tzc1[None] * scale[:, None], base.tzc2)
    xm = torch.ones(B, X, device="cuda")
    ym = torch.ones(B, Y, device="cuda")
    xm[1, 2] = 0.0
    ym[0, 5:9] = 0.0
    xm[2] = (torch.arange(X, device="cuda") <= Xr - 2).float()
    xm[2, 0] = 0.0
    ym[2] = ((torch.arange(Y, device="cuda") >= 1)
             & (torch.arange(Y, device="cuda") <= Yr - 2)).float()
    for y_tile in (None, 5):
        out = K.advect_fused_batched(u, v, w, p, T=T, dt=DT, y_tile=y_tile,
                                     x_interior_mask=xm, y_interior_mask=ym)
        for b in range(B):
            seq = K.advect_fused(u[b], v[b], w[b], slot_params(p, b), T=T,
                                 dt=DT, y_tile=y_tile, x_interior_mask=xm[b],
                                 y_interior_mask=ym[b])
            check(same([o[b] for o in out], seq),
                  f"K5 batched slot {b} == sequential, y_tile={y_tile}")
        alone = K.advect_fused(*small, slot_params(p, 2), T=T, dt=DT)
        check(same([o[2, :Xr, :Yr] for o in out], alone),
              f"K5 padded request == its unpadded run, y_tile={y_tile}")
    for leaf, nd in LEAF_BASE_NDIM.items():
        base_leaf = getattr(base, leaf)
        one = base._replace(**{leaf: torch.stack([base_leaf * s
                                                  for s in scale])})
        assert getattr(one, leaf).ndim == nd + 1
        out = K.advect_fused_batched(u, v, w, one, T=T, dt=DT, y_tile=5,
                                     x_interior_mask=xm, y_interior_mask=ym)
        seq = [K.advect_fused(u[b], v[b], w[b], slot_params(one, b), T=T,
                              dt=DT, y_tile=5, x_interior_mask=xm[b],
                              y_interior_mask=ym[b]) for b in range(B)]
        check(all(same([o[b] for o in out], seq[b]) for b in range(B)),
              f"K5 only {leaf} per-slot == sequential, every slot")
        plain = K._advect_fused_plain(u, v, w, K._slot_params(one, B, Z,
                                                              "cuda"),
                                      T, DT, xm, ym)
        check(same(out, plain), f"K5 only {leaf} per-slot == plain version")


def guard_phase(check: Checks) -> None:
    X, Y, Z, T = 8, 16, 64, 2
    u, v, w = rand_fields((X, Y, Z), seed=40)
    p = REF.default_params(Z, device="cuda")
    plain_out = K.advect_fused(u, v, w, p, T=T, dt=DT)
    gu, gv, gw, flags = K.advect_fused(u, v, w, p, T=T, dt=DT, guard=True)
    check(same((gu, gv, gw), plain_out), "guarded == unguarded outputs")
    check(bool(torch.all(flags == 1.0)) and flags.shape == (X,),
          "guard flags all 1 on finite fields")
    bad = [f.clone() for f in (u, v, w)]
    bad[0][2, 3, 5] = float("nan")
    bad[2][5, 0, 0] = float("inf")
    bad[1][7, 15, 63] = float("-inf")
    got = K.finite_guard(*bad)
    want = K._finite_guard_plain(*bad)
    check(torch.equal(got, want) and got.tolist()
          == [1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 0.0],
          "K4 flags == plain flags with NaN/Inf planted")
    stacked = [torch.stack([f, g, f]) for f, g in zip((u, v, w), bad)]
    got = K.finite_guard(*stacked)
    check(torch.equal(got, K._finite_guard_plain(*stacked)),
          "K4 batched flags == plain")
    odd = [f[:, :15, :61].contiguous() for f in bad]    # Y*Z % 4 != 0
    check(torch.equal(K.finite_guard(*odd), K._finite_guard_plain(*odd)),
          "K4 flags == plain on the scalar-load path")


def main_path_phase(check: Checks):
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T, dt=DT,
                          device="cuda")
    u0, v0, w0 = dom.init(seed=0)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = dom.advance(u0, v0, w0, MAIN_SUBSTEPS)
    flags = K.finite_guard(*out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    path = ("advect_fused", "finite_guard")
    print(f"main path: {MAIN_GRID} grid {(X, Y, Z)}, advance({MAIN_SUBSTEPS})"
          f" with fuse_T={MAIN_T}, y_tile={dom.run_y_tile} (K1 plans: "
          f"{k1_plan_text(k1_plan((X, Y, Z), MAIN_T))}); wall {wall:.3f} s;"
          f" launches {launches}", flush=True)
    for name, n in launches.items():
        check((n > 0) == (name in path),
              f"{name} launched {n} times on the main path")
    check(launches["advect_fused"] == MAIN_SUBSTEPS // MAIN_T,
          "advect_fused launched once per fused pass")
    check(all(o.shape == (X, Y, Z) and bool(torch.isfinite(o).all())
              for o in out), "main-path outputs finite, of shape (X, Y, Z)")
    check(flags.shape == (X,) and bool(torch.all(flags == 1.0)),
          "finite_guard flags all 1")
    for f0, fT in zip((u0, v0, w0), out):
        check(frozen_edges(f0, fT), "boundary planes unchanged")
    plain = plain_fused(u0, v0, w0, dom.params, MAIN_SUBSTEPS)
    k1_err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
    check(k1_err == 0.0, f"main path == plain version, bitwise ({k1_err})")
    del plain
    k4_err = float((flags - K._finite_guard_plain(*out)).abs().max())
    check(k4_err == 0.0, "main-path guard flags == plain flags")
    moved = max(float((a - b).abs().max())
                for a, b in zip(out, (u0, v0, w0)))
    check(moved > 0.0, f"the fields moved (max change {moved:.3e})")
    return dom, (u0, v0, w0), out, launches, k1_err, k4_err


def k1_plan(shape, T, y_tile=None):
    """K1's launch plan on cuda:0 for one (X, Y, Z) domain, as its wrapper
    makes it."""
    return K.fused_device_plan("cuda:0", *shape, T, 1, y_tile)


def k1_plan_text(plan, T=MAIN_T) -> str:
    a = K.fused_kernel_attrs("cuda:0", T, plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"TY={plan.TY} (slab {plan.S} rows), CX={plan.CX}, "
            f"CZ={plan.CZ} (window {plan.W}, {plan.n_cz} z chunks), "
            f"{plan.grid[0] * plan.grid[1]} blocks of {plan.threads} threads"
            f" x {plan.cells_per_thread} cells on {sms} SMs, "
            f"{a['blocks_per_sm']} resident per SM, {plan.shared_bytes} B "
            f"shared, {a['registers']} registers, {a['local_bytes']} B "
            f"spilled per thread")


def k6_plan_text(spec, shape, T, y_tile=None) -> str:
    """K6's launch plan on cuda:0 for one pass of T steps of `spec` over
    one (X, Y, Z) domain, as its wrapper makes it, with what the card says
    of the build that runs it."""
    plan = K.spec_device_plan("cuda:0", *shape, spec, T, 1, y_tile)
    a = K.spec_kernel_attrs("cuda:0", spec, T, plan)
    return (f"TY={plan.TY} (slab {plan.S} rows), CX={plan.CX}, "
            f"CZ={plan.CZ} (window {plan.W}, {plan.n_cz} z chunks), "
            f"{plan.grid[0] * plan.grid[1]} blocks of {plan.threads} threads"
            f" x {plan.cells_per_thread} cells, {a['blocks_per_sm']} "
            f"resident per SM, {plan.shared_bytes} B shared, "
            f"{a['registers']} registers, {a['local_bytes']} B spilled per "
            f"thread")


def rung_plan_text(name, shape, y_tile=None, x_chunk=None) -> str:
    """The v1-v3 kernel `name`'s launch plan on cuda:0 for one (X, Y, Z)
    domain, as its wrapper makes it, with what the card says of it."""
    plan = K.rung_device_plan("cuda:0", name, *shape, y_tile, x_chunk)
    a = K.rung_kernel_attrs("cuda:0", name, plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"TY={plan.TY} (slab {plan.S} rows), CX={plan.CX}, "
            f"{plan.planes} planes a field, "
            f"{plan.grid[0] * plan.grid[1]} blocks of {plan.threads} threads "
            f"on {sms} SMs, {a['blocks_per_sm']} resident per SM, "
            f"{plan.shared_bytes} B shared, {a['registers']} registers, "
            f"{a['local_bytes']} B spilled per thread")


def frozen_edges(f0, fT) -> bool:
    return (fT[0].equal(f0[0]) and fT[-1].equal(f0[-1])
            and fT[:, 0].equal(f0[:, 0]) and fT[:, -1].equal(f0[:, -1])
            and fT[:, :, 0].equal(f0[:, :, 0])
            and fT[:, :, -1].equal(f0[:, :, -1]))


def ladder_path_phase(check: Checks, fields):
    """Each v1-v3 rung through the domain at the 67M grid, with and without
    `fuse_update`; returns {kernel: (launches in its `fuse_update=True`
    run, max_abs_err over both runs)}."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    u0, v0, w0 = fields
    p = REF.default_params(Z, device="cuda")
    plain = (u0, v0, w0)
    for _ in range(LADDER_SUBSTEPS):
        plain = REF.pw_step_ref(*plain, p, DT)
    results = {}
    for name, variant in RUNGS.items():
        errs = []
        for fu in (False, True):
            dom = AdvectionDomain(X, Y, Z, variant=variant, fuse_update=fu,
                                  dt=DT, device="cuda")
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            out = dom.advance(u0, v0, w0, LADDER_SUBSTEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            tag = f"{variant} fuse_update={fu}"
            print(f"ladder path: {tag}: {MAIN_GRID} grid {(X, Y, Z)}, "
                  f"advance({LADDER_SUBSTEPS}), y_tile={dom.run_y_tile} "
                  f"(the reference's slab model {dom.vmem_register_bytes()} "
                  f"B), run on {name}'s plan: "
                  f"{rung_plan_text(name, (X, Y, Z), dom.run_y_tile)}; "
                  f"wall {wall:.3f} s; launches {launches}", flush=True)
            check(all((n == LADDER_SUBSTEPS) if k == name else n == 0
                      for k, n in launches.items()),
                  f"{tag}: {name} launched {LADDER_SUBSTEPS} times, no other "
                  f"kernel")
            err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
            check(err == 0.0, f"{tag}: == plain version, bitwise ({err})")
            check(all(frozen_edges(f0, fT) for f0, fT in zip(fields, out)),
                  f"{tag}: boundary planes unchanged")
            errs.append(err)
            del out
        results[name] = (launches[name], max(errs))
    return results


def timing_phase(check: Checks, dom, fields, out, launches, k1_err, k4_err,
                 ladder):
    X, Y, Z = dom.X, dom.Y, dom.Z
    u, v, w = fields
    p, T, cells = dom.params, dom.fuse_T, X * Y * Z
    ones_x = torch.ones(X, device="cuda")
    ones_y = torch.ones(Y, device="cuda")
    k1_ms = time_ms(lambda: K.advect_fused(u, v, w, p, T=T, dt=DT))
    k1_plain = time_ms(lambda: K._advect_fused_plain(
        u[None], v[None], w[None], p, T, DT, ones_x, ones_y), runs=10)
    k4_ms = time_ms(lambda: K.finite_guard(*out))
    k4_plain = time_ms(lambda: K._finite_guard_plain(*out))
    # bounds: each input read once, each output written once; operations
    # are the function's: 63 per interior cell and the 2-op update of each
    # of 3 fields per cell, per step (K1), one test per word (K4)
    k1_bytes = 6 * cells * 4 + 2 * (Z + 2) * 4 + (X + Y) * 4
    k1_ops = T * ((X - 2) * (Y - 2) * (Z - 2) * REF.flops_per_cell()
                  + 6 * cells)
    k4_bytes = R.guard_bytes_model(X, Y, Z)
    k4_ops = 3 * cells
    k1_dev = profiled_kernels(
        lambda: K.advect_fused(u, v, w, p, T=T, dt=DT), "advect_ring_kernel",
        ("cuda:0",), 10)[0]
    dev = (f"{k1_dev:.4f} ms per pass (torch.profiler, 10 passes; "
           f"{bound_of(k1_bytes, k1_ops)[0] / k1_dev:.4f} of the bound)"
           if k1_dev > 0 else "not measured")
    print(f"advect_fused plan at {(X, Y, Z)}, T={T}: "
          f"{k1_plan_text(k1_plan((X, Y, Z), T), T)}; the kernel's device "
          f"time {dev} against {k1_ms:.4f} ms by events around the whole "
          f"call", flush=True)
    records = [
        kernel_record("advect_fused", k1_ms, k1_plain, k1_bytes, k1_ops,
                      launches["advect_fused"], k1_err),
        kernel_record("finite_guard", k4_ms, k4_plain, k4_bytes, k4_ops,
                      launches["finite_guard"], k4_err)]
    # the v1-v3 rungs, each on its own plan (the domain's tile 64 runs as
    # the same sub-tiles): each reads and writes the three fields once and
    # reads the parameter row; 63 ops per interior cell, plus the 2-op
    # update of 3 fields per cell with fuse_update
    rung_bytes = 6 * cells * 4 + (2 + 2 * Z) * 4
    src_ops = (X - 2) * (Y - 2) * (Z - 2) * REF.flops_per_cell()
    rung_plain = time_ms(lambda: K._advect_rung_plain(u, v, w, p, True, DT),
                         runs=5)
    for name, variant in RUNGS.items():
        fn = getattr(K, name)
        src_ms = time_ms(lambda: fn(u, v, w, p))
        print(f"{name} sources only: {src_ms:.4f} ms per launch, bound "
              f"{bound_of(rung_bytes, src_ops)[0]:.4f} ms", flush=True)

        def call():
            return fn(u, v, w, p, fuse_update=True, dt=DT)

        ms = time_ms(call)
        dev, seen = profiled_kernels(call, RUNG_KERNEL[name], ("cuda:0",), 10)
        bound = bound_of(rung_bytes, src_ops + 6 * cells)[0]
        device = (f"{dev:.4f} ms ({seen} of 10 launches seen; "
                  f"{bound / dev:.4f} of the bound)" if dev > 0
                  else "not measured")
        print(f"{name} on its own plan ({rung_plan_text(name, (X, Y, Z))}): "
              f"{ms:.4f} ms by events, device {device}", flush=True)
        n, err = ladder[name]
        records.append(kernel_record(name, ms, rung_plain, rung_bytes,
                                     src_ops + 6 * cells, n, err))
        records[-1]["device_ms"] = dev if dev > 0 else None
    # the ladder per Euler step through the domain; without fuse_update the
    # step pays the separate f + dt*s pass. One step must read and write
    # the three fields once (the rung's bound); K1 shares that over T steps
    for variant in RUNGS.values():
        for fu in (False, True):
            rdom = AdvectionDomain(X, Y, Z, variant=variant, fuse_update=fu,
                                   dt=DT, device="cuda")
            step_ms = time_ms(lambda: rdom.step(u, v, w))
            ladder_line(f"{variant} fuse_update={fu}", step_ms,
                        rdom.hbm_bytes_per_step(),
                        bound_of(rung_bytes, src_ops + 6 * cells)[0])
    ladder_line(f"fused T={T} (K1 pass / T)", k1_ms / T,
                dom.hbm_bytes_per_step() / T,
                bound_of(k1_bytes, k1_ops)[0] / T)
    v2 = AdvectionDomain(X, Y, Z, variant="dataflow", fuse_update=True,
                         dt=DT, device="cuda")
    v2_ms = time_ms(lambda: v2.step(u, v, w))
    v4_ms = time_ms(lambda: dom.step(u, v, w)) / T
    print(f"Fig. 3 ladder on the card: fused T={T} {v4_ms:.4f} ms per Euler "
          f"step (domain step / T) against dataflow fuse_update=True "
          f"{v2_ms:.4f}: the fused rung "
          f"{'beats' if v4_ms < v2_ms else 'does not beat'} v2 "
          f"({v2_ms / v4_ms:.3f}x)", flush=True)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dom.advance(u, v, w, MAIN_SUBSTEPS)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"main path: advance({MAIN_SUBSTEPS}) {statistics.median(walls):.4f}"
          f" ms of wall time (median of 5 after the checked run; "
          f"{MAIN_SUBSTEPS // T} K1 passes back to back)", flush=True)
    k1_sweep(check, u, v, w, p, T, k1_bytes, k1_ops)
    rung_sweep(check, u, v, w, p, bound_of(rung_bytes, src_ops + 6 * cells)[0])
    return records


def rung_sweep(check: Checks, u, v, w, p, bound: float) -> None:
    """The rungs' launch plans at the main grid (`RUNG_SWEEP_TILES` by
    `RUNG_SWEEP_CHUNKS`, each distinct plan once), each with `fuse_update`
    timed (events, median of 10; device time by `torch.profiler`) and its
    output held against the planned one."""
    X, Y, Z = u.shape
    for name in RUNGS:
        want = K._advect_rung_cuda(name, u, v, w, p, None, True, DT)
        seen = set()
        for y_tile in RUNG_SWEEP_TILES:
            for x_chunk in RUNG_SWEEP_CHUNKS:
                plan = K.rung_device_plan("cuda:0", name, X, Y, Z, y_tile,
                                          x_chunk)
                if (plan.TY, plan.CX) in seen:
                    continue
                seen.add((plan.TY, plan.CX))
                rung_sweep_case(check, name, (u, v, w), p, y_tile, x_chunk,
                                want, bound)


def rung_sweep_case(check: Checks, name, fields, p, y_tile, x_chunk, want,
                    bound: float) -> None:
    """One case of `rung_sweep`: the rung at `y_tile` and `x_chunk`."""

    def run():
        return K._advect_rung_cuda(name, *fields, p, y_tile, True, DT,
                                   x_chunk=x_chunk)

    shape = tuple(fields[0].shape)
    plan = K.rung_device_plan("cuda:0", name, *shape, y_tile, x_chunk)
    own = " (the rung's own plan)" if y_tile is None and x_chunk is None \
        else ""
    check(same(run(), want), f"{name} plan TY={plan.TY} CX={plan.CX} "
          f"(y_tile={y_tile}, x_chunk={x_chunk}) == the planned output, "
          f"bitwise{own}")
    ms = time_ms(run, runs=10)
    dev = profiled_kernels(run, RUNG_KERNEL[name], ("cuda:0",), 10)[0]
    print(f"{name} plan sweep: y_tile={y_tile}, x_chunk={x_chunk}: "
          f"{rung_plan_text(name, shape, y_tile, x_chunk)}:"
          f" {ms:.4f} ms by events, device {dev:.4f} ms, "
          f"{bound / dev if dev > 0 else 0.0:.4f} of the bound by "
          f"device{own}", flush=True)


def k1_sweep(check: Checks, u, v, w, p, T, nbytes, ops) -> None:
    """K1's launch plans at the main grid: y-tiles by x-chunk lengths, each
    timed (median of 10) and its output held against the planned one."""
    X, Y, Z = u.shape
    fields = [f[None] for f in (u, v, w)]
    rest = (K._slot_params(p, 1, Z, "cuda"), T, DT,
            torch.ones(X, device="cuda"), torch.ones(Y, device="cuda"))

    def run(plan=None):
        return K._advect_fused_cuda(*fields, *rest, plan=plan)

    want = run()
    bound = bound_of(nbytes, ops)[0]
    for y_tile in K1_SWEEP_TILES:
        base = k1_plan((X, Y, Z), T, y_tile)
        for CX in dict.fromkeys((base.CX,) + K1_SWEEP_CHUNKS):
            plan = K.fused_plan_with_chunks(base, X, Z, T, CX=CX)
            tag = " (K1's own plan)" if y_tile is None and CX == base.CX \
                else ""
            check(same(run(plan), want), f"K1 plan TY={plan.TY} "
                  f"CX={plan.CX} == the planned output, bitwise{tag}")
            ms = time_ms(lambda: run(plan), runs=10)
            print(f"K1 plan sweep: {k1_plan_text(plan, T)}: {ms:.4f} ms per "
                  f"pass, {bound / ms:.4f} of the bound{tag}", flush=True)


def bound_of(nbytes: int, ops: int, peak: float = R.PEAK_FLOPS_F32):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its peak rate for their
    type (`peak`: f32 by default, `R.PEAK_FLOPS_BF16_SIMT` for ops that
    round to bf16)."""
    t_bytes = nbytes / R.HBM_BW * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_record(name, ms, plain_ms, nbytes, ops, launches, err,
                  peak: float = R.PEAK_FLOPS_F32) -> dict:
    bound, bound_by = bound_of(nbytes, ops, peak)
    kind = "bf16" if peak == R.PEAK_FLOPS_BF16_SIMT else "f32"
    print(f"{name}: {ms:.4f} ms per launch (median of {TIMED_RUNS}), "
          f"bound {bound:.4f} ms by {bound_by} ({nbytes} B at "
          f"{R.HBM_BW:.3g} B/s: {nbytes / R.HBM_BW * 1e3:.4f} ms; {ops} "
          f"{kind} ops at {peak:.4g}/s: {ops / peak * 1e3:.4f} ms), "
          f"{nbytes / ms / 1e6:.1f} GB/s achieved, {bound / ms:.3f} of the "
          f"bound; plain version {plain_ms:.4f} ms; no single PyTorch call "
          f"computes this function, so no library time", flush=True)
    return {"name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def ladder_line(what: str, step_ms: float, step_bytes: float,
                bound_ms: float) -> None:
    print(f"Fig. 3 ladder on the card: {what}: {step_ms:.4f} ms per Euler "
          f"step (median of {TIMED_RUNS}), bound {bound_ms:.4f} ms, "
          f"modelled {step_bytes:.0f} B per step, "
          f"{step_bytes / step_ms / 1e6:.1f} GB/s at the modelled bytes",
          flush=True)


# ---------------------------------------------------------------------------
# the spec ring (K6)
# ---------------------------------------------------------------------------


def spec_inputs(op: str, shape, seed: int):
    """(params, fields) of one operator at a small shape on the card:
    normal velocities (and tracer), a 300 +- 1 temperature-like phi."""
    X, Y, Z = shape
    rng = np.random.default_rng(seed)
    if op == "diffusion":
        return (SP.default_diffusion_params(Z, device="cuda"),
                REF.fields_from_numpy(300.0 + rng.normal(size=shape),
                                      device="cuda"))
    n = 4 if op == "tracer" else 3
    return (REF.default_params(Z, device="cuda"),
            REF.fields_from_numpy(*(rng.normal(size=shape)
                                    for _ in range(n)), device="cuda"))


def plain_spec(fields, params, spec, T, dt, xm=None, ym=None):
    """The plain version on one (X, Y, Z) domain."""
    X, Y = fields[0].shape[0], fields[0].shape[1]
    ones = lambda n: torch.ones(n, device="cuda")  # noqa: E731
    pv = K._spec_param_vectors(spec, params, "cuda", fields[0].dtype)
    out = K._stencil_fused_plain([f[None] for f in fields], pv, spec, T, dt,
                                 ones(X) if xm is None else xm,
                                 ones(Y) if ym is None else ym)
    return tuple(o[0] for o in out)


def oracle_err(out, fields, params, spec, T, dt):
    """(max abs error against the f64 oracle, the oracle's field scale, the
    oracle's max change from `fields`)."""
    oracle = SP.spec_multistep_ref_f64(fields, params, spec, T, dt)
    err = max(float((a.double() - b).abs().max())
              for a, b in zip(out, oracle))
    scale = max(1.0, max(float(b.abs().max()) for b in oracle))
    moved = max(float((b - a.double()).abs().max())
                for a, b in zip(fields, oracle))
    return err, scale, moved


def spec_small_phase(check: Checks) -> None:
    """K6 against its plain version, K1 and the f64 oracle at small shapes,
    for every shipped operator x integrator; one line per check kind, shape
    and operator, over T in {1, 2, 3}, y_tile in {None, 3, 5} and with and
    without interior masks (18 runs each). The oracle check also asks that
    the update exceed 5x its tolerance, so that it fails a no-op."""
    for si, shape in enumerate(SMALL_SHAPES):
        X, Y, Z = shape
        xm = torch.ones(X, device="cuda")
        ym = torch.ones(Y, device="cuda")
        xm[2] = 0.0
        ym[3:5] = 0.0
        inputs = {op: spec_inputs(op, shape, 100 + si) for op in SPEC_FACTORIES}
        # the tracer's velocities are the PW spec's
        inputs["tracer"] = (inputs["tracer"][0],
                            inputs["pw"][1] + inputs["tracer"][1][3:])
        outs = {}
        for op, factory in SPEC_FACTORIES.items():
            params, fields = inputs[op]
            dt = SMALL_DT[op]
            for integ in SP.INTEGRATORS:
                spec = factory(integ)
                tally = {"plain": [], "k1": [], "pw": [], "frozen": [],
                         "oracle": []}
                for T in (1, 2, 3):
                    for masked in (False, True):
                        mk = dict(x_interior_mask=xm if masked else None,
                                  y_interior_mask=ym if masked else None)
                        plain = plain_spec(fields, params, spec, T, dt,
                                           *(mk.values()))
                        for y_tile in (None, 3, 5):
                            out = K.stencil_fused(fields, params, spec, T=T,
                                                  dt=dt, y_tile=y_tile, **mk)
                            torch.cuda.synchronize()
                            outs[op, integ, T, masked, y_tile] = out
                            tally["plain"].append(same(out, plain))
                            tally["frozen"].append(all(
                                frozen_edges(a, b)
                                for a, b in zip(fields, out)))
                            if op == "pw" and integ == "euler":
                                k1 = K.advect_fused(*fields, params, T=T,
                                                    dt=dt, y_tile=y_tile,
                                                    **mk)
                                tally["k1"].append(same(out, k1))
                            if op == "tracer":
                                tally["pw"].append(same(
                                    out[:3],
                                    outs["pw", integ, T, masked, y_tile]))
                        if not masked:
                            err, scale, moved = oracle_err(
                                plain, fields, params, spec, T, dt)
                            tally["oracle"].append(
                                err <= SPEC_TOL_REL * scale
                                < moved / 5.0)
                tag = f"{spec.name} {shape}"
                check(all(tally["plain"]), f"K6 == plain, bitwise, {tag}: "
                      f"{len(tally['plain'])} runs (T, y_tile, masks)")
                check(all(tally["frozen"]), f"K6 boundary frozen, {tag}")
                check(all(tally["oracle"]), f"K6 within {SPEC_TOL_REL} x "
                      f"scale of the f64 oracle, update > 5x that, {tag}, "
                      f"dt={dt}, T = 1-3")
                if tally["k1"]:
                    check(all(tally["k1"]), f"PW-spec K6 == K1 "
                          f"(advect_fused), bitwise, {tag}: "
                          f"{len(tally['k1'])} runs")
                if tally["pw"]:
                    check(all(tally["pw"]), f"tracer K6 u, v, w == PW-spec "
                          f"K6, bitwise, {tag}: {len(tally['pw'])} runs")
    spec_batched_phase(check)
    spec_refusal_phase(check)
    spec_reach_phase(check)


def spec_batched_phase(check: Checks) -> None:
    """B = 3 slots with per-slot masks through one launch == 3 sequential
    launches, for every operator x integrator."""
    B, shape = 3, (5, 17, 12)
    X, Y, Z = shape
    xm = torch.ones(B, X, device="cuda")
    ym = torch.ones(B, Y, device="cuda")
    xm[1, 2] = 0.0
    ym[2, 5:9] = 0.0
    for op, factory in SPEC_FACTORIES.items():
        slots = [spec_inputs(op, shape, 200 + b) for b in range(B)]
        params = slots[0][0]
        fields = [torch.stack([sl[1][i] for sl in slots])
                  for i in range(len(slots[0][1]))]
        for integ in SP.INTEGRATORS:
            spec = factory(integ)
            ok = []
            for y_tile in (None, 5):
                out = K.stencil_fused_batched(
                    fields, params, spec, T=2, dt=SPEC_DT[op], y_tile=y_tile,
                    x_interior_mask=xm, y_interior_mask=ym)
                for b in range(B):
                    seq = K.stencil_fused(
                        [f[b] for f in fields], params, spec, T=2,
                        dt=SPEC_DT[op], y_tile=y_tile,
                        x_interior_mask=xm[b], y_interior_mask=ym[b])
                    ok.append(same([o[b] for o in out], seq))
            check(all(ok), f"K6 batched (B = {B}, per-slot masks) == "
                  f"sequential, bitwise, {spec.name}, y_tile None and 5")


def spec_refusal_phase(check: Checks) -> None:
    """A radius-2 spec whose z coefficients are cut for radius 1
    (diffusion's callback) is refused on the card with no launch, and a
    radius-1 user spec runs its generated functor (== plain, bitwise); PW
    and tracer rk2 at T = 4, refused before K6 kept its ring in registers,
    run as passes == plain and within `ORACLE_TOL` of f64."""
    custom = SP.StencilSpec(name="custom", fields=("a",),
                            offsets={"a": ((1, 0, 0),)},
                            source=lambda sh, pv: (sh(0, 1, 0, 0),),
                            pack_params=lambda p: ())
    star2 = tuple((d, 0, 0) for d in (-2, -1, 0, 1, 2))
    radius2 = SP.StencilSpec(name="diffusion_r2", fields=("phi",),
                             offsets={"phi": star2},
                             source=SP._diff_source,
                             pack_params=SP._diff_pack)
    dp = SP.default_diffusion_params(8, device="cuda")
    before = dict(K.LAUNCHES)
    try:
        K.stencil_fused([torch.zeros((6, 8, 8), device="cuda")], dp,
                        radius2, T=1)
        refused = False
    except NotImplementedError as err:
        refused = "ROADMAP Queue 2" in str(err)
    check(refused and K.LAUNCHES == before,
          f"a radius-2 spec ({radius2.name}) whose z coefficients are cut "
          f"for radius 1 is refused on the card, naming the queue, with no "
          f"launch")
    a = rand_fields((6, 8, 8), 77)[:1]
    out, launches, _ = counted(lambda: K.stencil_fused(a, None, custom, T=2,
                                                       dt=0.1))
    check(only_these(launches, {"stencil_generated": 1})
          and same(out, plain_spec(a, None, custom, 2, 0.1)),
          f"a radius-1 user spec ({custom.name}) runs its generated functor "
          f"(one launch) == plain, bitwise")
    for op in ("pw", "tracer"):
        spec = SPEC_FACTORIES[op]("rk2")
        for shape in ((4, 1024, 64), SMALL_SHAPES[1]):
            params, fields = spec_inputs(op, shape, 300)
            reset_all_counts()
            out = K.stencil_fused(fields, params, spec, T=4, dt=SPEC_DT[op])
            torch.cuda.synchronize()
            n = K.LAUNCHES["stencil_fused"]
            err, scale, moved = oracle_err(out, fields, params, spec, 4,
                                           SPEC_DT[op])
            check(same(out, plain_spec(fields, params, spec, 4, SPEC_DT[op]))
                  and n == len(K.spec_passes(spec, 4))
                  and err < ORACLE_TOL < moved / 5.0,
                  f"{spec.name} at T = 4 {shape} (the old ring refused it) "
                  f"runs as {n} passes == plain, bitwise; vs f64 oracle "
                  f"{err:.3e} < {ORACLE_TOL}, fields moved {moved:.3e}")


def spec_reach_phase(check: Checks) -> None:
    """K6's reach, each == plain bitwise: T beyond a build's levels as
    passes of whole steps, x and z chunks with remainders on a given plan,
    and a y_tile of the whole Y (no build takes its slab at 1024 rows) ==
    K6's own plan == a small tile."""
    shape = (13, 40, 70)
    X, Y, Z = shape
    for op, factory in SPEC_FACTORIES.items():
        params, fields = spec_inputs(op, shape, 400)
        dt = SMALL_DT[op]
        for integ in SP.INTEGRATORS:
            spec = factory(integ)
            for T in (3, 5):
                reset_all_counts()
                out = K.stencil_fused(fields, params, spec, T=T, dt=dt)
                n = K.LAUNCHES["stencil_fused"]
                passes = K.spec_passes(spec, T)
                check(same(out, plain_spec(fields, params, spec, T, dt))
                      and n == len(passes),
                      f"K6 {spec.name} T={T} as passes {passes} == plain, "
                      f"bitwise")
            T = 2
            L = spec.stages * T
            pv = K._spec_param_vectors(spec, params, "cuda")
            ones = (torch.ones(X, device="cuda"), torch.ones(Y, device="cuda"))
            plain = plain_spec(fields, params, spec, T, dt)
            for TY, CX, CZ in ((5, 4, 9), (3, 6, 20), (7, 13, None)):
                plan = K.fused_plan_with_chunks(
                    K.spec_device_plan("cuda", X, Y, Z, spec, T, 1, TY), X,
                    Z, L, CX=CX, CZ=CZ, knobs=K.spec_plan_knobs(spec, T))
                got = K._stencil_fused_cuda([f[None] for f in fields], pv,
                                            spec, T, dt, *ones, plan=plan)
                check(same((g[0] for g in got), plain),
                      f"K6 {spec.name} T={T} in chunks TY={plan.TY} "
                      f"CX={plan.CX} ({plan.n_cx}) CZ={plan.CZ} "
                      f"({plan.n_cz}) == plain, bitwise")
    for op, factory in SPEC_FACTORIES.items():
        params, fields = spec_inputs(op, (3, 1024, 64), 402)
        spec = factory("euler")
        runs = [K.stencil_fused(fields, params, spec, T=4, dt=SMALL_DT[op],
                                y_tile=y_tile) for y_tile in (1024, None, 3)]
        check(same(runs[0], runs[1]) and same(runs[1], runs[2])
              and same(runs[1], plain_spec(fields, params, spec, 4,
                                           SMALL_DT[op])),
              f"K6 {spec.name} (3, 1024, 64) T=4: y_tile 1024 (sub-tiles "
              f"of {K.spec_device_plan('cuda', 3, 1024, 64, spec, 4, 1, 1024).TY}"
              f") == own plan == y_tile 3 == plain, bitwise")


def spec_path_phase(check: Checks, fields):
    """One `stencil_fused` pass per operator at the 67M grid; returns
    {(op, integrator): run record}."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    u0, v0, w0 = fields
    q0 = SP.tracer_field(X, Y, Z, device="cuda")
    phi0 = SP.diffusion_field(X, Y, Z, device="cuda")
    p = REF.default_params(Z, device="cuda")
    inputs = {"pw": (p, (u0, v0, w0)), "tracer": (p, (u0, v0, w0, q0)),
              "diffusion": (SP.default_diffusion_params(Z, device="cuda"),
                               (phi0,))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs = {}
    for op, integ, T in SPEC_PATH:
        spec = SPEC_FACTORIES[op](integ)
        params, flds = inputs[op]
        dt = SPEC_DT[op]
        y_tile = None    # K6's own plan
        passes = K.spec_passes(spec, T)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = K.stencil_fused(flds, params, spec, T=T, dt=dt, y_tile=y_tile)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        tag = f"spec path {spec.name} T={T}"
        print(f"{tag}: {MAIN_GRID} grid {(X, Y, Z)}, {spec.n_fields} fields, "
              f"dt={dt}, K6's own plan, passes {passes} on {sms} SMs; wall "
              f"{wall:.3f} s; launches {launches}", flush=True)
        for Tk in sorted(set(passes)):
            print(f"{tag}: pass of T={Tk}: "
                  f"{k6_plan_text(spec, (X, Y, Z), Tk)}", flush=True)
        check(all(n == (len(passes) if k == "stencil_fused" else 0)
                  for k, n in launches.items()),
              f"{tag}: stencil_fused launched {len(passes)} time(s), one a "
              f"pass, no other kernel")
        check(all(o.shape == (X, Y, Z) and bool(torch.isfinite(o).all())
                  for o in out), f"{tag}: outputs finite, of shape (X, Y, Z)")
        plain = plain_spec(flds, params, spec, T, dt)
        err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
        check(err == 0.0, f"{tag}: == plain version, bitwise ({err})")
        del plain
        check(all(frozen_edges(a, b) for a, b in zip(flds, out)),
              f"{tag}: boundary cells unchanged")
        if op == "pw" and integ == "euler":
            k1 = K.advect_fused(*flds, params, T=T, dt=dt, y_tile=y_tile)
            check(same(out, k1), f"{tag}: == K1 (advect_fused) at y_tile "
                  f"{y_tile}, bitwise")
            del k1
        if op == "tracer":
            pw = runs["pw", integ]
            check(pw["T"] == T and same(out[:3], pw["out"]),
                  f"{tag}: u, v, w == the PW spec's ({integ}, T={T}), "
                  f"bitwise")
        o_err = oracle_err(out, flds, params, spec, T, dt)[0]
        check(o_err < ORACLE_TOL, f"{tag}: vs f64 oracle {o_err:.3e} < "
              f"{ORACLE_TOL}")
        moved = max(float((a - b).abs().max()) for a, b in zip(out, flds))
        if op == "diffusion":
            print(f"{tag}: max change {moved:.3e} (at dt={dt} the update is "
                  f"below half an f32 ulp of phi ~ 300)", flush=True)
            diffusion_resolved_check(check, tag, spec, params, flds, T,
                                     y_tile)
        else:
            check(moved > 0.0, f"{tag}: the fields moved (max change "
                  f"{moved:.3e})")
        runs[op, integ] = dict(spec=spec, params=params, fields=flds, T=T,
                               dt=dt, y_tile=y_tile, out=out,
                               launches=launches["stencil_fused"], err=err,
                               oracle_err=o_err)
    for r in runs.values():
        del r["out"]
    for op, integ, T in SPEC_DEEP:
        spec = SPEC_FACTORIES[op](integ)
        params, flds = inputs[op]
        dt = SPEC_DT[op]
        out = K.stencil_fused(flds, params, spec, T=T, dt=dt)
        plain = plain_spec(flds, params, spec, T, dt)
        err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
        del plain
        o_err = oracle_err(out, flds, params, spec, T, dt)[0]
        check(err == 0.0 and o_err < ORACLE_TOL,
              f"spec path {spec.name} T={T} (the old ring refused it), "
              f"{K.spec_passes(spec, T)} passes: == plain, bitwise ({err}); "
              f"vs f64 oracle {o_err:.3e} < {ORACLE_TOL}")
        del out
    return runs


def diffusion_resolved_check(check: Checks, tag, spec, params, flds, T,
                             y_tile) -> None:
    """The diffusion pass again at `DIFFUSION_RESOLVED_DT`, where f32
    resolves the update of phi ~ 300, so that == plain says something."""
    dt = DIFFUSION_RESOLVED_DT
    out = K.stencil_fused(flds, params, spec, T=T, dt=dt, y_tile=y_tile)
    plain = plain_spec(flds, params, spec, T, dt)
    moved = max(float((a - b).abs().max()) for a, b in zip(out, flds))
    o_err = oracle_err(out, flds, params, spec, T, dt)[0]
    check(same(out, plain) and o_err < ORACLE_TOL < moved / 5.0,
          f"{tag} at dt={dt}: == plain, bitwise, vs f64 oracle {o_err:.3e} "
          f"< {ORACLE_TOL}, fields moved by more than 5x that (max change "
          f"{moved:.3e})")


SPEC_PROBE = {"pw": lambda: REF.default_params(4, device="cpu"),
              "tracer": lambda: REF.default_params(4, device="cpu"),
              "diffusion": lambda: SP.default_diffusion_params(4,
                                                               device="cpu")}


def spec_bound(op, spec, params, T, shape, itemsize: int = 4, probe=None):
    """(bytes, operations) of T steps of `spec` over one (X, Y, Z) domain of
    `itemsize`-byte cells: the fields read and written once, the parameter
    vectors (f32 in the kernel's table) and masks read once; the spec's
    operations per interior cell at each of its stages * T levels, plus the
    2-op update of each field and cell. `probe`: the parameters of the op
    census's probe grid (`SPEC_PROBE[op]()` by default)."""
    X, Y, Z = shape
    cells, nf, rad = X * Y * Z, spec.n_fields, spec.radius
    pv_bytes = sum(v.numel() for v in
                   K._spec_param_vectors(spec, params, "cuda")) * 4
    nbytes = (K.hbm_bytes_model(X, Y, Z, itemsize, "fused", T=T, n_fields=nf,
                                halo_depth=spec.halo(T))
              + pv_bytes + (X + Y) * 4)
    interior = (X - 2 * rad) * (Y - 2 * rad) * (Z - 2 * rad)
    ops = spec.stages * T * (interior * SP.spec_flops_per_cell(
        spec, SPEC_PROBE[op]() if probe is None else probe)
        + 2 * nf * cells)
    return nbytes, ops


def spec_timing(runs):
    """Time each operator's pass (events, and its kernels' device time by
    `torch.profiler`), print the builds its plans launch; return the
    `stencil_fused` record (the PW euler pass, the bitwise partner of K1)
    with one entry per operator."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    per_op = []
    for (op, integ), r in runs.items():
        spec, params, flds, T, dt = (r["spec"], r["params"], r["fields"],
                                     r["T"], r["dt"])
        y_tile = r["y_tile"]

        def call():
            return K.stencil_fused(flds, params, spec, T=T, dt=dt,
                                   y_tile=y_tile)

        ms = time_ms(call)
        dev, seen = profiled_kernels(call, "stencil_", ("cuda:0",), 10)
        plain_ms = time_ms(lambda: plain_spec(flds, params, spec, T, dt),
                           runs=10)
        nbytes, ops = spec_bound(op, spec, params, T, (X, Y, Z))
        bound, bound_by = bound_of(nbytes, ops)
        device = (f"device {dev:.4f} ms ({bound / dev:.3f} of the bound; "
                  f"{seen} of {10 * r['launches']} launches seen)"
                  if dev > 0 else "device not measured")
        print(f"spec path on the card: {spec.name} T={T}: {ms:.4f} ms per "
              f"call, {ms / T:.4f} ms per step (median of {TIMED_RUNS}), "
              f"{device}, bound {bound:.4f} ms by {bound_by} ({nbytes} B, "
              f"{ops} f32 ops), {bound / ms:.3f} of the bound by events, "
              f"{nbytes / ms / 1e6:.1f} GB/s; K6's own plan, passes "
              f"{K.spec_passes(spec, T)}; plain version {plain_ms:.4f} ms",
              flush=True)
        per_op.append({"operator": spec.name, "T": T, "y_tile": y_tile,
                       "launches": r["launches"], "max_abs_err": r["err"],
                       "oracle_err": r["oracle_err"], "ms": ms,
                       "device_ms": dev if dev > 0 else None,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by})
    k6_deep_lines(runs)
    k6_builds_lines(runs)
    pw = per_op[0]
    record = {"name": "stencil_fused", "route": "cuda",
              "source": SOURCE["stencil_fused"],
              "replaces": REPLACES["stencil_fused"],
              "launches": sum(o["launches"] for o in per_op),
              "max_abs_err": max(o["max_abs_err"] for o in per_op),
              "ms": pw["ms"], "plain_ms": pw["plain_ms"],
              "bound_ms": pw["bound_ms"], "bound_by": pw["bound_by"],
              "library_ms": None, "operators": per_op}
    return record


def k6_deep_lines(runs) -> None:
    """Time `SPEC_DEEP` (PW and tracer rk2 at T = 4, passes of whole steps)
    on the spec path's fields: events and device time beside the bound."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    for op, integ, T in SPEC_DEEP:
        r = runs[op, integ]
        spec, params, flds, dt = r["spec"], r["params"], r["fields"], r["dt"]

        def call():
            return K.stencil_fused(flds, params, spec, T=T, dt=dt)

        ms = time_ms(call)
        dev, seen = profiled_kernels(call, "stencil_", ("cuda:0",), 10)
        bound = bound_of(*spec_bound(op, spec, params, T, (X, Y, Z)))[0]
        device = (f"device {dev:.4f} ms ({seen} launches seen in 10 calls; "
                  f"{bound / dev:.3f} of the bound)" if dev > 0
                  else "device not measured")
        print(f"spec path on the card: {spec.name} T={T} (passes "
              f"{K.spec_passes(spec, T)}): {ms:.4f} ms per call by events, "
              f"{device}, bound {bound:.4f} ms", flush=True)


def k6_builds_lines(runs) -> None:
    """Each K6 build a pass of the spec path (and of `SPEC_DEEP`) launches:
    its registers, spills, shared bytes and resident blocks per SM, as the
    card reports them for the pass's plan."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    seen = {}
    for op, integ, T in SPEC_PATH + SPEC_DEEP:
        spec = SPEC_FACTORIES[op](integ)
        for Tk in set(K.spec_passes(spec, T)):
            plan = K.spec_device_plan("cuda:0", X, Y, Z, spec, Tk)
            key = (spec.name, Tk, plan.cells_per_thread)
            seen[key] = (plan, K.spec_kernel_attrs("cuda:0", spec, Tk, plan))
    for (name, Tk, C), (plan, a) in seen.items():
        print(f"K6 build {name} T={Tk} C={C}: {a['registers']} registers, "
              f"{a['local_bytes']} B spilled per thread, "
              f"{plan.shared_bytes} B shared, {plan.threads} threads (bound "
              f"{a['max_threads']}), {a['blocks_per_sm']} resident per SM",
              flush=True)


def ladder_compare(card: str) -> int:
    """`--only ladder`: K3, K2 `dataflow` and K2 `wide` at the 67M grid,
    `fuse_update` False and True (events, and device time by
    `torch.profiler`), at y_tile 64 (the domain's tile) and, where the
    package plans its own (`rung_launch_plan`), at y_tile None too; beside
    K1's pass at T = 4. It uses only entry points that the port has had
    since the rungs were ported, so a copy of this script in an older
    checkout times that checkout's rungs the same way."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    cells = X * Y * Z
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T, dt=DT,
                          device="cuda")
    u, v, w = dom.init(seed=0)
    p = REF.default_params(Z, device="cuda")

    def k1():
        return K.advect_fused(u, v, w, p, T=MAIN_T, dt=DT)

    k1_ms = time_ms(k1)
    k1_dev = profiled_kernels(k1, "advect_ring_kernel", ("cuda:0",), 10)[0]
    print(f"ladder compare ({K.__file__}): K1 T={MAIN_T} {k1_ms:.4f} ms by "
          f"events a pass ({k1_ms / MAIN_T:.4f} a step), device "
          f"{k1_dev:.4f} ms ({k1_dev / MAIN_T:.4f} a step); card {card}",
          flush=True)
    nbytes = 6 * cells * 4 + (2 + 2 * Z) * 4
    src_ops = (X - 2) * (Y - 2) * (Z - 2) * REF.flops_per_cell()
    tiles = [64, None] if hasattr(K, "rung_launch_plan") else [64]
    for name in RUNGS:
        fn = getattr(K, name)
        for fu in (False, True):
            bound = bound_of(nbytes, src_ops + 6 * cells * fu)[0]
            for y_tile in tiles:

                def call():
                    return fn(u, v, w, p, y_tile=y_tile, fuse_update=fu,
                              dt=DT)

                ms = time_ms(call)
                dev, seen = profiled_kernels(call, RUNG_KERNEL[name],
                                             ("cuda:0",), 10)
                print(f"ladder compare ({K.__file__}): {name} fuse_update="
                      f"{fu} y_tile={y_tile}"
                      f"{' (own plan)' if y_tile is None else ''}: {ms:.4f} "
                      f"ms by events, device {dev:.4f} ms ({seen} launches "
                      f"seen in 10 calls), {bound / dev if dev > 0 else 0:.4f}"
                      f" of the {bound:.4f} ms bound by device; card {card}",
                      flush=True)
    return 0


def k6_compare(card: str) -> int:
    """`--only k6`: the six passes of `SPEC_PATH` at the 67M grid (events,
    and device time by `torch.profiler`) at the tile
    `largest_fitting_y_tile` gives with `spec_ring_knobs`, and where the
    package plans its own (`spec_launch_plan`), at y_tile None too; beside
    K1's pass at T = 4. It uses only entry points that the port has had
    since K6 was ported, so a copy of this script in an older checkout times
    that checkout's K6 the same way."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T, dt=DT,
                          device="cuda")
    u0, v0, w0 = dom.init(seed=0)
    p = REF.default_params(Z, device="cuda")
    k1_ms = time_ms(lambda: K.advect_fused(u0, v0, w0, p, T=MAIN_T, dt=DT))
    k1_dev = profiled_kernels(
        lambda: K.advect_fused(u0, v0, w0, p, T=MAIN_T, dt=DT), "advect_",
        ("cuda:0",), 10)[0]
    print(f"k6 compare ({K.__file__}): K1 T={MAIN_T} {k1_ms:.4f} ms by "
          f"events, device {k1_dev:.4f} ms; card {card}", flush=True)
    inputs = {"pw": (p, (u0, v0, w0)),
              "tracer": (p, (u0, v0, w0, SP.tracer_field(X, Y, Z,
                                                        device="cuda"))),
              "diffusion": (SP.default_diffusion_params(Z, device="cuda"),
                            (SP.diffusion_field(X, Y, Z, device="cuda"),))}
    tiles = [True, False] if hasattr(K, "spec_launch_plan") else [False]
    for op, integ, T in SPEC_PATH:
        spec = SPEC_FACTORIES[op](integ)
        params, flds = inputs[op]
        dt = SPEC_DT[op]
        bound = bound_of(*spec_bound(op, spec, params, T, (X, Y, Z)))[0]
        for own in tiles:
            y_tile = None if own else K.largest_fitting_y_tile(
                T, Y, Z, **K.spec_ring_knobs(spec, T))

            def call():
                return K.stencil_fused(flds, params, spec, T=T, dt=dt,
                                       y_tile=y_tile)

            ms = time_ms(call)
            dev, seen = profiled_kernels(call, "stencil_", ("cuda:0",), 10)
            print(f"k6 compare ({K.__file__}): {spec.name} T={T} y_tile="
                  f"{y_tile}{' (own plan)' if own else ''}: {ms:.4f} ms by "
                  f"events, device {dev:.4f} ms ({seen} launches seen in 10 "
                  f"calls), {bound / ms:.4f} of the {bound:.4f} ms bound by "
                  f"events; card {card}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# flash attention (K8) and the token-serving path
# ---------------------------------------------------------------------------


def attn_inputs(B, H, Hkv, Sq, Skv, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                                 device="cuda").to(dtype)
                 for s in ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))


def attn_check(got, plain, q, k, v, causal) -> tuple:
    """(ok, max |got - plain|, what): bf16 (the tensor-core kernel) within
    `attention.bf16_bound`, the bound derived there; f32 (the SIMT kernel)
    within 1e-5."""
    err = float((got.float() - plain.float()).abs().max())
    if q.dtype == torch.bfloat16:
        return A.within_bf16_bound(got, plain, q, k, v, causal), err, \
            "within bf16_bound"
    return err <= ATTN_F32_TOL, err, f"within {ATTN_F32_TOL}"


def attention_small_phase(check: Checks) -> None:
    for i, (B, H, Hkv, Sq, Skv, D, causal, dtype, bq, bk) in enumerate(
            ATTN_CASES):
        q, k, v = attn_inputs(B, H, Hkv, Sq, Skv, D, dtype, seed=300 + i)
        before = dict(A.LAUNCHES)
        got = A.flash_attention(q, k, v, causal=causal, block_q=bq,
                                block_k=bk)
        torch.cuda.synchronize()
        launched = {n: A.LAUNCHES[n] - before[n] for n in before}
        plain = A._flash_attention_plain(q, k, v, causal, D ** -0.5)
        ok, err, what = attn_check(got, plain, q, k, v, causal)
        tag = (f"K8 {(B, H, Hkv, Sq, Skv, D)} causal={causal} "
               f"{str(dtype)[6:]} blocks {bq}x{bk}")
        tc = int(dtype == torch.bfloat16)
        check(ok and launched == {"flash_attention": 1,
                                  "flash_attention_tc": tc}
              and got.dtype == dtype and got.shape == q.shape,
              f"{tag} == plain {what} ({err:.3e}), one launch "
              f"({'tensor-core' if tc else 'SIMT'} kernel)")
        if Sq == Skv:
            ref = mha_ref(q, k, v, causal=causal)
            r_err = float((got.float() - ref.float()).abs().max())
            tol = ATTN_REF_BF16_TOL if dtype == torch.bfloat16 else \
                ATTN_F32_TOL
            check(r_err < tol, f"{tag} vs mha_ref {r_err:.3e} < {tol}")
    for i, (B, H, Hkv, S, D, dtype, blk) in enumerate(ATTN_BIG_BLOCKS):
        q, k, v = attn_inputs(B, H, Hkv, S, S, D, dtype, seed=398 - i)
        before = A.LAUNCHES["flash_attention"]
        got = A.flash_attention(q, k, v, block_q=blk, block_k=blk)
        torch.cuda.synchronize()
        plain = A._flash_attention_plain(q, k, v, True, D ** -0.5)
        ok, err, what = attn_check(got, plain, q, k, v, True)
        check(ok and A.LAUNCHES["flash_attention"] == before + 1,
              f"K8 {(B, H, Hkv, S, S, D)} {str(dtype)[6:]} blocks "
              f"{blk}x{blk} (once refused for shared memory) runs and == "
              f"plain {what} ({err:.3e})")
    q, k, v = attn_inputs(1, 4, 2, 128, 128, 64, torch.float32, seed=399)
    refusals = (
        ("H % Hkv != 0", (q[:, :3], k, v), {}),
        ("Sq % block_q != 0", (q, k, v), dict(block_q=96)),
        ("Skv % block_k != 0", (q, k, v), dict(block_k=96)))
    for what, args, kw in refusals:
        before = A.LAUNCHES["flash_attention"]
        try:
            A.flash_attention(*args, **kw)
            refused = False
        except ValueError:
            refused = True
        check(refused and A.LAUNCHES["flash_attention"] == before,
              f"K8 refuses {what} with ValueError, no launch")


# ---------------------------------------------------------------------------
# the band exchange (K7) and the distributed path
# ---------------------------------------------------------------------------


# whether the package lands K7's bands in extended buffers (a copy of this
# script in an older checkout times that checkout's K7 and recv slabs)
EXTENDED = hasattr(K, "ExtendedBuffers")


def cards_of(mesh) -> list:
    return list(dict.fromkeys(mesh.devices))


def sync(mesh) -> None:
    for dev in cards_of(mesh):
        torch.cuda.synchronize(dev)


def buffers_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.buffers.bufs,
                                                 b.buffers.bufs))


def band_small_phase(check: Checks, devices=None, tag="loopback",
                     dtype=torch.float32) -> None:
    """K7 against its plain version at small shapes: `BAND_BLOCKS` blocks
    in a row on the same buffers, tables and counters (both slots, blocks
    2 on passing the slot's interior views, so only the bands move); every
    extended buffer, interior included, == plain bitwise, the slot block 0
    did not write keeps `BAND_FILL`, one put per card and exchange, the
    error words stay 0. `devices(n)` lays out the shards (default: n
    shards on cuda:0); `dtype` is the fields' (K7 moves bf16 bytes
    alike)."""
    kw = dict(dtype=dtype) if dtype != torch.float32 else {}
    if kw:
        tag += " bf16"
    for nx, ny, axis, dim, shape, depth in BAND_CASES:
        n = nx * ny
        if devices is not None and n > torch.cuda.device_count():
            continue
        devs = ["cuda:0"] * n if devices is None else devices(n)
        mesh = make_stencil_mesh(nx, ny, devices=devs)
        got = K.BandSlabs(mesh, shape, depth, dim, fill=BAND_FILL, **kw)
        want = K.BandSlabs(mesh, shape, depth, dim, fill=BAND_FILL, **kw)
        equal = untouched = True
        puts = []
        for block in range(BAND_BLOCKS):
            slot = block % 2
            shards = [tuple(f.to(dev) for f in
                            rand_fields(shape, 900 + 10 * block + s, dtype))
                      for s, dev in enumerate(mesh.devices)]
            src = (shards, shards)
            if block >= 2:
                for sl in (got, want):
                    for own, new in zip(sl.interior(slot), shards):
                        for a, b in zip(own, new):
                            a.copy_(b)
                src = (got.interior(slot), want.interior(slot))
            sync(mesh)
            before = K.LAUNCHES["band_exchange"]
            K.halo_band_exchange_dma(src[0], mesh=mesh, axis=axis,
                                     depth=depth, dim=dim,
                                     block_index=block, slabs=got)
            puts.append(K.LAUNCHES["band_exchange"] - before)
            K._band_exchange_plain(src[1], want,
                                   want.table(axis, slot, src[1]))
            sync(mesh)
            equal = equal and buffers_equal(got, want)
            if block == 0:
                untouched = all(bool((b[:, 1] == BAND_FILL).all())
                                for b in got.buffers.bufs)
        hops = len(K._band_schedule(shape[dim], depth))
        what = (f"K7 {tag} {(nx, ny)} axis {axis} dim {dim} shard {shape} "
                f"depth {depth} ({hops} hop{'s' if hops > 1 else ''})")
        check(equal, f"{what}: extended buffers == plain bitwise over "
              f"{BAND_BLOCKS} blocks, both slots, interior included")
        check(untouched, f"{what}: the slot block 0 did not write is "
              f"untouched")
        check(puts == [len(cards_of(mesh))] * BAND_BLOCKS,
              f"{what}: one put per card and exchange ({puts})")
        errors = [int(w[2]) for w in got.words]
        check(not any(errors), f"{what}: error words {errors}")


def distributed_run(mesh, fields, exchange: str, overlap: bool = True):
    """`make_distributed_run` on the 67M grid over `mesh`, the counts set
    to 0 just before and read just after; returns (global out, launches,
    wall s, run, shards). The coefficients are the fields' dtype (a bf16
    domain's are bf16)."""
    Z = fields[0].shape[2]
    p = REF.default_params(Z, dtype=fields[0].dtype, device="cuda")
    run = D.make_distributed_run(mesh, p, n_blocks=DIST_BLOCKS, T=MAIN_T,
                                 dt=DT, local_kernel="fused",
                                 overlap=overlap, exchange=exchange)
    shards = D.shard(mesh, *fields)
    sync(mesh)
    reset_all_counts()
    t0 = time.perf_counter()
    out = run(shards)
    sync(mesh)
    wall = time.perf_counter() - t0
    launches = all_counts()
    return D.gather(mesh, out, device="cuda:0"), launches, wall, run, shards


def k7_puts(mesh) -> int:
    """K7's put launches in one distributed run: one per card, phase and
    block (one per shard, phase and block before the extended route)."""
    per = len(cards_of(mesh)) if EXTENDED else len(mesh.devices)
    return 2 * per * DIST_BLOCKS


def distributed_path_phase(check: Checks, fields, single):
    """The distributed path at the 67M grid over a (2, 2) loopback mesh on
    the one card: `make_distributed_run(n_blocks=4, T=4, fused, overlap)`
    with each engine, == each other and == the single-card fused
    `advance(16)` (`single`), bitwise. Returns (K7 launches, the runs)."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    nx, ny = DIST_MESH
    mesh = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
    outs, runs = {}, {}
    for ex in ("remote_dma", "collective"):
        out, launches, wall, run, shards = distributed_run(mesh, fields, ex)
        outs[ex], runs[ex] = out, (run, shards)
        want = {"advect_fused": 2 * nx * ny * DIST_BLOCKS}
        if ex == "remote_dma":
            want["band_exchange"] = k7_puts(mesh)
            k7 = launches["band_exchange"]
        print(f"distributed path: {MAIN_GRID} grid {(X, Y, Z)} over a "
              f"{(nx, ny)} loopback mesh on cuda:0, exchange={ex}, "
              f"make_distributed_run(n_blocks={DIST_BLOCKS}, T={MAIN_T}, "
              f"local_kernel='fused', overlap=True); wall {wall:.3f} s; "
              f"launches {launches}", flush=True)
        check(all(n == want.get(k, 0) for k, n in launches.items()),
              f"{ex}: launches {want}, no other kernel (K7 one put per "
              f"card, phase and block, no enter or wait on one card; K1 "
              f"twice per shard and block)")
        check(all(o.shape == (X, Y, Z) and bool(torch.isfinite(o).all())
                  for o in out), f"{ex}: outputs finite, of shape (X, Y, Z)")
        check(all(frozen_edges(f0, fT) for f0, fT in zip(fields, out)),
              f"{ex}: boundary planes unchanged")
    check(same(outs["remote_dma"], outs["collective"]),
          "distributed remote_dma == collective, bitwise")
    err = max(float((a - b).abs().max())
              for a, b in zip(outs["remote_dma"], single))
    check(err == 0.0, f"distributed (2, 2) run == single-card fused "
          f"advance({MAIN_SUBSTEPS}), bitwise ({err})")
    return k7, mesh, outs["remote_dma"], runs


def cross_card_phase(check: Checks, fields, loopback_out, card: str) -> None:
    """K7 and the distributed path on a mesh of distinct cards, where the
    machine has two or more: each engine bitwise equal to the loopback run,
    and timed as on the loopback mesh."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"across cards: skipped, {n} card visible (the loopback mesh "
              f"on one card carried K7)", flush=True)
        return
    if EXTENDED:
        band_small_phase(check, devices=lambda k: [f"cuda:{i}"
                                                   for i in range(k)],
                         tag="across cards", dtype=fields[0].dtype)
    nx, ny = DIST_MESH if n >= 4 else (2, 1)
    mesh = make_stencil_mesh(nx, ny)
    if (nx, ny) == DIST_MESH:
        want = loopback_out
    else:
        loop = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
        want = distributed_run(loop, fields, "remote_dma")[0]
    runs = {}
    for ex in ("remote_dma", "collective"):
        out, launches, wall, run, shards = distributed_run(mesh, fields, ex)
        runs[ex] = (run, shards)
        print(f"across cards{' bf16' if fields[0].dtype == BF16 else ''}: "
              f"ran, exchange={ex}, a {(nx, ny)} mesh over "
              f"{[str(d) for d in mesh.devices]}; wall {wall:.3f} s; "
              f"launches {launches}", flush=True)
        err = max(float((a - b).abs().max()) for a, b in zip(out, want))
        check(err == 0.0, f"across cards {(nx, ny)} {ex} == loopback "
              f"remote_dma, bitwise ({err}), {fields[0].dtype}")
        if ex == "remote_dma" and EXTENDED:
            check(launches["band_exchange"] == k7_puts(mesh),
                  f"across cards: K7 one put per card, phase and block "
                  f"({launches['band_exchange']})")
    band_timing(mesh, fields, 0, runs, card, tag="across cards")


def k7_host_and_device_ms(call, mesh, runs: int = 20):
    """K7's host time to enqueue one exchange (median, no synchronise), and
    its kernels' summed device time per exchange from `torch.profiler`
    ("not measured" where the profiler sees no device time)."""
    host = []
    for _ in range(runs):
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
        sync(mesh)
    dev_ms = device_per_call(call, "band_", set(mesh.devices), runs)[0]
    device = f"{dev_ms:.4f} ms" if dev_ms > 0 else "not measured"
    return statistics.median(host), device


def device_per_call(call, match: str, devices, runs: int = 10):
    """(device ms per call, launches seen) of `call`, whose kernels are the
    ones it counts in `LAUNCHES`: the profiler's device time per launch it
    saw, times the launches one call makes, so that a trace that drops
    events reads low by none of them."""
    before = sum(all_counts().values())
    call()
    per = sum(all_counts().values()) - before
    for dev in devices:
        torch.cuda.synchronize(dev)
    dev, seen = profiled_kernels(call, match, devices, runs)
    return (dev * runs / seen * per if seen else 0.0), seen


def profiled_kernels(call, match: str, devices, runs: int):
    """(device ms per call, kernel launches seen) of the kernels whose name
    holds `match` ("" for every kernel on the card), summed by
    `torch.profiler` over `runs` calls (0.0 where the profiler sees no
    device time)."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(runs):
            call()
        for dev in devices:
            torch.cuda.synchronize(dev)
    cuda = torch.autograd.DeviceType.CUDA
    seen = [e for e in prof.key_averages() if match in e.key
            and getattr(e, "device_type", None) == cuda]
    dev_us = sum(getattr(e, "device_time_total", 0.0) for e in seen)
    return dev_us / runs / 1e3, sum(e.count for e in seen)


def device_text(ms: float) -> str:
    return f"{ms:.4f} ms" if ms > 0 else "not measured"


def band_timing(mesh, fields, launches: int, runs, card: str,
                tag: str = "loopback") -> dict:
    """Per phase at the path's shapes: K7 moving the bands alone (events,
    host enqueue, device time, bound), the extend pass as the distributed
    block runs it (`_LocalBlock._extend`: K7 landing each shard and its
    bands in the extended slab; in an older checkout its recv slabs plus
    `torch.cat`) beside its bound, K7's plain version, and the collective
    engine (its tensor copies of the bands, and its extend pass with the
    concatenation); then each engine's ms per block of the run. The
    record holds the extend pass, as the path launches K7."""
    T = MAIN_T
    shards = D.shard(mesh, *fields)
    Xl, Yl, Z = shards[0][0].shape
    dtype = fields[0].dtype
    bf16 = dtype == BF16
    item = fields[0].element_size()
    p = REF.default_params(Z, dtype=dtype, device="cuda")
    blocks = {ex: D._LocalBlock(mesh, p, T=T, dt=DT, local_kernel="fused",
                                y_tile=None, overlap=True, exchange=ex)
              for ex in ("remote_dma", "collective")}
    if EXTENDED:
        blocks["remote_dma"]._band_slabs((Xl, Yl, Z), T, T,
                                         *((dtype,) if bf16 else ()))
    kw_dtype = dict(dtype=dtype) if bf16 else {}
    tag = tag + (" bf16" if bf16 else "")
    # the y phase sends from the x-extended slab
    ext = {ex: b._extend(shards, "x", 0, 0, None, None)
           for ex, b in blocks.items()}
    evens = iter(range(0, 10 ** 9, 2))   # slot 0 throughout
    cards = set(mesh.devices)
    if EXTENDED:
        print(f"K7 put kernel ({tag}): {K.band_kernel_attrs('cuda:0')}; "
              f"card {card}", flush=True)
    tot = dict(k7=0.0, ext=0.0, plain=0.0, coll=0.0, coll_ext=0.0,
               bound=0.0, ext_bound=0.0, err=0.0, nbytes=0, ext_nbytes=0)
    for axis, dim, sh in (("x", 0, shards), ("y", 1, ext["remote_dma"])):
        shape = (Xl, Yl, Z) if dim == 0 else (Xl + 2 * T, Yl, Z)
        fresh = [tuple(f.to(dev) for f in rand_fields(shape, 1000 + s,
                                                       dtype))
                 for s, dev in enumerate(mesh.devices)]
        slabs = K.BandSlabs(mesh, shape, T, dim, **kw_dtype)
        plain = K.BandSlabs(mesh, shape, T, dim, **kw_dtype)
        if EXTENDED:
            # the bands alone: the fields already lie in the slot's middle
            for sl in (slabs, plain):
                for own, new in zip(sl.interior(0), fresh):
                    for a, b in zip(own, new):
                        a.copy_(b)
            src = slabs.interior(0)
            msgs = plain.table(axis, 0, plain.interior(0))

            def plain_call():
                K._band_exchange_plain(plain.interior(0), plain, msgs)
        else:
            src = fresh
            msgs = K.band_messages(mesh, axis, shape[dim], T)

            def plain_call():
                K._band_exchange_plain(fresh, plain, msgs, 0)

        def k7_call():
            K.halo_band_exchange_dma(src, mesh=mesh, axis=axis, depth=T,
                                     dim=dim, block_index=next(evens),
                                     slabs=slabs)

        k7_call()
        plain_call()
        sync(mesh)
        pairs = (zip(slabs.buffers.bufs, plain.buffers.bufs) if EXTENDED
                 else ((x, y) for sa, sb in zip(slabs.slabs, plain.slabs)
                       for fa, fb in zip(sa, sb) for x, y in zip(fa, fb)))
        tot["err"] = max([tot["err"]] + [float((x - y).float().abs().max())
                                         for x, y in pairs])
        k7 = time_ms(k7_call)
        host, device = k7_host_and_device_ms(k7_call, mesh)
        slabs.check()
        pl = time_ms(plain_call)
        coll = time_ms(lambda: [D._exchange_halos(
            mesh, [s[f] for s in sh], axis, T, dim) for f in range(3)])
        phase = {ex: (lambda b=b, x=(shards if dim == 0 else ext[ex]):
                      b._extend(x, axis, dim, next(evens), None, None))
                 for ex, b in blocks.items()}
        ext_ms = time_ms(phase["remote_dma"])
        ext_dev = device_per_call(phase["remote_dma"], "band_", cards)[0]
        coll_ext = time_ms(phase["collective"])
        coll_ext_dev = profiled_kernels(phase["collective"], "", cards,
                                        10)[0]
        blocks["remote_dma"].check()
        # bounds: each byte read once and written once in the one card's
        # memory (loopback): the bands alone, and the extend pass (the x
        # phase also moves every shard into its slab)
        other = math.prod(shape) // shape[dim]
        sent = sum(m.cnt * other * item
                   for m in K.band_messages(mesh, axis, shape[dim], T))
        owned = 3 * len(sh) * Xl * Yl * Z * item if dim == 0 else 0
        b, _ = bound_of(2 * sent, 0)
        eb, _ = bound_of(2 * (sent + owned), 0)
        print(f"band_exchange {axis} phase ({tag}): {len(sh)} shards of "
              f"{shape} on {sorted({str(d) for d in mesh.devices})}, "
              f"depth {T}, dim {dim}, {sent} B of bands sent "
              f"({sent // len(sh)} per shard): K7, bands alone, {k7:.4f} ms "
              f"(median of {TIMED_RUNS}), bound {b:.4f} ms ({2 * sent} B "
              f"read + written at {R.HBM_BW:.3g} B/s), {b / k7:.4f} of the "
              f"bound; host enqueue {host:.4f} ms and device kernel time "
              f"{device} per call; across cards the bound would be "
              f"{sent // len(sh)} B per shard at {R.NVLINK_BW:.3g} B/s each "
              f"way: {sent // len(sh) / R.NVLINK_BW * 1e3:.4f} ms; plain "
              f"version {pl:.4f} ms; collective engine's band copies "
              f"{coll:.4f} ms (card {card})", flush=True)
        if EXTENDED:
            table = blocks["remote_dma"].slabs[axis].table(axis, 0, sh)
            grids = [(str(q.card), q.tiles, q.grid)
                     for q in table.launches()]
            print(f"band_exchange {axis} phase ({tag}): (card, tiles of 16 "
                  f"KB, blocks) of the path's puts {grids}", flush=True)
        route = ("K7 into the extended slab" if EXTENDED
                 else "K7 recv slabs + torch.cat")
        print(f"band_exchange {axis} phase ({tag}) extend pass ({route}, "
              f"{K.__file__}): {ext_ms:.4f} ms by events, device "
              f"{device_text(ext_dev)}, bound {eb:.4f} ms "
              f"({2 * (sent + owned)} B read + written), {eb / ext_ms:.4f} "
              f"of the bound by events; collective engine's extend pass "
              f"(copies + torch.cat) {coll_ext:.4f} ms, device "
              f"{device_text(coll_ext_dev)} (card {card})", flush=True)
        for key, val in (("k7", k7), ("ext", ext_ms), ("plain", pl),
                         ("coll", coll), ("coll_ext", coll_ext),
                         ("bound", b), ("ext_bound", eb),
                         ("nbytes", 2 * sent),
                         ("ext_nbytes", 2 * (sent + owned))):
            tot[key] += val
    for ex, (run, rshards) in runs.items():
        per_block = time_ms(lambda: run(rshards), runs=5, warmup=1) / \
            DIST_BLOCKS
        busy = profiled_kernels(lambda: run(rshards), "", cards, 2)[0] / \
            DIST_BLOCKS
        idle = (f"{1 - busy / (per_block * len(cards))}" if busy > 0
                else "not measured")
        print(f"distributed path ({tag}): exchange={ex}: {per_block:.4f}"
              f" ms per block of {MAIN_T} substeps ({per_block / MAIN_T:.4f}"
              f" ms per Euler step; median of 5 runs of {DIST_BLOCKS} "
              f"blocks); kernels {device_text(busy)} of device time a block"
              f" (summed over {len(cards)} card(s)), idle share {idle}; "
              f"{K.__file__}; card {card}", flush=True)
    print(f"band_exchange per block ({tag}, x + y phases): bands alone "
          f"{tot['k7']:.4f} ms, bound {tot['bound']:.4f} ms by bytes "
          f"({tot['nbytes']} B); extend pass {tot['ext']:.4f} ms, bound "
          f"{tot['ext_bound']:.4f} ms ({tot['ext_nbytes']} B); plain "
          f"{tot['plain']:.4f} ms; collective engine: band copies "
          f"{tot['coll']:.4f} ms, extend pass {tot['coll_ext']:.4f} ms",
          flush=True)
    return {"name": "band_exchange" + ("_bf16" if bf16 else ""),
            "route": "cuda", "source": SOURCE["band_exchange"],
            "replaces": REPLACES["band_exchange"], "launches": launches,
            "max_abs_err": tot["err"], "ms": tot["ext"],
            "plain_ms": tot["plain"], "bound_ms": tot["ext_bound"],
            "bound_by": "bytes", "library_ms": tot["coll_ext"]}


def reset_all_counts() -> None:
    K.reset_launch_counts()
    A.reset_launch_counts()
    SS.reset_launch_counts()


def all_counts() -> dict:
    return {**K.LAUNCHES, **A.LAUNCHES, **SS.LAUNCHES}


def serving_phase(check: Checks, arch: str, kernels: tuple, **cut):
    """The token-serving path at full width under `attention_impl="pallas"`,
    where each of `kernels` (K8 and its tensor-core count, or K9; none on
    the hybrid path) runs once per layer of every prefill; `cut` (depth,
    weight dtype) is what one card forces, printed. Returns (cfg, params,
    the first kernel's launches)."""
    cfg = get_config(arch).replace(attention_impl="pallas", **cut)
    if cut:
        print(f"serving path: {arch} cut to {cut} to fit one card",
              flush=True)
    t0 = time.perf_counter()
    params = random_params(cfg, "cuda")
    torch.cuda.synchronize()
    shape = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}"
             if cfg.n_heads else f"d_inner {cfg.d_inner}, d_state "
             f"{cfg.ssm.d_state}")
    print(f"serving path: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {shape}, weights {cfg.param_dtype} "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) drawn on the card "
          f"in {time.perf_counter() - t0:.2f} s; compute {cfg.compute_dtype}",
          flush=True)
    tr = SERVE_TRAFFIC
    engine = ServingEngine(cfg, params, batch_size=tr["batch_size"],
                           max_len=tr["max_len"])
    reqs = random_requests(cfg, tr["requests"], tr["max_new"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    others = all_counts()
    counts = {name: others.pop(name) for name in kernels}
    launched = counts[kernels[0]] if kernels else 0
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    total = sum(len(v) for v in done.values())
    print(f"serving path: {len(done)} requests, {total} tokens in {wall:.3f}"
          f" s ({total / wall:.2f} tokens/s aggregate); {st['prefills']} "
          f"prefills, {st['prefill_s'] / st['prefills'] * 1e3:.2f} ms each; "
          f"{st['decode_steps']} decode steps, "
          f"{st['decode_s'] / st['decode_steps'] * 1e3:.2f} ms each "
          f"({st['decode_steps'] * tr['batch_size'] / st['decode_s']:.2f} "
          f"token slots/s); peak memory {peak} B ({peak / 1e9:.2f} GB); "
          f"launches {counts}", flush=True)
    for uid in sorted(done):
        print(f"  req {uid} (prompt {len(reqs[uid].prompt)}): {done[uid]}",
              flush=True)
    check(all(n == cfg.n_layers * st["prefills"] for n in counts.values())
          and st["prefills"] == len(reqs),
          f"serving {cfg.name}: {', '.join(counts)} launched {launched} "
          f"times each = {cfg.n_layers} layers x {st['prefills']} prefills"
          if kernels else f"serving {cfg.name}: {st['prefills']} prefills")
    check(all(n == 0 for n in others.values()),
          f"serving {cfg.name}: no other kernel launched ({others})")
    check(sorted(done) == list(range(len(reqs)))
          and all(len(v) == tr["max_new"] for v in done.values())
          and all(0 <= t < cfg.vocab_size for v in done.values() for t in v),
          f"serving {cfg.name}: every request done with {tr['max_new']} "
          f"tokens in the vocabulary")
    del engine
    return cfg, params, launched


def fixed_f32_limit(tol: float):
    """An f32 prefill limit on max |pallas - chunked logit| set in advance."""
    return lambda c, p, toks, layout, lc: (tol, f"{tol}")


def witness_f32_limit(c, p, toks, layout, lc):
    """The ssm f32 prefill limit: `SSM_F32_WITNESS_K` x max |chunked at one
    chunk of the whole prompt - chunked|, two correct routes whose only
    difference is the association order of the reference's own sums."""
    lw = M.forward(p, {"inputs": toks}, c.replace(
        attention_impl="chunked", scan_chunk=toks.shape[1]), layout)[0]
    w = float((lw - lc).abs().max())
    agree = float((lw.argmax(-1) == lc.argmax(-1)).float().mean())
    print(f"{c.name} prefill {toks.shape[1]} tokens, f32 compute, "
          f"{c.n_layers} layers: max |chunked(scan_chunk {toks.shape[1]}) - "
          f"chunked(scan_chunk {c.scan_chunk})| {w:.4e}, argmax agreement "
          f"{agree:.4f}", flush=True)
    return (SSM_F32_WITNESS_K * w, f"{SSM_F32_WITNESS_K} x that of chunked "
            f"at scan_chunk {toks.shape[1]} ({SSM_F32_WITNESS_K * w:.4e})")


def prefill_gate_phase(check: Checks, cfg, params, kernel: str,
                       f32_limit, bf16_rel_tol: float,
                       bf16_kernel: str = "", batch=None) -> int:
    """`pallas` (where `kernel` runs once per layer, and `bf16_kernel`, its
    bf16 build's own count, where named, once per layer in bf16 only)
    against `chunked` prefill logits on one 2048-token prompt: f32 at all
    layers within `f32_limit(cfg, params, tokens, layout, chunked
    logits)`, bf16 at the first 2 layers within `bf16_rel_tol` x max
    |chunked logit|, bf16 at all layers printed. Prints each pallas
    forward's wall time. Returns `kernel`'s launches in the last pallas
    forward (bf16, all layers). `batch` replaces the random 2048-token
    prompt (the vlm family's embeddings and M-RoPE positions)."""
    layout = M.make_layout(cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_TOKENS)), device="cuda")
    batch = {"inputs": toks} if batch is None else batch

    def logits(c, p):
        out = {}
        for impl in ("pallas", "chunked"):
            reset_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[impl] = M.forward(p, batch,
                                  c.replace(attention_impl=impl), layout)[0]
            torch.cuda.synchronize()
            out[impl + "_s"] = time.perf_counter() - t0
            out[impl + "_n"] = all_counts()
        return out

    first2 = dict(params, layers=tree_map(lambda a: a[:2], params["layers"],
                                          is_leaf=torch.is_tensor))
    L = cfg.n_layers
    runs = (("f32", L, cfg.replace(compute_dtype="float32"), params),
            ("bf16", 2, cfg.replace(n_layers=2), first2),
            ("bf16", L, cfg, params))
    for name, depth, c, p in runs:
        t0 = time.perf_counter()
        out = logits(c, p)
        wall = time.perf_counter() - t0
        lp, lc = out["pallas"], out["chunked"]
        diff = float((lp - lc).abs().max())
        scale = float(lc.abs().max())
        agree = float((lp.argmax(-1) == lc.argmax(-1)).float().mean())
        n_p, n_c = out["pallas_n"], out["chunked_n"]
        tag = (f"{cfg.name} prefill {PREFILL_TOKENS} tokens, {name} compute, "
               f"{depth} layers")
        print(f"{tag}: max |pallas - chunked| {diff:.4e}, max |logit| "
              f"{scale:.4f}, argmax agreement {agree:.4f}; {kernel} launches "
              f"{n_p[kernel]} (pallas), {n_c[kernel]} (chunked); pallas "
              f"forward {out['pallas_s'] * 1e3:.2f} ms of wall time, "
              f"chunked {out['chunked_s'] * 1e3:.2f} ms; both forwards "
              f"{wall:.2f} s", flush=True)
        bf16_ok = not bf16_kernel or \
            n_p.pop(bf16_kernel) == (depth if name == "bf16" else 0)
        launched = n_p.pop(kernel)
        check(bf16_ok and launched == depth and not any(n_p.values())
              and not any(n_c.values())
              and lp.shape == (1, PREFILL_TOKENS, cfg.vocab_size)
              and bool(torch.isfinite(lp).all())
              and bool(torch.isfinite(lc).all()),
              f"{tag}: {kernel} once per layer on the pallas path only"
              f"{f' ({bf16_kernel} in bf16)' if bf16_kernel else ''}, no "
              f"other kernel; logits finite, (1, {PREFILL_TOKENS}, "
              f"{cfg.vocab_size})")
        if name == "f32":
            limit, what = f32_limit(c, p, toks, layout, lc)
            check(diff <= limit, f"{tag}: pallas == chunked within {what}")
        elif depth == 2:
            check(diff <= bf16_rel_tol * scale,
                  f"{tag}: pallas == chunked within {bf16_rel_tol} x "
                  f"max |logit| ({bf16_rel_tol * scale:.4f})")
        else:
            print(f"{tag}: not gated: bf16 rounding of activations differs "
                  f"between the two algorithms and grows with depth", flush=True)
        del out, lp, lc
    return launched


def k8_bound(B, H, Hkv, S, D, itemsize: int = 2):
    """(bound ms, "bytes" or "operations", FLOP, bytes) of causal K8 at q
    (B, H, S, D), k, v (B, Hkv, S, D): read q, k, v once, write out once;
    the causal half of the two products, 2 FLOP per multiply-add, at the
    bf16 tensor-core peak."""
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize
    flops = 4 * B * H * D * (S * (S + 1) // 2)
    t_bytes = nbytes / R.HBM_BW * 1e3
    t_ops = flops / R.PEAK_FLOPS_BF16 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", flops, nbytes)


def k8_times(call, kernel: str, q):
    """`call`'s ms by CUDA events (median of `TIMED_RUNS`), the device ms
    of the kernels whose name holds `kernel` by `torch.profiler` ("not
    measured" where it sees no device time) and the host ms to enqueue it
    (median, the card synchronised after each)."""
    ms = time_ms(call)
    dev = profiled_kernels(call, kernel, {q.device}, TIMED_RUNS)[0]
    host = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return ms, (f"{dev:.4f} ms" if dev > 0 else "not measured"), \
        statistics.median(host)


def sdpa_ms(q, k, v) -> tuple:
    """`scaled_dot_product_attention`'s ms by events and its kernels'
    device ms by `torch.profiler` (the library yardstick, used nowhere in
    the port) at causal q, k, v."""
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(q, k, v, is_causal=True, enable_gqa=True)

    ms = time_ms(call)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(TIMED_RUNS):
            call()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    dev = dev_us / TIMED_RUNS / 1e3
    return ms, (f"{dev:.4f} ms" if dev > 0 else "not measured")


def attention_timing(launches: int, card: str, shape=ATTN_TIMED,
                     path: str = "") -> dict:
    """K8 (the tensor-core kernel, bf16) at `shape` (B, H, Hkv, S, D;
    default the timed shape, where it also prints the card's view of each
    build) beside its plain version, SDPA and its bound; `launches` are
    those of `path`, the path that runs K8 at that shape."""
    B, H, Hkv, S, D = shape
    q, k, v = attn_inputs(B, H, Hkv, S, S, D, torch.bfloat16, seed=500)
    got = A.flash_attention(q, k, v, causal=True)
    plain = A._flash_attention_plain(q, k, v, True, D ** -0.5)
    ok, err, _ = attn_check(got, plain, q, k, v, True)
    ms, dev, host = k8_times(
        lambda: A.flash_attention(q, k, v, causal=True), "flash_wgmma", q)
    lib_ms, lib_dev = sdpa_ms(q, k, v)
    plain_ms = time_ms(lambda: A._flash_attention_plain(q, k, v, True,
                                                        D ** -0.5))
    bound, bound_by, flops, nbytes = k8_bound(B, H, Hkv, S, D)
    print(f"flash_attention: {(B, H, S, D)} q, {(B, Hkv, S, D)} k/v bf16 "
          f"causal (the tensor-core kernel): {ms:.4f} ms by events (median "
          f"of {TIMED_RUNS}), device {dev} (torch.profiler), host "
          f"{host:.4f} ms to enqueue, bound "
          f"{bound:.4f} ms by {bound_by} ({flops} FLOP at "
          f"{R.PEAK_FLOPS_BF16:.3g}/s; {nbytes} B at {R.HBM_BW:.3g} B/s; "
          f"H100 SXM5 data-sheet peaks; card {card}), {bound / ms:.4f} of "
          f"the bound, {flops / ms / 1e9:.1f} TFLOP/s; plain version "
          f"{plain_ms:.4f} ms; library scaled_dot_product_attention "
          f"(enable_gqa) {lib_ms:.4f} ms by events, device {lib_dev} "
          f"({ms / lib_ms:.3f} x its time by events); "
          f"== plain within bf16_bound: {ok} ({err:.3e})", flush=True)
    rec = {"name": "flash_attention", "route": "cuda",
           "source": SOURCE["flash_attention"],
           "replaces": REPLACES["flash_attention"], "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
           "within_bf16_bound": ok}
    if shape != ATTN_TIMED:
        rec.update(shape=f"q {(B, H, S, D)}, k/v {(B, Hkv, S, D)} bf16 "
                   f"causal", path=path)
        return rec
    for d in A.TC_HEAD_DIMS:
        at = A.tc_kernel_attrs(q.device, d)
        print(f"flash_attention tensor-core build, head dim {d} (tiles "
              f"{A.tc_tiles(d)}): {at['registers']} registers, "
              f"{at['local_bytes']} B spilled per thread, "
              f"{at['shared_bytes']} B shared, {at['blocks_per_sm']} "
              f"resident blocks per SM", flush=True)
    return rec


def k8_compare(card: str) -> int:
    """`--only k8`: K8 at the timed shape (events, device, SDPA) and the
    wall time of a bf16 `qwen2.5-14b` prefill of `PREFILL_TOKENS` tokens
    under `attention_impl="pallas"`, through the package beside this file.
    It uses only entry points that the port has had since K8 was ported,
    so a copy of this script in an older checkout times that checkout's
    K8 the same way."""
    B, H, Hkv, S, D = ATTN_TIMED
    q, k, v = attn_inputs(B, H, Hkv, S, S, D, torch.bfloat16, seed=500)
    ms, dev, host = k8_times(
        lambda: A.flash_attention(q, k, v, causal=True), "flash", q)
    lib_ms, lib_dev = sdpa_ms(q, k, v)
    bound, bound_by, flops, _ = k8_bound(B, H, Hkv, S, D)
    print(f"k8 compare ({A.__file__}): K8 {(B, H, S, D)} bf16 causal "
          f"{ms:.4f} ms by events, device {dev}, host {host:.4f} ms to "
          f"enqueue, {flops / ms / 1e9:.1f} "
          f"TFLOP/s, {bound / ms:.4f} of the {bound:.4f} ms bound; SDPA "
          f"{lib_ms:.4f} ms by events, device {lib_dev}; card {card}",
          flush=True)
    del q, k, v
    cfg = get_config(SERVE_ARCH).replace(attention_impl="pallas")
    params = random_params(cfg, "cuda")
    layout = M.make_layout(cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_TOKENS)), device="cuda")
    walls = []
    for i in range(4):   # one warm-up, three timed
        n0 = A.LAUNCHES["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.forward(params, {"inputs": toks}, cfg, layout)
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
        launched = A.LAUNCHES["flash_attention"] - n0
    print(f"k8 compare ({A.__file__}): {cfg.name} bf16 prefill of "
          f"{PREFILL_TOKENS} tokens, pallas: {statistics.median(walls):.2f} "
          f"ms of wall time (median of {walls}), K8 launches {launched}; "
          f"card {card}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# the selective scan (K9) and the ssm serving path
# ---------------------------------------------------------------------------


def scan_inputs(B, S, D, N, dtype, dt_dtype, seed, dt_scale=0.1):
    """The reference's test inputs (`make` in tests/test_ssm_kernel.py) on
    the card: x, B, C in `dtype`, dt in `dt_dtype` (|normal| x `dt_scale`),
    A and h0 f32."""
    rng = np.random.default_rng(seed)
    t = lambda a, d: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                     device="cuda").to(d)
    return (t(rng.normal(size=(B, S, D)), dtype),
            t(np.abs(rng.normal(size=(B, S, D))) * dt_scale, dt_dtype),
            t(rng.normal(size=(B, S, N)), dtype),
            t(rng.normal(size=(B, S, N)), dtype),
            t(-np.abs(rng.normal(size=(D, N))), torch.float32),
            t(rng.normal(size=(B, D, N)) * 0.1, torch.float32))


def scan_err(got, want) -> float:
    """max |got - want| over y and h_final, over max(1, max |want|)."""
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def scan_f64(xc, dt, Bmat, Cmat, A, h0):
    """The recurrence in f64 on the card (the inputs widened exactly)."""
    xc, dt, Bmat, Cmat, A, h = (t.double()
                                for t in (xc, dt, Bmat, Cmat, A, h0))
    ys = []
    for t in range(xc.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * xc[:, t])[..., None] * Bmat[:, t, None, :]
        ys.append((h * Cmat[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h


def scan_check(check: Checks, tag: str, args, chunk: int,
               f64: bool = False) -> None:
    B, S, D = args[0].shape
    N = args[2].shape[-1]
    before = SS.LAUNCHES["selective_scan"]
    got = SS.selective_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    launched = SS.LAUNCHES["selective_scan"] - before
    err = scan_err(got, SS._selective_scan_plain(*args))
    err64 = scan_err(got, scan_f64(*args)) if f64 else 0.0
    check(err <= SCAN_TOL and err64 <= SCAN_TOL and launched == 1
          and got[0].shape == (B, S, D) and got[1].shape == (B, D, N)
          and all(g.dtype == torch.float32 for g in got),
          f"K9 {tag} == plain{' and f64' if f64 else ''} within {SCAN_TOL} "
          f"x max(1, max |ref|) ({err:.3e}"
          f"{f', f64 {err64:.3e}' if f64 else ''}), one launch")


def scan_attrs_lines(card: str) -> None:
    """Each K9 build's registers, spills, shared bytes and resident blocks
    per SM at N = 16 and PLAN_LANES lanes, and the plans of the two timed
    shapes."""
    for x_t, dt_t in ((torch.float32, torch.float32),
                      (torch.bfloat16, torch.float32),
                      (torch.bfloat16, torch.bfloat16)):
        for K in SS.STEP_BUILDS:
            L = SS.PLAN_LANES
            plan = SS.scan_device_plan("cuda", 1, L * K, 8192, 16, x_t,
                                       dt_t, lanes=L, steps=K)
            at = SS.scan_kernel_attrs("cuda", x_t, dt_t, 16, plan)
            print(f"selective_scan build: {K} steps a lane, x "
                  f"{str(x_t)[6:]}, dt {str(dt_t)[6:]}, at {L} lanes (N 16): "
                  f"{at['registers']} registers, {at['local_bytes']} B "
                  f"spilled per thread, {at['shared_bytes']} B shared, "
                  f"{at['blocks_per_sm']} resident blocks per SM (card "
                  f"{card})", flush=True)
    for B, S, D, N, _ in (SCAN_TIMED, SCAN_SERVE_TIMED):
        plan = SS.scan_device_plan("cuda", B, S, D, N, torch.bfloat16,
                                   torch.float32)
        print(f"selective_scan plan at {(B, S, D, N)}, x bf16, dt f32: "
              f"{plan}", flush=True)


def scan_small_phase(check: Checks) -> None:
    types = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16))
    for i, (B, S, D, N, chunk) in enumerate(SCAN_CASES):
        for x_t, dt_t in types:
            args = scan_inputs(B, S, D, N, x_t, dt_t, seed=600 + i)
            scan_check(check, f"{(B, S, D, N)} chunk {chunk} x "
                       f"{str(x_t)[6:]} dt {str(dt_t)[6:]}", args, chunk)
    xc, dt, Bm, Cm, A, h0 = scan_inputs(1, 64, 24, 16, torch.bfloat16,
                                        torch.float32, seed=620)
    full = SS.selective_scan(xc, dt, Bm, Cm, A, h0, chunk=16)
    y1, h1 = SS.selective_scan(xc[:, :32], dt[:, :32], Bm[:, :32],
                               Cm[:, :32], A, h0, chunk=16)
    y2, h2 = SS.selective_scan(xc[:, 32:], dt[:, 32:], Bm[:, 32:],
                               Cm[:, 32:], A, h1, chunk=16)
    err = scan_err((torch.cat([y1, y2], 1), h2), full)
    check(err <= SCAN_TOL, f"K9 two chained half-length scans == one full "
          f"scan ({err:.3e})")
    for S in range(4, 24):   # serve.py's prompt lengths, chunk = S
        args = scan_inputs(1, S, SCAN_SERVE_D, SCAN_SERVE_N, torch.bfloat16,
                           torch.float32, seed=640 + S)
        scan_check(check, f"serving prompt S={S}, D {SCAN_SERVE_D}, N "
                   f"{SCAN_SERVE_N}, chunk {S}", args, S)
    for i, (what, B, S, D, N, chunk, scale) in enumerate(SCAN_EDGE_CASES):
        for x_t in (torch.float32, torch.bfloat16):
            args = scan_inputs(B, S, D, N, x_t, torch.float32, 680 + i,
                               dt_scale=scale)
            scan_check(check, f"{what}: {(B, S, D, N)} chunk {chunk} x "
                       f"{str(x_t)[6:]} dt float32", args, chunk, f64=True)
    # a chunk the old kernel refused for its shared memory: the staging no
    # longer grows with the chunk
    args = scan_inputs(1, 1024, 16, 16, torch.float32, torch.float32, 660)
    scan_check(check, "(1, 1024, 16, 16) chunk 1024 (once over the shared-"
               "memory budget) x float32 dt float32", args, 1024)
    for what, (B, S, D, N), chunk in (
            ("S % chunk != 0", (1, 96, 16, 16), 64),
            ("N over 128 states", (1, 8, 4, 129), 8)):
        args = scan_inputs(B, S, D, N, torch.float32, torch.float32, 660)
        before = SS.LAUNCHES["selective_scan"]
        try:
            SS.selective_scan(*args, chunk=chunk)
            refused = False
        except ValueError:
            refused = True
        check(refused and SS.LAUNCHES["selective_scan"] == before,
              f"K9 refuses {what} with ValueError, no launch")


def ssm_layer_gate_phase(check: Checks, cfg, params) -> None:
    """`pallas` (K9) against `chunked` in f32 at each layer of the stack on
    one 2048-token prompt: both routes take the `chunked` route's input to
    the layer, so each layer's rounding difference reads apart from the
    stack's growth of it. What is held is the mamba mixer's output, over
    its own largest value: the residual the block adds it to grows to ~1e8
    under this random init and would hide the mixer's difference."""
    c32 = cfg.replace(compute_dtype="float32", attention_impl="chunked")
    routes = {"chunked": c32, "pallas": c32.replace(attention_impl="pallas")}
    layout = M.make_layout(cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_TOKENS)), device="cuda")
    t0 = time.perf_counter()
    reset_all_counts()
    errs = []
    with torch.no_grad():
        x = M._embed(params, c32, toks)
        for i in range(cfg.n_layers):
            p = M._layer(params["layers"], i)
            u = M._apply_norm(p["ln"], x, c32.norm_eps)
            mix = {name: BL.mamba_apply(p["mamba"], u, Ctx(cfg=c,
                                                           layout=layout))
                   for name, c in routes.items()}
            x = x + mix["chunked"]      # `_apply_block`'s mamba residual
            errs.append(float((mix["pallas"] - mix["chunked"]).abs().max()
                              / mix["chunked"].abs().max()))
    torch.cuda.synchronize()
    counts = all_counts()
    worst = max(range(len(errs)), key=errs.__getitem__)
    tag = (f"{cfg.name} prefill {PREFILL_TOKENS} tokens, f32 compute, each "
           f"of {cfg.n_layers} layers")
    print(f"{tag}: max |pallas - chunked| / max |chunked| of the mamba "
          f"mixer's output per layer: "
          f"largest {errs[worst]:.3e} (layer {worst}), median "
          f"{statistics.median(errs):.3e}, layer 0 {errs[0]:.3e}; "
          f"selective_scan launches {counts['selective_scan']}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    launched = counts.pop("selective_scan")
    check(launched == cfg.n_layers and not any(counts.values())
          and all(math.isfinite(e) for e in errs),
          f"{tag}: selective_scan once per layer on the pallas route, no "
          f"other kernel; finite")
    check(errs[worst] <= SSM_LAYER_F32_REL_TOL,
          f"{tag}: pallas == chunked within {SSM_LAYER_F32_REL_TOL} x max "
          f"|mamba mixer output| at every layer")


def scan_bound(B, S, D, N, args, got):
    """(bytes, f32 operations) of K9: read every input once (x, B, C bf16;
    dt, A, h0 f32), write y and h_final (f32) once; per (t, d, n) dt*A,
    exp, a*h, dx*B, the sum, h*C and its sum over n, 7 operations, and
    dt*x per (t, d)."""
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        sum(t.numel() * 4 for t in got)
    return nbytes, 7 * B * S * D * N + B * S * D


def scan_times(shape, seed: int):
    """K9 at `shape` (x, B, C bf16, dt f32): (args, result, ms by events,
    device ms by torch.profiler or 0.0 where it sees none)."""
    B, S, D, N, chunk = shape
    args = scan_inputs(B, S, D, N, torch.bfloat16, torch.float32, seed=seed)
    got = SS.selective_scan(*args, chunk=chunk)
    ms = time_ms(lambda: SS.selective_scan(*args, chunk=chunk))
    dev = profiled_kernels(lambda: SS.selective_scan(*args, chunk=chunk),
                           "selective_scan", {args[0].device}, TIMED_RUNS)[0]
    return args, got, ms, dev


def scan_timing(shape, launches: int, path: str, card: str) -> dict:
    """K9 at `shape` beside its plain version and its bound; `launches` is
    what the path of that shape (`path`) launched."""
    B, S, D, N, chunk = shape
    args, got, ms, dev = scan_times(shape, seed=700 + S)
    plain = SS._selective_scan_plain(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, plain))
    rel = scan_err(got, plain)
    plain_ms = time_ms(lambda: SS._selective_scan_plain(*args), runs=3,
                       warmup=1)
    nbytes, ops = scan_bound(B, S, D, N, args, got)
    exps = B * S * D * N
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"selective_scan: xc {(B, S, D)} bf16, dt f32, B/C {(B, S, N)} "
          f"bf16, chunk {chunk} ({path}; card {card}): device "
          f"{dev:.4f} ms by torch.profiler; {exps} exps, "
          f"{exps / (n_sm * 16 * 1.755e9) * 1e3:.4f} ms at 16 a clock per "
          f"SM on {n_sm} SMs at 1.755 GHz; == plain within {SCAN_TOL} x "
          f"max(1, max |plain|): {rel <= SCAN_TOL} ({rel:.3e}, max abs "
          f"{err:.3e})",
          flush=True)
    rec = kernel_record("selective_scan", ms, plain_ms, nbytes, ops,
                        launches, err)
    rec.update(shape=f"{(B, S, D, N)} chunk {chunk}", path=path,
               device_ms=dev, within_tolerance=rel <= SCAN_TOL)
    return rec


def k9_sweep(check: Checks, card: str) -> None:
    """K9 at the timed shape on the plan's own lanes and steps and on
    `K9_PLAN_SWEEP`'s, each == the planned one within SCAN_TOL."""
    B, S, D, N, chunk = SCAN_TIMED
    args = scan_inputs(B, S, D, N, torch.bfloat16, torch.float32, seed=710)
    want = SS.selective_scan(*args, chunk=chunk)
    for lanes, steps in K9_PLAN_SWEEP:
        plan = SS.scan_device_plan("cuda", B, S, D, N, torch.bfloat16,
                                   torch.float32, lanes=lanes, steps=steps)

        def call():
            return SS._selective_scan_cuda(*args, plan)
        err = scan_err(call(), want)
        dev = profiled_kernels(call, "selective_scan", {args[0].device},
                               TIMED_RUNS)[0]
        print(f"K9 plan sweep at {(B, S, D, N)}: {lanes} lanes of {steps} "
              f"steps: {time_ms(call, runs=10):.4f} ms by events, device "
              f"{dev:.4f} ms (card {card})", flush=True)
        check(err <= SCAN_TOL, f"K9 at {lanes} lanes of {steps} steps == "
              f"its own plan within {SCAN_TOL} ({err:.3e})")


def k9_compare(card: str) -> int:
    """`--only k9`: K9 at the 2048-token prefill's shape and at a serving
    prompt's (events and device time) and the wall time of a bf16
    `falcon-mamba-7b` prefill of `PREFILL_TOKENS` tokens under
    `attention_impl="pallas"`, through the package beside this file. It
    uses only entry points that the port has had since K9 was ported, so a
    copy of this script in an older checkout times that checkout's K9 the
    same way."""
    for shape in (SCAN_TIMED, SCAN_SERVE_TIMED):
        B, S, D, N, chunk = shape
        args, got, ms, dev = scan_times(shape, seed=700 + S)
        nbytes, ops = scan_bound(B, S, D, N, args, got)
        bound, _ = bound_of(nbytes, ops)
        print(f"k9 compare ({SS.__file__}): K9 {(B, S, D, N)} chunk {chunk}, "
              f"x bf16, dt f32: {ms:.4f} ms by events, device {dev:.4f} ms, "
              f"{bound / ms:.4f} of the {bound:.4f} ms bound by events; card "
              f"{card}", flush=True)
        del args, got
    if hasattr(SS, "scan_kernel_attrs"):
        scan_attrs_lines(card)
    cfg = get_config(SSM_ARCH).replace(attention_impl="pallas")
    params = random_params(cfg, "cuda")
    layout = M.make_layout(cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_TOKENS)), device="cuda")
    walls = []
    for i in range(4):   # one warm-up, three timed
        n0 = SS.LAUNCHES["selective_scan"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            M.forward(params, {"inputs": toks}, cfg, layout)
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
        launched = SS.LAUNCHES["selective_scan"] - n0
    print(f"k9 compare ({SS.__file__}): {cfg.name} bf16 prefill of "
          f"{PREFILL_TOKENS} tokens, pallas: {statistics.median(walls):.2f} "
          f"ms of wall time (median of {walls}), K9 launches {launched}; "
          f"card {card}", flush=True)
    return 0


def distributed_only(check: Checks, card: str) -> list:
    """`--only distributed`: K7 at small shapes, the distributed path at
    67M against the single-card fused `advance(16)`, its timing, and the
    cross-card phase (the run to make on a machine of several cards). A
    copy of this script in a checkout older than K7's extended route skips
    the small shapes and times that checkout's K7 and concatenation with
    the same entry points, for a before-and-after in one call."""
    if EXTENDED:
        band_small_phase(check)
    else:
        print(f"K7 small shapes: skipped, {K.__file__} predates the "
              f"extended route", flush=True)
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T, dt=DT,
                          device="cuda")
    fields = dom.init(seed=0)
    single = dom.advance(*fields, MAIN_SUBSTEPS)
    k7_launches, mesh, dist_out, dist_runs = distributed_path_phase(
        check, fields, single)
    records = [band_timing(mesh, fields, k7_launches, dist_runs, card)]
    cross_card_phase(check, fields, dist_out, card)
    del dist_runs, dist_out, single
    torch.cuda.empty_cache()
    # the same in bf16: K7 bf16 and K1 bf16, loopback and across cards
    band_small_phase(check, dtype=BF16)
    dom16 = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T, dt=DT,
                            device="cuda", dtype="bfloat16")
    f16 = dom16.init(seed=0)
    k7, mesh, out16, runs16 = bf16_distributed_phase(check, dom16, f16, card)
    records.append(band_timing(mesh, f16, k7, runs16, card))
    cross_card_phase(check, f16, out16, card)
    return records


# ---------------------------------------------------------------------------
# the rest of the distributed path: spec runs, checkpoints, recovery
# ---------------------------------------------------------------------------

def dist_spec_inputs(op: str, fields):
    """(spec params, global fields, dt) of one operator at the 67M grid:
    the main path's (u, v, w), the tracer's q, diffusion's phi at
    `DIFFUSION_RESOLVED_DT` (so that it moves f32 bits)."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    p = REF.default_params(Z, device="cuda")
    if op == "pw":
        return p, tuple(fields), SPEC_DT[op]
    if op == "tracer":
        return (p, tuple(fields) + (SP.tracer_field(X, Y, Z, device="cuda"),),
                SPEC_DT[op])
    return (SP.default_diffusion_params(Z, device="cuda"),
            (SP.diffusion_field(X, Y, Z, device="cuda"),),
            DIFFUSION_RESOLVED_DT)


def counted(call, mesh=None):
    """`call()` with every launch count set to 0 just before and read just
    after (the cards synchronised): (its result, the counts, wall s)."""
    if mesh is None:
        torch.cuda.synchronize()
    else:
        sync(mesh)
    reset_all_counts()
    t0 = time.perf_counter()
    out = call()
    if mesh is None:
        torch.cuda.synchronize()
    else:
        sync(mesh)
    return out, all_counts(), time.perf_counter() - t0


def only_these(launches: dict, want: dict) -> bool:
    return all(n == want.get(k, 0) for k, n in launches.items())


def distributed_spec_phase(check: Checks, fields, dom, card: str) -> dict:
    """Phase 21: `make_distributed_run(n_blocks=DIST_SPEC_BLOCKS, fused,
    overlap, collective, spec=...)` over a (2, 2) loopback mesh for each
    pass of `SPEC_PATH`, == `DIST_SPEC_BLOCKS` single-card `stencil_fused`
    calls bitwise, K6 launched twice per shard, pass and block and no
    other kernel; PW euler also == the legacy run (K1) == `advance`; the
    refusal of `remote_dma` for specs on the card. Prints ms per block
    beside the single-card pass. Returns the K6 record of one boundary
    pass (PW euler T = 4) at the shard's extended slab."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    nx, ny = DIST_MESH
    mesh = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
    nb = DIST_SPEC_BLOCKS
    k6_launches, k6_err = 0, 0.0
    for op, integ, T in SPEC_PATH:
        spec = SPEC_FACTORIES[op](integ)
        sp, flds, dt = dist_spec_inputs(op, fields)
        kw = dict(n_blocks=nb, T=T, dt=dt, local_kernel="fused",
                  overlap=True, exchange="collective")
        run = D.make_distributed_run(mesh, sp, spec=spec, spec_params=sp,
                                     **kw)
        shards = D.shard(mesh, *flds)
        out, launches, wall = counted(lambda: run(shards), mesh)
        passes = len(K.spec_passes(spec, T))
        want = 2 * nx * ny * passes * nb
        tag = f"distributed spec {spec.name} T={T}"
        print(f"{tag}: {MAIN_GRID} grid {(X, Y, Z)} over a {(nx, ny)} "
              f"loopback mesh on cuda:0, make_distributed_run(n_blocks={nb},"
              f" T={T}, dt={dt}, local_kernel='fused', overlap=True, "
              f"exchange='collective', spec={spec.name}), halo depth "
              f"{spec.halo(T)}; wall {wall:.3f} s; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        check(only_these(launches, {"stencil_fused": want}),
              f"{tag}: stencil_fused launched {want} times (twice per "
              f"shard, pass and block), no other kernel")
        k6_launches += launches["stencil_fused"]
        got = D.gather(mesh, out)
        del out
        single = flds
        for _ in range(nb):
            single = K.stencil_fused(single, sp, spec, T=T, dt=dt)
        err = max(float((a - b).abs().max()) for a, b in zip(got, single))
        k6_err = max(k6_err, err)
        check(err == 0.0 and all(bool(torch.isfinite(o).all())
                                 for o in got),
              f"{tag}: == {nb} single-card stencil_fused calls at T={T}, "
              f"bitwise ({err}), finite")
        moved = max(float((a - b).abs().max()) for a, b in zip(got, flds))
        check(moved > 0.0, f"{tag}: the fields moved ({moved:.3e})")
        if op == "pw" and integ == "euler":
            legacy = D.make_distributed_run(mesh, sp, **kw)
            lout, llaunch, _ = counted(lambda: legacy(shards), mesh)
            check(only_these(llaunch, {"advect_fused": 2 * nx * ny * nb}),
                  f"{tag}: the legacy run launched K1 {2 * nx * ny * nb} "
                  f"times, no other kernel")
            adv = dom.advance(*flds, nb * T)
            check(same(got, D.gather(mesh, lout)) and same(got, adv),
                  f"{tag}: == the legacy PW make_distributed_run (K1) == "
                  f"AdvectionDomain.advance({nb * T}), bitwise")
            del lout, adv
        block_ms = time_ms(lambda: run(shards), runs=5, warmup=1) / nb
        pass_ms = time_ms(lambda: K.stencil_fused(flds, sp, spec, T=T, dt=dt),
                          runs=5, warmup=1)
        print(f"{tag}: {block_ms:.4f} ms per block of {T} steps by events "
              f"(median of 5 runs of {nb} blocks) beside the single-card "
              f"pass over the whole grid {pass_ms:.4f} ms ({block_ms / pass_ms:.4f}x); "
              f"card {card}", flush=True)
        del got, single, shards, run
    p = REF.default_params(Z, device="cuda")
    spec = SP.pw_advection_spec()
    reset_all_counts()
    try:
        D.make_distributed_run(mesh, p, n_blocks=nb, T=MAIN_T, dt=DT,
                               local_kernel="fused", exchange="remote_dma",
                               spec=spec, spec_params=p)
        refused = False
    except RuntimeError as e:
        refused = "no band exchange kernel" in str(e)
    check(refused and sum(all_counts().values()) == 0,
          "spec= with exchange='remote_dma' on the CUDA mesh raises at "
          "build time, and launches nothing")
    # K6's record: one boundary pass at the extended slab a shard reads
    D_ = spec.halo(MAIN_T)
    ext = (X // nx + 2 * D_, Y // ny + 2 * D_, Z)
    slab = tuple(f[:ext[0], :ext[1]].contiguous() for f in fields)
    xm = torch.ones(ext[0], device="cuda")
    ym = torch.ones(ext[1], device="cuda")
    call = lambda: K.stencil_fused(slab, p, spec, T=MAIN_T, dt=DT,  # noqa
                                   x_interior_mask=xm, y_interior_mask=ym)
    err = max(float((a - b).abs().max()) for a, b in
              zip(call(), plain_spec(slab, p, spec, MAIN_T, DT, xm, ym)))
    check(err == 0.0, f"K6 at the shard's extended slab {ext}, T={MAIN_T} "
          f"== plain, bitwise ({err})")
    ms = time_ms(call)
    plain_ms = time_ms(lambda: plain_spec(slab, p, spec, MAIN_T, DT, xm, ym),
                       runs=5)
    nbytes, ops = spec_bound("pw", spec, p, MAIN_T, ext)
    print(f"K6 boundary pass (distributed spec path, PW euler T={MAIN_T}) at "
          f"{ext}:", flush=True)
    rec = kernel_record("stencil_fused", ms, plain_ms, nbytes, ops,
                        k6_launches, max(err, k6_err))
    return rec


def dist_kw(exchange: str) -> dict:
    return dict(T=MAIN_T, dt=DT, local_kernel="fused", overlap=True,
                exchange=exchange)


def checkpoint_phase(check: Checks, fields, want, card: str) -> int:
    """Phase 22: PW on K1 and K7 over the (2, 2) loopback mesh, checkpointed
    every 2 blocks == `want` (the uninterrupted run, itself held to the
    single-card `advance(16)`), bitwise; stopped at block 3 and resumed to
    4 == the same; with the collective engine and `verify_integrity=True`
    too, the flags summing to 0. Times a checkpoint's write and restore
    beside ms per block, then deletes the directories. Returns K1's
    launches in the uninterrupted checkpointed run."""
    import shutil
    import tempfile

    from repro_torch.training import checkpoint as CKPT

    nx, ny = DIST_MESH
    mesh = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
    Z = fields[0].shape[2]
    p = REF.default_params(Z, device="cuda")
    nb = DIST_BLOCKS
    k1, k7 = 2 * nx * ny, 2 * len(cards_of(mesh))   # a block's launches
    k1_launches = 0
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build"))
    try:
        print(f"checkpoints under {tmp}: "
              f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB free", flush=True)
        for ex, verify in (("remote_dma", False), ("collective", True)):
            kw = dict(dist_kw(ex), verify_integrity=verify)
            tag = f"checkpointed run, exchange={ex}, verify={verify}"
            per = {"advect_fused": k1} if ex == "collective" else \
                {"advect_fused": k1, "band_exchange": k7}

            def fields_of(out):
                return D.gather(mesh, out[0] if verify else out)

            if ex == "remote_dma":
                full = D.make_distributed_run(
                    mesh, p, n_blocks=nb, checkpoint_every=2,
                    checkpoint_dir=str(tmp / "full"), **kw)
                out, launches, wall = counted(
                    lambda: full(D.shard(mesh, *fields)), mesh)
                check(only_these(launches, {k: v * nb
                                            for k, v in per.items()}),
                      f"{tag}: launches {launches}")
                k1_launches = launches["advect_fused"]
                check(same(fields_of(out), want),
                      f"{tag}: make_distributed_run(n_blocks={nb}, T="
                      f"{MAIN_T}, checkpoint_every=2) == the uninterrupted "
                      f"run, bitwise (wall {wall:.3f} s, 3 checkpoints)")
                shutil.rmtree(tmp / "full")
            part = D.make_distributed_run(
                mesh, p, n_blocks=3, checkpoint_every=2,
                checkpoint_dir=str(tmp / ex), **kw)
            _, launches, wall = counted(
                lambda: part(D.shard(mesh, *fields)), mesh)
            check(only_these(launches, {k: v * 3 for k, v in per.items()}),
                  f"{tag}: the run stopped at block 3 launched {launches}")
            res, launches, rwall = counted(
                lambda: D.resume_distributed_run(
                    mesh, p, D.shard(mesh, *fields), n_blocks=nb,
                    checkpoint_dir=str(tmp / ex), **kw), mesh)
            check(only_these(launches, per),
                  f"{tag}: the resume from block 3 to {nb} launched "
                  f"{launches}")
            flags_ok = (not verify) or int(res[1].sum()) == 0
            check(same(fields_of(res), want) and flags_ok,
                  f"{tag}: stopped at block 3 (wall {wall:.3f} s), resumed "
                  f"to {nb} (wall {rwall:.3f} s) == the uninterrupted run, "
                  f"bitwise" + (", flags sum to 0" if verify else ""))
            shutil.rmtree(tmp / ex)
        # one checkpoint's write and restore, timed apart
        shards = D.shard(mesh, *want)
        nbytes = sum(f.numel() * 4 for f in want)
        sync(mesh)
        t0 = time.perf_counter()
        state = D._run_state(mesh, shards, nb, None)
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        CKPT.save(tmp / "timed", state, nb)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = CKPT.restore(tmp / "timed", {k: 0 for k in state})
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        up = D.shard(mesh, *(torch.from_numpy(back[k]) for k in "uvw"))
        sync(mesh)
        t_up = time.perf_counter() - t0
        check(same(D.gather(mesh, up), want), "the restored checkpoint == "
              "the fields saved, bitwise")
        run = D.make_distributed_run(mesh, p, n_blocks=nb,
                                     **dist_kw("remote_dma"))
        block_ms = time_ms(lambda: run(shards), runs=5, warmup=1) / nb

        def rate(s):
            return f"{s:.4f} s ({nbytes / s / 1e9:.3f} GB/s)"

        print(f"checkpoint of the (2, 2) run at {tuple(want[0].shape)}, "
              f"{nbytes} B: write {rate(t_host + t_save)} = gather and copy "
              f"to the host {rate(t_host)} + np.savez and rename "
              f"{rate(t_save)}; restore {rate(t_read + t_up)} = np.load "
              f"{rate(t_read)} + copy to the card and shard {rate(t_up)}; "
              f"beside {block_ms:.4f} ms per block (remote_dma, events, "
              f"median of 5 runs of {nb} blocks); card {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not tmp.exists(), f"the checkpoint directory {tmp} is deleted")
    return k1_launches


RESILIENT_MESH = (1, 4)
RESILIENT_PLANS = (  # name, plan, ladder start, verify, raises
    ("clean", "", None, None, False),
    # again: the first run also pays the first use of its shapes
    ("clean again", "", None, None, False),
    ("faulted", "exchange_stall@1:stalls=5,rung=remote_dma;"
     "nan_poison@2:persistent=false;cache_evict@2;"
     "device_loss@1:reshard_to=2;device_loss@3:reshard_to=4", None, None,
     False),
    ("halo", "halo_corruption@2:field=v", "collective", True, False),
    ("persistent", "nan_poison@1", None, None, True))
RESILIENT_MIRROR = (6, 16, 12)   # the CPU run's grid (Y / 4 rows a shard)


def resilient_case(mesh, p, fields, plan: str, start, verify):
    """One `resilient_distributed_run` (K1, n_blocks 4, T 4): (out or None,
    injector, RecoveryExhausted message or None)."""
    from repro_torch.serving import faults as F

    inj = F.FaultInjector(F.FaultPlan.parse(plan))
    ladder = F.DegradationLadder(F.ELASTIC_LADDER, start=start)
    try:
        out, inj = F.resilient_distributed_run(
            mesh, p, *fields, n_blocks=DIST_BLOCKS, T=MAIN_T, dt=DT,
            local_kernel="fused", injector=inj, ladder=ladder,
            verify_integrity=verify)
        return out, inj, None
    except F.RecoveryExhausted as e:
        return None, inj, str(e)


def resilient_phase(check: Checks, fields, want, card: str) -> None:
    """Phase 23: `resilient_distributed_run` on K1 over a (1, 4) loopback
    mesh, n_blocks 4, T 4. K1 at the shards' extended slab with each edge
    shard's y mask == plain, bitwise; `make_distributed_run` on that mesh
    == `want` (the single-card `advance(16)`, or the (2, 2) run held to
    it), bitwise. Under each plan of `RESILIENT_PLANS`: the clean plan ==
    `make_distributed_run`, the faulted ones == the clean run, bitwise, a
    persistent poison raises `RecoveryExhausted`; each run's `health()` ==
    a CPU run of the same plan on `RESILIENT_MIRROR` (the fault logic
    depends on the schedule alone). Prints each run's wall seconds and the
    share spent in snapshots."""
    from repro_torch.serving import faults as F

    nx, ny = RESILIENT_MESH
    mesh = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
    cpu_mesh = make_stencil_mesh(nx, ny, devices=["cpu"] * (nx * ny))
    Z = fields[0].shape[2]
    p = REF.default_params(Z, device="cuda")
    Xm, Ym, Zm = RESILIENT_MIRROR
    small = stratus_fields(Xm, Ym, Zm, seed=0, device="cpu")
    p_small = REF.default_params(Zm, device="cpu")
    # K1 at this mesh's shard slab: no x mask (nx = 1), the y ring D = T
    # rows wide on each side, the edge shards' y masks freezing the walls
    X, Y, _ = fields[0].shape
    Yl = Y // ny
    for iy in (0, ny - 1):
        g = iy * Yl - MAIN_T + torch.arange(Yl + 2 * MAIN_T, device="cuda")
        ym = ((g >= 1) & (g <= Y - 2)).float()
        slab = tuple(f.roll(MAIN_T - iy * Yl, dims=1)[:, :Yl + 2 * MAIN_T]
                     .contiguous() for f in fields)
        got = K.advect_fused(*slab, p, T=MAIN_T, dt=DT, y_interior_mask=ym)
        err = max(float((a - b).abs().max())
                  for a, b in zip(got, plain_fused(*slab, p, MAIN_T, None,
                                                   ym)))
        check(err == 0.0, f"K1 at the (1, 4) shard slab "
              f"{tuple(slab[0].shape)}, shard y={iy}'s y mask "
              f"({int(ym.sum())} of {len(ym)} rows interior) == plain, "
              f"bitwise ({err})")
        del slab, got
    clean = D.gather(mesh, D.make_distributed_run(
        mesh, p, n_blocks=DIST_BLOCKS, T=MAIN_T, dt=DT, local_kernel="fused",
        exchange="remote_dma")(D.shard(mesh, *fields)))
    check(same(clean, want), f"make_distributed_run over the (1, 4) "
          f"loopback mesh == advance({DIST_BLOCKS * MAIN_T}), bitwise")
    spent = [0.0]
    real = F._snapshot

    def timed_snapshot(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    F._snapshot = timed_snapshot
    try:
        for name, plan, start, verify, raises in RESILIENT_PLANS:
            spent[0] = 0.0
            (out, inj, raised), launches, wall = counted(
                lambda: resilient_case(mesh, p, fields, plan, start, verify))
            h = inj.health()
            tag = f"resilient run '{name}' ({plan or 'no faults'})"
            print(f"{tag}: (1, 4) loopback mesh on cuda:0, K1, n_blocks "
                  f"{DIST_BLOCKS}, T {MAIN_T}; wall {wall:.3f} s, snapshots "
                  f"{h['snapshots']} taking {spent[0]:.4f} s "
                  f"({spent[0] / wall:.4f} of it); launches "
                  f"{ {k: v for k, v in launches.items() if v} }; health "
                  f"{ {k: v for k, v in h.items() if v and k != 'plan'} }; "
                  f"card {card}", flush=True)
            if raises:
                check(raised is not None and "persists after" in raised,
                      f"{tag}: raises RecoveryExhausted ({raised})")
            else:
                check(raised is None and same(out, clean),
                      f"{tag}: == make_distributed_run, bitwise")
            if name.startswith("clean"):
                check(only_these(launches, {"advect_fused": nx * ny
                                            * DIST_BLOCKS,
                                            "band_exchange": DIST_BLOCKS}),
                      f"{tag}: K1 once per shard and block, K7 once per "
                      f"block, no other kernel")
            if name == "halo":
                check(h["rollbacks"] == 1, f"{tag}: one rollback")
            cpu = resilient_case(cpu_mesh, p_small, small, plan, start,
                                 verify)
            check(h == cpu[1].health() and (raised is None) == (cpu[2]
                                                                 is None),
                  f"{tag}: health() == a CPU run of the same plan on "
                  f"{RESILIENT_MIRROR}")
            del out
    finally:
        F._snapshot = real


def recovery_only(check: Checks, card: str) -> list:
    """`--only recovery`: phases 22-23, both held to the single-card
    `advance(16)`, then K1's record at a boundary pass of the (2, 2) run
    (the shard's extended slab), with phase 22's launches of K1."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T, dt=DT,
                          device="cuda")
    fields = dom.init(seed=0)
    want = dom.advance(*fields, DIST_BLOCKS * MAIN_T)
    k1_launches = phase("22 checkpoint and resume", checkpoint_phase, check,
                        fields, want, card)
    phase("23 resilient run", resilient_phase, check, fields, want, card)
    del want
    nx, ny = DIST_MESH
    ext = (X // nx + 2 * MAIN_T, Y // ny + 2 * MAIN_T, Z)
    u, v, w = (f[:ext[0], :ext[1]].contiguous() for f in fields)
    p = dom.params
    xm = torch.ones(ext[0], device="cuda")
    ym = torch.ones(ext[1], device="cuda")
    K.reset_launch_counts()
    got = K.advect_fused(u, v, w, p, T=MAIN_T, dt=DT, x_interior_mask=xm,
                         y_interior_mask=ym)
    err = max(float((a - b).abs().max())
              for a, b in zip(got, plain_fused(u, v, w, p, MAIN_T, xm, ym)))
    check(err == 0.0, f"K1 at the shard's extended slab {ext} == plain, "
          f"bitwise ({err})")
    cells = math.prod(ext)
    nbytes = 6 * cells * 4 + 2 * (Z + 2) * 4 + (ext[0] + ext[1]) * 4
    ops = MAIN_T * ((ext[0] - 2) * (ext[1] - 2) * (Z - 2)
                    * REF.flops_per_cell() + 6 * cells)
    ms = time_ms(lambda: K.advect_fused(u, v, w, p, T=MAIN_T, dt=DT,
                                        x_interior_mask=xm,
                                        y_interior_mask=ym))
    plain_ms = time_ms(lambda: plain_fused(u, v, w, p, MAIN_T, xm, ym),
                       runs=5)
    print(f"K1 boundary pass (checkpointed run) at {ext}:", flush=True)
    return [kernel_record("advect_fused", ms, plain_ms, nbytes, ops,
                          k1_launches, err)]


# ---------------------------------------------------------------------------
# the stencil serving tier: K5 at B > 1 and K4 per slot
# ---------------------------------------------------------------------------

def mirror_requests(reqs, X: int, Y: int):
    """The same jobs (uids, budgets, order) cropped to an (X, Y) slot: the
    fault logic, and so the health counters and cache stats, depend on the
    schedule alone, so a CPU run of the mirror at a small slot is the CPU
    run of the same plan."""
    return [StencilRequest(uid=r.uid, u=r.u[:X, :Y], v=r.v[:X, :Y],
                           w=r.w[:X, :Y], n_steps=r.n_steps) for r in reqs]


def fresh(reqs):
    """Unserved copies of `reqs` (a run writes its requests' results)."""
    return [StencilRequest(uid=r.uid, u=r.u, v=r.v, w=r.w,
                           n_steps=r.n_steps) for r in reqs]


def serve_counted(dom, reqs, batch: int, plan=None, snapshot_dir=None):
    """One `StencilServingEngine.run` on `dom`'s device (disk snapshots in
    `snapshot_dir` where given), the launch counts set to 0 just before and
    read just after. Returns (engine, done, launches, wall s)."""
    eng = StencilServingEngine(dom, batch_size=batch, fault_plan=plan,
                               snapshot_dir=snapshot_dir)
    if dom.device != "cpu":
        torch.cuda.synchronize()
    reset_all_counts()
    t0 = time.perf_counter()
    done = eng.run(fresh(reqs))
    if dom.device != "cpu":
        torch.cuda.synchronize()
    return eng, done, all_counts(), time.perf_counter() - t0


def sequential_equal(done, dom) -> bool:
    """Every completed job's streamed states and `out` == a sequential
    `K.advect_fused` of its unpadded fields on the card, bitwise."""
    ok = True
    for req in done.values():
        if req.status != "done":
            continue
        u, v, w = REF.fields_from_numpy(req.u, req.v, req.w,
                                        dtype=getattr(torch, dom.dtype),
                                        device="cuda")
        for state in req.states:
            u, v, w = K.advect_fused(u, v, w, dom.params, T=dom.fuse_T,
                                     dt=dom.dt)
            ok &= all(np.array_equal(s, f.float().cpu().numpy())
                      for s, f in zip(state, (u, v, w)))
        ok &= len(req.states) == req.n_steps and all(
            np.array_equal(a, b) for a, b in zip(req.out, req.states[-1]))
    return ok


def primed(dom, reqs, batch: int) -> StencilServingEngine:
    """An engine of `batch` slots primed with the first jobs of `reqs`."""
    eng = StencilServingEngine(dom, batch_size=batch)
    for slot, req in enumerate(fresh(reqs)[:batch]):
        eng._prime(slot, req)
    return eng


def guard_case(check: Checks, tag: str, eng) -> None:
    """K4 on the engine's primed (B, X, Y, Z) batch == its plain version
    bitwise, on the clean batch and with a NaN planted in slot 1 at an x
    inside the slot's extent: the (B, X) flags must be 1 everywhere but
    there. The launches are comparisons, outside any counted run."""
    fields = (eng.u, eng.v, eng.w)
    got = K.finite_guard(*fields)
    clean_ok = (torch.equal(got, K._finite_guard_plain(*fields))
                and bool((got == 1.0).all()))
    slot = 1
    Xr, Yr = eng._extent[slot]
    x, y, z = Xr // 2, Yr - 1, eng.domain.Z // 2
    eng.v[slot, x, y, z] = float("nan")
    got = K.finite_guard(*fields)
    want = torch.ones_like(got)
    want[slot, x] = 0.0
    nan_ok = (torch.equal(got, K._finite_guard_plain(*fields))
              and torch.equal(got, want))
    check(clean_ok and nan_ok, f"{tag}: K4 over the engine's {eng.B} x "
          f"{tuple(eng.u.shape[1:])} batch == its plain version bitwise, "
          f"clean (all 1) and with a NaN at slot {slot}, x {x} of its "
          f"{Xr} (0 there alone)")


def serving_case(check: Checks, tag: str, dom, reqs, batch: int,
                 snapshot_dir=None):
    """The clean run and the faulted run (`SERVE_FAULT_PLAN`) of `reqs` on
    the card (disk snapshots in `snapshot_dir` where given), each gated: K5
    and K4 once a mega-step and no other kernel; clean == sequential K1
    bitwise; faulted == clean bitwise for every job not quarantined; health
    and cache stats == the CPU run of the same plan (`mirror_requests`).
    Returns the clean run's (engine, done, launches, wall)."""
    runs = {}
    for plan in (None, SERVE_FAULT_PLAN):
        # a directory a run: a checkpoint directory keeps its newest steps,
        # so one run's snapshots would prune the next one's
        eng, done, launches, wall = serve_counted(
            dom, reqs, batch, plan, None if snapshot_dir is None
            else Path(snapshot_dir) / ("clean" if plan is None
                                       else "faulted"))
        runs[plan] = (eng, done, launches, wall)
        n = eng.megasteps_executed
        what = f"{tag}, plan {plan or 'none'}"
        print(f"stencil serving ({what}): {len(done)} jobs, {n} mega-steps "
              f"({eng.steps_run} logical), batch {batch} -> {eng.B}, wall "
              f"{wall:.4f} s ({len(done) / wall:.4f} domains/s), launches "
              f"{ {k: v for k, v in launches.items() if v} }, cache "
              f"{eng.cache_stats()}, health "
              f"{ {k: v for k, v in eng.health().items() if k != 'plan'} }",
              flush=True)
        check(launches["advect_fused"] == n and launches["finite_guard"] == n
              and all(v == 0 for k, v in launches.items()
                      if k not in ("advect_fused", "finite_guard")),
              f"{what}: K5 and K4 launched once a mega-step ({n}), no other "
              f"kernel")
        mirror = AdvectionDomain(*SERVE_MIRROR, dom.Z, variant="fused",
                                 fuse_T=dom.fuse_T, dt=dom.dt, device="cpu",
                                 dtype=dom.dtype)
        cpu_eng = serve_counted(mirror, mirror_requests(reqs, *SERVE_MIRROR),
                                batch, plan)[0]
        check(eng.health() == cpu_eng.health()
              and eng.cache_stats() == cpu_eng.cache_stats(),
              f"{what}: health counters and cache stats == the CPU run of "
              f"the same plan")
    guard_case(check, tag, primed(dom, reqs, batch))
    clean, faulted = runs[None][1], runs[SERVE_FAULT_PLAN][1]
    check(sequential_equal(clean, dom), f"{tag}: every job's states and out "
          f"== sequential K1 on the card, bitwise")
    quarantined = runs[SERVE_FAULT_PLAN][0].health()["quarantined_uids"]
    check(sorted(clean) == sorted(faulted) and len(quarantined) == 1
          and all(all(np.array_equal(a, b) for a, b in
                      zip(faulted[u].out, clean[u].out)) and
                  len(faulted[u].states) == len(clean[u].states)
                  for u in clean if u not in quarantined),
          f"{tag}: the faulted run's outputs == the clean run's, bitwise "
          f"(uid {quarantined} quarantined)")
    return runs[None]


def paper_requests(X: int, Y: int, Z: int):
    """`SERVE_PAPER_REQUESTS` jobs on (X, Y, Z) slots: extents drawn in
    [X/2, X] x [Y/2, Y] and budgets in [1, SERVE_PAPER_MAX_NEW] from
    `np.random.default_rng(1)`, fields `stratus_fields(..., seed=i)`."""
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(SERVE_PAPER_REQUESTS):
        Xr = int(rng.integers(X // 2, X + 1))
        Yr = int(rng.integers(Y // 2, Y + 1))
        u, v, w = (f.numpy() for f in stratus_fields(Xr, Yr, Z, seed=i,
                                                     device="cpu"))
        reqs.append(StencilRequest(uid=i, u=u, v=v, w=w, n_steps=int(
            rng.integers(1, SERVE_PAPER_MAX_NEW + 1))))
    return reqs


def serving_timing(dom, reqs, launches: int, wall: float, n_done: int,
                   n_states: int, card: str) -> dict:
    """At B = `SERVE_BATCH` primed with the first jobs: the mega-step (K5
    then K4 through the engine's cached launcher) and K5 alone by events;
    K5's and K4's device time by `torch.profiler`; the host time to enqueue
    a mega-step, and of the launch-plan lookup within it; the time to
    stream the batch's states back; K5's plain version; and the busy share
    of a profiled `run()`. K5's record times K5 alone."""
    eng = primed(dom, reqs, SERVE_BATCH)
    print(f"K5's plan at {SERVE_BATCH} x {(dom.X, dom.Y, dom.Z)}, "
          f"T={dom.fuse_T}: " + k1_plan_text(K.fused_device_plan(
              "cuda:0", dom.X, dom.Y, dom.Z, dom.fuse_T, SERVE_BATCH),
              dom.fuse_T), flush=True)
    step = eng.cache.get(eng._step_key(), eng._build_step)
    args = (eng.u, eng.v, eng.w, REF.AdvectParams(*eng._p), eng.xm, eng.ym)
    mega_ms = time_ms(lambda: step(*args))

    def k5():
        return K.advect_fused_batched(
            eng.u, eng.v, eng.w, REF.AdvectParams(*eng._p), T=dom.fuse_T,
            dt=dom.dt, y_tile=dom.y_tile, x_interior_mask=eng.xm,
            y_interior_mask=eng.ym)

    k5_ms = time_ms(k5)
    k5_dev, k5_seen = profiled_kernels(lambda: step(*args),
                                       "advect_ring_kernel", ("cuda:0",), 10)
    k4_dev, k4_seen = profiled_kernels(lambda: step(*args),
                                       "finite_guard_kernel", ("cuda:0",), 10)
    k4_ms = time_ms(lambda: K.finite_guard(eng.u, eng.v, eng.w))
    host = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        step(*args)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    host_ms = statistics.median(host) * 1e3
    passes = K.fused_passes(dom.fuse_T)
    looks = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        for Tk in set(passes):
            K._fused_block(dom.Y, dom.Z, Tk, dom.y_tile)
        K.check_launch_grid((1, SERVE_BATCH, 1), "K1")
        for Tk in passes:
            K.fused_device_plan("cuda:0", dom.X, dom.Y, dom.Z, Tk,
                                SERVE_BATCH, dom.y_tile)
        looks.append(time.perf_counter() - t0)
    plan_us = statistics.median(looks) * 1e6
    crops = []
    for _ in range(3):
        t0 = time.perf_counter()
        for s in eng.slots.live_slots():
            eng._crop(s)
        crops.append((time.perf_counter() - t0) * 1e3)
    crop_ms = statistics.median(crops)
    crop_bytes = sum(3 * Xr * Yr * dom.Z * 4 for Xr, Yr in eng._extent)
    ps = K._slot_params(REF.AdvectParams(*eng._p), SERVE_BATCH, dom.Z,
                        eng.device)
    plain_ms = time_ms(lambda: K._advect_fused_plain(
        eng.u, eng.v, eng.w, ps, dom.fuse_T, dom.dt, eng.xm, eng.ym),
        runs=3, warmup=1)
    plain = K._advect_fused_plain(eng.u, eng.v, eng.w, ps, dom.fuse_T,
                                  dom.dt, eng.xm, eng.ym)
    got = k5()
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    del plain
    B, (X, Y, Z) = SERVE_BATCH, (dom.X, dom.Y, dom.Z)
    cells = B * X * Y * Z
    # bytes: the batch read once and written once, each slot's parameter
    # row and masks; operations: what this batch's masks leave to compute,
    # 63 per live interior cell and the 2-op update of 3 fields, per step
    k5_bytes = 6 * cells * 4 + B * (2 + 2 * Z) * 4 + B * (X + Y) * 4
    live = sum(int((eng.xm[b] > 0).sum()) * int((eng.ym[b] > 0).sum())
               for b in range(B)) * (Z - 2)
    k5_ops = dom.fuse_T * live * (REF.flops_per_cell() + 6)
    k4_bytes = R.guard_bytes_model(X, Y, Z, batch=B)
    k5_bound, k5_by = bound_of(k5_bytes, k5_ops)
    k4_bound = bound_of(k4_bytes, 3 * cells)[0]
    prof = []
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as p:
        t0 = time.perf_counter()
        StencilServingEngine(dom, batch_size=SERVE_BATCH).run(fresh(reqs))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    for e in p.key_averages():
        if getattr(e, "device_type", None) == cuda:
            prof.append((e.key, getattr(e, "device_time_total", 0.0)))
    busy_ms = sum(t for _, t in prof) / 1e3
    kern_ms = sum(t for k, t in prof if "kernel" in k) / 1e3
    copy_ms = sum(t for k, t in prof if "Memcpy" in k or "memcpy" in k) / 1e3
    print(f"stencil serving at {B} x {(X, Y, Z)}, T={dom.fuse_T}: "
          f"mega-step (K5 + K4) {mega_ms:.4f} ms by events, K5 alone "
          f"{k5_ms:.4f} ms by events; K5 device "
          f"{device_text(k5_dev)} ({k5_seen} of 10 seen), bound "
          f"{k5_bound:.4f} ms by {k5_by} ({k5_bytes} B; {k5_ops} f32 ops), "
          f"{k5_bound / k5_dev if k5_dev > 0 else float('nan'):.4f} of it by "
          f"device time; K4 device {device_text(k4_dev)} ({k4_seen} seen), "
          f"{k4_ms:.4f} ms by events, bound {k4_bound:.4f} ms "
          f"({k4_bytes} B); host enqueue of a mega-step {host_ms:.4f} ms "
          f"(median of {TIMED_RUNS}), of which K1's launch-plan lookup "
          f"{plan_us:.2f} us (what a plan held by the launcher would save; "
          f"the port's SERVING_LAUNCH_OVERHEAD_S "
          f"is {R.SERVING_LAUNCH_OVERHEAD_S * 1e3:.4f} ms); streaming the "
          f"batch's states back {crop_ms:.4f} ms ({crop_bytes} B, "
          f"{crop_bytes / crop_ms / 1e6:.1f} GB/s); K5 plain version "
          f"{plain_ms:.4f} ms; card {card}", flush=True)
    print(f"stencil serving run() at {(X, Y, Z)} slots: {n_done} jobs, "
          f"{n_states} fused steps streamed, in {wall:.4f} s "
          f"({n_done / wall:.4f} domains/s measured, {n_states / wall:.4f} "
          f"domain-steps/s, {launches} mega-steps; modelled "
          f"{eng.modelled_throughput():.4f} domain-steps/s at batch {B}); a "
          f"profiled run {prof_wall:.4f} s with {busy_ms:.4f} ms of device "
          f"activity (kernels {kern_ms:.4f}, copies {copy_ms:.4f}): busy "
          f"share {busy_ms / 1e3 / prof_wall:.4f}, kernels alone "
          f"{kern_ms / 1e3 / prof_wall:.4f}; card {card}", flush=True)
    return {"name": "advect_fused_batched", "route": "cuda",
            "source": SOURCE["advect_fused"],
            "replaces": REPLACES["advect_fused_batched"],
            "launches": launches, "max_abs_err": err, "ms": k5_ms,
            "plain_ms": plain_ms, "bound_ms": k5_bound, "bound_by": k5_by,
            "library_ms": None, "device_ms": k5_dev if k5_dev > 0 else None}


def stencil_serving_phases(check: Checks, card: str) -> list:
    """The CLI's own traffic at its full shape, then paper-size slots, each
    clean and under `SERVE_FAULT_PLAN` (`serving_case`); then the timing
    at the paper-size slots (`serving_timing`)."""
    X, Y, Z, T = STENCIL_SHAPES[False]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=T, dt=STENCIL_DT,
                          device="cuda")
    reqs = stencil_requests(X, Y, Z, SERVE_REQUESTS, SERVE_MAX_NEW)
    clean = serving_case(check, f"serve.py traffic, {(X, Y, Z)} slots", dom,
                         reqs, SERVE_BATCH)[1]
    for B in (SERVE_BATCH, SERVE_WIDE_BATCH):
        print(f"K5's plan at {B} x {(X, Y, Z)}, T={T}: "
              f"{k1_plan_text(K.fused_device_plan('cuda:0', X, Y, Z, T, B), T)}",
              flush=True)
    guard_case(check, f"serve.py traffic, batch {SERVE_WIDE_BATCH}",
               primed(dom, reqs, SERVE_WIDE_BATCH))
    eng, wide, launches, wall = serve_counted(dom, reqs, SERVE_WIDE_BATCH)
    n = eng.megasteps_executed
    print(f"stencil serving (serve.py traffic, batch {SERVE_WIDE_BATCH}): "
          f"{n} mega-steps, wall {wall:.4f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    check(launches["advect_fused"] == n and launches["finite_guard"] == n
          and sum(launches.values()) == 2 * n and sorted(wide) == sorted(clean)
          and all(all(np.array_equal(a, b) for a, b in zip(x, y))
                  for u in clean for x, y in zip(wide[u].states,
                                                 clean[u].states)),
          f"serve.py traffic at batch {SERVE_WIDE_BATCH}: K5 and K4 once a "
          f"mega-step, every state == batch {SERVE_BATCH}'s, bitwise")
    X, Y, Z = SERVE_PAPER_SLOT
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=T, dt=STENCIL_DT,
                          device="cuda")
    reqs = paper_requests(X, Y, Z)
    eng, done, launches, wall = serving_case(
        check, f"paper-size slots {(X, Y, Z)}", dom, reqs, SERVE_BATCH)
    record = serving_timing(dom, reqs, launches["advect_fused"], wall,
                            len(done), sum(len(r.states) for r in
                                           done.values()), card)
    check(record["max_abs_err"] == 0.0, "K5 at the paper-size batch == its "
          "plain version, bitwise")
    return [record]


# ---------------------------------------------------------------------------
# the other model families (slice G1c): hybrid, moe, vlm, encdec
# ---------------------------------------------------------------------------


def fam_cfg(arch: str, **cut):
    """The config at full width under `attention_impl="pallas"`, cut only
    as one card forces (printed)."""
    cfg = get_config(arch).replace(attention_impl="pallas", **cut)
    if cut:
        print(f"{arch}: cut to {cut} to fit one card", flush=True)
    return cfg


def draw(cfg):
    """The config's weights drawn on the card from seed 0, timed."""
    t0 = time.perf_counter()
    params = random_params(cfg, "cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.n_layers} layers, weights {cfg.param_dtype} "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) drawn on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    return params


def card_seq(*shape, seed: int):
    """Standard-normal f32 values drawn on the card from `seed`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda")


def counted_forward(*args, **kw):
    """`M.forward` with the launch counts set to 0 just before and read just
    after: (outputs, counts, wall ms)."""
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = M.forward(*args, **kw)
    torch.cuda.synchronize()
    return out, all_counts(), (time.perf_counter() - t0) * 1e3


def greedy_decode(params, caches, cfg, layout, first: int, pos0: int,
                  steps: int, embeds=None):
    """`steps` greedy decode steps from token `first` at `pos0`, counted:
    (the fed tokens, each step's f32 logits, counts, ms per step)."""
    fed, outs = [first], []
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(steps):
            batch = {"token": torch.tensor([fed[-1]], device="cuda"),
                     "pos": torch.tensor([pos0 + t], device="cuda")}
            if embeds is not None:
                batch["embeds"] = embeds[:, t:t + 1]
            logits, caches = M.decode_step(params, caches, batch, cfg,
                                           layout)
            outs.append(logits[0].float())
            fed.append(int(logits[0].argmax()))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return fed, outs, all_counts(), ms


def hybrid_phase(check: Checks) -> None:
    """recurrentgemma-9b at full width and depth: serve.py's traffic (no
    kernel: the window takes the attention to `attn_local`, and the RG-LRU
    has none), on rings of min(window, max_len) = 128 slots; then a
    `RG_LONG_PROMPT`-token prompt in f32 compute (past the window;
    `attn_local` pads it to two blocks of the window) and
    `RG_DECODE_STEPS` greedy decode steps through a ring of the window,
    each step's logits == a full forward over prompt + fed tokens."""
    cfg, params, _ = serving_phase(check, RG_ARCH, ())
    layout = M.make_layout(cfg, 1)
    c32 = cfg.replace(compute_dtype="float32")
    P, T = RG_LONG_PROMPT, RG_DECODE_STEPS
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, P)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    (logits, _, caches), n_pre, pre_ms = counted_forward(
        params, {"inputs": toks}, c32, layout, mode="prefill")
    caches = prefill_to_decode_cache(c32, caches, P, P + T + 2)
    ring = caches[RG_ATTN_LAYER]["k"].shape[1]
    fed, outs, n_dec, dec_ms = greedy_decode(
        params, caches, c32, layout, int(logits[0, -1].argmax()), P, T)
    seq = torch.cat([toks, torch.tensor([fed[:T]], device="cuda")], 1)
    (full, _, _), n_full, full_ms = counted_forward(
        params, {"inputs": seq}, c32.replace(scan_chunk=P + T), layout)
    peak = torch.cuda.max_memory_allocated()
    errs = [float((outs[t] - full[0, P + t]).abs().max()) for t in range(T)]
    agree = sum(int(outs[t].argmax()) == int(full[0, P + t].argmax())
                for t in range(T))
    tag = (f"{cfg.name} f32, a {P}-token prompt (window "
           f"{cfg.hybrid.window}) + {T} decode steps on a ring of {ring}")
    print(f"{tag}: prefill {pre_ms:.2f} ms, decode {dec_ms:.2f} ms a step, "
          f"full forward of {P + T} tokens {full_ms:.2f} ms; max |decode - "
          f"full forward| {max(errs):.4e} (step {errs.index(max(errs))}), "
          f"max |logit| {float(full.abs().max()):.4f}, argmax agreement "
          f"{agree} of {T}; peak memory {peak / 1e9:.2f} GB; launches "
          f"{n_pre}, {n_dec}, {n_full}", flush=True)
    check(ring == cfg.hybrid.window and not any(n_pre.values())
          and not any(n_dec.values()) and not any(n_full.values())
          and all(math.isfinite(e) for e in errs)
          and logits.shape == (1, P, cfg.vocab_size),
          f"{tag}: no kernel launched, ring of the window, logits finite")
    check(max(errs) <= RG_DECODE_F32_TOL,
          f"{tag}: each step == the full forward within {RG_DECODE_F32_TOL}")
    del params, caches, logits, full, outs


def moe_routes(record: list):
    """Wrap `blocks.moe_route` so that each call appends its (gate_idx,
    keep) to `record`; returns the original."""
    orig = BL.moe_route

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        record.append((out[3], out[5]))
        return out
    BL.moe_route = wrapped
    return orig


def moe_phase(check: Checks, arch: str, n_layers: int) -> int:
    """An MoE config at full width, `n_layers` deep, bf16 weights:
    serve.py's traffic (K8 once per layer per prefill), then one
    `PREFILL_TOKENS`-token prefill in bf16 under `pallas` and `chunked`:
    K8 once per layer on the pallas route only; the tokens whose routing
    (expert choices and capacity drops, every MoE layer) differs between
    the routes counted; the logits of the others within
    `MOE_BF16_REL_TOL` x max |chunked logit|, and at least
    `MOE_MIN_ALIKE` of the tokens routed alike. Returns K8's launches on
    the serving path and the prefill."""
    cfg, params, launched = serving_phase(
        check, arch, ("flash_attention", "flash_attention_tc"),
        n_layers=n_layers, param_dtype="bfloat16")
    layout = M.make_layout(cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_TOKENS)), device="cuda")
    out, routes = {}, {}
    for impl in ("pallas", "chunked"):
        record = []
        orig = moe_routes(record)
        try:
            out[impl] = counted_forward(params, {"inputs": toks}, cfg.replace(
                attention_impl=impl), layout)
        finally:
            BL.moe_route = orig
        routes[impl] = record
    (lp, aux_p, _), n_p, ms_p = out["pallas"]
    (lc, aux_c, _), n_c, ms_c = out["chunked"]
    alike = torch.ones(PREFILL_TOKENS, dtype=torch.bool, device="cuda")
    for (ip, kp), (ic, kc) in zip(routes["pallas"], routes["chunked"]):
        alike &= ((ip == ic) & (kp == kc)).reshape(PREFILL_TOKENS, -1).all(-1)
    diff = (lp[0] - lc[0]).abs().amax(-1)
    scale = float(lc.abs().max())
    worst = float(diff[alike].max()) if bool(alike.any()) else float("inf")
    share = float(alike.float().mean())
    agree = float((lp.argmax(-1) == lc.argmax(-1)).float().mean())
    n_moe = sum(k == "moe" for k in M.layer_kinds(cfg))
    tag = (f"{cfg.name} prefill {PREFILL_TOKENS} tokens, bf16 weights and "
           f"compute, {cfg.n_layers} layers ({n_moe} MoE)")
    print(f"{tag}: routing differs for {int((~alike).sum())} of "
          f"{PREFILL_TOKENS} tokens; max |pallas - chunked| over the others "
          f"{worst:.4e}, over all {float(diff.max()):.4e}, max |logit| "
          f"{scale:.4f}, argmax agreement {agree:.4f}; aux {float(aux_p):.6f} "
          f"/ {float(aux_c):.6f}; pallas forward {ms_p:.2f} ms, chunked "
          f"{ms_c:.2f} ms; K8 launches {n_p['flash_attention']} (pallas), "
          f"{n_c['flash_attention']} (chunked)", flush=True)
    k8 = n_p.pop("flash_attention")
    check(k8 == cfg.n_layers and n_p.pop("flash_attention_tc") == k8
          and not any(n_p.values()) and not any(n_c.values())
          and len(routes["pallas"]) == n_moe
          and bool(torch.isfinite(lp).all() and torch.isfinite(lc).all()),
          f"{tag}: K8 once per layer on the pallas route only, no other "
          f"kernel; logits finite")
    check(share >= MOE_MIN_ALIKE and worst <= MOE_BF16_REL_TOL * scale,
          f"{tag}: {share:.4f} of the tokens routed alike (>= "
          f"{MOE_MIN_ALIKE}), their logits pallas == chunked within "
          f"{MOE_BF16_REL_TOL} x max |logit| ({MOE_BF16_REL_TOL * scale:.4f})")
    del params, lp, lc, out
    return launched + k8


def vlm_batch(cfg, n: int, seed: int):
    """`n` embeddings drawn on the card from `seed`, with the M-RoPE
    positions of a 1 x `VLM_GRID` x `VLM_GRID` patch grid (t 0, h the row,
    w the column) followed by text at t = h = w = `VLM_GRID` + i."""
    g = VLM_GRID * VLM_GRID
    i = torch.arange(n, device="cuda")
    pos = torch.stack([torch.zeros_like(i), i // VLM_GRID, i % VLM_GRID], -1)
    text = (VLM_GRID + i - g)[:, None].expand(n, 3)
    pos = torch.where((i < g)[:, None], pos, text)
    emb = card_seq(1, n, cfg.d_model, seed=seed)
    return {"embeds": emb, "positions": pos[None]}


def vlm_phase(check: Checks) -> int:
    """qwen2-vl-72b at full width, `VLM_LAYERS` deep (f32 weights): the
    prefill gate on `PREFILL_TOKENS` embeddings under M-RoPE (K8 once per
    layer; pallas == chunked in f32 at every layer and in bf16 at 2), then
    `VLM_DECODE_STEPS` decode steps with embeddings (no kernel). Returns
    K8's launches in the gate's last pallas prefill and the decode's
    prefill."""
    cfg = fam_cfg(VLM_ARCH, n_layers=VLM_LAYERS)
    params = draw(cfg)
    layout = M.make_layout(cfg, 1)
    batch = vlm_batch(cfg, PREFILL_TOKENS, seed=1)
    launched = prefill_gate_phase(
        check, cfg, params, "flash_attention",
        fixed_f32_limit(PREFILL_F32_TOL), PREFILL_BF16_REL_TOL,
        bf16_kernel="flash_attention_tc", batch=batch)
    T = VLM_DECODE_STEPS
    torch.cuda.reset_peak_memory_stats()
    (logits, _, caches), n_pre, pre_ms = counted_forward(
        params, batch, cfg, layout, mode="prefill")
    caches = prefill_to_decode_cache(cfg, caches, PREFILL_TOKENS,
                                     PREFILL_TOKENS + T)
    embeds = card_seq(1, T, cfg.d_model, seed=2)
    fed, outs, n_dec, dec_ms = greedy_decode(
        params, caches, cfg, layout, 0, PREFILL_TOKENS, T, embeds=embeds)
    peak = torch.cuda.max_memory_allocated()
    tag = (f"{cfg.name} bf16, {PREFILL_TOKENS} embeddings under M-RoPE + "
           f"{T} decode steps with embeddings")
    print(f"{tag}: prefill {pre_ms:.2f} ms, decode {dec_ms:.2f} ms a step; "
          f"peak memory {peak / 1e9:.2f} GB; K8 launches "
          f"{n_pre['flash_attention']} (prefill), "
          f"{n_dec['flash_attention']} (decode); greedy tokens {fed[1:]}",
          flush=True)
    k8 = n_pre.pop("flash_attention")
    check(k8 == cfg.n_layers and not any(n_dec.values())
          and all(bool(torch.isfinite(o).all()) for o in outs)
          and outs[0].shape == (cfg.vocab_size,),
          f"{tag}: K8 once per layer at prefill, no kernel at decode; "
          f"logits finite")
    del params, caches, logits, outs
    return launched + k8


def whisper_witness(c, p, batch, layout, lc):
    """`WHISPER_F32_WITNESS_K` x max |chunked at attn_chunk 128 - chunked|
    (three kv chunks against one: the association order of the
    reference's own sums), or `PREFILL_F32_TOL` if larger."""
    lw = M.forward(p, batch, c.replace(attention_impl="chunked",
                                       attn_chunk=128), layout)[0]
    w = float((lw - lc).abs().max())
    limit = max(PREFILL_F32_TOL, WHISPER_F32_WITNESS_K * w)
    return limit, (f"max({PREFILL_F32_TOL}, {WHISPER_F32_WITNESS_K} x that "
                   f"of chunked at attn_chunk 128, {w:.4e}) = {limit:.4e}")


def whisper_phase(check: Checks) -> int:
    """whisper-large-v3 at full width and depth (32 + 32 layers, f32
    weights): an encoder over `WHISPER_FRAMES` frames and a decoder
    prefill of `WHISPER_PROMPT` tokens in f32 under `pallas` and
    `chunked` (K8 once per decoder layer, never in the encoder or
    cross-attention; the decoder logits within `whisper_witness`); then in
    bf16 a prefill and greedy decode to position max_dec_len - 1 (no
    kernel at decode). Returns K8's launches in the bf16 prefill."""
    cfg = fam_cfg(WHISPER_ARCH)
    params = draw(cfg)
    layout = M.make_layout(cfg, 1)
    e = cfg.encdec
    batch = {"enc_embeds": card_seq(1, WHISPER_FRAMES, cfg.d_model, seed=3),
             "dec_inputs": torch.as_tensor(np.random.default_rng(0).integers(
                 0, cfg.vocab_size, (1, WHISPER_PROMPT)), device="cuda")}
    c32 = cfg.replace(compute_dtype="float32")
    out = {impl: counted_forward(params, batch, c32.replace(
        attention_impl=impl), layout) for impl in ("pallas", "chunked")}
    (lp, _, _), n_p, ms_p = out["pallas"]
    (lc, _, _), n_c, ms_c = out["chunked"]
    diff = float((lp - lc).abs().max())
    limit, what = whisper_witness(c32, params, batch, layout, lc)
    tag = (f"{cfg.name} f32, encoder over {WHISPER_FRAMES} frames, decoder "
           f"prompt of {WHISPER_PROMPT} tokens")
    print(f"{tag}: max |pallas - chunked| {diff:.4e}, max |logit| "
          f"{float(lc.abs().max()):.4f}, argmax agreement "
          f"{float((lp.argmax(-1) == lc.argmax(-1)).float().mean()):.4f}; "
          f"pallas forward {ms_p:.2f} ms, chunked {ms_c:.2f} ms; K8 "
          f"launches {n_p['flash_attention']} (pallas), "
          f"{n_c['flash_attention']} (chunked)", flush=True)
    k8 = n_p.pop("flash_attention")
    check(k8 == e.dec_layers and not any(n_p.values())
          and not any(n_c.values())
          and lp.shape == (1, WHISPER_PROMPT, cfg.vocab_size)
          and bool(torch.isfinite(lp).all() and torch.isfinite(lc).all()),
          f"{tag}: K8 once per decoder layer ({e.dec_layers}) on the pallas "
          f"route only, never in the encoder or cross-attention; finite")
    check(diff <= limit, f"{tag}: pallas == chunked within {what}")
    del out, lp, lc
    torch.cuda.reset_peak_memory_stats()
    (logits, _, caches), n_pre, pre_ms = counted_forward(
        params, batch, cfg, layout, mode="prefill")
    steps = e.max_dec_len - WHISPER_PROMPT
    fed, outs, n_dec, dec_ms = greedy_decode(
        params, caches, cfg, layout, int(logits[0, -1].argmax()),
        WHISPER_PROMPT, steps)
    peak = torch.cuda.max_memory_allocated()
    tag = (f"{cfg.name} bf16, encoder + decoder prefill of "
           f"{WHISPER_PROMPT} tokens, greedy decode to position "
           f"{e.max_dec_len - 1}")
    print(f"{tag}: prefill {pre_ms:.2f} ms, decode {dec_ms:.2f} ms a step "
          f"({steps} steps); peak memory {peak / 1e9:.2f} GB; K8 launches "
          f"{n_pre['flash_attention']} (prefill), "
          f"{n_dec['flash_attention']} (decode); tokens {fed[1:11]}...",
          flush=True)
    launched = n_pre.pop("flash_attention")
    check(launched == e.dec_layers and not any(n_dec.values())
          and all(0 <= t < cfg.vocab_size for t in fed)
          and all(bool(torch.isfinite(o).all()) for o in outs),
          f"{tag}: K8 once per decoder layer at prefill, none at decode; "
          f"tokens in the vocabulary, logits finite")
    del params, caches, logits, outs
    return launched


def families_phases(check: Checks, card: str) -> list:
    """Phases 24-28: the hybrid, moe, vlm and encdec families on the card,
    each model freed before the next is drawn, then K8 at their shapes.
    Returns the kernel records of K8 at those shapes."""
    phase("24 hybrid (recurrentgemma-9b)", hybrid_phase, check)
    torch.cuda.empty_cache()
    moe_k8 = {}
    for arch, depth in MOE_ARCHS:
        moe_k8[arch] = phase(f"25 moe ({arch})", moe_phase, check, arch,
                             depth)
        torch.cuda.empty_cache()
    vlm_k8 = phase("26 vlm (qwen2-vl-72b)", vlm_phase, check)
    torch.cuda.empty_cache()
    whisper_k8 = phase("27 encdec (whisper-large-v3)", whisper_phase, check)
    torch.cuda.empty_cache()
    records = []
    t0 = time.perf_counter()
    for (arch, shape), launches in zip(ATTN_FAMILY_TIMED, (
            moe_k8["arctic-480b"], vlm_k8, whisper_k8)):
        rec = attention_timing(launches, card, shape, path=f"{arch} "
                               f"prefills (serving and gate)")
        check(rec["within_bf16_bound"], f"K8 at {arch}'s shape "
              f"{rec['shape']} == plain within bf16_bound")
        records.append(rec)
    print(f"phase 28 K8 at the families' shapes: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return records


# ---------------------------------------------------------------------------
# training (slice G2a): qwen3-32b at full width, its gates, the families
# ---------------------------------------------------------------------------


def leaves(tree) -> list:
    return PS.tree_leaves(tree, is_leaf=torch.is_tensor)


def digest(tree) -> list:
    """Two wrapping 64-bit sums (of the bits, and of their squares) of
    every slice of every leaf: what a bitwise comparison with a 56 GB
    state's copy would read, without the copy."""
    out = []
    for t in leaves(tree):
        for sl in TO.slices(t):
            b = sl.reshape(-1).view(torch.int32).to(torch.int64)
            out.append((int(b.sum()), int((b * b).sum())))
    return out


def max_rel(got, want) -> float:
    """Largest of each leaf's max |got - want| over its max |want|."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(leaves(got), leaves(want)))


def train_cfg(**kw):
    return get_config(TRAIN_ARCH).replace(n_layers=TRAIN_DEPTH,
                                          attention_impl="flash", **kw)


def train_phase(check: Checks, card: str) -> None:
    """Phase 29: `launch.train.train_loop` on qwen3-32b at full width, 4 of
    64 layers, at train.py's defaults (batch 8, seq 128, Markov data, lr
    3e-3): 20 steps, then a poisoned 21st that the guard skips; then the
    step timed by events, profiled, and a poisoned step's state digest."""
    cfg = train_cfg(remat="full")
    shape = RunShape("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt = TO.OptConfig(peak_lr=TRAIN_LR, warmup_steps=min(
        20, TRAIN_STEPS // 5), total_steps=TRAIN_STEPS)
    print(f"{cfg.name}: cut to {TRAIN_DEPTH} of 64 layers to fit one card; "
          f"{cfg.param_count() / 1e9:.3f} B params, f32 params and moments, "
          f"bf16 compute, attention_impl flash, remat full", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.perf_counter()
    state, hist, info = train_loop(cfg, steps=TRAIN_STEPS + 1,
                                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, opt=opt,
                                   log_every=5, seed=0,
                                   inject_nan_at=TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(info["skipped"] == 1 and len(hist) == TRAIN_STEPS
          and all(math.isfinite(h) for h in hist),
          f"{cfg.name} train: {TRAIN_STEPS} of {TRAIN_STEPS} steps good, "
          f"the poisoned step {TRAIN_STEPS + 1} skipped and counted once")
    check(hist[-1] < hist[0], f"{cfg.name} train: last loss {hist[-1]:.4f} "
          f"below the first {hist[0]:.4f}")
    check(not any(all_counts().values()), "the training path launched none "
          "of the port's kernels (flash attention and AdamW are plain "
          "PyTorch, as the reference's are jnp)")
    walls = [t * 1e3 for t in info["step_s"][2:TRAIN_STEPS]]
    layout = M.make_layout(cfg, 1)
    step = TS.make_train_step(cfg, layout, opt=opt)
    batch = to_device(synth_batch(cfg, shape, TRAIN_STEPS + 1, seed=0),
                      "cuda")
    ms = time_ms(lambda: step(state, batch), runs=TRAIN_TIMED, warmup=1)
    dev_ms, n_kernels = profiled_kernels(lambda: step(state, batch), "",
                                         [0], 2)
    # the step's two halves: the gradients, and the global norm with AdamW
    metrics, grads = TS.accumulated_grads(state["params"], batch, cfg,
                                          layout)

    def update():
        gn = TO.global_norm(grads)
        TO.adamw_update(TS.split_layers(state["params"]), grads,
                        TS.split_opt(state["opt"]), opt, gnorm=gn,
                        good=torch.isfinite(metrics["loss"])
                        & torch.isfinite(gn))
    opt_ms = time_ms(update, runs=TRAIN_TIMED, warmup=1)
    del grads
    before = digest(state)
    state, m = step(state, batch, poison=True)
    check(not bool(m["good"]) and digest(state) == before,
          f"{cfg.name} train: a poisoned step is not good and leaves the "
          f"params, moments and step as they were (digest of "
          f"{len(before)} slices)")
    flops = R.model_flops(cfg, shape)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 29 {cfg.name} ({TRAIN_DEPTH} L) train, {card}: "
          f"{TRAIN_STEPS + 1} steps in {loop_s:.2f} s; a step "
          f"{ms:.4f} ms by events (median of {TRAIN_TIMED}), "
          f"{statistics.median(walls):.4f} ms wall in the loop (median of "
          f"steps 3-{TRAIN_STEPS}); {tokens / ms * 1e3:.1f} tokens/s; "
          f"{flops / 1e12:.3f} TFLOP a step (6 N D), "
          f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s, "
          f"{flops / (ms / 1e3) / R.PEAK_FLOPS_BF16:.4f} of the bf16 peak; "
          f"the global norm and AdamW {opt_ms:.4f} ms by events, the "
          f"forward and backward the other {ms - opt_ms:.4f}; "
          f"kernels {device_text(dev_ms)} a step ({n_kernels // 2} "
          f"launches), busy share "
          f"{dev_ms / ms if dev_ms > 0 else 'not measured'}; peak "
          f"{peak:.2f} GB; losses {[round(h, 4) for h in hist]}",
          flush=True)
    del state, batch, step


def grads_of(params, batch, cfg, tag: str):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, g = TS.loss_and_grads(params, batch, cfg, M.make_layout(cfg, 1))
    torch.cuda.synchronize()
    print(f"  {tag}: loss {float(loss):.6f}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return loss, g


def train_gate_phase(check: Checks) -> None:
    """Phase 30: qwen3-32b at full width, 4 layers, f32 compute, batch 1,
    seq 2048: remat none / dots and scan_group 2 == remat full (flat),
    bitwise; chunked against flash; grad_accum 2 against 1; the kernel
    routes' refusal of grad on the card."""
    cfg = train_cfg(remat="full", compute_dtype="float32")
    params = random_params(cfg, "cuda")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, GATE_SEQ + 1)), device="cuda")
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    ref_loss, ref = grads_of(params, batch, cfg, "flash, remat full")
    for kw in (dict(remat="none"), dict(remat="dots"),
               dict(scan_group=2)):
        loss, g = grads_of(params, batch, cfg.replace(**kw), str(kw))
        check(torch.equal(loss, ref_loss) and all(
            torch.equal(a, b) for a, b in zip(leaves(g), leaves(ref))),
            f"{cfg.name} f32 at {GATE_SEQ} tokens: {kw} == remat full, "
            f"loss and every gradient bitwise")
        del g
    loss, g = grads_of(params, batch, cfg.replace(attention_impl="chunked"),
                       "chunked")
    err, lerr = max_rel(g, ref), abs(float(loss) - float(ref_loss))
    check(lerr <= LOSS_REL * max(1.0, abs(float(ref_loss)))
          and err <= FLASH_GRAD_REL,
          f"{cfg.name} f32: chunked vs flash loss {lerr:.3e} (limit "
          f"{LOSS_REL} x max(1, |loss|)), gradients {err:.3e} x each "
          f"leaf's max (limit {FLASH_GRAD_REL}): the same function, other "
          f"operations (flash's hand-written backward)")
    del g, ref
    B, S = GATE_ACCUM
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S + 1)), device="cuda")
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    layout = M.make_layout(cfg, 1)
    runs = [TS.accumulated_grads(params, batch, cfg.replace(grad_accum=a),
                                 layout) for a in (1, 2)]
    oc = TO.OptConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                      clip_norm=1e9, weight_decay=0.0)
    norms = [TO.global_norm(g) for _, g in runs]
    gerr = max_rel(runs[1][1], runs[0][1])
    worst, bad, flipped = 0.0, 0, 0
    for i, p in enumerate(leaves(TS.split_layers(params))):
        new = []
        for (_, g), gn in zip(runs, norms):
            one = {"p": p.clone()}
            TO.adamw_update(one, {"p": leaves(g)[i]}, TO.init_opt_state(one),
                            oc, gnorm=gn)
            new.append(one["p"])
        g1 = leaves(runs[0][1])[i]
        # AdamW's first step is about lr x sign(g): where g lies within the
        # two orders' rounding of 0, either sign is the right one
        near0 = g1.abs() <= ORDER_GRAD_REL * g1.abs().max()
        out = (new[0] - new[1]).abs() > 2e-4 + 5e-2 * new[1].abs()
        bad += int((out & ~near0).sum())
        flipped += int((out & near0).sum())
        worst = max(worst, float((new[0] - new[1]).abs().max()))
        del new, out, near0
    lerr = abs(float(runs[0][0]["loss"]) - float(runs[1][0]["loss"]))
    check(lerr < 5e-3 and gerr <= ORDER_GRAD_REL and bad == 0,
          f"{cfg.name} f32 at {B} x {S}: grad_accum 2 vs 1, loss {lerr:.3e} "
          f"(limit 5e-3), gradients {gerr:.3e} x each leaf's max (limit "
          f"{ORDER_GRAD_REL}), params after one AdamW step within the "
          f"reference test's rtol 5e-2 + atol 2e-4 wherever the gradient "
          f"is not within that of 0 ({bad} outside; {flipped} elements "
          f"with near-0 gradients stepped the other way; largest "
          f"difference {worst:.3e})")
    del runs
    pallas = cfg.replace(attention_impl="pallas")
    try:
        TS.loss_and_grads(params, {"inputs": toks[:, :129],
                                   "targets": toks[:, 1:130]}, pallas, layout)
        raised = False
    except RuntimeError as e:
        raised = "forward-only" in str(e)
    g = torch.Generator(device="cuda").manual_seed(5)
    xc = torch.randn(1, 16, 32, device="cuda", generator=g,
                     requires_grad=True)
    try:
        SS.selective_scan(xc, torch.rand_like(xc), torch.randn(
            1, 16, 4, device="cuda"), torch.randn(1, 16, 4, device="cuda"),
            -torch.rand(32, 4, device="cuda"), torch.zeros(1, 32, 4,
                                                           device="cuda"))
        raised_k9 = False
    except RuntimeError as e:
        raised_k9 = "forward-only" in str(e)
    check(raised and raised_k9, "on the card, attention_impl='pallas' (K8) "
          "under a train step and K9 with a grad-requiring input raise "
          "(forward-only), where the CUDA route returned outputs without "
          "autograd history")
    del params


def family_train_phase(check: Checks) -> None:
    """Phase 31: one train step of each other family at smoke width
    (f32, flash) on the card against the CPU: loss and gradients within
    the two summation orders' tolerance, the update against the CPU's
    from the same gradients; then a checkpointed train loop killed and
    resumed on the card == the uninterrupted run, bitwise; then serve.py
    --ckpt-dir."""
    for arch, kw in FAMILY_TRAIN:
        cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                             attention_impl="flash", **kw)
        layout = M.make_layout(cfg, 1)
        oc = TO.OptConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
        cpu = TS.init_state(cfg, layout, torch.Generator().manual_seed(0))
        gpu = tree_map(lambda t: t.to("cuda"), cpu, is_leaf=torch.is_tensor)
        raw = synth_batch(cfg, RunShape("t", "train", 32, 2), 0, seed=0)
        cb, gb = to_device(raw, "cpu"), to_device(raw, "cuda")
        lc, _, gc = TS.loss_and_grads(cpu["params"], cb, cfg, layout)
        lg, _, gg = TS.loss_and_grads(gpu["params"], gb, cfg, layout)
        again = TS.loss_and_grads(gpu["params"], gb, cfg, layout)[2]
        repeat = all(torch.equal(a, b) for a, b in zip(leaves(gg),
                                                        leaves(again)))
        gerr = max_rel([t.cpu() for t in leaves(gg)], leaves(gc))
        lerr = abs(float(lg) - float(lc))
        # the step on the card, then the same update by hand on a copy (on
        # the card, and on the CPU from the card's gradients): AdamW's
        # first step is about lr x sign(g), so it is held to the CPU's
        # given the same gradients, not across their rounding
        copy = tree_map(torch.clone, gpu, is_leaf=torch.is_tensor)
        gpu, mg = TS.make_train_step(cfg, layout, opt=oc)(gpu, gb)
        gn = TO.global_norm(gg)
        TO.adamw_update(TS.split_layers(copy["params"]), gg,
                        TS.split_opt(copy["opt"]), oc, gnorm=gn,
                        good=torch.isfinite(lg) & torch.isfinite(gn))
        by_hand = all(torch.equal(a, b) for a, b in zip(leaves(gpu),
                                                        leaves(copy)))
        host = tree_map(lambda t: t.cpu(), gg, is_leaf=torch.is_tensor)
        TO.adamw_update(TS.split_layers(cpu["params"]), host,
                        TS.split_opt(cpu["opt"]), oc, gnorm=gn.cpu())
        uerr = max(float(((a.cpu() - b).abs() - 1e-6 * b.abs()).max())
                   for a, b in zip(leaves(gpu), leaves(cpu)))
        check(lerr <= LOSS_REL * max(1.0, abs(float(lc)))
              and gerr <= ORDER_GRAD_REL and bool(mg["good"]) and repeat
              and by_hand and uerr <= 1e-9,
              f"{cfg.name} ({cfg.n_layers} L{', scan_group 1' if kw else ''}) "
              f"one step on the card vs the CPU: loss {lerr:.3e}, gradients "
              f"{gerr:.3e} x each leaf's max (limit {ORDER_GRAD_REL}), the "
              f"card's gradients repeat bitwise; the step == its update by "
              f"hand, bitwise, and the params, moments and step within "
              f"1e-6 x each value + 1e-9 of the CPU's update from the "
              f"card's gradients (excess over 1e-6 x each value "
              f"{uerr:.1e})")
    cfg = get_smoke_config(TRAIN_ARCH).replace(n_layers=RESUME_DEPTH,
                                               scan_group=2)
    opt = TO.OptConfig(peak_lr=1e-3, warmup_steps=0, total_steps=RESUME_STEPS)
    kw = dict(batch=2, seq=32, opt=opt, log_every=0, seed=99, device="cuda")
    full, hist_full, _ = train_loop(cfg, steps=RESUME_STEPS, **kw)
    d = ROOT / "build" / "ckpt_train"
    shutil.rmtree(d, ignore_errors=True)
    try:
        _, h1, _ = train_loop(cfg, steps=RESUME_KILL, ckpt_dir=d,
                              ckpt_every=RESUME_EVERY, **kw)
        # the kill: step RESUME_KILL's checkpoint never completed
        shutil.rmtree(d / f"step_{RESUME_KILL:09d}")
        resumed_from = CKPT.latest_step(d)
        resumed, h2, _ = train_loop(cfg, steps=RESUME_STEPS, ckpt_dir=d,
                                    ckpt_every=RESUME_EVERY, **kw)
        check(resumed_from == RESUME_EVERY
              and h1[:resumed_from] + h2 == hist_full
              and all(torch.equal(a, b) for a, b in zip(leaves(full),
                                                        leaves(resumed))),
              f"{cfg.name} ({RESUME_DEPTH} L, scan_group 2) on the card: "
              f"{RESUME_KILL} steps, killed, resumed from step "
              f"{resumed_from} to {RESUME_STEPS} == the uninterrupted run "
              f"(losses and final state bitwise)")
        serve_cfg = get_smoke_config(TRAIN_ARCH)
        state, _, _ = train_loop(serve_cfg, steps=2, ckpt_dir=d / "serve",
                                 **dict(kw, opt=TO.OptConfig(
                                     peak_lr=3e-2, warmup_steps=0,
                                     total_steps=2)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            SERVE.main(["--arch", TRAIN_ARCH, "--smoke", "--requests", "4",
                        "--max-new", "8", "--ckpt-dir", str(d / "serve"),
                        "--device", "cuda"])
        out = buf.getvalue()
        print(out, end="", flush=True)
        want = ServingEngine(serve_cfg, state["params"], batch_size=4,
                             max_len=128).run(
            random_requests(serve_cfg, 4, 8))
        check("[serve] restored step 2" in out and all(
            f"  req {u}: {want[u][:10]}" in out for u in range(4)),
            "serve.py --ckpt-dir on the card served the trained weights: "
            "its tokens are an engine's over the trained params")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def training_phases(check: Checks, card: str) -> None:
    """Phases 29-31: training (slice G2a)."""
    phase("29 qwen3-32b train", train_phase, check, card)
    torch.cuda.empty_cache()
    phase("30 qwen3-32b train gates", train_gate_phase, check)
    torch.cuda.empty_cache()
    phase("31 families train, resume, serve --ckpt-dir", family_train_phase,
          check)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 32-34: the static data-movement analyzer on the card
# ---------------------------------------------------------------------------

# kernel op -> its counts in LAUNCHES (K2's wide launches count apart)
OP_LAUNCH_KEYS = {"advect_fused": ("advect_fused",),
                  "finite_guard": ("finite_guard",),
                  "advect_blocked": ("advect_blocked",),
                  "advect_dataflow": ("advect_dataflow", "advect_wide"),
                  "stencil_fused": ("stencil_fused", "stencil_generated"),
                  "band_exchange": ("band_exchange",),
                  "flash_attention": ("flash_attention",),
                  "selective_scan": ("selective_scan",)}
ANALYSIS_SERVE = (512, 512, 64)
ANALYSIS_BATCH = 4
HOST_RUNS = 50


def analysis_programs() -> list:
    """Phase 32's programs at the paper's sizes (`analysis.programs`)."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    B, H, Hkv, S, Dh = ATTN_TIMED
    return [
        PR.advance_program(X, Y, Z, T=MAIN_T, n_substeps=MAIN_SUBSTEPS,
                           dt=DT),
        PR.distributed_program(X, Y, Z, exchange="collective", T=MAIN_T,
                               n_blocks=DIST_BLOCKS, mesh=DIST_MESH, dt=DT),
        PR.distributed_program(X, Y, Z, exchange="remote_dma", T=MAIN_T,
                               n_blocks=DIST_BLOCKS, mesh=DIST_MESH, dt=DT),
        PR.distributed_program(X, Y, Z, exchange="collective", T=MAIN_T,
                               n_blocks=DIST_BLOCKS, mesh=DIST_MESH,
                               verify=True, dt=DT),
        PR.serving_program(*ANALYSIS_SERVE, B=ANALYSIS_BATCH, T=MAIN_T, dt=DT),
        PR.advance_program(X, Y, Z, T=MAIN_T, n_substeps=MAIN_SUBSTEPS,
                           dt=DT, dtype=torch.bfloat16),
        PR.serving_program(*ANALYSIS_SERVE, B=ANALYSIS_BATCH, T=MAIN_T, dt=DT,
                           dtype=torch.bfloat16),
        PR.spec_path_program(X, Y, Z, dt=DT),
        PR.spec_path_program(X, Y, Z, dt=DT, dtype=torch.bfloat16),
        PR.distributed_program(X, Y, Z, exchange="remote_dma", T=MAIN_T,
                               n_blocks=DIST_BLOCKS, mesh=DIST_MESH, dt=DT,
                               dtype=torch.bfloat16),
        PR.attention_program(B, H, Hkv, S, Dh),
        PR.scan_program(*SCAN_TIMED[:3], SCAN_TIMED[3]),
    ]


def ledger_of(prog, records) -> dict:
    led = AN.MovementLedger.from_ops(records)
    if prog.per_block:
        return led.per_shard_block_totals(prog.n_shards)
    return led.totals()


def op_counts(records) -> dict:
    out = {}
    for r in records:
        if r.op is not None and r.op != "band_send":
            out[r.op] = out.get(r.op, 0) + 1
    return out


def ledger_phase(check: Checks) -> list:
    """Phase 32: each program's ledger live on the card against its models,
    its fake trace and its launch counts. Returns (program, records, the
    kernels' launched shared bytes) for phase 33."""
    recorded = []
    for prog in analysis_programs():
        with TR.fake_mode():
            fn, args = prog.build("cuda")
            fake = ledger_of(prog, TR.record_ops(fn, *args))
        del fn, args
        fn, args = prog.build("cuda")
        torch.cuda.synchronize()
        reset_all_counts()
        t0 = time.perf_counter()
        records = TR.record_ops(fn, *args, execute=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_counts()
        shared = {**K.LAUNCHED_SHARED, **A.LAUNCHED_SHARED,
                  **SS.LAUNCHED_SHARED}
        del fn, args
        torch.cuda.empty_cache()
        live = ledger_of(prog, records)
        moved = {c: b for c, b in live.items() if b}
        unit = " per shard and block" if prog.per_block else ""
        print(f"ledger {prog.name}{unit}: {moved} (claims {prog.claims}); "
              f"{len(records)} ops recorded in {wall:.2f} s", flush=True)
        for cat, want in prog.claims.items():
            check(live[cat] == want, f"32 {prog.name}: {cat} {live[cat]} == "
                  f"model {want}{unit}")
        report = AN.check_model_coverage(live, prog.claims)
        check(report.ok, f"32 {prog.name}: model coverage (pallas_control "
              f"unpriced) {[str(f) for f in report.failures]}")
        check(live == fake, f"32 {prog.name}: live ledger == fake trace, "
              f"category by category")
        ops = op_counts(records)
        for op, n in ops.items():
            got = sum(launches[k] for k in OP_LAUNCH_KEYS[op])
            check(n == got, f"32 {prog.name}: {op} ops {n} == LAUNCHES "
                  f"delta {got}")
        check(ops == prog.launches, f"32 {prog.name}: kernel ops {ops} == "
              f"{prog.launches}")
        recorded.append((prog, records, shared))
    return recorded


def n_sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def plan_phase(check: Checks, recorded) -> None:
    """Phase 33: the linter over phase 32's ops, planned == launched shared
    bytes, and an oversized plan's refusal."""
    sms = n_sms()
    for prog, records, _ in recorded:
        report = AN.lint_records(records, n_sm=sms)
        kinds = sorted({i.kind for i in report.warnings})
        print(f"lint {prog.name}: {report.kernels} kernel ops, "
              f"{len(report.errors)} errors, {len(report.warnings)} "
              f"warnings {kinds}", flush=True)
        check(not report.errors, f"33 {prog.name}: no tiling error "
              f"{[str(e) for e in report.errors[:3]]}")
    shared = {prog.name: sh for prog, _, sh in recorded}
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    nx, ny = DIST_MESH
    ext = (X // nx + 2 * MAIN_T, Y // ny + 2 * MAIN_T, Z)
    plans = [
        ("advance", "advect_fused",
         SM.fused_ring_plan(X, Y, Z, T=MAIN_T, n_sm=sms)),
        ("serving", "advect_fused",
         SM.serving_ring_plan(*ANALYSIS_SERVE, batch=ANALYSIS_BATCH,
                              T=MAIN_T, n_sm=sms)),
        # the bf16 ring plans as the f32 one: f32 words in its planes
        ("advance_bf16", "advect_fused",
         SM.fused_ring_plan(X, Y, Z, T=MAIN_T, n_sm=sms)),
        ("serving_bf16", "advect_fused",
         SM.serving_ring_plan(*ANALYSIS_SERVE, batch=ANALYSIS_BATCH,
                              T=MAIN_T, itemsize=2, n_sm=sms)),
        ("distributed_remote_dma", "advect_fused",
         SM.distributed_block_plan((X // nx, Y // ny, Z), T=MAIN_T,
                                   local_kernel="fused",
                                   exchange="remote_dma", nx=nx, ny=ny,
                                   shards_per_card=nx * ny, n_sm=sms)),
        ("spec_path", "stencil_fused",
         SM.fused_ring_plan(X, Y, Z, T=PR.SPEC_PAIRS[-1][2], n_sm=sms,
                            spec=PR._spec(*PR.SPEC_PAIRS[-1][:2]))),
        # K6 and K1 in bf16 plan as in f32: f32 words in their planes
        ("spec_path_bf16", "stencil_fused",
         SM.fused_ring_plan(X, Y, Z, T=PR.SPEC_PAIRS[-1][2], n_sm=sms,
                            spec=PR._spec(*PR.SPEC_PAIRS[-1][:2]))),
        ("distributed_remote_dma_bf16", "advect_fused",
         SM.distributed_block_plan((X // nx, Y // ny, Z), T=MAIN_T,
                                   local_kernel="fused",
                                   exchange="remote_dma", nx=nx, ny=ny,
                                   shards_per_card=nx * ny, n_sm=sms,
                                   itemsize=2)),
        ("scan", "selective_scan", None),
    ]
    for name, kernel, plan in plans:
        if plan is None:
            B, S_, Dd, N = SCAN_TIMED[:4]
            dev_plan = SS.scan_device_plan("cuda", B, S_, Dd, N,
                                           torch.bfloat16, torch.bfloat16)
            plan = SM.scan_plan(B, S_, Dd, N, x_itemsize=2, dt_itemsize=2,
                                n_sm=sms,
                                blocks_per_sm=dev_plan.blocks_per_sm)
        got = shared[name].get(kernel)
        print(f"smem plan {name} ({kernel}): {plan.total()} B planned, "
              f"{got} B launched\n{plan.table()}", flush=True)
        check(plan.total() == got, f"33 {name}: {kernel}'s planned shared "
              f"bytes {plan.total()} == launched {got}")
    # the ext slab's plan is K1's at the extended shape
    check(SM.fused_ring_plan(*ext, T=MAIN_T, n_sm=sms).total()
          == shared["distributed_collective"].get("advect_fused"),
          "33 distributed_collective: K1's planned shared bytes at the "
          "extended slab == launched")
    # the ladder's rungs, and K8's two kernels
    u, v, w = rand_fields((X, Y, Z), 3)
    p = REF.default_params(Z, device="cuda")
    for name in ("advect_blocked", "advect_dataflow", "advect_wide"):
        getattr(K, name)(u, v, w, p, fuse_update=True, dt=DT)
        torch.cuda.synchronize()
        per_sm = K.rung_device_plan("cuda", name, X, Y, Z).blocks_per_sm
        plan = SM.rung_plan(name, X, Y, Z, n_sm=sms, blocks_per_sm=per_sm)
        check(plan.total() == K.LAUNCHED_SHARED.get(name), f"33 {name}: planned "
              f"shared bytes {plan.total()} == launched "
              f"{K.LAUNCHED_SHARED.get(name)}")
    # the bf16 rungs: their stages hold 2-byte cells
    ub, vb, wb = (f.to(torch.bfloat16) for f in (u, v, w))
    pb = REF.default_params(Z, dtype=torch.bfloat16, device="cuda")
    for name in ("advect_blocked", "advect_dataflow", "advect_wide"):
        getattr(K, name)(ub, vb, wb, pb, fuse_update=True, dt=DT)
        torch.cuda.synchronize()
        per_sm = K.rung_device_plan("cuda", name, X, Y, Z,
                                    dtype=torch.bfloat16,
                                    coef=True).blocks_per_sm
        plan = SM.rung_plan(name, X, Y, Z, n_sm=sms, blocks_per_sm=per_sm,
                            itemsize=2)
        check(plan.total() == K.LAUNCHED_SHARED.get(name), f"33 {name} bf16: "
              f"planned shared bytes {plan.total()} == launched "
              f"{K.LAUNCHED_SHARED.get(name)}")
    del u, v, w, ub, vb, wb
    B, H, Hkv, S, Dh = ATTN_TIMED
    tc = A.tc_kernel_attrs(0, Dh)["shared_bytes"]
    plan = SM.attention_plan(Dh, torch.bfloat16)
    check(plan.total() == tc, f"33 K8 tensor-core build at D={Dh}: planned "
          f"shared bytes {plan.total()} == its attrs' {tc}")
    q, k, v = attn_inputs(1, 4, 2, 256, 256, Dh, torch.float32, 5)
    A.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    plan = SM.attention_plan(Dh, torch.float32)
    got = A.LAUNCHED_SHARED.get("flash_attention")
    check(plan.total() == got, f"33 K8 SIMT build at D={Dh}: planned shared "
          f"bytes {plan.total()} == launched {got}")
    # an oversized plan raises, naming its largest buffer
    big = SM.distributed_block_plan((X, Y, Z), T=MAIN_T, local_kernel="fused",
                                    exchange="remote_dma", nx=2, ny=2,
                                    shards_per_card=64, n_sm=sms)
    try:
        big.check()
        check(False, "33 an oversized plan raises SmemBudgetExceeded")
    except SM.SmemBudgetExceeded as e:
        check("largest buffer: 'K7 extended buffers (2 slots)'" in str(e),
              f"33 an oversized plan raises naming its largest buffer: "
              f"{str(e).splitlines()[0][:160]}")


def retrace_phase(check: Checks) -> None:
    """Phase 34: the distributed drivers on the card are free of retrace,
    and the fixture pair is red and green."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    nx, ny = DIST_MESH
    mesh = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
    p = REF.default_params(Z, device="cuda")
    shards = D.shard(mesh, *rand_fields((X, Y, Z), 4))
    for exchange in D.EXCHANGES:
        block = D._build_block(mesh, p, T=MAIN_T, dt=DT,
                               local_kernel="fused", y_tile=None,
                               overlap=False, exchange=exchange,
                               verify_integrity=False, corrupt_halo=None,
                               spec=None, spec_params=None)
        for k in (0, 1):    # warm: buffers, masks and both slots' tables
            block(shards, k)

        def at_block(dma_block_index):
            return (lambda sh: block(sh, dma_block_index)), (shards,)

        report = AN.detect_retrace(
            at_block, [AN.Perturbation("dma_block_index", (2, 3, 4, 5))],
            caches=lambda: AN.launch_cache_sizes(block), execute=True)
        check(report.ok, f"34 {exchange} block: dma_block_index 2-5 share "
              f"one op stream and grow no launch cache "
              f"{[str(f) for f in report.findings]}")

        def run_of(n_blocks=DIST_BLOCKS, y_tile=None):
            run = D.make_distributed_run(mesh, p, n_blocks=n_blocks,
                                         T=MAIN_T, dt=DT,
                                         local_kernel="fused",
                                         y_tile=y_tile, exchange=exchange)
            return run, (shards,)

        report = AN.detect_retrace(
            run_of, [AN.Perturbation("n_blocks", (3, 5)),
                     AN.Perturbation("y_tile", (None, 64), "distinct")],
            execute=True)
        check(report.ok, f"34 {exchange} run: n_blocks shared, y_tile "
              f"distinct {[str(f) for f in report.findings]}")
        del block
    red, green = {}, {}
    report = AN.detect_retrace(
        lambda block_index: AN.make_static_parity_driver(
            block_index, tables=red, device="cuda"),
        [AN.Perturbation("block_index", (0, 1, 2, 3))],
        caches=lambda: {"tables": len(red)}, execute=True)
    check(not report.ok and report.findings[0].kind == "leak",
          f"34 red fixture (table rebuilt from Python parity every block) "
          f"flagged: {[str(f) for f in report.findings][:1]}")
    report = AN.detect_retrace(
        lambda block_index: AN.make_traced_parity_driver(
            block_index, tables=green, device="cuda"),
        [AN.Perturbation("block_index", (0, 1, 2, 3))],
        caches=lambda: {"tables": len(green)}, execute=True)
    check(report.ok, f"34 green fixture (tables built once) clean "
          f"{[str(f) for f in report.findings]}")
    del shards
    torch.cuda.empty_cache()


def host_ms(calls: dict, runs: int = HOST_RUNS) -> dict:
    """Median host milliseconds of one call of each of `calls` (name ->
    callable), without synchronising inside it: the time before its launch
    returns. The calls take turns, one of each per round (the card idle at
    each start), so that no order or warm-up favours one."""
    for _ in range(5):
        for call in calls.values():
            call()
    torch.cuda.synchronize()
    times = {name: [] for name in calls}
    for _ in range(runs):
        for name, call in calls.items():
            t0 = time.perf_counter()
            call()
            times[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    return {name: statistics.median(t) for name, t in times.items()}


def _dispatch_floor_op():
    """An op of K1's schema whose CUDA implementation does nothing: the
    dispatcher's own cost of a call, the floor under the op layer's."""
    lib = torch.library.Library("chip_smoke_probe", "FRAGMENT")
    lib.define("k1_schema(Tensor u, Tensor v, Tensor w, Tensor tcx, "
               "Tensor tcy, Tensor tzc1, Tensor tzc2, Tensor xm, Tensor ym, "
               "int T, float dt, int y_tile) -> ()")
    lib.impl("k1_schema", lambda *args: None, "CUDA")
    return lib, torch.ops.chip_smoke_probe.k1_schema.default


def host_cost_lines(card: str) -> dict:
    """The op layer's host cost: K1, K7 and K8 through their op, their bare
    launch function and their public wrapper, at the main path's shapes,
    in one call; and the dispatcher's floor at K1's schema."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    out = {}
    u, v, w = rand_fields((X, Y, Z), 6)
    p = REF.default_params(Z, device="cuda")
    ps = K._slot_params(p, 1, Z, u.device)
    ub, vb, wb = u[None], v[None], w[None]
    xm, ym = torch.ones(X, device="cuda"), torch.ones(Y, device="cuda")
    lib, floor_op = _dispatch_floor_op()
    k1 = host_ms({
        "op": lambda: K._OP_K1(ub, vb, wb, *ps, xm, ym, MAIN_T, DT, 0),
        "bare": lambda: K._advect_fused_cuda(ub, vb, wb, ps, MAIN_T, DT, xm,
                                             ym),
        "wrapper": lambda: K.advect_fused(u, v, w, p, T=MAIN_T, dt=DT),
        "floor": lambda: floor_op(ub, vb, wb, *ps, xm, ym, MAIN_T, DT, 0)})
    del lib
    floor = k1.pop("floor")
    out["K1"] = (k1["op"], k1["bare"], k1["wrapper"])
    del u, v, w, ub, vb, wb
    nx, ny = DIST_MESH
    mesh = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
    shards = D.shard(mesh, *rand_fields((X, Y, Z), 7))
    slabs = K.BandSlabs(mesh, shards[0][0].shape, MAIN_T, 0)
    table = slabs.table("x", 0, shards)
    ptrs = tuple(f.data_ptr() for trio in shards for f in trio)
    flat = [f for trio in shards for f in trio]
    regions = [f for trio in slabs.extended(0) for f in trio]
    k7 = host_ms({
        "op": lambda: K._OP_K7(flat, regions, slabs.words, table.handle,
                               -1, False),
        "bare": lambda: K._band_exchange_cuda(slabs, table, ptrs),
        "wrapper": lambda: K.halo_band_exchange_dma(
            shards, mesh=mesh, axis="x", depth=MAIN_T, dim=0, slabs=slabs)})
    out["K7"] = (k7["op"], k7["bare"], k7["wrapper"])
    del shards, slabs, table, flat, regions
    torch.cuda.empty_cache()
    B, H, Hkv, S, Dh = ATTN_TIMED
    q, k, v = attn_inputs(B, H, Hkv, S, S, Dh, torch.bfloat16, 8)
    o = torch.empty_like(q)
    scale = Dh ** -0.5
    k8 = host_ms({
        "op": lambda: A._OP_K8(q, k, v, o, True, scale, 128, 128),
        "bare": lambda: A._flash_attention_cuda(q, k, v, True, scale, 128,
                                                128, o),
        "wrapper": lambda: A.flash_attention(q, k, v, causal=True, out=o)})
    out["K8"] = (k8["op"], k8["bare"], k8["wrapper"])
    for name, (op_ms, bare_ms, wrap_ms) in out.items():
        print(f"op layer host cost {name}: {op_ms:.4f} ms through the op, "
              f"{bare_ms:.4f} ms through the bare launch, {wrap_ms:.4f} ms "
              f"through the public wrapper (the op's cost "
              f"{op_ms - bare_ms:+.4f} ms; medians of {HOST_RUNS}, the "
              f"three taking turns; {card})",
              flush=True)
    print(f"op layer host cost: a no-op op of K1's schema {floor:.4f} ms "
          f"(the dispatcher's floor; {card})", flush=True)
    out["floor"] = floor
    return out


def analysis_phases(check: Checks, card: str) -> list:
    recorded = phase("32 movement ledger", ledger_phase, check)
    phase("33 plans and alignment", plan_phase, check, recorded)
    del recorded
    torch.cuda.empty_cache()
    phase("34 retrace", retrace_phase, check)
    phase("34 op host cost", host_cost_lines, card)
    return []


# ---------------------------------------------------------------------------
# the bf16 PW path: K1/K5, K4, K3 and K2 on bf16 fields (phases 35-39)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# shapes with remainder y-tiles at y_tile 4, 5, 7 (Z = 16 and 24 let `wide`
# move 8 bf16 cells a vector; Z = 12 takes K4's 1-cell path only; the rungs
# run their pair build at even Z and their one-cell build at Z = 15)
BF16_SHAPES = ((6, 10, 16), (5, 17, 12), (8, 12, 24), (6, 10, 15))
BF16_U = 2.0 ** -8      # bf16's unit roundoff (8 significant bits)
BF16_ORACLE_SLACK = 1.1  # the stencil's propagation of earlier roundings
BF16_SNAPSHOTS = ROOT / "build" / "bf16_snapshots"
# dt of phase 36's second gate: at the paper's DT an update below half a
# bf16 ulp of its cell rounds away, and few cells move
BF16_RESOLVED_DT = 0.5
# the bf16 kernels' launch keys and their entry in the kernels line
BF16_RUNGS = {"advect_blocked": "blocked", "advect_dataflow": "dataflow",
              "advect_wide": "wide"}
# the rate of the timed bf16 kernels' operations: with a bf16 domain's
# coefficients every op of the source and the update rounds to bf16
BF16_PEAK = R.PEAK_FLOPS_BF16_SIMT


def bf16_params(Z: int, coef: str):
    """The domain's coefficients in f32 (the kernel tests' case) or bf16
    (a bf16 domain's)."""
    return REF.default_params(Z, dtype=torch.float32 if coef == "f32"
                              else BF16, device="cuda")


def bf16_oracle_bound(oracle, n: int) -> float:
    """The bound on a bf16 run of n Euler steps against the f64 oracle: each
    step's update rounds once to bf16, an error of at most u = 2^-8 of the
    field's magnitude M (the largest |oracle| over the run's fields), and
    the source's own bf16 roundings are scaled by dt (under 1 % of that at
    the paper's dt); `BF16_ORACLE_SLACK` covers the stencil carrying the
    earlier steps' errors (a factor 1 + n * dt * |d src / d f| < 1.03)."""
    M = max(float(o.abs().max()) for o in oracle)
    return BF16_ORACLE_SLACK * n * BF16_U * M


def cell_gate(check: Checks, tag: str, out, fields, oracle, bounds) -> None:
    """`out` within `REF.pw_multistep_bf16_bound`'s bound of the f64 oracle
    in every cell, and the gate able to fail a no-op: `fields`, the inputs,
    lie outside it somewhere."""
    def over(got):
        return sum(int(((g.double() - o).abs() > b).sum())
                   for g, o, b in zip(got, oracle, bounds))

    n_out, n_noop = over(out), over(fields)
    worst = max(float(((g.double() - o).abs() / b.clamp_min(1e-300)).max())
                for g, o, b in zip(out, oracle, bounds))
    cells = sum(f.numel() for f in fields)
    print(f"{tag} against the f64 oracle cell by cell: {n_out} of {cells} "
          f"cells outside their bound (largest |err| / bound {worst:.4f}; "
          f"largest bound {max(float(b.max()) for b in bounds):.6f}); the "
          f"inputs returned unchanged would lie outside it at {n_noop} "
          f"cells", flush=True)
    check(n_out == 0, f"{tag}: every cell within its derived bound of the "
          f"f64 oracle ({n_out} outside)")
    check(n_noop > 0, f"{tag}: the per-cell gate fails a no-op ({n_noop} "
          f"cells)")


def device_per_launch(call, match: str, runs: int = 10):
    """(device ms per launch the profiler saw, launches seen) of `call`,
    which launches one kernel matching `match` a run: a trace that drops
    events then reads low by none of them."""
    dev, seen = profiled_kernels(call, match, ("cuda:0",), runs)
    return (dev * runs / seen if seen else 0.0), seen


def bf16_small_phase(check: Checks) -> None:
    """Phase 35: every bf16 kernel == its plain version bitwise at small
    shapes, with f32 and with bf16 coefficients."""
    for coef in ("f32", "bf16"):
        for si, shape in enumerate(BF16_SHAPES):
            X, Y, Z = shape
            u, v, w = rand_fields(shape, seed=300 + si, dtype=BF16)
            p = bf16_params(Z, coef)
            tag = f"bf16 {shape} {coef} coefficients"
            for T in (1, 2, 3, 4):
                full = K.advect_fused(u, v, w, p, T=T, dt=DT)
                torch.cuda.synchronize()
                check(all(o.dtype == BF16 for o in full)
                      and same(full, plain_fused(u, v, w, p, T)),
                      f"35 K1 == plain, {tag} T={T}")
                for y_tile in (4, 5, 7):
                    check(same(K.advect_fused(u, v, w, p, T=T, dt=DT,
                                              y_tile=y_tile), full),
                          f"35 K1 tiled == untiled, {tag} T={T} "
                          f"y_tile={y_tile}")
            check(same(K.advect_fused(u, v, w, p, T=10, dt=DT, y_tile=5),
                       plain_fused(u, v, w, p, 10)),
                  f"35 K1 T=10 as passes {K.fused_passes(10)} == plain, "
                  f"{tag}")
            xm = torch.ones(X, device="cuda")
            xm[:2] = 0.0
            ym = torch.ones(Y, device="cuda")
            ym[Y // 2:] = 0.0
            masked = K.advect_fused(u, v, w, p, T=3, dt=DT, x_interior_mask=xm,
                                    y_interior_mask=ym, y_tile=4)
            check(same(masked, plain_fused(u, v, w, p, 3, xm, ym)),
                  f"35 K1 masked tiled == plain masked, {tag}")
            gu, gv, gw, flags = K.advect_fused(u, v, w, p, T=2, dt=DT,
                                               guard=True)
            check(same((gu, gv, gw), K.advect_fused(u, v, w, p, T=2, dt=DT))
                  and flags.dtype == torch.float32
                  and bool((flags == 1.0).all()),
                  f"35 K1 guarded == unguarded, f32 flags all 1, {tag}")
            check(K.rung_pairs(u, v, w) == (Z % 2 == 0),
                  f"35 the rungs run their "
                  f"{'pair' if Z % 2 == 0 else 'one-cell'} build, {tag}")
            for fu in (False, True):
                plain = K._advect_rung_plain(u, v, w, p, fu, DT)
                kw = dict(fuse_update=fu, dt=DT)
                rtag = f"{tag} fuse_update={fu}"
                for name in BF16_RUNGS:
                    if name == "advect_wide" and Z % 8:
                        continue
                    fn = getattr(K, name)
                    got = fn(u, v, w, p, **kw)
                    check(all(o.dtype == BF16 for o in got)
                          and same(got, plain),
                          f"35 {name} own plan == plain, {rtag}")
                    for y_tile in (3, 4, 5):
                        check(same(fn(u, v, w, p, y_tile=y_tile, **kw),
                                   plain),
                              f"35 {name} tiled == untiled, {rtag} "
                              f"y_tile={y_tile}")
                    for x_chunk in (1, 3):
                        got = K._advect_rung_cuda(name, u, v, w, p, 4, fu,
                                                  DT, x_chunk=x_chunk)
                        check(same(got, plain), f"35 {name} x-chunks of "
                              f"{x_chunk} == plain, {rtag}")
                    if name != "advect_wide":
                        check(same(fn(u, v, w, p, y_tile=4, tiling="host",
                                      **kw), plain),
                              f"35 {name} host == grid, {rtag}")
    bf16_batched_phase(check)
    bf16_guard_phase(check)
    # fields 2 bytes past an allocation: the 1-cell rungs copy cell by cell
    shape = (5, 9, 12)
    u, v, w = rand_fields(shape, seed=320, dtype=BF16)
    p = bf16_params(12, "bf16")
    off = offset_copies((u, v, w))
    check(not K.rung_pairs(*off), "35 fields 2 bytes past an allocation run "
          "the rungs' one-cell build")
    for name in ("advect_blocked", "advect_dataflow"):
        got = getattr(K, name)(*off, p, fuse_update=True, dt=DT)
        check(same(got, K._advect_rung_plain(u, v, w, p, True, DT)),
              f"35 {name} bf16 on fields 2 bytes past an allocation == "
              f"plain")
    try:
        K.advect_wide(u, v, w, p)
        refused = False
    except ValueError as err:
        refused = "Z % 8" in str(err)
    check(refused, "35 bf16 wide refuses Z = 12 (24 B rows), naming Z % 8")
    out = K.stencil_fused([u, v, w], p, SP.pw_advection_spec("euler"), T=1)
    check(same(out, K.advect_fused(u, v, w, p, T=1, dt=1.0))
          and all(o.dtype == BF16 for o in out),
          "35 K6 takes bf16 fields (its refusal lifted): == K1 bf16, bitwise")


def offset_copies(fields):
    """Copies of bf16 `fields`, each starting 2 bytes past an allocation (off
    every 4-byte boundary: the rungs run their one-cell build on them)."""
    out = []
    for f in fields:
        buf = torch.empty(f.numel() + 1, device=f.device, dtype=f.dtype)
        out.append(buf[1:].view(f.shape))
        out[-1].copy_(f)
    return out


def bf16_batched_phase(check: Checks) -> None:
    """K5 on bf16 slots: per-slot bf16 (and f32) coefficients and masks, a
    smaller request padded into slot 2, == sequential and == plain."""
    B, X, Y, Z, T = 3, 5, 17, 16, 2
    Xr, Yr = 4, 11
    fields = [rand_fields((X, Y, Z), seed=330 + b, dtype=BF16)
              for b in range(B)]
    for f in fields[2]:
        f[Xr:] = 0.0
        f[:, Yr:] = 0.0
    u, v, w = (torch.stack([fl[i] for fl in fields]) for i in range(3))
    xm = torch.ones(B, X, device="cuda")
    ym = torch.ones(B, Y, device="cuda")
    xm[1, 2] = 0.0
    ym[0, 5:9] = 0.0
    xm[2] = (torch.arange(X, device="cuda") <= Xr - 2).float()
    xm[2, 0] = 0.0
    ym[2] = ((torch.arange(Y, device="cuda") >= 1)
             & (torch.arange(Y, device="cuda") <= Yr - 2)).float()
    for coef in ("f32", "bf16"):
        base = bf16_params(Z, coef)
        scale = torch.tensor([1.0, 1.5, 0.5], device="cuda",
                             dtype=base.tcx.dtype)
        p = REF.AdvectParams(base.tcx * scale, base.tcy * scale,
                             base.tzc1[None] * scale[:, None], base.tzc2)
        for y_tile in (None, 5):
            out = K.advect_fused_batched(u, v, w, p, T=T, dt=DT,
                                         y_tile=y_tile, x_interior_mask=xm,
                                         y_interior_mask=ym)
            seq = all(same([o[b] for o in out], K.advect_fused(
                u[b], v[b], w[b], slot_params(p, b), T=T, dt=DT,
                y_tile=y_tile, x_interior_mask=xm[b], y_interior_mask=ym[b]))
                for b in range(B))
            plain = K._advect_fused_plain(u, v, w,
                                          K._slot_params(p, B, Z, "cuda"),
                                          T, DT, xm, ym)
            alone = K.advect_fused(*(f[2, :Xr, :Yr].contiguous()
                                     for f in (u, v, w)), slot_params(p, 2),
                                   T=T, dt=DT)
            check(seq and same(out, plain)
                  and same([o[2, :Xr, :Yr] for o in out], alone),
                  f"35 K5 bf16, per-slot {coef} coefficients, y_tile="
                  f"{y_tile}: batched == sequential == plain, the padded "
                  f"request == its unpadded run")


def bf16_guard_phase(check: Checks) -> None:
    """K4 on bf16 fields: clean, and with a NaN and an inf planted, on the
    16-byte path and the 1-cell path, batched too."""
    X, Y, Z = 8, 16, 64
    u, v, w = rand_fields((X, Y, Z), seed=340, dtype=BF16)
    clean = K.finite_guard(u, v, w)
    check(torch.equal(clean, K._finite_guard_plain(u, v, w))
          and clean.dtype == torch.float32 and bool((clean == 1.0).all()),
          "35 K4 bf16 clean: f32 flags all 1 == plain")
    bad = [f.clone() for f in (u, v, w)]
    bad[0][2, 3, 5] = float("nan")
    bad[2][5, 0, 0] = float("inf")
    bad[1][7, 15, 63] = float("-inf")
    got = K.finite_guard(*bad)
    check(torch.equal(got, K._finite_guard_plain(*bad))
          and got.tolist() == [1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 0.0],
          "35 K4 bf16 with NaN and inf planted == plain")
    stacked = [torch.stack([f, g, f]) for f, g in zip((u, v, w), bad)]
    check(torch.equal(K.finite_guard(*stacked),
                      K._finite_guard_plain(*stacked)),
          "35 K4 bf16 batched == plain")
    odd = [f[:, :15, :61].contiguous() for f in bad]   # Y*Z % 8 != 0
    check(torch.equal(K.finite_guard(*odd), K._finite_guard_plain(*odd)),
          "35 K4 bf16 on the 1-cell path == plain")


def bf16_main_path_phase(check: Checks):
    """Phase 36: `AdvectionDomain(67M, fused, dtype="bfloat16")
    .advance(16)` and K4, counted; == plain bitwise, within the bound of
    the f64 oracle, edges frozen."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T, dt=DT,
                          device="cuda", dtype="bfloat16")
    u0, v0, w0 = dom.init(seed=0)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = dom.advance(u0, v0, w0, MAIN_SUBSTEPS)
    flags = K.finite_guard(*out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    plan = K.fused_device_plan("cuda:0", X, Y, Z, MAIN_T, dtype=BF16,
                               coef=True)
    a = K.fused_kernel_attrs("cuda:0", MAIN_T, plan, dtype=BF16, coef=True)
    print(f"bf16 main path: {MAIN_GRID} grid {(X, Y, Z)} bf16 fields and "
          f"coefficients, advance({MAIN_SUBSTEPS}) with fuse_T={MAIN_T}; K1 "
          f"plan TY={plan.TY}, CX={plan.CX}, {plan.grid[0]} blocks of "
          f"{plan.threads} threads, {plan.shared_bytes} B shared, "
          f"{a['registers']} registers, {a['local_bytes']} B spilled, "
          f"{a['blocks_per_sm']} resident per SM; wall {wall:.3f} s; "
          f"launches {launches}", flush=True)
    for name, n in launches.items():
        want = {"advect_fused": MAIN_SUBSTEPS // MAIN_T,
                "finite_guard": 1}.get(name, 0)
        check(n == want, f"36 bf16 main path: {name} launched {n} times "
              f"({want} expected)")
    check(all(o.dtype == BF16 and o.shape == (X, Y, Z)
              and bool(torch.isfinite(o).all()) for o in out)
          and bool((flags == 1.0).all()),
          "36 bf16 outputs finite bf16 of shape (X, Y, Z), flags all 1")
    for f0, fT in zip((u0, v0, w0), out):
        check(frozen_edges(f0, fT), "36 bf16 boundary planes unchanged")
    plain = plain_fused(u0, v0, w0, dom.params, MAIN_SUBSTEPS)
    k1_err = max(float((a - b).float().abs().max())
                 for a, b in zip(out, plain))
    check(k1_err == 0.0, f"36 bf16 main path == plain version, bitwise "
          f"({k1_err})")
    del plain
    k4_err = float((flags - K._finite_guard_plain(*out)).abs().max())
    check(k4_err == 0.0, "36 bf16 guard flags == plain flags")
    oracle, cell_bounds = REF.pw_multistep_bf16_bound(
        u0, v0, w0, dom.params, MAIN_SUBSTEPS, DT)
    err = max(float((o.double() - r).abs().max())
              for o, r in zip(out, oracle))
    bound = bf16_oracle_bound(oracle, MAIN_SUBSTEPS)
    moved = max(float((a.double() - r).abs().max())
                for a, r in zip((u0, v0, w0), oracle))
    print(f"bf16 main path against the f64 oracle: max |err| {err:.6f}, "
          f"bound {bound:.6f} (1.1 x {MAIN_SUBSTEPS} x 2^-8 x max |f|); the "
          f"oracle moved the fields by up to {moved:.6f}, so a no-op "
          f"{'passes' if moved <= bound else 'fails'} this bound",
          flush=True)
    check(err <= bound, f"36 bf16 main path within {bound:.6f} of the f64 "
          f"oracle ({err:.6f})")
    cell_gate(check, "36 bf16 main path", out, (u0, v0, w0), oracle,
              cell_bounds)
    del oracle, cell_bounds
    changed = sum(int((a != b).sum()) for a, b in zip(out, (u0, v0, w0)))
    print(f"bf16 main path: {changed} of {3 * X * Y * Z} cells changed over "
          f"advance({MAIN_SUBSTEPS}) (an update below half a bf16 ulp of its "
          f"cell rounds away)", flush=True)
    check(changed > 0, "36 the bf16 fields moved")
    return dom, (u0, v0, w0), out, launches, k1_err, k4_err


def bf16_resolved_phase(check: Checks) -> None:
    """Phase 36, at `BF16_RESOLVED_DT`: a bf16 domain at the 67M grid on
    normal fields, one K1 pass (T = 4) where most updates exceed half a bf16
    ulp of their cell, == plain bitwise and within the per-cell bound of the
    f64 oracle, which a no-op breaks in most cells."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T,
                          dt=BF16_RESOLVED_DT, device="cuda",
                          dtype="bfloat16")
    fields = rand_fields((X, Y, Z), seed=350, dtype=BF16)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = dom.advance(*fields, MAIN_T)
    torch.cuda.synchronize()
    tag = f"36 bf16 at dt={BF16_RESOLVED_DT}"
    check(dict(K.LAUNCHES).get("advect_fused") == 1,
          f"{tag}: K1 launched once, one pass ({dict(K.LAUNCHES)})")
    plain = plain_fused(*fields, dom.params, MAIN_T, dt=BF16_RESOLVED_DT)
    check(same(out, plain), f"{tag}: == plain version, bitwise")
    del plain
    oracle, bounds = REF.pw_multistep_bf16_bound(
        *fields, dom.params, MAIN_T, BF16_RESOLVED_DT)
    cell_gate(check, tag, out, fields, oracle, bounds)
    changed = sum(int((a != b).sum()) for a, b in zip(out, fields))
    print(f"{tag}: {changed} of {3 * X * Y * Z} cells changed", flush=True)


def bf16_ladder_phase(check: Checks, fields):
    """Phase 37: each rung through a bf16 domain at the 67M grid, with and
    without `fuse_update`, advance(4), counted, == plain bitwise."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    u0, v0, w0 = fields
    results = {}
    for name, variant in BF16_RUNGS.items():
        errs = []
        for fu in (False, True):
            dom = AdvectionDomain(X, Y, Z, variant=variant, fuse_update=fu,
                                  dt=DT, device="cuda", dtype="bfloat16")
            plain = (u0, v0, w0)
            for _ in range(LADDER_SUBSTEPS):
                s = K._advect_rung_plain(*plain, dom.params, fu, DT)
                plain = s if fu else tuple(K._euler(f, si, DT) for f, si
                                           in zip(plain, s))
            torch.cuda.synchronize()
            K.reset_launch_counts()
            out = dom.advance(u0, v0, w0, LADDER_SUBSTEPS)
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            tag = f"bf16 {variant} fuse_update={fu}"
            rp = K.rung_device_plan("cuda:0", name, X, Y, Z, dom.run_y_tile,
                                    dtype=BF16, coef=True)
            a = K.rung_kernel_attrs("cuda:0", name, rp, dtype=BF16, coef=True)
            print(f"bf16 ladder path: {tag}, y_tile={dom.run_y_tile}, plan "
                  f"TY={rp.TY}, CX={rp.CX}, {rp.threads} threads, "
                  f"{rp.shared_bytes} B shared, {a['registers']} registers, "
                  f"{a['local_bytes']} B spilled, {a['blocks_per_sm']} "
                  f"resident per SM; launches {launches}", flush=True)
            check(all((n == LADDER_SUBSTEPS) if k == name else n == 0
                      for k, n in launches.items()),
                  f"37 {tag}: {name} launched {LADDER_SUBSTEPS} times, no "
                  f"other kernel")
            err = max(float((a - b).float().abs().max())
                      for a, b in zip(out, plain))
            check(err == 0.0, f"37 {tag}: == plain version, bitwise ({err})")
            check(all(frozen_edges(f0, fT) for f0, fT in zip(fields, out)),
                  f"37 {tag}: boundary planes unchanged")
            errs.append(err)
            del out, plain
        results[name] = (launches[name], max(errs))
    return results


def bf16_serving_phase(check: Checks, card: str) -> list:
    """Phase 38: the serving tier on bf16 slots of `SERVE_PAPER_SLOT`,
    clean and under `SERVE_FAULT_PLAN`, with disk snapshots: K5 and K4 once
    a mega-step, batched == sequential and rolled back == clean, bitwise;
    K4 over the batch; then K5's times."""
    X, Y, Z = SERVE_PAPER_SLOT
    dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T,
                          dt=STENCIL_DT, device="cuda", dtype="bfloat16")
    reqs = paper_requests(X, Y, Z)
    shutil.rmtree(BF16_SNAPSHOTS, ignore_errors=True)
    try:
        eng, done, launches, wall = serving_case(
            check, f"38 bf16 paper-size slots {(X, Y, Z)}, disk snapshots",
            dom, reqs, SERVE_BATCH, snapshot_dir=BF16_SNAPSHOTS)
        written = sorted(p.name for p in BF16_SNAPSHOTS.glob("*/step_*"))
    finally:
        shutil.rmtree(BF16_SNAPSHOTS, ignore_errors=True)
    check(bool(written), f"38 bf16 snapshots written to disk ({written})")
    check(all(r.out is None or r.out[0].dtype == np.float32
              for r in done.values()),
          "38 bf16 outputs come back as float32 arrays of the bf16 values")
    eng = primed(dom, reqs, SERVE_BATCH)
    step = eng.cache.get(eng._step_key(), eng._build_step)
    args = (eng.u, eng.v, eng.w, REF.AdvectParams(*eng._p), eng.xm, eng.ym)

    def k5():
        return K.advect_fused_batched(
            eng.u, eng.v, eng.w, REF.AdvectParams(*eng._p), T=dom.fuse_T,
            dt=dom.dt, x_interior_mask=eng.xm, y_interior_mask=eng.ym)

    ps = K._slot_params(REF.AdvectParams(*eng._p), SERVE_BATCH, Z, eng.device)
    plain = K._advect_fused_plain(eng.u, eng.v, eng.w, ps, dom.fuse_T,
                                  dom.dt, eng.xm, eng.ym)
    err = max(float((a - b).float().abs().max())
              for a, b in zip(k5(), plain))
    del plain
    check(err == 0.0, f"38 K5 bf16 at {SERVE_BATCH} x {(X, Y, Z)} == plain, "
          f"bitwise")
    guard_case(check, "38 bf16 paper-size slots", primed(dom, reqs,
                                                         SERVE_BATCH))
    k5_ms = time_ms(k5)
    mega_ms = time_ms(lambda: step(*args))
    k5_dev, seen = device_per_launch(k5, "advect_ring_kernel")
    plain_ms = time_ms(lambda: K._advect_fused_plain(
        eng.u, eng.v, eng.w, ps, dom.fuse_T, dom.dt, eng.xm, eng.ym),
        runs=3, warmup=1)
    B, cells = SERVE_BATCH, SERVE_BATCH * X * Y * Z
    nbytes = 6 * cells * 2 + B * (2 + 2 * Z) * 4 + B * (X + Y) * 4
    live = sum(int((eng.xm[b] > 0).sum()) * int((eng.ym[b] > 0).sum())
               for b in range(B)) * (Z - 2)
    ops = dom.fuse_T * live * (REF.flops_per_cell() + 6)
    rec = kernel_record("advect_fused", k5_ms, plain_ms, nbytes, ops,
                        launches["advect_fused"], err, BF16_PEAK)
    rec.update(name="advect_fused_batched_bf16",
               replaces=REPLACES["advect_fused_batched"],
               device_ms=k5_dev if k5_dev > 0 else None)
    print(f"bf16 stencil serving at {B} x {(X, Y, Z)}: K5 {k5_ms:.4f} ms by "
          f"events, device {device_text(k5_dev)} ({seen} of 10 seen), "
          f"{rec['bound_ms'] / k5_dev if k5_dev > 0 else 0.0:.4f} of the "
          f"bound by device; the mega-step (K5 + K4) {mega_ms:.4f} ms; "
          f"run() {wall:.4f} s for {len(done)} jobs; card {card}",
          flush=True)
    return [rec]


def bf16_timing_phase(check: Checks, dom, fields, out, launches, k1_err,
                      k4_err, ladder, card: str) -> list:
    """Phase 39: each bf16 kernel at the 67M grid by events and device
    time, beside its bound, plain time, registers and spills."""
    X, Y, Z = dom.X, dom.Y, dom.Z
    u, v, w = fields
    p, T, cells = dom.params, dom.fuse_T, X * Y * Z
    ones_x = torch.ones(X, device="cuda")
    ones_y = torch.ones(Y, device="cuda")
    src_ops = (X - 2) * (Y - 2) * (Z - 2) * REF.flops_per_cell()

    def k1():
        return K.advect_fused(u, v, w, p, T=T, dt=DT)

    k1_ms = time_ms(k1)
    k1_dev, k1_seen = device_per_launch(k1, "advect_ring_kernel")
    k1_plain = time_ms(lambda: K._advect_fused_plain(
        u[None], v[None], w[None], p, T, DT, ones_x, ones_y), runs=5)
    k1_bytes = 6 * cells * 2 + 2 * (Z + 2) * 4 + (X + Y) * 4
    k1_ops = T * (src_ops + 6 * cells)
    k4_ms = time_ms(lambda: K.finite_guard(*out))
    k4_dev, k4_seen = device_per_launch(lambda: K.finite_guard(*out),
                                        "finite_guard")
    k4_plain = time_ms(lambda: K._finite_guard_plain(*out))
    k4_bytes = R.guard_bytes_model(X, Y, Z, itemsize=2)
    records = []
    for name, ms, dev, seen, plain_ms, nbytes, ops, peak, n, err in (
            ("advect_fused", k1_ms, k1_dev, k1_seen, k1_plain, k1_bytes,
             k1_ops, BF16_PEAK, launches["advect_fused"], k1_err),
            ("finite_guard", k4_ms, k4_dev, k4_seen, k4_plain, k4_bytes,
             3 * cells, R.PEAK_FLOPS_F32, launches["finite_guard"], k4_err)):
        rec = kernel_record(name, ms, plain_ms, nbytes, ops, n, err, peak)
        rec.update(name=name + "_bf16", device_ms=dev if dev > 0 else None)
        print(f"{name} bf16 at {(X, Y, Z)}: device {device_text(dev)} a "
              f"launch ({seen} of 10 seen), "
              f"{rec['bound_ms'] / dev if dev > 0 else 0.0:.4f} of the bound "
              f"by device; card {card}", flush=True)
        records.append(rec)
    plan = K.fused_device_plan("cuda:0", X, Y, Z, T, dtype=BF16, coef=True)
    for coef in (False, True):
        a = K.fused_kernel_attrs("cuda:0", T, plan, dtype=BF16, coef=coef)
        print(f"K1 bf16 build T={T} C={plan.cells_per_thread} "
              f"({'bf16' if coef else 'f32'} coefficients): "
              f"{a['registers']} registers, {a['local_bytes']} B spilled, "
              f"{a['blocks_per_sm']} resident per SM", flush=True)
    rung_bytes = 6 * cells * 2 + (2 + 2 * Z) * 4
    rung_plain = time_ms(lambda: K._advect_rung_plain(u, v, w, p, True, DT),
                         runs=5)
    for name in BF16_RUNGS:
        fn = getattr(K, name)

        def call():
            return fn(u, v, w, p, fuse_update=True, dt=DT)

        ms = time_ms(call)
        dev, seen = device_per_launch(call, RUNG_KERNEL[name])
        rp = K.rung_device_plan("cuda:0", name, X, Y, Z, dtype=BF16,
                                coef=True)
        a = K.rung_kernel_attrs("cuda:0", name, rp, dtype=BF16, coef=True)
        n, err = ladder[name]
        rec = kernel_record(name, ms, rung_plain, rung_bytes,
                            src_ops + 6 * cells, n, err, BF16_PEAK)
        rec.update(name=name + "_bf16", device_ms=dev if dev > 0 else None)
        print(f"{name} bf16 fuse_update=True on its own plan (TY={rp.TY}, "
              f"CX={rp.CX}, {rp.threads} threads, {rp.shared_bytes} B, "
              f"{a['registers']} registers, {a['local_bytes']} B spilled, "
              f"{a['blocks_per_sm']} resident per SM): {ms:.4f} ms by "
              f"events, device {device_text(dev)} ({seen} of 10 seen), "
              f"{rec['bound_ms'] / dev if dev > 0 else 0.0:.4f} of the bound "
              f"by device; card {card}", flush=True)
        records.append(rec)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dom.advance(u, v, w, MAIN_SUBSTEPS)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"bf16 main path: advance({MAIN_SUBSTEPS}) "
          f"{statistics.median(walls):.4f} ms of wall time (median of 5); "
          f"card {card}", flush=True)
    return records


# ---------------------------------------------------------------------------
# phases 40-43: K6 and K7 in bf16, and K6 for user-written specs
# ---------------------------------------------------------------------------

TOL_REL_BF16 = 0.02     # the reference's TOL_REL["bfloat16"] of the field
#                         scale (tests/test_stencil_spec.py:35)
DIST_BF16_TOL = 0.1     # the reference's bf16 2D step against its global
#                         oracle (tests/test_distributed_2d.py:64)
SPEC_BF16_SHAPES = ((6, 10, 12), (9, 14, 20))
SPEC_BF16_DT = 0.1      # at unit spacings most updates exceed half a bf16
#                         ulp of their cell, so == plain says something
SPEC_BF16_CHUNKS = ((5, 4, 9), (3, 2, None))   # TY, CX, CZ of given plans


def unit_spec_inputs(op: str, shape, seed: int, fields_dtype, coef_dtype):
    """(params, fields) of one shipped operator at unit spacings: normal
    fields of `fields_dtype`, coefficients of `coef_dtype` (diffusion at
    nu = 0.1)."""
    X, Y, Z = shape
    n = {"pw": 3, "tracer": 4, "diffusion": 1}[op]
    fields = rand_fields(shape, seed, fields_dtype)
    fields = (fields + rand_fields(shape, seed + 1, fields_dtype))[:n]
    if op == "diffusion":
        return (SP.default_diffusion_params(Z, dx=1.0, dy=1.0, dz=1.0,
                                            nu=0.1, dtype=coef_dtype,
                                            device="cuda"), fields)
    return (REF.default_params(Z, dx=1.0, dy=1.0, dz=1.0, dtype=coef_dtype,
                               device="cuda"), fields)


def ones_cuda(n: int) -> torch.Tensor:
    return torch.ones(n, device="cuda")


def k6_bf16_small_phase(check: Checks) -> None:
    """Phase 40 at small shapes: K6 on bf16 fields == its plain version,
    bitwise, for the six operator x integrator pairs with f32 and with bf16
    coefficients: T 1-3, y_tile None and 3 (tiled == untiled), with and
    without masks; x and z chunks with remainders on given plans; T = 5 as
    passes; the PW spec == K1 bf16; batched == sequential. Each check also
    asks that the fields moved."""
    dt = SPEC_BF16_DT
    for coef in ("f32", "bf16"):
        cd = torch.float32 if coef == "f32" else BF16
        for si, shape in enumerate(SPEC_BF16_SHAPES):
            X, Y, Z = shape
            xm, ym = ones_cuda(X), ones_cuda(Y)
            xm[2] = 0.0
            ym[3:5] = 0.0
            for op, factory in SPEC_FACTORIES.items():
                params, fields = unit_spec_inputs(op, shape, 600 + 10 * si,
                                                  BF16, cd)
                for integ in SP.INTEGRATORS:
                    spec = factory(integ)
                    tally = {"plain": [], "moved": [], "k1": [],
                             "chunks": [], "passes": []}
                    for T in (1, 2, 3):
                        for masked in (False, True):
                            mk = dict(x_interior_mask=xm if masked else None,
                                      y_interior_mask=ym if masked else None)
                            plain = plain_spec(fields, params, spec, T, dt,
                                               *mk.values())
                            tally["moved"].append(not same(plain, fields))
                            for y_tile in (None, 3):
                                out = K.stencil_fused(fields, params, spec,
                                                      T=T, dt=dt,
                                                      y_tile=y_tile, **mk)
                                tally["plain"].append(
                                    same(out, plain)
                                    and all(o.dtype == BF16 for o in out))
                                if op == "pw" and integ == "euler":
                                    tally["k1"].append(same(out, K.advect_fused(
                                        *fields, params, T=T, dt=dt,
                                        y_tile=y_tile, **mk)))
                    pv = K._spec_param_vectors(spec, params, "cuda", BF16)
                    plain = plain_spec(fields, params, spec, 2, dt)
                    for TY, CX, CZ in SPEC_BF16_CHUNKS:
                        plan = K.fused_plan_with_chunks(
                            K.spec_device_plan("cuda", X, Y, Z, spec, 2, 1, TY,
                                               dtype=BF16,
                                               coef=coef == "bf16"),
                            X, Z, spec.stages * 2, CX=CX, CZ=CZ,
                            knobs=K.spec_plan_knobs(spec, 2))
                        got = K._stencil_fused_cuda(
                            [f[None] for f in fields], pv, spec, 2, dt,
                            ones_cuda(X), ones_cuda(Y), plan=plan)
                        tally["chunks"].append(
                            plan.n_cx > 1 and same((g[0] for g in got), plain))
                    out, launches, _ = counted(lambda: K.stencil_fused(
                        fields, params, spec, T=5, dt=dt))
                    tally["passes"].append(
                        same(out, plain_spec(fields, params, spec, 5, dt))
                        and only_these(launches, {"stencil_fused": len(
                            K.spec_passes(spec, 5))}))
                    tag = f"40 K6 bf16 {spec.name} {shape} {coef} coefficients"
                    check(all(tally["plain"]) and all(tally["moved"]),
                          f"{tag}: == plain, bitwise, bf16 out, "
                          f"{len(tally['plain'])} runs (T 1-3, y_tile None "
                          f"and 3, masks), the fields moved")
                    check(all(tally["chunks"]), f"{tag}: x and z chunks "
                          f"with remainders on given plans == plain, bitwise")
                    check(all(tally["passes"]), f"{tag}: T = 5 as passes "
                          f"{K.spec_passes(spec, 5)} == plain, bitwise")
                    if tally["k1"]:
                        check(all(tally["k1"]), f"{tag}: the PW spec == K1 "
                              f"bf16 (advect_fused), bitwise, "
                              f"{len(tally['k1'])} runs")
    B, shape = 3, SPEC_BF16_SHAPES[1]
    X, Y, Z = shape
    xm, ym = torch.ones(B, X, device="cuda"), torch.ones(B, Y, device="cuda")
    xm[1, 2] = 0.0
    ym[2, 5:9] = 0.0
    for op, factory in SPEC_FACTORIES.items():
        slots = [unit_spec_inputs(op, shape, 700 + 2 * b, BF16, BF16)
                 for b in range(B)]
        params = slots[0][0]
        fields = [torch.stack([sl[1][i] for sl in slots])
                  for i in range(len(slots[0][1]))]
        for integ in SP.INTEGRATORS:
            spec = factory(integ)
            out = K.stencil_fused_batched(fields, params, spec, T=2, dt=dt,
                                          x_interior_mask=xm,
                                          y_interior_mask=ym)
            ok = [same([o[b] for o in out], K.stencil_fused(
                [f[b] for f in fields], params, spec, T=2, dt=dt,
                x_interior_mask=xm[b], y_interior_mask=ym[b]))
                for b in range(B)]
            check(all(ok), f"40 K6 bf16 batched (B = {B}, per-slot masks) "
                  f"== sequential, bitwise, {spec.name}")


def k6_bf16_path_phase(check: Checks, fields) -> dict:
    """Phase 40 at the 67M grid: one `stencil_fused` pass per operator of
    `SPEC_PATH` on bf16 fields (the bf16 domain's u, v, w, the tracer's q,
    diffusion's phi) and bf16 coefficients, counted; == plain, bitwise, and
    within `TOL_REL_BF16` of the f64 oracle's field scale. Returns
    {(op, integrator): run record}."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    u0, v0, w0 = fields
    q0 = SP.tracer_field(X, Y, Z, dtype=BF16, device="cuda")
    phi0 = SP.diffusion_field(X, Y, Z, dtype=BF16, device="cuda")
    p = REF.default_params(Z, dtype=BF16, device="cuda")
    inputs = {"pw": (p, (u0, v0, w0)), "tracer": (p, (u0, v0, w0, q0)),
              "diffusion": (SP.default_diffusion_params(Z, dtype=BF16,
                                                        device="cuda"),
                            (phi0,))}
    runs = {}
    for op, integ, T in SPEC_PATH:
        spec = SPEC_FACTORIES[op](integ)
        params, flds = inputs[op]
        dt = SPEC_DT[op]
        out, launches, wall = counted(lambda: K.stencil_fused(
            flds, params, spec, T=T, dt=dt))
        n = len(K.spec_passes(spec, T))
        plain = plain_spec(flds, params, spec, T, dt)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(out, plain))
        o_err, scale, moved = oracle_err(out, flds, params, spec, T, dt)
        tag = f"40 K6 bf16 {spec.name} T={T} at {(X, Y, Z)}"
        print(f"{tag}: wall {wall:.3f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }; vs plain "
              f"{err}; vs f64 oracle {o_err:.4e} (scale {scale:.4e}, the "
              f"oracle moved the fields by {moved:.4e})", flush=True)
        check(only_these(launches, {"stencil_fused": n}) and err == 0.0
              and all(o.dtype == BF16 for o in out),
              f"{tag}: {n} launch(es), == plain, bitwise")
        check(o_err <= TOL_REL_BF16 * scale, f"{tag}: within "
              f"{TOL_REL_BF16} x the field scale of the f64 oracle "
              f"({o_err:.4e} <= {TOL_REL_BF16 * scale:.4e})")
        runs[op, integ] = dict(spec=spec, params=params, fields=flds, T=T,
                               dt=dt, launches=launches["stencil_fused"],
                               err=err)
        del plain, out
        # at the path's dt most bf16 updates round away (the error above is
        # the oracle's own motion): once more at unit spacings and
        # `SPEC_BF16_DT` on normal fields, where they resolve
        up, uf = unit_spec_inputs(op, (X, Y, Z), 950, BF16, BF16)
        got = K.stencil_fused(uf, up, spec, T=T, dt=SPEC_BF16_DT)
        moved = sum(int((a != b).sum()) for a, b in zip(got, uf))
        check(same(got, plain_spec(uf, up, spec, T, SPEC_BF16_DT))
              and moved > 0, f"{tag}, at unit spacings and dt "
              f"{SPEC_BF16_DT} on normal fields: == plain, bitwise, "
              f"{moved} cells moved")
        del got, uf
    return runs


def k6_bf16_timing(runs, card: str) -> dict:
    """Each bf16 pass of phase 40 timed (events, device time), beside its
    bound at 2-byte cells and bf16 operations, and its plain version; the
    record is the PW euler pass (K1 bf16's bitwise partner)."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    per_op = []
    for (op, integ), r in runs.items():
        spec, params, flds, T, dt = (r["spec"], r["params"], r["fields"],
                                     r["T"], r["dt"])

        def call():
            return K.stencil_fused(flds, params, spec, T=T, dt=dt)

        ms = time_ms(call)
        dev, seen = device_per_call(call, "stencil_", ("cuda:0",))
        plain_ms = time_ms(lambda: plain_spec(flds, params, spec, T, dt),
                           runs=5)
        nbytes, ops = spec_bound(op, spec, params, T, (X, Y, Z), itemsize=2)
        bound, bound_by = bound_of(nbytes, ops, BF16_PEAK)
        print(f"spec path bf16 on the card: {spec.name} T={T}: {ms:.4f} ms "
              f"per call by events (median of {TIMED_RUNS}), device "
              f"{device_text(dev)} a call ({seen} launches seen in 10 "
              f"calls), "
              f"bound {bound:.4f} ms by {bound_by} ({nbytes} B, {ops} bf16 "
              f"ops), {bound / dev if dev > 0 else 0.0:.4f} of the bound by "
              f"device; plain version {plain_ms:.4f} ms; card {card}",
              flush=True)
        per_op.append({"operator": spec.name, "T": T,
                       "launches": r["launches"], "max_abs_err": r["err"],
                       "ms": ms, "device_ms": dev if dev > 0 else None,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by})
    for coef in (False, True):
        spec = SP.pw_advection_spec()
        plan = K.spec_device_plan("cuda:0", X, Y, Z, spec, MAIN_T,
                                  dtype=BF16, coef=coef)
        a = K.spec_kernel_attrs("cuda:0", spec, MAIN_T, plan, dtype=BF16,
                                coef=coef)
        print(f"K6 bf16 build pw_advection T={MAIN_T} "
              f"C={plan.cells_per_thread} ({'bf16' if coef else 'f32'} "
              f"coefficients): {a['registers']} registers, "
              f"{a['local_bytes']} B spilled, {a['blocks_per_sm']} resident "
              f"per SM", flush=True)
    pw = per_op[0]
    return {"name": "stencil_fused_bf16", "route": "cuda",
            "source": SOURCE["stencil_fused"],
            "replaces": REPLACES["stencil_fused"],
            "launches": sum(o["launches"] for o in per_op),
            "max_abs_err": max(o["max_abs_err"] for o in per_op),
            "ms": pw["ms"], "device_ms": pw["device_ms"],
            "plain_ms": pw["plain_ms"], "bound_ms": pw["bound_ms"],
            "bound_by": pw["bound_by"], "library_ms": None,
            "operators": per_op}


def bf16_distributed_phase(check: Checks, dom, fields, card: str):
    """Phase 41: the bf16 PW run at the 67M grid over the (2, 2) loopback
    mesh, `make_distributed_run(n_blocks=4, T=4, fused)` with overlap False
    and True: `remote_dma` (K7 bf16, one put per card, phase and block; K1
    bf16) == `collective`, == the single-card bf16 `advance(16)`, bitwise,
    and within `DIST_BF16_TOL` of `reference_global_step` in bf16. Returns
    (K7's launches, the mesh, the remote_dma output, the overlap runs)."""
    X, Y, Z = dom.X, dom.Y, dom.Z
    nx, ny = DIST_MESH
    mesh = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
    single = dom.advance(*fields, MAIN_SUBSTEPS)
    k7, outs, runs = 0, {}, {}
    for overlap in (False, True):
        for ex in ("remote_dma", "collective"):
            out, launches, wall, run, shards = distributed_run(
                mesh, fields, ex, overlap=overlap)
            outs[ex, overlap] = out
            if overlap:
                runs[ex] = (run, shards)
            want = {"advect_fused": (2 if overlap else 1) * nx * ny
                    * DIST_BLOCKS}
            if ex == "remote_dma":
                want["band_exchange"] = k7_puts(mesh)
                k7 = launches["band_exchange"]
            tag = f"41 bf16 distributed {ex} overlap={overlap}"
            print(f"{tag}: {MAIN_GRID} grid {(X, Y, Z)} over a {(nx, ny)} "
                  f"loopback mesh on cuda:0, make_distributed_run(n_blocks="
                  f"{DIST_BLOCKS}, T={MAIN_T}, local_kernel='fused'); wall "
                  f"{wall:.3f} s; launches "
                  f"{ {k: v for k, v in launches.items() if v} }", flush=True)
            check(only_these(launches, want), f"{tag}: launches {want}, no "
                  f"other kernel")
            check(all(o.dtype == BF16 and bool(torch.isfinite(o).all())
                      for o in out), f"{tag}: finite bf16 outputs")
        check(same(outs["remote_dma", overlap], outs["collective", overlap]),
              f"41 bf16 distributed overlap={overlap}: remote_dma == "
              f"collective, bitwise")
        check(same(outs["remote_dma", overlap], single),
              f"41 bf16 distributed overlap={overlap}: == the single-card "
              f"bf16 advance({MAIN_SUBSTEPS}), bitwise")
    oracle = D.reference_global_step(*fields, dom.params, T=MAIN_SUBSTEPS,
                                     dt=DT)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(outs["remote_dma", True], oracle))
    check(err < DIST_BF16_TOL, f"41 bf16 distributed: within "
          f"{DIST_BF16_TOL} of reference_global_step in bf16 ({err:.4e})")
    del oracle, single
    return k7, mesh, outs["remote_dma", True], runs


def bf16_dist_spec_phase(check: Checks, fields, want, card: str) -> None:
    """Phase 42: the `spec=` runs on `collective` with K6 bf16 (each pass of
    `SPEC_PATH`, bf16 fields and coefficients, two blocks) == two
    single-card K6 bf16 calls == the plain spec loop, bitwise; the
    `remote_dma` refusal for specs on the card stands; then a checkpointed
    bf16 PW run (K1 and K7 bf16) and its resume from block 3 == the clean
    run `want` (phase 41's), bitwise."""
    import shutil
    import tempfile
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    nx, ny = DIST_MESH
    mesh = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
    nb = DIST_SPEC_BLOCKS
    p = REF.default_params(Z, dtype=BF16, device="cuda")
    # phi ~ 300 would not move in bf16: diffusion runs on a normal field
    inputs = {"pw": (p, tuple(fields), SPEC_DT["pw"]),
              "tracer": (p, tuple(fields) + (SP.tracer_field(
                  X, Y, Z, dtype=BF16, device="cuda"),), SPEC_DT["tracer"]),
              "diffusion": (SP.default_diffusion_params(Z, dtype=BF16,
                                                        device="cuda"),
                            rand_fields((X, Y, Z), 42, BF16)[:1], 4.0)}
    for op, integ, T in SPEC_PATH:
        spec = SPEC_FACTORIES[op](integ)
        sp, flds, dt = inputs[op]
        run = D.make_distributed_run(mesh, sp, spec=spec, spec_params=sp,
                                     n_blocks=nb, T=T, dt=dt,
                                     local_kernel="fused", overlap=True,
                                     exchange="collective")
        shards = D.shard(mesh, *flds)
        out, launches, wall = counted(lambda: run(shards), mesh)
        got = D.gather(mesh, out)
        del out, shards
        n = 2 * nx * ny * len(K.spec_passes(spec, T)) * nb
        single = plain = flds
        for _ in range(nb):
            single = K.stencil_fused(single, sp, spec, T=T, dt=dt)
            plain = plain_spec(plain, sp, spec, T, dt)
        tag = f"42 bf16 distributed spec {spec.name} T={T}"
        moved = not same(got, flds)
        print(f"{tag}: collective, {nb} blocks, wall {wall:.3f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }, the fields "
              f"moved: {moved}", flush=True)
        check(only_these(launches, {"stencil_fused": n}), f"{tag}: K6 "
              f"launched {n} times, no other kernel")
        check(same(got, single) and same(got, plain) and moved
              and all(g.dtype == BF16 for g in got),
              f"{tag}: == {nb} single-card K6 bf16 calls == the plain spec "
              f"loop, bitwise; the fields moved")
        del got, single, plain
    reset_all_counts()
    try:
        D.make_distributed_run(mesh, p, n_blocks=nb, T=MAIN_T, dt=DT,
                               local_kernel="fused", exchange="remote_dma",
                               spec=SP.pw_advection_spec(), spec_params=p)
        refused = False
    except RuntimeError as e:
        refused = "no band exchange kernel" in str(e)
    check(refused and sum(all_counts().values()) == 0,
          "42 spec= with exchange='remote_dma' on the CUDA mesh still raises "
          "at build time (by design), launching nothing")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_bf16_", dir=ROOT / "build"))
    try:
        kw = dict(dist_kw("remote_dma"))
        full = D.make_distributed_run(mesh, p, n_blocks=DIST_BLOCKS,
                                      checkpoint_every=2,
                                      checkpoint_dir=str(tmp / "full"), **kw)
        out, launches, wall = counted(lambda: full(D.shard(mesh, *fields)),
                                      mesh)
        check(same(D.gather(mesh, out), want), f"42 bf16 checkpointed run "
              f"(remote_dma, every 2 blocks) == the clean run, bitwise "
              f"(wall {wall:.3f} s)")
        part = D.make_distributed_run(mesh, p, n_blocks=3, checkpoint_every=2,
                                      checkpoint_dir=str(tmp / "part"), **kw)
        part(D.shard(mesh, *fields))
        res, launches, rwall = counted(lambda: D.resume_distributed_run(
            mesh, p, D.shard(mesh, *fields), n_blocks=DIST_BLOCKS,
            checkpoint_dir=str(tmp / "part"), **kw), mesh)
        per = {"advect_fused": 2 * nx * ny, "band_exchange": 2}
        check(only_these(launches, per) and same(D.gather(mesh, res), want)
              and all(r.dtype == BF16 for trio in res for r in trio),
              f"42 bf16 run stopped at block 3, resumed to {DIST_BLOCKS} "
              f"(wall {rwall:.3f} s, launches {per}) == the clean run, "
              f"bitwise, bf16 shards")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not tmp.exists(), f"42 the checkpoint directory {tmp} is deleted")


# --- phase 43: user-written specs, built from their own callbacks ----------

USER_STAR = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
             (0, 0, -1), (0, 0, 1))


def lap_xyz_source(sh, pv):
    """A 7-point Laplacian whose x, y and z terms each have a coefficient of
    their own, [cx, cy, cz(Z)] (cz per level)."""
    (t,) = pv
    cx, cy, cz = t[0], t[1], t[2:][1:-1]
    c = sh(0, 0, 0, 0)
    return (cx * (sh(0, -1, 0, 0) + sh(0, 1, 0, 0))
            + cy * (sh(0, 0, -1, 0) + sh(0, 0, 1, 0))
            + cz * (sh(0, 0, 0, -1) + sh(0, 0, 0, 1))
            - 2.0 * (cx + cy + cz) * c,)


def yz_cross_source(sh, pv):
    """The mixed y-z derivative (the centre plane's four diagonals) and an
    x difference, [k_yz, k_x]."""
    (t,) = pv
    return (t[0] * (sh(0, 0, 1, 1) - sh(0, 0, 1, -1) - sh(0, 0, -1, 1)
                    + sh(0, 0, -1, -1))
            + t[1] * (sh(0, 1, 0, 0) - sh(0, 0, 0, 0)),)


def gray_scott_source(sh, pv):
    """Gray-Scott reaction-diffusion of u and v, constant coefficients."""
    del pv

    def lap(f):
        return (sh(f, -1, 0, 0) + sh(f, 1, 0, 0) + sh(f, 0, -1, 0)
                + sh(f, 0, 1, 0) + sh(f, 0, 0, -1) + sh(f, 0, 0, 1)
                - 6.0 * sh(f, 0, 0, 0))

    u, v = sh(0, 0, 0, 0), sh(1, 0, 0, 0)
    uvv = u * v * v
    return (0.16 * lap(0) - uvv + 0.035 * (1.0 - u),
            0.08 * lap(1) + uvv - 0.095 * v)


def user_spec(name: str, integrator: str):
    fields, source, pack, extra = {
        "lap_xyz": (("phi",), lap_xyz_source, lambda q: (q,), ()),
        "yz_cross": (("a",), yz_cross_source, lambda q: (q,),
                     ((0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1))),
        "gray_scott": (("u", "v"), gray_scott_source, lambda q: (), ())}[name]
    return SP.StencilSpec(name=name, fields=fields,
                          offsets={f: USER_STAR + extra for f in fields},
                          source=source, pack_params=pack,
                          integrator=integrator)


USER_SPECS = ("lap_xyz", "yz_cross", "gray_scott")
USER_DT = {"lap_xyz": 0.5, "yz_cross": 0.2, "gray_scott": 0.5}


def user_inputs(name: str, shape, dtype, seed: int):
    """(params, fields) of a user spec: normal fields (Gray-Scott's u and v
    in [0.5, 1] and [0, 0.25]), coefficients of `dtype`."""
    X, Y, Z = shape
    if name == "gray_scott":
        a, b = rand_fields(shape, seed)[:2]
        return None, ((1.0 - 0.5 * a.abs().clamp(max=1.0)).to(dtype),
                      (0.25 * b.abs().clamp(max=1.0)).to(dtype))
    field = rand_fields(shape, seed, dtype)[:1]
    if name == "lap_xyz":
        q = torch.cat([torch.tensor([0.1, 0.15]),
                       torch.linspace(0.05, 0.1, Z)])
    else:
        q = torch.tensor([0.2, 0.3])
    return q.to(dtype).cuda(), field


USER_PROBE = {"lap_xyz": torch.ones(6), "yz_cross": torch.ones(2),
              "gray_scott": None}


def user_spec_phase(check: Checks, card: str) -> dict:
    """Phase 43: three specs written here (none uses a shipped callback),
    each run on its generated functor in f32 and bf16 (bf16 coefficients),
    euler and rk2: their builds made at once and timed, then again from the
    cache; at small shapes (T 1-3, y_tile None and 3, masks) and at the 67M
    grid == the callback's plain version, bitwise, each launch counted; the
    analyzer's live ledger == fake == model for one of them. Returns the
    `stencil_generated` record (lap_xyz, f32, euler, T = 4 at 67M)."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    cases = []
    for name in USER_SPECS:
        for integ in SP.INTEGRATORS:
            for dtype in (torch.float32, BF16):
                spec = user_spec(name, integ)
                pv = K._spec_param_vectors(spec, user_inputs(
                    name, SPEC_BF16_SHAPES[0], dtype, 0)[0], "cuda", dtype)
                cases.append((spec, dtype, K._coef_is_bf16(pv)))
    t0 = time.perf_counter()
    n_builds = K.build_spec_kernels(cases)
    first = time.perf_counter() - t0
    print(f"43 generated K6 builds: {n_builds} (3 specs x euler, rk2 x f32, "
          f"bf16), compiled at once in {first:.2f} s", flush=True)
    gen = user_spec("lap_xyz", "euler").cuda_functor()
    flags = _build.generated_flags(1, False, False, K._k6_builds(gen, 1))
    _build.load_generated.cache_clear()
    t0 = time.perf_counter()
    again = K.build_spec_kernels(cases)
    lib = _build.load_generated(gen.text, flags)
    second = time.perf_counter() - t0
    print(f"43 the same builds again (a second run, the cache cleared in the "
          f"process): {second:.4f} s, from {Path(lib._name).parent.name}",
          flush=True)
    check(n_builds == again == 12 and second < first / 10,
          f"43 the generated builds are cached by their digest: {second:.4f} "
          f"s the second time, {first:.2f} s the first")
    for spec, dt_, _ in cases:
        op = spec.cuda_functor()
        check(not isinstance(op, int) and op.n_fields == spec.n_fields,
              f"43 {spec.name} {spec.integrator} runs a generated functor "
              f"(digest {op.digest})")
    runs = {}
    for name in USER_SPECS:
        dt = USER_DT[name]
        for integ in SP.INTEGRATORS:
            spec = user_spec(name, integ)
            for dtype in (torch.float32, BF16):
                tag = (f"43 {name} {integ} "
                       f"{'bf16' if dtype == BF16 else 'f32'}")
                ok, moved = [], []
                for si, shape in enumerate(SPEC_BF16_SHAPES):
                    params, flds = user_inputs(name, shape, dtype, 800 + si)
                    xm, ym = ones_cuda(shape[0]), ones_cuda(shape[1])
                    xm[2] = 0.0
                    ym[3:5] = 0.0
                    for T in (1, 2, 3):
                        for masked in (False, True):
                            mk = dict(x_interior_mask=xm if masked else None,
                                      y_interior_mask=ym if masked else None)
                            plain = plain_spec(flds, params, spec, T, dt,
                                               *mk.values())
                            moved.append(not same(plain, flds))
                            for y_tile in (None, 3):
                                out, launches, _ = counted(
                                    lambda: K.stencil_fused(
                                        flds, params, spec, T=T, dt=dt,
                                        y_tile=y_tile, **mk))
                                ok.append(same(out, plain) and only_these(
                                    launches, {"stencil_generated": len(
                                        K.spec_passes(spec, T))}))
                check(all(ok) and all(moved), f"{tag}: at small shapes == "
                      f"the callback's plain version, bitwise, {len(ok)} "
                      f"runs, each launch counted; the fields moved")
                T = 4 if integ == "euler" else 2
                params, flds = user_inputs(name, (X, Y, Z), dtype, 900)
                out, launches, wall = counted(lambda: K.stencil_fused(
                    flds, params, spec, T=T, dt=dt))
                plain = plain_spec(flds, params, spec, T, dt)
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(out, plain))
                n = len(K.spec_passes(spec, T))
                print(f"{tag} T={T} at {(X, Y, Z)}: wall {wall:.3f} s, "
                      f"launches {launches['stencil_generated']}, vs plain "
                      f"{err}", flush=True)
                check(err == 0.0 and not same(out, flds) and only_these(
                    launches, {"stencil_generated": n}),
                      f"{tag} T={T} at {(X, Y, Z)}: == plain, bitwise, "
                      f"{n} launch(es), the fields moved")
                runs[name, integ, dtype] = dict(
                    spec=spec, params=params, fields=flds, T=T, dt=dt,
                    launches=launches["stencil_generated"], err=err)
                del out, plain
    # the analyzer: lap_xyz's ledger live == fake == model
    spec = user_spec("lap_xyz", "euler")
    q = user_inputs("lap_xyz", (X, Y, Z), torch.float32, 900)[0].cpu()
    prog = PR.user_spec_program(spec, X, Y, Z, params=q, T=MAIN_T, dt=0.5)
    with TR.fake_mode():
        fn, args = prog.build("cuda")
        fake = ledger_of(prog, TR.record_ops(fn, *args))
    del fn, args
    fn, args = prog.build("cuda")
    records = TR.record_ops(fn, *args, execute=True)
    torch.cuda.synchronize()
    live = ledger_of(prog, records)
    del fn, args
    print(f"43 ledger {prog.name}: {live} (claims {prog.claims})", flush=True)
    check(live == fake and all(live[c] == b for c, b in prog.claims.items())
          and op_counts(records) == prog.launches,
          f"43 {prog.name}: live ledger == fake trace == model "
          f"{prog.claims}, ops {prog.launches}")
    r = runs["lap_xyz", "euler", torch.float32]
    flds, params, T, dt = r["fields"], r["params"], r["T"], r["dt"]

    def call():
        return K.stencil_fused(flds, params, spec, T=T, dt=dt)

    ms = time_ms(call)
    dev, seen = device_per_launch(call, "stencil_")   # one launch a call
    plain_ms = time_ms(lambda: plain_spec(flds, params, spec, T, dt), runs=5)
    nbytes, ops = spec_bound(None, spec, params, T, (X, Y, Z),
                             probe=USER_PROBE["lap_xyz"])
    for name in USER_SPECS:
        for dtype in (torch.float32, BF16):
            rr = runs[name, "euler", dtype]
            t = time_ms(lambda: K.stencil_fused(rr["fields"], rr["params"],
                                                rr["spec"], T=rr["T"],
                                                dt=rr["dt"]))
            plan = K.spec_device_plan("cuda:0", X, Y, Z, rr["spec"], rr["T"],
                                      dtype=dtype, coef=dtype == BF16)
            a = K.spec_kernel_attrs("cuda:0", rr["spec"], rr["T"], plan,
                                    dtype=dtype, coef=dtype == BF16)
            print(f"43 generated K6 {name} euler T={rr['T']} "
                  f"{'bf16' if dtype == BF16 else 'f32'} at {(X, Y, Z)}: "
                  f"{t:.4f} ms by events; build C={plan.cells_per_thread}, "
                  f"{plan.threads} threads, {a['registers']} registers, "
                  f"{a['local_bytes']} B spilled, {a['blocks_per_sm']} "
                  f"resident per SM; card {card}", flush=True)
    print("generated K6 (lap_xyz, f32, euler) at the 67M grid:", flush=True)
    rec = kernel_record("stencil_generated", ms, plain_ms, nbytes, ops,
                        sum(v["launches"] for v in runs.values()),
                        max(v["err"] for v in runs.values()))
    rec["device_ms"] = dev if dev > 0 else None
    print(f"stencil_generated: device {device_text(dev)} a launch ({seen} "
          f"launches seen in 10 calls); card {card}", flush=True)
    return rec


# --- phases 44-46: every spec shape the reference's kernel runs -------------

# the four specs' torch side (their JAX twins are in
# tests/test_torch_spec_shapes.py): hyperdiff4 (radius 2), smag_cross
# (x-diagonal reads), moist6 (six fields), tvd_vl (radius 2, the limiter
# operations); the three cloud-model specs of the math nodes: satadj3 (exp,
# division by traced values), sponge_log (log, tanh, clamp, a generic
# power, `t[-1]`), wrap_phase (`%`, `//`, sin, comparisons as numbers); and
# sqrt_div (sqrt, a division by a Python number)
SHAPE_NAMES = SHAPES.NAMES
MATH_NAMES = SHAPES.MATH_NAMES
SHAPE_ALL = SHAPE_NAMES + MATH_NAMES
SHAPE_DT = dict(SHAPES.DT, sqrt_div=0.1)
# (5, 9, 8)-like shapes, the least a radius-2 ring takes on every axis
# (2R + 2), and one of several y-tiles and z chunks
SHAPE_SMALL = ((5, 9, 8), (6, 6, 6), (13, 23, 17))
SHAPE_CHUNKS = ((5, 4, None), (5, 3, 5), (4, 6, 4))   # TY, CX, CZ
SHAPE_T = 4
SHAPE_BLOCKS = 4      # the distributed runs: 4 blocks of T = 4 == T = 16
SHAPE_DIST = ("hyperdiff4", "moist6", "satadj3")
STOP_Z = 14           # the z-slice with a positive stop lines up at this Z


def shape_spec(name: str, integrator: str = "euler"):
    return SHAPES.port_spec(name, integrator)


def shape_storages(name: str) -> tuple:
    """(field dtype, bf16 coefficients) of one spec's runs: f32, and bf16
    with bf16 coefficients (a bf16 domain's); the math specs also bf16 with
    f32 coefficients, and sqrt_div, which has none, f32 and bf16."""
    if name in MATH_NAMES:
        return ((torch.float32, False), (BF16, False), (BF16, True))
    if name == "sqrt_div":
        return ((torch.float32, False), (BF16, False))
    return ((torch.float32, False), (BF16, True))


def storage_tag(dtype, coef: bool) -> str:
    return ("f32" if dtype == torch.float32 else
            "bf16" if coef else "bf16/f32 coef")


def shape_params(name: str, Z: int, dtype=torch.float32):
    """The parameter vectors of one spec at unit spacings, on the card,
    bf16 values in either storage (so that f32 and bf16 runs share one f64
    oracle)."""
    if name == "sqrt_div":
        return ()
    p = SHAPES.params(name, Z, BF16, "cuda")
    return type(p)(*(v.to(dtype) for v in p))


def storage_params(name: str, Z: int, coef: bool):
    """`shape_params` in bf16 where `coef`, else in f32."""
    return shape_params(name, Z, BF16 if coef else torch.float32)


def shape_fields(name: str, shape, dtype, seed: int):
    """Seeded fields (`tests/_spec_shapes.np_fields`), bf16 values in
    either storage."""
    return tuple(torch.tensor(f, device="cuda").to(BF16).to(dtype)
                 for f in SHAPES.np_fields(
                     "smag_cross" if name == "sqrt_div" else name, shape,
                     seed))


def shape_bound(spec, params, T: int, shape, itemsize: int):
    """(bytes, operations) of one `stencil_fused` call of T steps: the
    fields read and written once, the parameter table and masks read once;
    the functor's operations (`Generated.ops_per_cell`) at every interior
    cell of each of its stages * T levels and the 2-op update of each field
    and cell."""
    X, Y, Z = shape
    r, nf = spec.radius, spec.n_fields
    gen = spec.cuda_functor()
    pv = K._spec_param_vectors(spec, params, "cuda")
    nbytes = (2 * nf * X * Y * Z * itemsize
              + sum(v.numel() for v in pv) * 4 + (X + Y) * 4)
    interior = (X - 2 * r) * (Y - 2 * r) * (Z - 2 * r)
    ops = spec.stages * T * (interior * gen.ops_per_cell()
                             + 2 * nf * X * Y * Z)
    return nbytes, ops


def stop_spec():
    """A one-field spec whose z coefficients are a slice with a positive
    stop, `t[1:STOP_Z - 1]`: it lines up with z at Z = STOP_Z only."""
    def src(sh, pv):
        return (pv[0][1:STOP_Z - 1] * (sh(0, 1, 0, 0) - sh(0, 0, 0, 0)),)
    return SP.StencilSpec(name="stop_slice", fields=("a",),
                          offsets={"a": SHAPES.STAR1}, source=src,
                          pack_params=lambda p: tuple(p))


def shape_cases():
    """(spec, field dtype, bf16 coefficients) of every build phases 44-46
    launch: each spec x euler, rk2 x its storages, sqrt_div (euler) in f32
    and bf16, and the positive-stop spec in f32."""
    out = [(shape_spec(n, i), d, c) for n in SHAPE_ALL
           for i in SP.INTEGRATORS for d, c in shape_storages(n)]
    return out + [(shape_spec("sqrt_div"), d, c)
                  for d, c in shape_storages("sqrt_div")] + [
        (stop_spec(), torch.float32, False)]


def stop_slice_checks(check: Checks) -> None:
    """Phase 44's positive-stop z slice: == plain at the Z it lines up
    with, one launch; refused before any launch at another."""
    spec = stop_spec()
    for Z in (STOP_Z, STOP_Z - 2):
        flds = (torch.randn(7, 9, Z, device="cuda"),)
        params = (torch.linspace(0.1, 0.9, Z + 2, device="cuda"),)
        if Z == STOP_Z:
            out, launches, _ = counted(lambda: K.stencil_fused(
                flds, params, spec, T=2, dt=0.1))
            check(same(out, plain_spec(flds, params, spec, 2, 0.1))
                  and only_these(launches, {"stencil_generated": 1}),
                  f"44 z slice [1:{STOP_Z - 1}] (a positive stop) at Z = "
                  f"{Z}: == plain, bitwise, one launch")
            continue
        reset_all_counts()
        try:
            K.stencil_fused(flds, params, spec, T=2, dt=0.1)
            refused = False
        except NotImplementedError as e:
            refused = "does not line up with z" in str(e)
        check(refused and sum(all_counts().values()) == 0,
              f"44 z slice [1:{STOP_Z - 1}] at Z = {Z}: refused before any "
              f"launch (it holds {STOP_Z - 2} cells, z has {Z - 2})")


def shape_small_phase(check: Checks) -> None:
    """Phase 44: the generated builds of the seven specs (radius 2,
    x-diagonal reads, six fields, the limiter operations, the math nodes)
    made at once; then each spec x integrator x storage through K6 at small
    shapes == its plain version on the card, bitwise: T 1-3 (passes where a
    pass holds fewer levels), y_tile None and 3, masks, one build for every
    Z, x and z chunks with remainders on given plans, and batched (B = 3,
    per-slot masks) == sequential; the sqrt/division check spec likewise;
    the positive-stop z slice (`stop_slice_checks`)."""
    t0 = time.perf_counter()
    n_builds = K.build_spec_kernels(shape_cases())
    print(f"44 generated K6 builds: {n_builds} (7 specs x euler, rk2 x "
          f"their storages, the sqrt/division check in f32 and bf16, the "
          f"positive-stop spec), compiled at once in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in SHAPE_ALL + ("sqrt_div",):
        integs = SP.INTEGRATORS if name != "sqrt_div" else ("euler",)
        for integ in integs:
            spec = shape_spec(name, integ)
            gen = spec.cuda_functor()
            check(not isinstance(gen, int) and gen.n_fields == spec.n_fields
                  and K.spec_on_card(spec),
                  f"44 {spec.name} runs a generated functor (digest "
                  f"{gen.digest}, radius {gen.radius}, planes at x offsets "
                  f"{gen.plane_lo}..{gen.plane_hi}, {gen.ops_per_cell()} "
                  f"operations a cell and level, builds "
                  f"{gen.builds(spec.stages)}, {K.spec_levels(spec)} levels "
                  f"a pass)")
            for dtype, coef in shape_storages(name):
                tag = f"44 {spec.name} {storage_tag(dtype, coef)}"
                dt = SHAPE_DT[name]
                ok, moved, chunks = [], [], []
                for si, shape in enumerate(SHAPE_SMALL):
                    X, Y, Z = shape
                    params = storage_params(name, Z, coef)
                    flds = shape_fields(name, shape, dtype, 440 + 10 * si)
                    xm, ym = ones_cuda(X), ones_cuda(Y)
                    # where x = 2 is the one interior slice (X = 5 at
                    # radius 2) the y mask alone walls cells off
                    if X - 2 * gen.radius > 1:
                        xm[2] = 0.0
                    ym[3:5] = 0.0
                    for T in (1, 2, 3):
                        for masked in (False, True):
                            mk = dict(x_interior_mask=xm if masked else None,
                                      y_interior_mask=ym if masked else None)
                            plain = plain_spec(flds, params, spec, T, dt,
                                               *mk.values())
                            moved.append(not same(plain, flds))
                            for y_tile in (None, 3):
                                out, launches, _ = counted(
                                    lambda: K.stencil_fused(
                                        flds, params, spec, T=T, dt=dt,
                                        y_tile=y_tile, **mk))
                                ok.append(same(out, plain) and only_these(
                                    launches, {"stencil_generated": len(
                                        K.spec_passes(spec, T))}))
                    if si < 2:
                        continue
                    pv = K._spec_param_vectors(spec, params, "cuda", dtype)
                    T = 1
                    plain = plain_spec(flds, params, spec, T, dt)
                    for TY, CX, CZ in SHAPE_CHUNKS:
                        plan = K.fused_plan_with_chunks(
                            K.spec_device_plan("cuda", X, Y, Z, spec, T, 1,
                                               TY, dtype=dtype, coef=coef),
                            X, Z, spec.stages * T, CX=CX, CZ=CZ,
                            knobs=K.spec_plan_knobs(spec, T))
                        got = K._stencil_fused_cuda(
                            [f[None] for f in flds], pv, spec, T, dt,
                            ones_cuda(X), ones_cuda(Y), plan=plan)
                        chunks.append(plan.n_cx > 1 and plan.n_ty > 1 and (
                            CZ is None or plan.n_cz > 1)
                            and same((g[0] for g in got), plain))
                check(all(ok) and all(moved), f"{tag}: == plain on the card, "
                      f"bitwise, {len(ok)} runs over {SHAPE_SMALL} (T 1-3, "
                      f"y_tile None and 3, masks; one build for every Z), "
                      f"each launch counted; the fields moved")
                check(all(chunks) and chunks, f"{tag}: x chunks, y-tiles and "
                      f"z chunks with remainders on given plans "
                      f"{SHAPE_CHUNKS} == plain, bitwise")
    B, shape = 3, SHAPE_SMALL[2]
    X, Y, Z = shape
    xm, ym = torch.ones(B, X, device="cuda"), torch.ones(B, Y, device="cuda")
    xm[1, 2] = 0.0
    ym[2, 5:9] = 0.0
    for name in SHAPE_ALL:
        for integ in SP.INTEGRATORS:
            spec = shape_spec(name, integ)
            for dtype, coef in shape_storages(name):
                params = storage_params(name, Z, coef)
                slots = [shape_fields(name, shape, dtype, 470 + 7 * b)
                         for b in range(B)]
                fields = [torch.stack([sl[i] for sl in slots])
                          for i in range(spec.n_fields)]
                out = K.stencil_fused_batched(
                    fields, params, spec, T=2, dt=SHAPE_DT[name],
                    x_interior_mask=xm, y_interior_mask=ym)
                ok = [same([o[b] for o in out], K.stencil_fused(
                    [f[b] for f in fields], params, spec, T=2,
                    dt=SHAPE_DT[name], x_interior_mask=xm[b],
                    y_interior_mask=ym[b])) for b in range(B)]
                check(all(ok), f"44 {spec.name} {storage_tag(dtype, coef)} "
                      f"batched (B = {B}, per-slot masks) == sequential, "
                      f"bitwise")
    stop_slice_checks(check)


def shape_path_tiles_and_slots(check: Checks, tag: str, spec, params,
                               flds, dt: float, out, coef: bool) -> None:
    """Phase 45's other equalities at the 67M grid, for a spec whose
    untiled run of `SHAPE_T` steps gave `out`: an explicit y_tile of half
    the spec's own tile == untiled, and two slots with per-slot masks
    (`flds` and `flds` reversed along x) batched == sequential, bitwise,
    each with K6 alone once a pass, the masks changing the result."""
    X, Y, Z = flds[0].shape
    T, dtype = SHAPE_T, flds[0].dtype
    passes = K.spec_passes(spec, T)
    want = {"stencil_generated": len(passes)}
    own = K.spec_device_plan("cuda:0", X, Y, Z, spec, passes[0],
                             dtype=dtype, coef=coef)
    y_tile = max(2, own.TY // 2)
    given = K.spec_device_plan("cuda:0", X, Y, Z, spec, passes[0], 1,
                               y_tile, dtype=dtype, coef=coef)
    tiled, launches, _ = counted(lambda: K.stencil_fused(
        flds, params, spec, T=T, dt=dt, y_tile=y_tile))
    check(same(tiled, out) and given.TY != own.TY
          and only_these(launches, want),
          f"{tag} T={T} at {(X, Y, Z)} with y_tile={y_tile} (tile "
          f"{given.TY}, K6's own {own.TY}) == untiled, bitwise, "
          f"{len(passes)} launch(es)")
    del tiled
    B = 2
    xm = torch.ones(B, X, device="cuda")
    ym = torch.ones(B, Y, device="cuda")
    xm[1, X // 2 - 20:X // 2 + 20] = 0.0
    ym[0, Y // 3:Y // 3 + 40] = 0.0
    slots = (flds, tuple(f.flip(0) for f in flds))
    stacked = [torch.stack([sl[i] for sl in slots])
               for i in range(spec.n_fields)]
    batched, launches, _ = counted(lambda: K.stencil_fused_batched(
        stacked, params, spec, T=T, dt=dt, x_interior_mask=xm,
        y_interior_mask=ym))
    del stacked
    ok = [same([o[b] for o in batched], K.stencil_fused(
        slots[b], params, spec, T=T, dt=dt, x_interior_mask=xm[b],
        y_interior_mask=ym[b])) for b in range(B)]
    masked = not same([o[0] for o in batched], out)
    del batched, slots
    check(all(ok) and masked and only_these(launches, want),
          f"{tag} T={T} at {(X, Y, Z)} batched (B = {B}, per-slot masks) "
          f"== sequential, bitwise, {len(passes)} launch(es); the masks "
          f"changed the result")


def shape_bf16_bounds(spec, start, params, oracle, levels: int,
                      dt: float) -> list:
    """Per field f, the bound on a bf16 run of `levels` ring levels against
    the f64 oracle: BF16_ORACLE_SLACK x levels x (u M_f + dt E_f), each
    level's update rounding once to bf16 (at most u = 2^-8 of the field's
    largest |value| M_f) and adding the error of its source's own bf16
    roundings, dt E_f, E_f the largest |source in the run's storage -
    source in f64| over the start fields (the plain version's
    `spec_sources` on the card; a property of the spec and the storage, not
    of K6). The slack covers the stencil carrying earlier errors."""
    src = SP.spec_sources(start, params, spec)
    src64 = SP.spec_sources([f.double() for f in start],
                            type(params)(*(v.double() for v in params)),
                            spec)
    return [BF16_ORACLE_SLACK * levels * (
        BF16_U * float(o.abs().max())
        + dt * float((s.double() - s64).abs().max()))
        for o, s, s64 in zip(oracle, src, src64)]


def field_errs(got, want) -> list:
    """Per field, the largest |got - want|."""
    return [float((g.double() - w.double()).abs().max())
            for g, w in zip(got, want)]


def shape_path_phase(check: Checks, card: str) -> dict:
    """Phase 45 at the 67M grid: each spec x integrator x storage through
    `stencil_fused` at T = 4 on K6's own plan (each pass's plan printed with
    the card's registers, spills and resident blocks), the counts set to 0
    just before and read just after (`stencil_generated` once a pass, no
    other kernel), == the plain version on the card bitwise; f32 within
    `ORACLE_TOL` x max(1, max |field|) of the f64 oracle field by field,
    bf16 within its per-field bound (`shape_bf16_bounds`, by `cell_gate`,
    which fails a no-op); the analyzer's shared-memory plan == the launch
    plan == the launched shared bytes; an explicit y_tile == untiled and two
    slots batched == sequential (`shape_path_tiles_and_slots`). A build of
    the four specs spills nothing; a math spec's spill is printed, a
    finding. The runs of a spec start from the same bf16 values, so they
    share one f64 oracle. Returns the runs for the timing phase."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    T = SHAPE_T
    runs = {}
    for name in SHAPE_ALL:
        dt = SHAPE_DT[name]
        start = shape_fields(name, (X, Y, Z), BF16, 450)
        for integ in SP.INTEGRATORS:
            spec = shape_spec(name, integ)
            passes = K.spec_passes(spec, T)
            oracle = SP.spec_multistep_ref_f64(
                start, shape_params(name, Z, BF16), spec, T, dt)
            for dtype, coef in shape_storages(name):
                tag = f"45 {spec.name} {storage_tag(dtype, coef)}"
                params = storage_params(name, Z, coef)
                flds = tuple(f.to(dtype) for f in start)
                for Tk in sorted(set(passes)):
                    plan = K.spec_device_plan("cuda:0", X, Y, Z, spec, Tk,
                                              dtype=dtype, coef=coef)
                    a = K.spec_kernel_attrs("cuda:0", spec, Tk, plan,
                                            dtype=dtype, coef=coef)
                    ring = SM.fused_ring_plan(X, Y, Z, T=Tk, spec=spec,
                                              n_sm=n_sms(),
                                              blocks_per_sm=plan.blocks_per_sm)
                    print(f"{tag} pass T={Tk} at {(X, Y, Z)}: plan TY "
                          f"{plan.TY} S {plan.S} CZ {plan.CZ} W {plan.W} CX "
                          f"{plan.CX} C {plan.cells_per_thread} threads "
                          f"{plan.threads} shared {plan.shared_bytes} B grid "
                          f"{plan.grid}; {a['registers']} registers, "
                          f"{a['local_bytes']} B spilled, "
                          f"{a['blocks_per_sm']} resident per SM; card {card}",
                          flush=True)
                    check(ring.total() == plan.shared_bytes,
                          f"{tag} pass T={Tk}: the analyzer's shared-memory "
                          f"plan {ring.total()} B == the launch plan's "
                          f"{plan.shared_bytes} B")
                    if name not in MATH_NAMES:
                        check(a["local_bytes"] == 0, f"{tag} pass T={Tk}: "
                              f"the build spills nothing ({a['local_bytes']} "
                              f"B, {a['registers']} registers)")
                out, launches, wall = counted(lambda: K.stencil_fused(
                    flds, params, spec, T=T, dt=dt))
                launched = K.LAUNCHED_SHARED.get("stencil_fused")
                plain = plain_spec(flds, params, spec, T, dt)
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(out, plain))
                bitwise = same(out, plain)
                del plain
                print(f"{tag} T={T} at {(X, Y, Z)}: wall {wall:.3f} s, "
                      f"launches {launches['stencil_generated']} "
                      f"({passes}), vs plain {err}", flush=True)
                check(bitwise and not same(out, flds) and only_these(
                    launches, {"stencil_generated": len(passes)}),
                    f"{tag} T={T} at {(X, Y, Z)}: == plain, bitwise, "
                    f"{len(passes)} launch(es), the fields moved")
                last = K.spec_device_plan("cuda:0", X, Y, Z, spec,
                                          passes[-1], dtype=dtype, coef=coef)
                check(launched == last.shared_bytes, f"{tag}: launched "
                      f"{launched} B of shared memory == planned "
                      f"{last.shared_bytes} B")
                shape_path_tiles_and_slots(check, tag, spec, params, flds,
                                           dt, out, coef)
                errs, moved = field_errs(out, oracle), field_errs(flds, oracle)
                if dtype == torch.float32:
                    tols = [ORACLE_TOL * max(1.0, float(o.abs().max()))
                            for o in oracle]
                    print(f"{tag} against the f64 oracle, field by field: "
                          f"{[f'{e:.3e}' for e in errs]} (TOL {ORACLE_TOL} x "
                          f"max(1, max |field|): "
                          f"{[f'{t:.3e}' for t in tols]}); the oracle moved "
                          f"{[f'{m:.3e}' for m in moved]}", flush=True)
                    check(all(e <= t for e, t in zip(errs, tols))
                          and any(m > t for m, t in zip(moved, tols)),
                          f"{tag}: each field within {ORACLE_TOL} x max(1, "
                          f"max |field|) of the f64 oracle, which a no-op "
                          f"misses")
                else:
                    bounds = shape_bf16_bounds(spec, flds, params, oracle,
                                               spec.stages * T, dt)
                    cell_gate(check, tag, out, flds, oracle,
                              [torch.full_like(o, b)
                               for o, b in zip(oracle, bounds)])
                runs[name, integ, dtype, coef] = dict(
                    spec=spec, params=params, fields=flds, dt=dt,
                    launches=launches["stencil_generated"], err=err)
                del out
            del oracle
            torch.cuda.empty_cache()
        del start
    # the shipped specs keep their shipped functors
    for op, factory in SPEC_FACTORIES.items():
        for integ in SP.INTEGRATORS:
            check(isinstance(factory(integ).cuda_functor(), int),
                  f"45 {factory(integ).name} runs its shipped functor")
    return runs


def shape_dist_phase(check: Checks, card: str) -> None:
    """Phase 45's distributed runs: the `collective` engine over the (2, 2)
    loopback mesh, `make_distributed_run(n_blocks=4, T=4, fused, overlap)`
    for hyperdiff4, moist6 and satadj3 at depth `spec.halo(4)`, ==
    single-card `stencil_fused` at T = 16, bitwise, K6 twice a shard,
    pass and block; `remote_dma` refused for `spec=` on the card,
    launching nothing."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    nx, ny = DIST_MESH
    mesh = make_stencil_mesh(nx, ny, devices=["cuda:0"] * (nx * ny))
    nb, T = SHAPE_BLOCKS, SHAPE_T
    for name in SHAPE_DIST:
        spec = shape_spec(name)
        sp = shape_params(name, Z)
        flds = shape_fields(name, (X, Y, Z), torch.float32, 460)
        dt = SHAPE_DT[name]
        run = D.make_distributed_run(mesh, sp, n_blocks=nb, T=T, dt=dt,
                                     local_kernel="fused", overlap=True,
                                     exchange="collective", spec=spec,
                                     spec_params=sp)
        shards = D.shard(mesh, *flds)
        out, launches, wall = counted(lambda: run(shards), mesh)
        want = 2 * nx * ny * len(K.spec_passes(spec, T)) * nb
        got = D.gather(mesh, out)
        del out, shards
        single = K.stencil_fused(flds, sp, spec, T=nb * T, dt=dt)
        tag = (f"45 distributed {spec.name} over a {(nx, ny)} loopback mesh, "
               f"collective, {nb} blocks of T={T} at depth {spec.halo(T)}")
        print(f"{tag}: wall {wall:.3f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        check(only_these(launches, {"stencil_generated": want}),
              f"{tag}: stencil_generated launched {want} times, no other "
              f"kernel")
        check(same(got, single) and not same(got, flds),
              f"{tag}: == single-card stencil_fused(T={nb * T}), bitwise, "
              f"the fields moved")
        del got, single
        torch.cuda.empty_cache()
    spec = shape_spec("hyperdiff4")
    sp = shape_params("hyperdiff4", Z)
    reset_all_counts()
    try:
        D.make_distributed_run(mesh, sp, n_blocks=nb, T=T, dt=0.5,
                               local_kernel="fused", exchange="remote_dma",
                               spec=spec, spec_params=sp)
        refused = False
    except RuntimeError as e:
        refused = "no band exchange kernel" in str(e)
    check(refused and sum(all_counts().values()) == 0,
          "45 hyperdiff4 with exchange='remote_dma' on the CUDA mesh raises "
          "at build time, and launches nothing")


def shape_ledger_phase(check: Checks) -> None:
    """Phase 45's analyzer gate: each spec's K6 call recorded live on the
    card == its fake trace == its model (each pass's fields read and
    written once), with `check_model_coverage` and the ops == the passes."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    for name in SHAPE_ALL:
        spec = shape_spec(name)
        q = shape_params(name, Z)
        q = type(q)(*(v.cpu() for v in q))
        prog = PR.user_spec_program(spec, X, Y, Z, params=q, T=SHAPE_T,
                                    dt=SHAPE_DT[name])
        with TR.fake_mode():
            fn, args = prog.build("cuda")
            fake = ledger_of(prog, TR.record_ops(fn, *args))
        del fn, args
        fn, args = prog.build("cuda")
        records = TR.record_ops(fn, *args, execute=True)
        torch.cuda.synchronize()
        live = ledger_of(prog, records)
        del fn, args
        torch.cuda.empty_cache()
        report = AN.check_model_coverage(live, prog.claims)
        print(f"45 ledger {prog.name}: {live} (claims {prog.claims})",
              flush=True)
        check(live == fake and report.ok and op_counts(records)
              == prog.launches, f"45 {prog.name}: live ledger == fake trace "
              f"== model {prog.claims}, model coverage "
              f"{[str(f) for f in report.failures]}, ops {prog.launches}")


def shape_timing(runs, card: str) -> list:
    """Phase 46: each spec's K6 pass at the 67M grid (euler, one pass of
    its most steps a pass), f32 and bf16: events (median of 20) and device
    time by `torch.profiler` (divided by the launches seen), the plain
    version, the bound; the build's registers, spills and shared bytes
    (bf16 with bf16 coefficients). Returns one kernels-line record per spec
    (f32), its launches the phase-45 path's."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    records = []
    for name in SHAPE_ALL:
        spec = shape_spec(name)
        Tp = K.spec_passes(spec, SHAPE_T)[0]
        launches = sum(r["launches"] for (n, *_), r in runs.items()
                       if n == name)
        err = max(r["err"] for (n, *_), r in runs.items() if n == name)
        for dtype in (torch.float32, BF16):
            r = runs[name, "euler", dtype, dtype == BF16]
            flds, params, dt = r["fields"], r["params"], r["dt"]

            def call():
                return K.stencil_fused(flds, params, spec, T=Tp, dt=dt)

            ms = time_ms(call)
            dev, seen = device_per_launch(call, "stencil_")
            plan = K.spec_device_plan("cuda:0", X, Y, Z, spec, Tp,
                                      dtype=dtype, coef=dtype == BF16)
            a = K.spec_kernel_attrs("cuda:0", spec, Tp, plan, dtype=dtype,
                                    coef=dtype == BF16)
            item = 2 if dtype == BF16 else 4
            nbytes, ops = shape_bound(spec, params, Tp, (X, Y, Z), item)
            peak = R.PEAK_FLOPS_BF16_SIMT if dtype == BF16 \
                else R.PEAK_FLOPS_F32
            bound, by = bound_of(nbytes, ops, peak)
            kind = "bf16" if dtype == BF16 else "f32"
            print(f"46 K6 {name} {kind} euler pass T={Tp} at {(X, Y, Z)}: "
                  f"{ms:.4f} ms by events, device {device_text(dev)} a "
                  f"launch ({seen} launches seen in 10 calls); bound "
                  f"{bound:.4f} ms by {by} ({nbytes} B, {ops} ops, "
                  f"{spec.cuda_functor().ops_per_cell()} a cell and level); "
                  f"build C={plan.cells_per_thread}, {plan.threads} threads, "
                  f"{a['registers']} registers, {a['local_bytes']} B "
                  f"spilled, {plan.shared_bytes} B shared, "
                  f"{a['blocks_per_sm']} resident per SM; card {card}",
                  flush=True)
            if dtype == BF16:
                continue
            plain_ms = time_ms(lambda: plain_spec(flds, params, spec, Tp,
                                                  dt), runs=3, warmup=1)
            rec = kernel_record(f"stencil_generated_{name}", ms, plain_ms,
                                nbytes, ops, launches, err)
            rec["device_ms"] = dev if dev > 0 else None
            records.append(rec)
    return records


def spec_shapes_phases(check: Checks, card: str) -> list:
    """Phase 54, the probe of the tracer's math nodes, then phases 44-46:
    every spec shape the reference's kernel runs."""
    phase("54 node probe", probe_node_phase, check, card)
    torch.cuda.empty_cache()
    phase("44 spec shapes small", shape_small_phase, check)
    runs = phase("45 spec shapes at 67M", shape_path_phase, check, card)
    phase("45 spec shapes distributed", shape_dist_phase, check, card)
    phase("45 spec shapes ledger", shape_ledger_phase, check)
    records = phase("46 spec shapes timing", shape_timing, runs, card)
    del runs
    torch.cuda.empty_cache()
    return records


def spec_codegen_only(check: Checks, card: str) -> list:
    """`--only spec_codegen`: phase 43, then phases 54 and 44-46."""
    records = [phase("43 user-written specs", user_spec_phase, check, card)]
    torch.cuda.empty_cache()
    return records + spec_shapes_phases(check, card)


def bf16_phases(check: Checks, card: str) -> list:
    """Phases 35-39: the bf16 PW path; phases 40-43: K6 and K7 in bf16 and
    K6 for user-written specs."""
    phase("35 bf16 small shapes", bf16_small_phase, check)
    phase("40 K6 bf16 small shapes", k6_bf16_small_phase, check)
    dom, fields, out, launches, k1_err, k4_err = phase(
        "36 bf16 main path", bf16_main_path_phase, check)
    phase("36 bf16 resolved dt", bf16_resolved_phase, check)
    ladder = phase("37 bf16 ladder path", bf16_ladder_phase, check, fields)
    records = phase("39 bf16 timing", bf16_timing_phase, check, dom, fields,
                    out, launches, k1_err, k4_err, ladder, card)
    del out
    torch.cuda.empty_cache()
    k6_runs = phase("40 K6 bf16 path", k6_bf16_path_phase, check, fields)
    records.append(phase("40 K6 bf16 timing", k6_bf16_timing, k6_runs, card))
    del k6_runs
    torch.cuda.empty_cache()
    phase("41 K7 bf16 small shapes", band_small_phase, check, dtype=BF16)
    k7, mesh, dist_out, runs = phase("41 bf16 distributed path",
                                     bf16_distributed_phase, check, dom,
                                     fields, card)
    records.append(phase("41 K7 bf16 timing", band_timing, mesh, fields, k7,
                         runs, card))
    del runs
    torch.cuda.empty_cache()
    phase("42 bf16 distributed spec path and checkpoint",
          bf16_dist_spec_phase, check, fields, dist_out, card)
    del dom, fields, dist_out
    torch.cuda.empty_cache()
    records += phase("38 bf16 stencil serving", bf16_serving_phase, check,
                     card)
    torch.cuda.empty_cache()
    records.append(phase("43 user-written specs", user_spec_phase, check,
                         card))
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# phases 47-49: how K1/K5 and K6 round to bf16 (`rpk`: one
# `cvt.rn.bf16x2.f32` of the value and 0.0f a round, off the conversion unit
# that `__float2bfloat16_rn` queues on)
# ---------------------------------------------------------------------------

ROUND_SHAPES = ((6, 10, 16), (7, 12, 20))
ROUND_T = (1, 2, 4)
ROUND_DT = 0.1
# the runs: normal cells of each field (u, v, w, q) times its scale, with
# a share of them replaced by planted magnitudes, each with a random sign.
# "mixed": near 1, with zero, bf16 subnormals (2^-133 the least), f32's
# least normal, values near and past 2^111, bf16's largest, Inf and NaN;
# "tiny": q (the tracer's, and diffusion's phi) near f32's least normal,
# so that its sources, linear in it, are f32 subnormals that move it;
# "huge": products near and past bf16's largest
BF16_MAX = 3.3895313892515355e38
ROUND_CASES = (
    ("mixed", (1.0,) * 4, 0.03,
     (0.0, 2.0 ** -133, 1e-39, 2.0 ** -126, 1e-20, 1e19, 2.0 ** 110,
      1.5 * 2.0 ** 110, 2.0 ** 111, 2.0 ** 112, BF16_MAX, float("inf"),
      float("nan"))),
    ("tiny", (1.0, 1.0, 1.0, 2.0 ** -126), 0.15,
     (0.0, 2.0 ** -133, 1e-39, 2.0 ** -126)),
    ("huge", (1e19,) * 4, 0.03,
     (0.0, 2.0 ** 110, 1.5 * 2.0 ** 110, 2.0 ** 111, 2.0 ** 112, BF16_MAX)))


def bits_nan_equal(a, b) -> bool:
    """Each pair of tensors holds the same bits wherever neither is NaN
    (the sign of zero included), and NaN at the same cells."""
    for x, y in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        nx, ny = torch.isnan(x), torch.isnan(y)
        ints = torch.int16 if x.dtype == BF16 else torch.int32
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if not (torch.equal(nx, ny) and torch.equal(
                torch.where(nx, zero, x).view(ints),
                torch.where(ny, zero, y).view(ints))):
            return False
    return True


def extreme_fields(shape, seed: int, scales, share: float, planted):
    """A bf16 field per scale: normal values times it, with `share` of the
    cells replaced by `planted` magnitudes, each with a random sign."""
    rng = np.random.default_rng(seed)
    out = []
    for scale in scales:
        f = rng.normal(size=shape) * scale
        hit = rng.random(size=shape) < share
        vals = np.array(planted)[rng.integers(len(planted),
                                              size=int(hit.sum()))]
        f[hit] = vals * rng.choice((-1.0, 1.0), size=vals.shape)
        out.append(torch.tensor(f, dtype=torch.float32,
                                device="cuda").to(BF16))
    return tuple(out)


def kinds_of(fields) -> str:
    """How many cells of `fields` are NaN, +-Inf, zero and subnormal."""
    cat = torch.cat([f.float().flatten() for f in fields])
    tiny = (cat != 0) & (cat.abs() < 2.0 ** -126)
    return (f"{int(torch.isnan(cat).sum())} NaN, "
            f"{int(torch.isinf(cat).sum())} Inf, {int((cat == 0).sum())} "
            f"zero, {int(tiny.sum())} subnormal of {cat.numel()}")


def round_routes_phase(check: Checks, card: str) -> None:
    """Phase 47: each rounding route of `csrc/bf16_round.cu` alone: its
    rounds a clock per SM and how many of the 2^32 f32 bit patterns it
    rounds as `__float2bfloat16_rn` does; every route must take all. Then
    each bf16x2 op of the rungs' pair build alone: its ops a clock per SM
    and how many of the 2^32 pairs of bf16 operands it computes as `rpk` of
    the f32 op does; every op must take all."""
    from repro_torch.kernels import bf16_round as BR
    for route in BR.ROUTES:
        r = BR.route_rate(route)
        n = BR.check_route(route)
        chosen = (" (K1/K5, K6 and the rungs' one-cell build round by it)"
                  if route == BR.ROUTE else "")
        print(f"47 route {route}{chosen}: {r['per_clock_per_sm']:.2f} rounds "
              f"a clock per SM ({r['rounds']} rounds in {r['ms']:.4f} ms at "
              f"{r['ghz']:.3f} GHz); exact on {n:,} of {BR.PATTERNS:,} bit "
              f"patterns; card {card}", flush=True)
        check(n == BR.PATTERNS, f"47 route {route}{chosen}: "
              f"{n:,} of {BR.PATTERNS:,} f32 bit patterns round as "
              f"__float2bfloat16_rn (NaN to NaN)")
    for op in BR.PAIR_OPS:
        r = BR.pair_op_rate(op)
        n = BR.check_pair_op(op)
        print(f"47 bf16x2 {op} (the rungs' pair build): "
              f"{r['per_clock_per_sm']:.2f} ops a clock per SM, two an "
              f"instruction ({r['rounds']} ops in {r['ms']:.4f} ms at "
              f"{r['ghz']:.3f} GHz); equal to rpk of the f32 op on {n:,} "
              f"of {BR.PATTERNS:,} pairs of bf16 operands; card {card}",
              flush=True)
        check(n == BR.PATTERNS, f"47 bf16x2 {op}: {n:,} of "
              f"{BR.PATTERNS:,} pairs of bf16 operands == rpk of the f32 "
              f"op (the sign of zero included, NaN as NaN)")


def round_extremes_phase(check: Checks) -> None:
    """Phase 48: K1 bf16 (f32 and bf16 coefficients), K5 bf16 (B = 2), K6
    bf16 (PW, tracer, diffusion; euler and rk2), `tvd_vl` (which divides)
    and the rungs K3, K2 `dataflow` and `wide` (both coefficient storages,
    `fuse_update` False and True; their pair build, and the one-cell build
    on copies 2 bytes past an allocation) on fields that span f32
    subnormals, values near 2^111 and near bf16's largest, +-0, +-Inf and
    NaN (`ROUND_CASES`: mixed, tiny and huge fields): each == its plain
    version on the card, the same bits where not NaN and NaN at the same
    cells."""
    for si, shape in enumerate(ROUND_SHAPES):
        X, Y, Z = shape
        for ci, (case, scales, share, planted) in enumerate(ROUND_CASES):
            seed = 1000 + 10 * si + ci
            u, v, w, q = extreme_fields(shape, seed, scales, share, planted)
            tag = f"48 {shape} {case}"
            print(f"{tag}: inputs {kinds_of((u, v, w, q))}", flush=True)
            for coef in ("f32", "bf16"):
                cd = torch.float32 if coef == "f32" else BF16
                p = REF.default_params(Z, dx=1.0, dy=1.0, dz=1.0, dtype=cd,
                                       device="cuda")
                for T in ROUND_T:
                    out = K.advect_fused(u, v, w, p, T=T, dt=ROUND_DT)
                    want = plain_fused(u, v, w, p, T, dt=ROUND_DT)
                    check(bits_nan_equal(out, want), f"{tag} K1 bf16 {coef} "
                          f"coefficients T={T} == plain, bits and NaN "
                          f"({kinds_of(out)})")
                ub, vb, wb = (torch.stack([a, b]) for a, b in
                              ((u, v), (v, w), (w, q)))
                out = K.advect_fused_batched(ub, vb, wb, p, T=2, dt=ROUND_DT)
                want = K._advect_fused_plain(
                    ub, vb, wb, K._slot_params(p, 2, Z, "cuda"), 2, ROUND_DT,
                    torch.ones(2, X, device="cuda"),
                    torch.ones(2, Y, device="cuda"))
                check(bits_nan_equal(out, want), f"{tag} K5 bf16 (B = 2) "
                      f"{coef} coefficients T=2 == plain, bits and NaN "
                      f"({kinds_of(out)})")
                for op, factory in SPEC_FACTORIES.items():
                    flds = {"pw": (u, v, w), "tracer": (u, v, w, q),
                            "diffusion": (q,)}[op]
                    params = (SP.default_diffusion_params(
                        Z, dx=1.0, dy=1.0, dz=1.0, nu=0.1, dtype=cd,
                        device="cuda") if op == "diffusion" else p)
                    for integ in SP.INTEGRATORS:
                        spec = factory(integ)
                        out = K.stencil_fused(flds, params, spec, T=2,
                                              dt=ROUND_DT)
                        want = plain_spec(flds, params, spec, 2, ROUND_DT)
                        check(bits_nan_equal(out, want), f"{tag} K6 bf16 "
                              f"{spec.name} {coef} coefficients T=2 == "
                              f"plain, bits and NaN ({kinds_of(out)})")
            spec = shape_spec("tvd_vl")
            flds = (u, v, w, q)[:spec.n_fields]
            params = shape_params("tvd_vl", Z, BF16)
            dt = SHAPE_DT["tvd_vl"]
            out = K.stencil_fused(flds, params, spec, T=2, dt=dt)
            want = plain_spec(flds, params, spec, 2, dt)
            check(bits_nan_equal(out, want), f"{tag} K6 bf16 tvd_vl (bf16 "
                  f"coefficients) T=2 == plain, bits and NaN "
                  f"({kinds_of(out)})")
            off = offset_copies((u, v, w))
            for coef in ("f32", "bf16"):
                cd = torch.float32 if coef == "f32" else BF16
                p = REF.default_params(Z, dx=1.0, dy=1.0, dz=1.0, dtype=cd,
                                       device="cuda")
                for name in BF16_RUNGS:
                    if name == "advect_wide" and Z % 8:
                        continue
                    builds = [("pair", (u, v, w))]
                    if name != "advect_wide":
                        builds.append(("one-cell", off))
                    for fu in (False, True):
                        want = K._advect_rung_plain(u, v, w, p, fu, ROUND_DT)
                        for build, flds in builds:
                            out = getattr(K, name)(*flds, p, fuse_update=fu,
                                                   dt=ROUND_DT)
                            check(bits_nan_equal(out, want),
                                  f"{tag} {name} bf16 {build} build {coef} "
                                  f"coefficients fuse_update={fu} == plain, "
                                  f"bits and NaN ({kinds_of(out)})")


def round_timing(card: str) -> None:
    """Phase 49: the times this rounding moves, device time by
    `torch.profiler` (divided by the launches seen) and events (median of
    20): the rungs K3, K2 `dataflow` and `wide` at 67M, bf16 with f32 and
    with bf16 coefficients and f32 as controls, `fuse_update` False and
    True, each on its own plan; K1 bf16's pass at 67M, T = 4, with f32 and
    bf16 coefficients; K5 bf16 at 4 x (512, 512, 64); K6 bf16's six spec
    passes (phase 40); the four spec shapes in bf16, euler, a pass (phase
    46); and the f32 K1 and K6 PW passes as controls; each build's
    registers, spills and resident blocks. Runs in a checkout from before
    the paired rounding or the rungs' pairs too (`--only bf16_times`),
    through entry points such a checkout has, so that one call times both.
    Returns each build's (name, local bytes spilled)."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    T = MAIN_T
    spills = []

    def line(what, call, match, extra=""):
        ms = time_ms(call)
        dev, seen = device_per_launch(call, match)
        print(f"49 {what}: device {device_text(dev)} a launch ({seen} of 10 "
              f"seen), {ms:.4f} ms by events{extra}; card {card}",
              flush=True)

    for dtype in (torch.float32, BF16):
        u, v, w = rand_fields((X, Y, Z), seed=0, dtype=dtype)
        for coef in ((False,) if dtype == torch.float32 else (False, True)):
            p = REF.default_params(Z, dtype=BF16 if coef else torch.float32,
                                   device="cuda")
            kind = ("f32" if dtype == torch.float32 else
                    f"bf16, {'bf16' if coef else 'f32'} coefficients")
            for name in BF16_RUNGS:
                rp = K.rung_device_plan("cuda:0", name, X, Y, Z, dtype=dtype,
                                        coef=coef)
                a = K.rung_kernel_attrs("cuda:0", name, rp, dtype=dtype,
                                        coef=coef)
                spills.append((f"{name} {kind}", a["local_bytes"]))
                for fu in (False, True):
                    line(f"{name} {kind} fuse_update={fu} at {(X, Y, Z)}",
                         lambda: getattr(K, name)(u, v, w, p, fuse_update=fu,
                                                  dt=DT),
                         RUNG_KERNEL[name],
                         f"; plan TY={rp.TY}, CX={rp.CX}, {rp.threads} "
                         f"threads, {rp.shared_bytes} B, {a['registers']} "
                         f"registers, {a['local_bytes']} B spilled, "
                         f"{a['blocks_per_sm']} resident per SM")
        del u, v, w

    for dtype in (torch.float32, BF16):
        u, v, w = rand_fields((X, Y, Z), seed=0, dtype=dtype)
        for coef in ((False,) if dtype == torch.float32 else (False, True)):
            p = REF.default_params(Z, dtype=BF16 if coef else torch.float32,
                                   device="cuda")
            plan = K.fused_device_plan("cuda:0", X, Y, Z, T, dtype=dtype,
                                       coef=coef)
            a = K.fused_kernel_attrs("cuda:0", T, plan, dtype=dtype,
                                     coef=coef)
            kind = ("f32" if dtype == torch.float32 else
                    f"bf16, {'bf16' if coef else 'f32'} coefficients")
            spills.append((f"K1 {kind} T={T} C={plan.cells_per_thread}",
                           a["local_bytes"]))
            line(f"K1 {kind} pass T={T} at {(X, Y, Z)}",
                 lambda: K.advect_fused(u, v, w, p, T=T, dt=DT),
                 "advect_ring_kernel",
                 f"; build C={plan.cells_per_thread}, {plan.threads} "
                 f"threads, {a['registers']} registers, {a['local_bytes']} "
                 f"B spilled, {a['blocks_per_sm']} resident per SM")
        del u, v, w
    B, (Xs, Ys, Zs) = SERVE_BATCH, SERVE_PAPER_SLOT
    slots = [torch.stack(f) for f in zip(*(
        rand_fields((Xs, Ys, Zs), seed=20 + b, dtype=BF16)
        for b in range(B)))]
    p = REF.default_params(Zs, dtype=BF16, device="cuda")
    line(f"K5 bf16 at {B} x {(Xs, Ys, Zs)} T={T}",
         lambda: K.advect_fused_batched(*slots, p, T=T, dt=DT),
         "advect_ring_kernel")
    del slots
    u, v, w = rand_fields((X, Y, Z), seed=0, dtype=BF16)
    q = SP.tracer_field(X, Y, Z, dtype=BF16, device="cuda")
    phi = SP.diffusion_field(X, Y, Z, dtype=BF16, device="cuda")
    for dtype in (torch.float32, BF16):
        p = REF.default_params(Z, dtype=dtype, device="cuda")
        inputs = {"pw": (p, (u, v, w)), "tracer": (p, (u, v, w, q)),
                  "diffusion": (SP.default_diffusion_params(
                      Z, dtype=dtype, device="cuda"), (phi,))}
        for op, integ, Ts in SPEC_PATH:
            if dtype == torch.float32 and (op, integ) != ("pw", "euler"):
                continue
            spec = SPEC_FACTORIES[op](integ)
            params, flds = inputs[op]
            flds = tuple(f.to(dtype) for f in flds)
            seen_builds = []
            for Tk in sorted(set(K.spec_passes(spec, Ts))):
                plan = K.spec_device_plan("cuda:0", X, Y, Z, spec, Tk,
                                          dtype=dtype, coef=dtype == BF16)
                a = K.spec_kernel_attrs("cuda:0", spec, Tk, plan,
                                        dtype=dtype, coef=dtype == BF16)
                spills.append((f"K6 {dtype} {spec.name} T={Tk} "
                               f"C={plan.cells_per_thread}", a["local_bytes"]))
                seen_builds.append(
                    f"T={Tk} C={plan.cells_per_thread}, {plan.threads} "
                    f"threads, {a['registers']} registers, "
                    f"{a['local_bytes']} B spilled, {a['blocks_per_sm']} "
                    f"resident per SM")
            kind = "bf16" if dtype == BF16 else "f32"
            n_pass = len(K.spec_passes(spec, Ts))
            line(f"K6 {kind} {spec.name} T={Ts} ({n_pass} pass(es)) at "
                 f"{(X, Y, Z)}",
                 lambda: K.stencil_fused(flds, params, spec, T=Ts,
                                         dt=SPEC_DT[op]),
                 "stencil_", "; builds " + "; ".join(seen_builds))
    del u, v, w, q, phi
    for name in SHAPE_NAMES:
        spec = shape_spec(name)
        Tp = K.spec_passes(spec, SHAPE_T)[0]
        flds = shape_fields(name, (X, Y, Z), BF16, 450)
        params = shape_params(name, Z, BF16)
        plan = K.spec_device_plan("cuda:0", X, Y, Z, spec, Tp, dtype=BF16,
                                  coef=True)
        a = K.spec_kernel_attrs("cuda:0", spec, Tp, plan, dtype=BF16,
                                coef=True)
        spills.append((f"K6 bf16 {name} T={Tp} C={plan.cells_per_thread}",
                       a["local_bytes"]))
        line(f"K6 bf16 {name} euler pass T={Tp} at {(X, Y, Z)}",
             lambda: K.stencil_fused(flds, params, spec, T=Tp,
                                     dt=SHAPE_DT[name]),
             "stencil_",
             f"; build C={plan.cells_per_thread}, {plan.threads} threads, "
             f"{a['registers']} registers, {a['local_bytes']} B spilled, "
             f"{a['blocks_per_sm']} resident per SM")
        del flds
    torch.cuda.empty_cache()
    return spills


def rounding_phases(check: Checks, card: str) -> None:
    """Phases 47-49: the routes alone, the extreme values, the times (and
    no build they time spills)."""
    phase("47 bf16 rounding routes", round_routes_phase, check, card)
    phase("48 bf16 rounding at extreme values", round_extremes_phase, check)
    for name, spilled in phase("49 bf16 rounding times", round_timing, card):
        check(spilled == 0, f"49 {name}: the build spills nothing "
              f"({spilled} B)")


# --- phase 50: the sharding layer --------------------------------------------

SHARD_TP = 2                 # 50b: qwen2.5-14b's 8 kv heads, 4 a rank
SHARD_TRAIN_DEPTH = 2        # of 64 qwen3-32b layers (50a)
SHARD_TRAIN_STEPS = 3
SHARD_REF = ROOT / "build" / "sharding_ref.pt"   # 50a's tp = 1 logits
# 50a's single-card f32 train step, 50b's reference at tp = 2
SHARD_TRAIN_REF = ROOT / "build" / "sharding_train_ref.json"
SHARD_TRAIN_TOL = 2e-5   # relative; the reference's TOL_REL["float32"]
SHARD_DIR = ROOT / "build" / "sharding"          # 50b's store and results
PIPE_SHAPE = (8, 1024, 6, 64)    # layers, width, micro-batches, rows
PSUM_N = 1 << 20                 # elements of 50b's compressed gradient
PSUM_STEPS = 2


def psum_mean_rel(n: int) -> float:
    """The CPU test's bound on |mean - host mean| / |host mean| of
    `compressed_psum` over n ranks: two orders of the scale sum differ by
    2(n-1) units of rounding, and the product rounds once on each side
    (exact divisions by n, a power of two)."""
    return (2 * (n - 1) + 2) * 2.0 ** -24


def prefill_tokens(vocab: int) -> torch.Tensor:
    """Phase 9's prompt."""
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab, (1, PREFILL_TOKENS)), device="cuda")


def timed_prefill(step, params, batch, calls: int = 2):
    """`calls` prefills (the first pays DTensor's sharding propagation);
    returns (the last one's logits and caches, [(host s, wall s)] a call,
    the last call's launch counts). Host: until the call returns; wall:
    until the card is done."""
    times = []
    for _ in range(calls):
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = step(params, batch)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        times.append((host, time.perf_counter() - t0))
        counts = all_counts()
    return logits, caches, times, counts


def times_text(times) -> str:
    return ", ".join(f"call {i + 1}: host {h * 1e3:.2f} ms, wall "
                     f"{w * 1e3:.2f} ms" for i, (h, w) in enumerate(times))


def one_card_mesh():
    """A (1, 1) `DeviceMesh` on card 0 over a single-rank NCCL group (its
    store a `HashStore`: no address, no port)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as TMESH
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))
    return TMESH.make_host_mesh(model=1, device="cuda")


def shard_prefill_phase(check: Checks, card: str, mesh) -> dict:
    """50a, prefill: qwen2.5-14b at full width and depth (f32 weights drawn
    on the card, bf16 compute, `pallas`) on phase 9's 2048-token prompt,
    the plain step, then the sharded step on the (1, 1) mesh (params
    placed, no copy): last-position logits and caches bitwise, K8 48
    times on each, each call's host and wall time. Saves the tp = 1
    last-position logits 50b holds its tp = 2 runs to. Returns a kernel
    record of K8 with the sharded prefill's launches."""
    from repro_torch.distributed.sharding import make_rules
    cfg = get_config(SERVE_ARCH).replace(attention_impl="pallas")
    layout = M.make_layout(cfg, 1)
    rules = make_rules(multi_pod=False)
    params = random_params(cfg, "cuda")
    batch = {"inputs": prefill_tokens(cfg.vocab_size)}
    tag = (f"50a {cfg.name} prefill {PREFILL_TOKENS} tokens, bf16 compute, "
           f"{cfg.n_layers} layers")
    got = {}
    for name in ("plain", "sharded"):
        if name == "plain":
            step, p = TS.make_prefill_step(cfg, layout), params
        else:
            step = TS.make_prefill_step(cfg, layout, rules, mesh)
            p = PS.place_tree(params, M.param_specs(cfg, layout), rules, mesh)
        logits, caches, times, counts = timed_prefill(step, p, batch)
        logits, caches = PS.gather_tree(logits), PS.gather_tree(caches)
        got[name] = (logits.clone(), digest(caches), times, counts)
        print(f"{tag}, {name} step: {times_text(times)}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        del logits, caches, p
        torch.cuda.empty_cache()
    (lp, dp, tp_, cp), (ls, ds, ts, cs) = got["plain"], got["sharded"]
    check(torch.equal(lp, ls) and dp == ds,
          f"{tag}: the sharded step on the (1, 1) mesh == the plain step, "
          f"bitwise (last-position logits, caches by digest)")
    n_tc = cs.pop("flash_attention_tc")
    n_k8 = cs.pop("flash_attention")
    check(n_tc == n_k8 == cfg.n_layers and not any(cs.values())
          and cp["flash_attention_tc"] == cfg.n_layers,
          f"{tag}: K8 (its tensor-core build) {n_tc} times on the sharded "
          f"step = {cfg.n_layers} layers, no other kernel")
    print(f"{tag}: DTensor dispatch, host time a call {ts[-1][0] * 1e3:.2f}"
          f" ms sharded against {tp_[-1][0] * 1e3:.2f} ms plain (warm); "
          f"wall {ts[-1][1] * 1e3:.2f} ms against {tp_[-1][1] * 1e3:.2f} ms;"
          f" first sharded call {ts[0][1]:.2f} s; card {card}", flush=True)
    if torch.cuda.device_count() >= 2:
        # 50b's tp = 1 references, on the same weights and prompt
        first2 = dict(params, layers=tree_map(lambda a: a[:2],
                                              params["layers"],
                                              is_leaf=torch.is_tensor))
        ref = {"bf16": lp}
        for key, c, p in (("f32", cfg.replace(compute_dtype="float32"),
                           params),
                          ("bf16_2", cfg.replace(n_layers=2), first2)):
            ref[key] = TS.make_prefill_step(c, layout)(p, batch)[0].cpu()
        SHARD_REF.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in ref.items()}, SHARD_REF)
        del first2
    del params, got
    torch.cuda.empty_cache()
    rec = attention_timing(n_tc, card)
    rec.update(path=f"the sharded prefill on a (1, 1) mesh: "
               f"{PREFILL_TOKENS} tokens of {cfg.name}, one launch a layer",
               shape=f"q {(1, cfg.n_heads, PREFILL_TOKENS, cfg.head_dim)}, "
               f"k/v {(1, cfg.n_kv_heads, PREFILL_TOKENS, cfg.head_dim)} "
               f"bf16 causal")
    check(rec.pop("within_bf16_bound"), "K8 at the sharded prefill's shape "
          "== plain within bf16_bound")
    return rec


def shard_train_phase(check: Checks, card: str, mesh) -> None:
    """50a, train: `train_loop` on qwen3-32b at full width, 2 of 64
    layers, `flash`, remat, batch 8 x 128, 3 steps, on a plain host mesh
    and then on the (1, 1) `DeviceMesh` under `make_rules`: losses,
    gradient norms and the final params (by digest) bitwise. Each run is
    freed before the next."""
    from repro_torch.launch import mesh as TMESH
    cfg = get_config(TRAIN_ARCH).replace(n_layers=SHARD_TRAIN_DEPTH,
                                         attention_impl="flash",
                                         remat="full")
    opt = TO.OptConfig(peak_lr=TRAIN_LR, warmup_steps=1,
                       total_steps=SHARD_TRAIN_STEPS)
    host = TMESH.HostMesh({"data": 1, "model": 1},
                          (torch.device("cuda", 0),))
    tag = (f"50a {cfg.name} ({SHARD_TRAIN_DEPTH} L) train, "
           f"{SHARD_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}")
    got = {}
    for name, m in (("plain", host), ("sharded", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, hist, info = train_loop(
            cfg, steps=SHARD_TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            opt=opt, log_every=1, seed=0, device="cuda", mesh=m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        params = PS.gather_tree(state["params"])
        got[name] = (hist, info["grad_norm"], digest(params))
        print(f"{tag}, {name}: {wall:.2f} s in all; steps "
              f"{[round(s * 1e3, 2) for s in info['step_s']]} ms (wall, "
              f"the loss read); losses {hist}; gradient norms "
              f"{info['grad_norm']}; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card}",
              flush=True)
        del state, params
    torch.cuda.empty_cache()
    (hp, gp, dp), (hs, gs, ds) = got["plain"], got["sharded"]
    check(len(hp) == SHARD_TRAIN_STEPS and hp == hs and gp == gs
          and dp == ds and all(math.isfinite(h) for h in hp),
          f"{tag}: on the (1, 1) mesh == plain, bitwise (losses, gradient "
          f"norms, final params by digest of {len(dp)} slices)")
    # 50b's reference: one f32 step on the card alone, its loss (the
    # vocabulary whole) and gradient norm
    state, hist, info = train_loop(
        cfg.replace(compute_dtype="float32"), steps=1, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, opt=opt, log_every=0, seed=0, device="cuda",
        mesh=host)
    del state
    torch.cuda.empty_cache()
    SHARD_TRAIN_REF.parent.mkdir(parents=True, exist_ok=True)
    SHARD_TRAIN_REF.write_text(json.dumps(
        {"loss": hist[0], "grad_norm": info["grad_norm"][0]}))


def vocab_train_step(mesh) -> dict:
    """50b, on one rank: 50a's f32 train step (qwen3-32b at full width,
    2 layers, one step of 8 x 128) on the NCCL mesh at tp = 2, the loss
    vocab-parallel (`models.model._vocab_parallel`, counted, on logits of
    V / 2 columns a rank). Returns its loss, gradient norm and counts."""
    cfg = get_config(TRAIN_ARCH).replace(
        n_layers=SHARD_TRAIN_DEPTH, attention_impl="flash", remat="full",
        compute_dtype="float32")
    opt = TO.OptConfig(peak_lr=TRAIN_LR, warmup_steps=1,
                       total_steps=SHARD_TRAIN_STEPS)
    inner, seen = M._vocab_parallel, []

    def counting(logits, tgt, dims):
        seen.append(logits.to_local().shape[-1])
        return inner(logits, tgt, dims)
    M._vocab_parallel = counting
    try:
        t0 = time.perf_counter()
        state, hist, info = train_loop(
            cfg, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ, opt=opt,
            log_every=0, seed=0, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        M._vocab_parallel = inner
    del state
    return {"loss": hist[0] if hist else math.nan,
            "grad_norm": info["grad_norm"][0] if hist else math.nan,
            "columns": seen, "vocab": M.param_specs(cfg, M.make_layout(
                cfg, SHARD_TP))["lm_head"].shape[-1], "s": wall}


def sharding_rank(rank: int, world: int) -> None:
    """50b, one NCCL rank a card (`torch.multiprocessing.spawn`): the tp =
    2 prefill, the f32 train step through the vocab-parallel loss
    (`vocab_train_step`), the pipeline and the compressed all-reduce.
    Writes its
    readings to `SHARD_DIR/rank<r>.json`; raises on any failure."""
    import torch.distributed as dist
    from repro_torch.distributed import compression as CMP
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import mesh as TMESH
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=(SHARD_DIR / "store")
                            .as_uri(), rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank))
    _build.load()
    out = {"rank": rank}
    try:
        mesh = TMESH.make_host_mesh(model=SHARD_TP, device="cuda")
        out["mesh"] = list(mesh.shape)
        rules = make_rules(multi_pod=False)
        cfg = get_config(SERVE_ARCH).replace(attention_impl="pallas")
        layout = M.make_layout(cfg, SHARD_TP)
        shapes = [s.shape for s in leaves(M.param_specs(cfg, layout))]
        if shapes != [s.shape for s in leaves(M.param_specs(
                cfg, M.make_layout(cfg, 1)))]:
            raise ValueError(f"{cfg.name} at tp = {SHARD_TP} stores other "
                             f"shapes than at tp = 1: the draws would "
                             f"differ from 50a's")
        gen = torch.Generator(device=f"cuda:{rank}").manual_seed(0)
        params = PS.init_sharded(M.param_specs(cfg, layout), gen, rules,
                                 mesh)
        out["param_gb"] = sum(t.to_local().numel() * 4 for t in leaves(
            params)) / 1e9
        ref = torch.load(SHARD_REF)
        batch = {"inputs": prefill_tokens(cfg.vocab_size)}
        first2 = dict(params, layers=tree_map(lambda a: a[:2],
                                              params["layers"],
                                              is_leaf=torch.is_tensor))
        for key, c, p in (("f32", cfg.replace(compute_dtype="float32"),
                           params),
                          ("bf16_2", cfg.replace(n_layers=2), first2),
                          ("bf16", cfg, params)):
            step = TS.make_prefill_step(c, layout, rules, mesh)
            logits, _, times, counts = timed_prefill(step, p, batch)
            logits = PS.gather_tree(logits).float().cpu()
            out[key] = {"diff": float((logits - ref[key]).abs().max()),
                        "scale": float(ref[key].abs().max()),
                        "finite": bool(torch.isfinite(logits).all()),
                        "times": times,
                        "counts": {k: v for k, v in counts.items() if v}}
        del params, first2
        torch.cuda.empty_cache()
        out["train"] = vocab_train_step(mesh)
        torch.cuda.empty_cache()
        # the pipeline: one stage a rank, == the sequential stack bitwise
        L, D, n_micro, rows = PIPE_SHAPE
        g = torch.Generator(device="cuda").manual_seed(7)
        stack = {"w": torch.randn(L, D, D, generator=g, device="cuda")
                 * D ** -0.5,
                 "b": torch.randn(L, D, generator=g, device="cuda") * 0.1}
        xs = torch.randn(n_micro, rows, D, generator=g, device="cuda")

        def block(p, x):
            return torch.tanh(x @ p["w"] + p["b"])

        def seq(x):
            for i in range(L):
                x = block({k: v[i] for k, v in stack.items()}, x)
            return x
        want = torch.stack([seq(xs[i]) for i in range(n_micro)])
        stages = world if L % world == 0 else 2
        pmesh = None
        if stages != world:
            from torch.distributed.device_mesh import init_device_mesh
            pmesh = init_device_mesh("cuda", (stages, world // stages),
                                     mesh_dim_names=("pod", "data"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipeline_apply(stack, xs, block, pmesh, axis="pod")
        torch.cuda.synchronize()
        out["pipeline"] = {"stages": stages, "equal": torch.equal(got, want),
                           "s": time.perf_counter() - t0}
        # the compressed all-reduce against a host recomputation
        res, ok_res, worst = None, True, 0.0
        for s in range(PSUM_STEPS):
            grads = []
            for r in range(world):
                gr = torch.Generator(device="cuda").manual_seed(
                    1000 * s + r)
                grads.append(torch.randn(PSUM_N, generator=gr,
                                         device="cuda") * 10.0 ** (r - 2))
            if res is None:
                res = [torch.zeros(PSUM_N, device="cuda")
                       for _ in range(world)]
            mean, mine = CMP.compressed_psum(grads[rank], None, res[rank])
            # host: every rank's quantisation, the int32 sum, the scales
            # summed in rank order
            qs, scales, hres = [], [], []
            for r in range(world):
                xf = grads[r].cpu() + res[r].cpu()
                q, sc = CMP.quantize_int8(xf)
                qs.append(q.to(torch.int32))
                scales.append(sc)
                hres.append(CMP._residual(xf, q, sc))
            ssum = scales[0].clone()
            for sc in scales[1:]:
                ssum = ssum + sc
            hmean = torch.stack(qs).sum(0).float() * (ssum / world) / world
            ok_res &= torch.equal(mine.cpu(), hres[rank])
            err = (mean.cpu() - hmean).abs()
            worst = max(worst, float((err / hmean.abs().clamp_min(
                1e-30))[hmean != 0].max()) if bool((hmean != 0).any())
                else 0.0)
            ok_res &= bool((err[hmean == 0] == 0).all())
            res = hres
            res = [t.to("cuda") for t in res]
        out["psum"] = {"residual_bitwise": bool(ok_res),
                       "mean_rel": worst}
    finally:
        (SHARD_DIR / f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def shard_cards_phase(check: Checks, card: str) -> None:
    """50b: with two or more cards, one NCCL rank a card (`sharding_rank`):
    qwen2.5-14b prefills on the (world / 2, 2) mesh, f32 at 48 layers
    within phase 9's f32 limit of 50a's tp = 1 logits, bf16 at 2 layers
    within phase 9's bf16 limit, bf16 at 48 layers printed (the depth
    phase 9 gates neither), K8 once a layer on every rank; 50a's f32
    qwen3-32b train step at tp = 2, its loss vocab-parallel (V / 2
    columns a rank), loss and gradient norm within `SHARD_TRAIN_TOL` of
    50a's one card; the pipeline over the ranks == the sequential stack
    bitwise; `compressed_psum`
    == a host recomputation (residuals bitwise, means within
    `psum_mean_rel`)."""
    n = torch.cuda.device_count()
    if n < 2:
        print("sharding across cards: skipped, 1 card visible", flush=True)
        return
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        torch.multiprocessing.spawn(sharding_rank, args=(n,), nprocs=n,
                                    join=True)
        failed = ""
    except Exception as e:      # a rank raised: its traceback is in e
        failed = f"{type(e).__name__}: {e}"[-3000:]
    print(f"50b: {n} ranks in {time.perf_counter() - t0:.1f} s", flush=True)
    check(not failed, f"50b: every one of {n} ranks ran to its end"
          f"{' (' + failed + ')' if failed else ''}")
    outs = []
    for r in range(n):
        path = SHARD_DIR / f"rank{r}.json"
        outs.append(json.loads(path.read_text()) if path.exists() else {})
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_REF.unlink(missing_ok=True)
    if failed:
        return
    cfg = get_config(SERVE_ARCH)
    tp_tag = (f"50b {cfg.name} prefill {PREFILL_TOKENS} tokens at tp = "
              f"{SHARD_TP}, mesh {outs[0]['mesh']} over {n} cards")
    for key, what, depth, limit in (
            ("f32", "f32 compute", cfg.n_layers, lambda s: PREFILL_F32_TOL),
            ("bf16_2", "bf16 compute", 2,
             lambda s: PREFILL_BF16_REL_TOL * s),
            ("bf16", "bf16 compute", cfg.n_layers, None)):
        for o in outs:
            rec = o[key]
            print(f"{tp_tag}, {what}, {depth} layers, rank {o['rank']} "
                  f"({o['param_gb']:.2f} GB of params): max |tp 2 - tp 1| "
                  f"{rec['diff']:.4e} (last position), max |logit| "
                  f"{rec['scale']:.4f}; {times_text(rec['times'])}; "
                  f"launches {rec['counts']}; {card}", flush=True)
        kernel = "flash_attention_tc" if key != "f32" else "flash_attention"
        check(all(o[key]["counts"].get(kernel) == depth
                  and o[key]["counts"].get("flash_attention") == depth
                  and o[key]["finite"] for o in outs),
              f"{tp_tag}, {what}, {depth} layers: K8 {depth} times on every "
              f"rank ({kernel}), logits finite")
        if limit is None:
            print(f"{tp_tag}, {what}, {depth} layers: not gated, as phase 9 "
                  f"gates bf16 only at 2 layers", flush=True)
            continue
        lim = limit(outs[0][key]["scale"])
        check(all(o[key]["diff"] <= lim for o in outs),
              f"{tp_tag}, {what}, {depth} layers: tp 2 == tp 1 within "
              f"phase 9's limit ({lim:.4g})")
    ref = json.loads(SHARD_TRAIN_REF.read_text())
    SHARD_TRAIN_REF.unlink(missing_ok=True)
    tr_tag = (f"50b {TRAIN_ARCH} ({SHARD_TRAIN_DEPTH} L) f32 train step of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} at tp = {SHARD_TP}, mesh "
              f"{outs[0]['mesh']} over {n} cards")
    for o in outs:
        t = o["train"]
        print(f"{tr_tag}, rank {o['rank']}: loss {t['loss']!r} (one card "
              f"{ref['loss']!r}), gradient norm {t['grad_norm']!r} (one card "
              f"{ref['grad_norm']!r}); the loss vocab-parallel "
              f"{len(t['columns'])} time(s) on {t['columns']} of "
              f"{t['vocab']} columns; {t['s']:.2f} s; {card}", flush=True)
    rel = max(max(abs(o["train"][k] - ref[k]) / abs(ref[k])
                  for k in ("loss", "grad_norm")) for o in outs)
    check(all(o["train"]["columns"] and all(
        2 * c == o["train"]["vocab"] for c in o["train"]["columns"])
        for o in outs) and rel <= SHARD_TRAIN_TOL,
        f"{tr_tag}: the loss vocab-parallel on every rank (V / 2 columns "
        f"a rank), loss and gradient norm == one card's within "
        f"{SHARD_TRAIN_TOL} relative ({rel:.3e})")
    pipe = outs[0]["pipeline"]
    check(all(o["pipeline"]["equal"] for o in outs),
          f"50b pipeline_apply over {pipe['stages']} stages "
          f"({PIPE_SHAPE[0]} layers of {PIPE_SHAPE[1]}, {PIPE_SHAPE[2]} "
          f"micro-batches of {PIPE_SHAPE[3]}) == the sequential stack, "
          f"bitwise ({pipe['s'] * 1e3:.2f} ms, first call)")
    worst = max(o["psum"]["mean_rel"] for o in outs)
    check(all(o["psum"]["residual_bitwise"] for o in outs)
          and worst <= psum_mean_rel(n),
          f"50b compressed_psum over {n} ranks, {PSUM_STEPS} steps of "
          f"{PSUM_N} elements: residuals == host bitwise, means within "
          f"{psum_mean_rel(n):.3e} relative (worst {worst:.3e})")


def sharding_phases(check: Checks, card: str) -> list:
    """Phase 50: 50a on one card (the (1, 1) mesh), then 50b across the
    cards. Returns the kernel records (K8 on the sharded prefill)."""
    import torch.distributed as dist
    mesh = one_card_mesh()
    rec = phase("50a sharded prefill", shard_prefill_phase, check, card,
                mesh)
    phase("50a sharded train", shard_train_phase, check, card, mesh)
    dist.destroy_process_group()
    phase("50b sharding across cards", shard_cards_phase, check, card)
    return [rec]


# ---------------------------------------------------------------------------
# phase 51: the paper's §IV, chunked host-to-card streaming
# ---------------------------------------------------------------------------


def wall_s(fn, runs: int = CHUNK_RUNS) -> float:
    """Median seconds of `fn` on the host's clock, the card synchronised
    before and after each run."""
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def chunking_phase(check: Checks, card: str) -> dict:
    """Phase 51: the 268M grid (3 f32 fields drawn on the host from
    `CHUNK_SEED`) cut in x into `CHUNK_N` independent chunks, each K2's
    sources (`pw_advect(variant="wide")`) through `ChunkScheduler`:
    `run_overlapped` (the main path, K2 counted) == `run_serial` bitwise,
    chunk by chunk, and each chunk == K2 on it already on the card; then the
    times. Returns K2's record on this path."""
    X, Y, Z = PAPER_GRIDS[CHUNK_GRID]
    cx = X // CHUNK_N
    t0 = time.perf_counter()
    rng = np.random.default_rng(CHUNK_SEED)
    fields = [rng.standard_normal((X, Y, Z), dtype=np.float32)
              for _ in range(3)]
    chunks = [tuple(f[i * cx:(i + 1) * cx] for f in fields)
              for i in range(CHUNK_N)]
    one_way = sum(f.nbytes for f in fields)
    print(f"chunking: {CHUNK_GRID} grid {(X, Y, Z)} f32, 3 fields "
          f"({one_way / 1e9:.3f} GB each way) drawn on the host in "
          f"{time.perf_counter() - t0:.2f} s, cut in x into {CHUNK_N} "
          f"chunks of {(cx, Y, Z)}", flush=True)
    p = REF.default_params(Z, device="cuda")

    def k2(u, v, w):
        return AOPS.pw_advect(u, v, w, p, variant="wide")

    sched = ChunkScheduler(k2, depth=CHUNK_DEPTH, device="cuda")
    sched.run_serial(chunks[:1])
    sched.run_overlapped(chunks[:CHUNK_DEPTH])
    torch.cuda.synchronize()
    K.reset_launch_counts()
    over = sched.run_overlapped(chunks)
    launches = K.LAUNCHES["advect_wide"]
    others = {k: n for k, n in K.LAUNCHES.items() if k != "advect_wide" and n}
    check(launches == CHUNK_N and not others,
          f"chunked path: {launches} K2 launches for {CHUNK_N} chunks "
          f"(want {CHUNK_N}), no other kernel ({others})")
    serial = sched.run_serial(chunks)
    check(all(len(a) == 3 and all(np.array_equal(x, y) for x, y in zip(a, b))
              for a, b in zip(over, serial)),
          f"chunked path: run_overlapped == run_serial bitwise, all "
          f"{CHUNK_N} chunks")
    bad, err = 0, 0.0
    for c, got in zip(chunks, over):
        dev = tuple(torch.from_numpy(a).cuda() for a in c)
        want = k2(*dev)
        bad += sum(not np.array_equal(g, w.cpu().numpy())
                   for g, w in zip(got, want))
        del dev, want
    check(bad == 0, f"chunked path: each chunk's sources == K2 on that "
          f"chunk resident on the card, bitwise ({bad} of {3 * CHUNK_N} "
          f"arrays differ)")
    dev = tuple(torch.from_numpy(a).cuda() for a in chunks[0])
    plain = K._advect_rung_plain(*dev, p, False, 1.0)
    err = max(float((a - b).abs().max()) for a, b in zip(k2(*dev), plain))
    check(err == 0.0, f"chunked path: K2 == plain on chunk 0 ({err})")

    allocs0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
    t_serial = wall_s(lambda: sched.run_serial(chunks))
    allocs1 = torch.cuda.memory_stats().get("num_device_alloc", 0)
    t_over = wall_s(lambda: sched.run_overlapped(chunks))
    allocs2 = torch.cuda.memory_stats().get("num_device_alloc", 0)
    hbuf = torch.empty(LINK_BYTES // 4, dtype=torch.float32, pin_memory=True)
    dbuf = torch.empty_like(hbuf, device="cuda")
    h2d_ms = time_ms(lambda: dbuf.copy_(hbuf, non_blocking=True), runs=5,
                     warmup=2)
    d2h_ms = time_ms(lambda: hbuf.copy_(dbuf, non_blocking=True), runs=5,
                     warmup=2)
    h2d, d2h = LINK_BYTES / h2d_ms / 1e6, LINK_BYTES / d2h_ms / 1e6
    del hbuf, dbuf
    pins = [torch.empty((cx, Y, Z), pin_memory=True) for _ in range(3)]
    t_memcpy = wall_s(lambda: [b.copy_(torch.from_numpy(a)) for c in chunks
                               for b, a in zip(pins, c)])
    t_npcopy = wall_s(lambda: [np.copyto(b.numpy(), a) for c in chunks
                               for b, a in zip(pins, c)])
    t_take = wall_s(lambda: [torch.from_numpy(np.empty(b.shape,
                                                       np.float32)).copy_(b)
                             for _ in chunks for b in pins])
    k2_ms = time_ms(lambda: k2(*dev))
    k2_dev = profiled_kernels(lambda: k2(*dev), RUNG_KERNEL["advect_wide"],
                              ("cuda:0",), 10)[0]
    plain_ms = time_ms(lambda: K._advect_rung_plain(*dev, p, False, 1.0),
                       runs=5)
    bw = (h2d + d2h) / 2 * 1e9
    model = overlap_model(one_way, CHUNK_N * k2_ms / 1e3, bw, CHUNK_N)
    print(f"chunked path ({card}): serial {t_serial:.4f} s, overlapped "
          f"{t_over:.4f} s (median of {CHUNK_RUNS}, depth {CHUNK_DEPTH}), "
          f"overlapped / serial {t_over / t_serial:.4f} (cudaMallocs in the "
          f"timed runs: serial {allocs1 - allocs0}, overlapped "
          f"{allocs2 - allocs1}); host link from "
          f"pinned memory, {LINK_BYTES} B alone: host-to-card "
          f"{h2d:.2f} GB/s, card-to-host {d2h:.2f} GB/s (PCIe Gen5 x16 data "
          f"sheet {R.PCIE_BW / 1e9:.0f} GB/s each way); the host's copy of "
          f"every chunk into pinned staging buffers alone {t_memcpy:.4f} s "
          f"({one_way / t_memcpy / 1e9:.2f} GB/s, torch's copy on "
          f"{torch.get_num_threads()} threads; numpy's on one "
          f"{t_npcopy:.4f} s, {one_way / t_npcopy / 1e9:.2f} GB/s); the "
          f"copy out of them into new numpy arrays alone (the worker's "
          f"share) {t_take:.4f} s ({one_way / t_take / 1e9:.2f} GB/s); the "
          f"host memory traffic of a run (each way a copy's read and write "
          f"and the transfer's read or write: {6 * one_way} B) at the rate "
          f"of the copy in alone {3 * t_memcpy:.4f} s; K2 "
          f"{k2_ms:.4f} ms a chunk "
          f"by events, device "
          f"{f'{k2_dev:.4f} ms' if k2_dev > 0 else 'not measured'}; "
          f"overlap_model(bytes {one_way}, compute {CHUNK_N} x K2, bw "
          f"{bw / 1e9:.2f} GB/s, {CHUNK_N}): serial "
          f"{model['serial_s']:.4f} s, overlapped {model['overlapped_s']:.4f}"
          f" s, beside the measured {t_serial:.4f} s and {t_over:.4f} s",
          flush=True)
    for depth in CHUNK_DEPTHS:
        s = ChunkScheduler(k2, depth=depth, device="cuda")
        s.run_overlapped(chunks[:depth])
        t = wall_s(lambda: s.run_overlapped(chunks))
        print(f"chunked path: run_overlapped at depth {depth}: {t:.4f} s "
              f"(median of {CHUNK_RUNS}; {t / t_serial:.4f} of serial)",
              flush=True)
        del s
    cells = cx * Y * Z
    rec = kernel_record("advect_wide", k2_ms, plain_ms,
                        6 * cells * 4 + (2 + 2 * Z) * 4,
                        (cx - 2) * (Y - 2) * (Z - 2) * REF.flops_per_cell(),
                        launches, err)
    rec.update(path=f"§IV chunked streaming: {CHUNK_N} chunks of "
               f"{(cx, Y, Z)}", shape=str((cx, Y, Z)),
               device_ms=k2_dev if k2_dev > 0 else None)
    del sched, over, serial, chunks, fields, dev, plain, pins
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 52: the profiler and the dry run against the card
# ---------------------------------------------------------------------------


def profiler_phase(check: Checks, card: str, cfg0, params) -> None:
    """Phase 52: `profiler.wallclock` on K1 at 67M, T = 4, beside the
    events median; then phase 9's prefill (2048 tokens, bf16 compute, the
    dry run's execution policy) traced by `dryrun.trace_cell` on a (1, 1)
    fake mesh and run live on the card under `FlopCounterMode`: the FLOPs
    equal, the traced resident bytes against the measured peak."""
    X, Y, Z = PAPER_GRIDS[MAIN_GRID]
    u, v, w = rand_fields((X, Y, Z), seed=520)
    p = REF.default_params(Z, device="cuda")
    wc = PF.wallclock(lambda *f: K.advect_fused(*f, p, T=MAIN_T, dt=DT),
                      u, v, w, iters=TIMED_RUNS, warmup=WARMUP) * 1e3
    ev = time_ms(lambda: K.advect_fused(u, v, w, p, T=MAIN_T, dt=DT))
    print(f"profiler.wallclock: K1 at {(X, Y, Z)}, T={MAIN_T}: {wc:.4f} ms "
          f"(median of {TIMED_RUNS}), events median {ev:.4f} ms; ratio "
          f"{wc / ev:.4f}", flush=True)
    check(abs(wc - ev) <= WALLCLOCK_REL * ev, f"profiler.wallclock == the "
          f"events median within {WALLCLOCK_REL:.0%} ({wc:.4f} vs "
          f"{ev:.4f} ms)")
    del u, v, w
    shape = RunShape("prefill_2048", "prefill", PREFILL_TOKENS, 1)
    cfg = DRY.exec_policy(cfg0, shape)
    t0 = time.perf_counter()
    with DRY.fake_group(1):
        mesh = DRY._mesh(False, (1, 1))
        cell = DRY.trace_cell(cfg, shape, mesh)
    tr, mem = cell["trace"], cell["memory"]
    trace_s = time.perf_counter() - t0
    layout = M.make_layout(cfg, 1)
    batch = LSP.make_batch(cfg, shape, np.random.default_rng(0),
                           device="cuda")
    step = TS.make_prefill_step(cfg, layout)
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    args = sum(t.numel() * t.element_size() for t in PF.local_tensors(
        (params, batch)))
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = step(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - (held - args)
    live = fc.get_total_flops()
    del out
    ratio = mem["resident_bytes_per_dev"] / peak
    print(f"dry run vs the card ({card}): {cfg.name} prefill "
          f"{PREFILL_TOKENS} tokens, {cfg.compute_dtype} compute, "
          f"{cfg.attention_impl}, traced in {trace_s:.1f} s on a (1, 1) fake "
          f"mesh: FLOPs traced {tr.flops:.0f}, live {live}; resident traced "
          f"{mem['resident_bytes_per_dev']} B (arguments "
          f"{mem['argument_size_in_bytes']} B), measured peak {peak} B "
          f"(max_memory_allocated less {held - args} B the process held "
          f"besides the step's arguments); traced / measured {ratio:.4f}",
          flush=True)
    check(int(tr.flops) == int(live), f"dry run: traced FLOPs == live "
          f"FlopCounterMode FLOPs ({tr.flops:.0f} vs {live})")
    lo, hi = RESIDENT_RATIO
    check(lo <= ratio <= hi, f"dry run: traced resident / measured peak "
          f"{ratio:.4f} within [{lo}, {hi}]")


# ---------------------------------------------------------------------------
# phase 53: nemotron on the card
# ---------------------------------------------------------------------------


def nemotron_phase(check: Checks, card: str) -> list:
    """Phase 53: each `NEMOTRON` config at full width (cut in depth as one
    card forces, f32 weights), a bf16 `pallas` prefill of
    `PREFILL_TOKENS` tokens against `flash` on the card: K8 once a layer
    (its tensor-core build), no other kernel; the logits of the first
    `NEMOTRON_GATE_LAYERS` layers within phase 9's bf16 limit, every layer
    printed. Returns K8's record at nemotron-4-340b's head dim (192)."""
    records = []
    for arch, cut in NEMOTRON:
        cfg = fam_cfg(arch, **cut)
        params = draw(cfg)
        layout = M.make_layout(cfg, 1)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, PREFILL_TOKENS)), device="cuda")
        depths = sorted({min(NEMOTRON_GATE_LAYERS, cfg.n_layers),
                         cfg.n_layers})
        launched = {}
        for depth in depths:
            c = cfg.replace(n_layers=depth)
            pp = dict(params, layers=tree_map(lambda a: a[:depth],
                                              params["layers"],
                                              is_leaf=torch.is_tensor))
            (lp, _, _), n_p, ms_p = counted_forward(pp, {"inputs": toks}, c,
                                                    layout)
            (lf, _, _), n_f, ms_f = counted_forward(
                pp, {"inputs": toks}, c.replace(attention_impl="flash"),
                layout)
            diff = float((lp - lf).abs().max())
            scale = float(lf.abs().max())
            tag = (f"{arch} bf16 prefill {PREFILL_TOKENS} tokens, {depth} of "
                   f"{get_config(arch).n_layers} layers")
            print(f"{tag}: max |pallas - flash| {diff:.4e}, max |logit| "
                  f"{scale:.4f} ({diff / scale:.4e} of it); pallas "
                  f"{ms_p:.1f} ms, flash {ms_f:.1f} ms of wall time; K8 "
                  f"launches {n_p['flash_attention']} "
                  f"({n_p['flash_attention_tc']} tensor-core)", flush=True)
            k8 = n_p.pop("flash_attention")
            tc = n_p.pop("flash_attention_tc")
            launched[depth] = k8
            check(k8 == depth and tc == depth and not any(n_p.values())
                  and not any(n_f.values())
                  and lp.shape == (1, PREFILL_TOKENS, cfg.vocab_size)
                  and bool(torch.isfinite(lp).all()),
                  f"{tag}: K8 once a layer (tensor-core build, head dim "
                  f"{cfg.head_dim}) on the pallas path only; logits finite")
            if depth <= NEMOTRON_GATE_LAYERS:
                check(diff <= PREFILL_BF16_REL_TOL * scale,
                      f"{tag}: pallas == flash within "
                      f"{PREFILL_BF16_REL_TOL} x max |logit| "
                      f"({PREFILL_BF16_REL_TOL * scale:.4f})")
            else:
                print(f"{tag}: not gated, as phase 9's {cfg.n_layers}-layer "
                      f"bf16 run is not: the two algorithms' bf16 rounding "
                      f"of activations differs and grows with depth",
                      flush=True)
            del lp, lf
        del params, pp
        torch.cuda.empty_cache()
        if cfg.head_dim == 192:
            rec = attention_timing(
                launched[cfg.n_layers], card,
                shape=(1, cfg.n_heads, cfg.n_kv_heads, PREFILL_TOKENS,
                       cfg.head_dim),
                path=f"{arch} bf16 prefill of {PREFILL_TOKENS} tokens, "
                f"{cfg.n_layers} layer(s)")
            check(rec["within_bf16_bound"], f"K8 at {arch}'s shape == plain "
                  f"within bf16_bound")
            records.append(rec)
    return records


def dryrun_only(check: Checks, card: str) -> list:
    """`--only dryrun`: phase 52 with `qwen2.5-14b` drawn first."""
    cfg = get_config(SERVE_ARCH)
    params = draw(cfg)
    phase("52 profiler and dry run", profiler_phase, check, card, cfg, params)
    return []


# ---------------------------------------------------------------------------
# phase 54: the device code of each node the tracer emits for the math
# callbacks (math functions, powers, floor division and remainder,
# comparisons as numbers), held against torch's op on the card over every
# input of its probe; the specs that use them run in phases 44-46
# ---------------------------------------------------------------------------

PROBE_CHUNK = 1 << 28        # elements a probe launch takes
PROBE_F32_PAIRS = 1 << 28    # random f32 operand pairs of a binary node
PROBE_SPECIALS = (0.0, -0.0, math.inf, -math.inf, math.nan, 1e-45, -1e-45,
                  1.1754942e-38, 1.1754944e-38, -1.1754944e-38,
                  3.4028235e38, -3.4028235e38, 1.0, -1.0, 0.5, -0.5, 2.0,
                  -2.0, 3.0, -3.0, 0.75, -0.75, 0.1, -0.1, 180.0, -180.0,
                  360.0, -360.0, 720.0, -540.0, 7.5, -7.5, 1e-30, 1e30,
                  2.0 ** 24, -(2.0 ** 24), 2.0 ** 24 + 2.0, 123456.0, 88.5,
                  -87.5, 0.3, 1.5, 2.5)


def probe_bits(start: int, n: int, dtype) -> torch.Tensor:
    """n consecutive bit patterns of `dtype` from `start` (modulo its
    width)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device="cuda")
    if dtype == BF16:
        return idx.to(torch.int16).view(BF16)
    return idx.to(torch.int32).view(torch.float32)


def probe_inputs(arity: int, dtype):
    """The operands a probe case runs on, chunk by chunk: every bit
    pattern (one operand); every pair of bf16 patterns, or PROBE_F32_PAIRS
    random f32 pairs (random bits, and normal values times powers of ten)
    and every pair of PROBE_SPECIALS (two)."""
    width = 16 if dtype == BF16 else 32
    if arity == 1:
        total = 1 << width
        for start in range(0, total, PROBE_CHUNK):
            yield probe_bits(start, min(PROBE_CHUNK, total - start), dtype), \
                None
        return
    if dtype == BF16:
        for start in range(0, 1 << 32, PROBE_CHUNK):
            idx = torch.arange(start, start + PROBE_CHUNK, dtype=torch.int64,
                               device="cuda")
            yield ((idx >> 16).to(torch.int16).view(BF16),
                   (idx & 0xFFFF).to(torch.int16).view(BF16))
        return
    gen = torch.Generator(device="cuda").manual_seed(54)
    for _ in range(0, PROBE_F32_PAIRS, PROBE_CHUNK):
        a, b = (torch.randint(-2 ** 31, 2 ** 31, (PROBE_CHUNK // 2,),
                              dtype=torch.int64, device="cuda",
                              generator=gen).to(torch.int32)
                .view(torch.float32) for _ in range(2))
        yield a, b
        a, b = (torch.randn(PROBE_CHUNK // 2, device="cuda", generator=gen)
                * 10.0 ** torch.randint(-4, 5, (PROBE_CHUNK // 2,),
                                        device="cuda", generator=gen)
                for _ in range(2))
        yield a, b
    sp = torch.tensor(PROBE_SPECIALS, dtype=torch.float32, device="cuda")
    yield sp.repeat_interleave(len(sp)), sp.repeat(len(sp))


def probe_mismatch(got, want) -> tuple:
    """(inputs whose result bits differ, NaN to NaN allowed; the first
    such index)."""
    it = torch.int16 if got.dtype == BF16 else torch.int32
    bad = (got.view(it) != want.view(it)) & ~(torch.isnan(got)
                                              & torch.isnan(want))
    n = int(bad.sum())
    return n, (int(bad.nonzero()[0, 0]) if n else None)


def probe_node_phase(check: Checks, card: str) -> dict:
    """Phase 54: every new node's device code, as the tracer emits it into
    a functor (`spec_cuda.probe_cases`, built into one probe with the
    generated builds' flags), == torch's op on the card (the case's own
    callback) over every input of `probe_inputs`: the same bits, or NaN for
    NaN. Returns {case name: differing inputs}."""
    t0 = time.perf_counter()
    _build.load_probe(G.probe_header())
    print(f"54 probe of {len(G.probe_cases())} node cases built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {}
    for i, (name, arity, _) in enumerate(G.probe_cases()):
        for dtype in (torch.float32, BF16):
            kind = "bf16" if dtype == BF16 else "f32"
            n_in, n_bad, first = 0, 0, None
            for a, b in probe_inputs(arity, dtype):
                want = G.probe_reference(i, a, b)
                got = G.run_probe(i, a, b)
                bad, at = probe_mismatch(got, want)
                if bad and first is None:
                    first = (float(a[at]), None if b is None else float(b[at]),
                             float(got[at]), float(want[at]))
                n_bad += bad
                n_in += a.numel()
                del want, got
            out[f"{name} {kind}"] = n_bad
            what = ("every bit pattern" if arity == 1 else
                    "every pair of bit patterns" if dtype == BF16 else
                    f"{PROBE_F32_PAIRS} random pairs and "
                    f"{len(PROBE_SPECIALS) ** 2} pairs of special values")
            check(n_bad == 0, f"54 node {name!r} {kind}: the functor's code "
                  f"== torch's op on the card over {what} ({n_in} inputs): "
                  f"{n_bad} differ (first: a, b, card, torch = {first})")
    print(f"54 probe: {time.perf_counter() - t0:.1f} s; card {card}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 55: training on every card of the host
# ---------------------------------------------------------------------------

HOST_TRAIN_DEPTH = 2         # of 64 qwen3-32b layers: 30.4 GB of state
HOST_TRAIN_STEPS = 4
HOST_TRAIN_AT = 2            # 55a's checkpoint, the resume's first step
HOST_TRAIN_DIR = ROOT / "build" / "host_train"   # logs and readings
# the checkpoints: in memory (a call may write 45 GiB to the machine's
# disk; one 84 GB archive is more), in a directory of the run's own there
HOST_CKPT_PARENT = Path("/dev/shm")
HOST_SSM_STEPS, HOST_SSM_KILL = 6, 4   # 55b's command line runs
HOST_QWEN_DEPTH = 16         # 55b: 112.3 GB of state over the cards
HOST_QWEN_STEPS = 3
# 55b's host memory: two whole falcon-mamba-7b archives at once and the
# writing rank's host copy of the state, beside the ranks themselves
HOST_MEM_GB = 3 * 84.1 + 16
HOST_ROOM = 1.01             # an archive's bytes over its state's (headers)
HOST_CLI_TIMEOUT = 1800      # seconds a command line run may take
HOST_ELASTIC_TOL = 2e-5      # relative: 50b's gate (the reference's f32)


def state_bytes(cfg, tp: int = 1) -> tuple:
    """(bytes of the whole train state, bytes of its largest leaf), from
    `state_specs`."""
    sizes = [int(np.prod(s.shape)) * torch.empty((), dtype=PS.torch_dtype(
        s.dtype)).element_size() for s in leaves(TS.state_specs(
            cfg, M.make_layout(cfg, tp)))]
    return sum(sizes), max(sizes)


@contextlib.contextmanager
def ckpt_probe():
    """Each `AsyncCheckpointer.save` (its gathers and host copy) and
    `restore_placed` in this process, recorded: seconds, the device memory
    allocated before, and the device peak during it. The archive a restore
    read is deleted once read (the checkpoints live in memory)."""
    rec = []
    save, restore = CKPT.AsyncCheckpointer.save, CKPT.restore_placed

    def probed(fn, what):
        def call(*a, **kw):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec.append({"what": what, "s": time.perf_counter() - t0,
                        "base": base,
                        "peak": torch.cuda.max_memory_allocated()})
            if what == "restore":
                shutil.rmtree(Path(a[0]) / f"step_{out[1]:09d}")
            return out
        return call
    CKPT.AsyncCheckpointer.save = probed(save, "save")
    CKPT.restore_placed = probed(restore, "restore")
    try:
        yield rec
    finally:
        CKPT.AsyncCheckpointer.save, CKPT.restore_placed = save, restore


def drop_state() -> None:
    """Free the device memory of a state the caller dropped: the cyclic
    collector first (torch's first DTensor call in a process imports
    `torch._dynamo`, whose `torch.fx.wrap` keeps the calling frames, and
    with them the first `train_loop`'s state, in a reference cycle), then
    the caching allocator's blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def host_cfg(depth: int, **kw):
    return get_config(TRAIN_ARCH).replace(n_layers=depth,
                                          attention_impl="flash",
                                          remat="full", **kw)


def host_train_one_phase(check: Checks, card: str, ckpt_root: Path) -> None:
    """55a, on one card: `train_loop` on a (1, 1) `DeviceMesh` over a
    one-rank NCCL group, qwen3-32b at full width, 2 of 64 layers, `flash`,
    remat, 4 steps of 8 x 128 straight; then 2 steps with a checkpoint at
    step 2 (leaf by leaf) and a resume to step 4: losses, gradient norms
    and the final state (by digest) bitwise; the device peak during the
    save and the restore against the state plus its largest leaf; then
    `python -m repro_torch.launch.train --arch qwen3-32b --smoke --steps
    3` as a child: exit 0, one log. Checkpoints under `ckpt_root`."""
    import torch.distributed as dist
    mesh = one_card_mesh()
    cfg = host_cfg(HOST_TRAIN_DEPTH)
    whole, largest = state_bytes(cfg)
    opt = TO.OptConfig(peak_lr=TRAIN_LR, warmup_steps=1,
                       total_steps=HOST_TRAIN_STEPS)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, opt=opt, log_every=1,
              seed=0, device="cuda", mesh=mesh)
    d = ckpt_root / "one_card"
    tag = (f"55a {cfg.name} ({HOST_TRAIN_DEPTH} L, {whole / 1e9:.2f} GB of "
           f"state, largest leaf {largest / 1e9:.2f} GB) on a (1, 1) "
           f"DeviceMesh, {HOST_TRAIN_STEPS} steps of {TRAIN_BATCH} x "
           f"{TRAIN_SEQ}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, hist, info = train_loop(cfg, steps=HOST_TRAIN_STEPS, **kw)
    straight = (hist, info["grad_norm"], digest(PS.gather_tree(state)))
    ms = [round(s * 1e3, 2) for s in info["step_s"]]
    print(f"{tag}, straight: steps {ms} ms; losses {hist}; gradient norms "
          f"{info['grad_norm']}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card}",
          flush=True)
    del state
    drop_state()
    try:
        with ckpt_probe() as rec:
            state, h1, i1 = train_loop(cfg, steps=HOST_TRAIN_AT, ckpt_dir=d,
                                       ckpt_every=HOST_TRAIN_AT, **kw)
            del state
            drop_state()
            state, h2, i2 = train_loop(cfg, steps=HOST_TRAIN_STEPS,
                                       ckpt_dir=d,
                                       ckpt_every=HOST_TRAIN_STEPS, **kw)
        latest = CKPT.latest_step(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    resumed = (h1 + h2, i1["grad_norm"] + i2["grad_norm"],
               digest(PS.gather_tree(state)))
    del state
    drop_state()
    check(straight == resumed and latest == HOST_TRAIN_STEPS
          and all(math.isfinite(h) for h in hist),
          f"{tag}: {HOST_TRAIN_AT} steps, a checkpoint leaf by leaf, a resume "
          f"to {HOST_TRAIN_STEPS} == {HOST_TRAIN_STEPS} straight, bitwise "
          f"(losses, gradient norms, the final state by digest of "
          f"{len(straight[2])} slices)")
    for r in rec:
        print(f"{tag}: {r['what']} {r['s']:.2f} s, device "
              f"{r['base'] / 1e9:.2f} GB before, peak "
              f"{r['peak'] / 1e9:.2f} GB against the state "
              f"plus its largest leaf {(whole + largest) / 1e9:.2f} GB; "
              f"{card}", flush=True)
    for c in i1["ckpt_s"] + i2["ckpt_s"]:
        print(f"{tag}: checkpoint step {c['step']}: host copy "
              f"{c['copy_s']:.2f} s, write {c.get('write_s', 0):.2f} s "
              f"({whole / 1e9 / max(c.get('write_s', 0), 1e-9):.2f} GB/s) "
              f"under {ckpt_root}; {card}", flush=True)
    print(f"{tag}: the resume's restore {i2['restore_s']:.2f} s "
          f"({whole / 1e9 / i2['restore_s']:.2f} GB/s); {card}", flush=True)
    check(len(rec) == 3 and all(r["peak"] - r["base"] <= largest
                                for r in rec if r["what"] == "save")
          and all(r["peak"] <= whole + largest for r in rec)
          and all(r["base"] < largest for r in rec
                  if r["what"] == "restore"),
          f"{tag}: the device peak during the save at most its state plus "
          f"one whole leaf, during the restore at most the state plus its "
          f"largest leaf, with less than one leaf allocated before it (no "
          f"dropped state left)")
    dist.destroy_process_group()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--smoke", "--steps", "3"], capture_output=True,
        text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    print(f"55a `python -m repro_torch.launch.train --arch {TRAIN_ARCH} "
          f"--smoke --steps 3` ({torch.cuda.device_count()} card(s)): exit "
          f"{out.returncode} in {time.perf_counter() - t0:.1f} s; "
          f"{out.stdout.strip().splitlines()[-1:]}", flush=True)
    err = out.stderr.strip()[-2000:] if out.returncode else "ok"
    check(out.returncode == 0 and out.stdout.count("[train] done") == 1,
          f"55a the command line on {torch.cuda.device_count()} card(s): "
          f"exit 0, one log ({err})")


def mem_available() -> int:
    """The host's available memory in bytes (`/proc/meminfo`)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


def smi_memory() -> list:
    """Each card's memory.used in MiB (the NVIDIA driver's view: every
    process's context and PyTorch's cache included)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return [int(x) for x in out.stdout.split()]


def cli_run(args: list, log: Path, kill_at=None, drop=None) -> dict:
    """`python -m repro_torch.launch.train` with `args`, its output into
    `log`, each card's memory.used sampled while it runs. With `kill_at`
    (a checkpoint directory and a step) the run is killed, every process it
    started with it, once that step's checkpoint is published; `drop` (a
    checkpoint's directory) is deleted once the run says it resumed (the
    checkpoints live in memory). Returns the exit code, the wall seconds,
    each card's peak MiB and the output."""
    import signal
    peaks = smi_memory()
    t0 = time.perf_counter()
    with open(log, "w") as f:
        p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train"]
                             + args, stdout=f, stderr=subprocess.STDOUT,
                             text=True, cwd=ROOT, start_new_session=True,
                             env=dict(os.environ, PYTHONUNBUFFERED="1",
                                      PYTHONPATH=str(ROOT / "src")))
        killed = False
        while p.poll() is None:
            peaks = [max(a, b) for a, b in zip(peaks, smi_memory())]
            if kill_at is not None and CKPT.latest_step(kill_at[0]) == \
                    kill_at[1]:
                os.killpg(p.pid, signal.SIGKILL)
                killed = True
            if drop is not None and "[train] resumed" in log.read_text():
                shutil.rmtree(drop, ignore_errors=True)
                drop = None
            if time.perf_counter() - t0 > HOST_CLI_TIMEOUT:
                os.killpg(p.pid, signal.SIGKILL)
            time.sleep(0.5)
    with contextlib.suppress(ProcessLookupError):
        os.killpg(p.pid, signal.SIGKILL)
    return {"rc": p.returncode, "killed": killed,
            "s": time.perf_counter() - t0, "peaks": peaks,
            "out": log.read_text()}


def log_lines(out: str, what: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(what)]


def member_spans(path: Path) -> dict:
    """{member: (offset of its bytes in the file, size, CRC)} of an
    uncompressed zip archive (`np.savez`'s)."""
    import struct
    out = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for info in z.infolist():
            f.seek(info.header_offset)
            head = f.read(30)          # the local header: its name, extra
            n, m = struct.unpack("<HH", head[26:30])
            out[info.filename] = (info.header_offset + 30 + n + m,
                                  info.file_size, info.CRC)
    return out


def archives_equal(a: Path, b: Path, chunk: int = 1 << 26) -> tuple:
    """(every member of the two archives equal, byte for byte and by its
    CRC, members compared), the bytes read a chunk at a time."""
    sa, sb = member_spans(a), member_spans(b)
    if sa.keys() != sb.keys() or any(sa[k][1:] != sb[k][1:] for k in sa):
        return False, len(sa)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        for k, (off, size, _) in sa.items():
            fa.seek(off)
            fb.seek(sb[k][0])
            left = size
            while left:
                n = min(chunk, left)
                if fa.read(n) != fb.read(n):
                    return False, len(sa)
                left -= n
    return True, len(sa)


def host_cli_phase(check: Checks, card: str, n: int,
                   ckpt_root: Path) -> None:
    """55b, the command line on every card: falcon-mamba-7b at full width
    and depth, `--steps 6 --ckpt-every 4`, killed once step 4's checkpoint
    is published (a node lost), the same command again (it resumes from
    step 4 and writes step 6), then `--steps 6 --ckpt-every 6` into a
    second directory, uninterrupted: the two step-6 archives equal member
    for member, bitwise, and so the loss lines the runs print.
    Checkpoints under `ckpt_root`."""
    cfg = get_config(SSM_ARCH)
    whole, largest = state_bytes(cfg)
    HOST_TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    d, d2 = ckpt_root / "ssm", ckpt_root / "ssm_straight"
    free = mem_available()
    room = shutil.disk_usage(ckpt_root).free
    tag = (f"55b {cfg.name} whole ({whole / 1e9:.2f} GB of state, largest "
           f"leaf {largest / 1e9:.2f} GB) on {n} cards, the command line")
    print(f"{tag}: checkpoints under {ckpt_root} (in memory, "
          f"{room / 1e9:.1f} GB free there for two archives of "
          f"{whole / 1e9:.1f}), {free / 1e9:.1f} GB of host memory "
          f"available (two archives and a host copy need "
          f"{HOST_MEM_GB:.1f})", flush=True)
    enough = free >= HOST_MEM_GB * 1e9 and room >= 2 * whole * HOST_ROOM
    check(enough, f"{tag}: host memory and room under {ckpt_root} for two "
          f"archives and a host copy")
    if not enough:
        return
    try:
        cli_runs(check, card, tag, d, d2)
    finally:
        for x in (d, d2):
            shutil.rmtree(x, ignore_errors=True)


def cli_runs(check: Checks, card: str, tag: str, d: Path, d2: Path) -> None:
    """55b's three command line runs into `d` and `d2`, and their checks
    (`host_cli_phase`)."""
    base = ["--arch", SSM_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--steps", str(HOST_SSM_STEPS)]
    drop_state()
    runs = {}
    for name, args, kill, drop in (
            ("killed", ["--ckpt-dir", str(d), "--ckpt-every",
                        str(HOST_SSM_KILL)], (d, HOST_SSM_KILL), None),
            ("resumed", ["--ckpt-dir", str(d), "--ckpt-every",
                         str(HOST_SSM_KILL)], None,
             d / f"step_{HOST_SSM_KILL:09d}"),
            ("straight", ["--ckpt-dir", str(d2), "--ckpt-every",
                          str(HOST_SSM_STEPS)], None, None)):
        r = cli_run(base + args, HOST_TRAIN_DIR / f"{name}.log", kill, drop)
        runs[name] = r
        lines = [ln for what in ("step", "resumed", "checkpoint", "done")
                 for ln in log_lines(r["out"], f"[train] {what}")]
        print(f"{tag}, {name}: exit {r['rc']}"
              f"{' (killed)' if r['killed'] else ''} in {r['s']:.1f} s; "
              f"memory.used peak a card "
              f"{[round(p / 1024, 2) for p in r['peaks']]} GiB; {lines}; "
              f"{card}", flush=True)
        for x in d.glob(".tmp_*"):       # the killed run's partial write
            shutil.rmtree(x, ignore_errors=True)
    k, r, s = runs["killed"], runs["resumed"], runs["straight"]
    ok_runs = (k["killed"] and r["rc"] == 0 and s["rc"] == 0
               and log_lines(r["out"], "[train] resumed from step "
                             f"{HOST_SSM_KILL} ")
               and r["out"].count("[train] done") == 1
               and s["out"].count("[train] done") == 1)
    check(bool(ok_runs), f"{tag}: the run killed after step "
          f"{HOST_SSM_KILL}'s checkpoint, the resume and the straight run "
          f"each one run (exit 0, one log)")
    last = f"[train] step {HOST_SSM_STEPS - 1:5d}"
    first = f"[train] step {0:5d}"
    strip = lambda ls: [ln.split(" (")[0] for ln in ls]   # noqa: E731
    check(ok_runs and strip(log_lines(r["out"], last))
          == strip(log_lines(s["out"], last)) != []
          and strip(log_lines(k["out"], first))
          == strip(log_lines(s["out"], first)) != [],
          f"{tag}: the losses printed equal (step 0: killed vs straight; "
          f"step {HOST_SSM_STEPS - 1}: resumed vs straight)")
    t0 = time.perf_counter()
    name = f"step_{HOST_SSM_STEPS:09d}"
    same_archive, members = (archives_equal(d / name / "arrays.npz",
                                            d2 / name / "arrays.npz")
                             if ok_runs else (False, 0))
    print(f"{tag}: the two step-{HOST_SSM_STEPS} archives compared in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(same_archive and members > 0,
          f"{tag}: the resumed run's step-{HOST_SSM_STEPS} archive == the "
          f"straight run's, member for member, bitwise ({members} leaves)")


def host_cards_rank(out_dir: str, ckpt_root: str) -> None:
    """55b, on each rank (`ranks.launch`): qwen3-32b at 16 of 64 layers
    through `train_loop` on the host mesh (world, 1), 3 steps; then the
    elastic restart in f32 compute: 2 layers, 4 steps straight on (world,
    1), 2 steps with a checkpoint, its resume on (world / 2, 2) at tp = 2
    and on one card (rank 0, no group), its checkpoints under
    `ckpt_root`. Writes its readings to `out_dir/rank<r>.json`."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as TMESH
    from repro_torch.launch import ranks as RK
    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "card": torch.cuda.current_device()}
    try:
        mesh = TMESH.make_host_mesh(device="cuda")
        out["mesh"] = list(mesh.shape)
        cfg = host_cfg(HOST_QWEN_DEPTH)
        torch.cuda.reset_peak_memory_stats()
        state, hist, info = train_loop(
            cfg, steps=HOST_QWEN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            log_every=1, seed=0, device="cuda", mesh=mesh,
            opt=TO.OptConfig(peak_lr=TRAIN_LR, warmup_steps=1,
                             total_steps=HOST_QWEN_STEPS))
        out["qwen"] = {"losses": hist, "norms": info["grad_norm"],
                       "step_s": info["step_s"],
                       "local_gb": sum(t.to_local().numel() * t.element_size()
                                       for t in leaves(state)) / 1e9,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state
        drop_state()
        cfg = host_cfg(HOST_TRAIN_DEPTH, compute_dtype="float32")
        kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=0, seed=0,
                  device="cuda", opt=TO.OptConfig(
                      peak_lr=TRAIN_LR, warmup_steps=1,
                      total_steps=HOST_TRAIN_STEPS))
        e = Path(ckpt_root) / "elastic"

        def losses(steps, m, **ck):
            """The run's losses and gradient norms, its state freed."""
            _, h, i = train_loop(cfg, steps=steps, mesh=m, **ck, **kw)
            drop_state()
            return h, i["grad_norm"]
        runs = {"straight": losses(HOST_TRAIN_STEPS, mesh),
                "written": losses(HOST_TRAIN_AT, mesh, ckpt_dir=e,
                                  ckpt_every=HOST_TRAIN_AT)}
        mesh22 = TMESH.make_host_mesh(model=2, device="cuda")
        out["tp2_mesh"] = list(mesh22.shape)
        runs["tp2"] = losses(HOST_TRAIN_STEPS, mesh22, ckpt_dir=e,
                             ckpt_every=HOST_TRAIN_STEPS)
        if rank == 0:   # back to step 2, then one card with no mesh
            shutil.rmtree(e / f"step_{HOST_TRAIN_STEPS:09d}")
            one = TMESH.HostMesh({"data": 1, "model": 1},
                                 (torch.device("cuda", 0),))
            runs["one card"] = losses(HOST_TRAIN_STEPS, one, ckpt_dir=e,
                                      ckpt_every=HOST_TRAIN_STEPS)
            shutil.rmtree(e, ignore_errors=True)
        RK.barrier()
        out["elastic"] = runs
    finally:
        if rank == 0:
            shutil.rmtree(Path(ckpt_root) / "elastic", ignore_errors=True)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def host_cards_phase(check: Checks, card: str, n: int,
                     ckpt_root: Path) -> None:
    """55b through `train_loop` on one NCCL rank a card
    (`launch.ranks.launch`, `host_cards_rank`): qwen3-32b at 16 layers on
    (n, 1), losses finite and the same on every rank, each card's device
    peak; the elastic restart: each resume's losses and gradient norms
    within `HOST_ELASTIC_TOL` of the straight (n, 1) run's."""
    from repro_torch.launch import ranks as RK
    out_dir = HOST_TRAIN_DIR / "ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    drop_state()
    t0 = time.perf_counter()
    try:
        RK.launch(host_cards_rank, (str(out_dir), str(ckpt_root)),
                  device="cuda")
        failed = ""
    except Exception as e:      # a rank raised: its traceback is in e
        failed = f"{type(e).__name__}: {e}"[-3000:]
    print(f"55b: {n} ranks in {time.perf_counter() - t0:.1f} s", flush=True)
    check(not failed, f"55b: every one of {n} ranks ran to its end"
          f"{' (' + failed + ')' if failed else ''}")
    outs = [json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))]
    shutil.rmtree(out_dir, ignore_errors=True)
    if failed or len(outs) != n:
        return
    qcfg = host_cfg(HOST_QWEN_DEPTH)
    whole, largest = state_bytes(qcfg)
    tag = (f"55b {qcfg.name} ({HOST_QWEN_DEPTH} L, {whole / 1e9:.2f} GB of "
           f"state, largest leaf {largest / 1e9:.2f} GB) through train_loop "
           f"on mesh {outs[0]['mesh']}, {HOST_QWEN_STEPS} steps of "
           f"{TRAIN_BATCH} x {TRAIN_SEQ}")
    for o in outs:
        q = o["qwen"]
        print(f"{tag}, rank {o['rank']} (card {o['card']}): losses "
              f"{q['losses']}; gradient norms {q['norms']}; steps "
              f"{[round(s * 1e3, 2) for s in q['step_s']]} ms; own blocks "
              f"{q['local_gb']:.2f} GB, device peak {q['peak_gb']:.2f} GB; "
              f"{card}", flush=True)
    q0 = outs[0]["qwen"]
    check(len(q0["losses"]) == HOST_QWEN_STEPS
          and all(math.isfinite(x) for x in q0["losses"])
          and all(o["qwen"]["losses"] == q0["losses"] for o in outs)
          and all(o["qwen"]["peak_gb"] < 80 for o in outs),
          f"{tag}: losses finite and the same on every rank, every card's "
          f"peak below 80 GB")
    runs = outs[0]["elastic"]
    straight = runs["straight"]
    etag = (f"55b elastic restart, {TRAIN_ARCH} ({HOST_TRAIN_DEPTH} L) f32, "
            f"written at step {HOST_TRAIN_AT} on {outs[0]['mesh']}")
    worst = 0.0
    for name in ("tp2", "one card"):
        h, g = runs[name]
        want_h = straight[0][HOST_TRAIN_AT:]
        want_g = straight[1][HOST_TRAIN_AT:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(h + g, want_h + want_g))
        worst = max(worst, rel)
        where = (f"mesh {outs[0]['tp2_mesh']} at tp = 2" if name == "tp2"
                 else "one card, no group")
        print(f"{etag}, resumed on {where}: losses {h}, gradient norms {g}; "
              f"straight {want_h}, {want_g}; worst relative {rel:.3e}; "
              f"{card}", flush=True)
        check(len(h) == HOST_TRAIN_STEPS - HOST_TRAIN_AT
              and rel <= HOST_ELASTIC_TOL,
              f"{etag}, resumed on {where} to step {HOST_TRAIN_STEPS}: "
              f"losses and gradient norms within {HOST_ELASTIC_TOL} of the "
              f"straight run's ({rel:.3e})")
    check(runs["written"][0] == straight[0][:HOST_TRAIN_AT]
          and all(o["elastic"]["straight"] == straight for o in outs),
          f"{etag}: the run that wrote it == the straight run's first "
          f"{HOST_TRAIN_AT} steps, bitwise; every rank the same")


def host_train_phases(check: Checks, card: str,
                      one_card: bool = True) -> None:
    """Phase 55: 55a on one card (where `one_card`), then 55b across the
    cards, their checkpoints in a directory of this run's own, removed at
    the end."""
    root = Path(tempfile.mkdtemp(prefix="repro_torch_host_train_",
                                 dir=HOST_CKPT_PARENT))
    try:
        if one_card:
            phase("55a train on one card", host_train_one_phase, check,
                  card, root)
        n = torch.cuda.device_count()
        if n < 2:
            print("host_train across cards: skipped, 1 card visible",
                  flush=True)
            return
        phase("55b the command line on every card", host_cli_phase, check,
              card, n, root)
        phase("55b train_loop on every card", host_cards_phase, check, card,
              n, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase(label: str, fn, *args, **kw):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    only = sys.argv[2:] if sys.argv[1:2] == ["--only"] else None
    if sys.argv[1:] and only not in (["distributed"], ["ladder"], ["k6"],
                                     ["k8"], ["k9"], ["stencil_serving"],
                                     ["distributed_spec"], ["recovery"],
                                     ["families"], ["train"],
                                     ["analysis"], ["bf16"],
                                     ["spec_codegen"], ["bf16_round"],
                                     ["bf16_times"], ["sharding"],
                                     ["chunking"], ["dryrun"],
                                     ["nemotron"], ["spec_math"],
                                     ["host_train"],
                                     ["host_train_cards"]):
        print("usage: chip_smoke.py [--only distributed|ladder|k6|k8|k9|"
              "stencil_serving|distributed_spec|recovery|families|train|"
              "analysis|bf16|spec_codegen|bf16_round|bf16_times|sharding|"
              "chunking|dryrun|nemotron|spec_math|host_train|"
              "host_train_cards]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on "
              "a GPU", file=sys.stderr)
        return 2
    # f32 products in full f32 (PyTorch's defaults, set here so that the
    # f32 prefill gate holds whatever the environment chose)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    check = Checks()
    if only in (["host_train"], ["host_train_cards"]):   # no hand kernel
        host_train_phases(check, card, one_card=only == ["host_train"])
        return finish(check, [], card, t0)
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    print(_build.build_log().strip(), flush=True)
    if only == ["ladder"]:
        return ladder_compare(card)
    if only == ["k6"]:
        return k6_compare(card)
    if only == ["k8"]:
        return k8_compare(card)
    if only == ["k9"]:
        return k9_compare(card)
    if only == ["stencil_serving"]:
        return finish(check, phase("stencil serving", stencil_serving_phases,
                                   check, card), card, t0)
    if only == ["distributed_spec"]:
        X, Y, Z = PAPER_GRIDS[MAIN_GRID]
        dom = AdvectionDomain(X, Y, Z, variant="fused", fuse_T=MAIN_T, dt=DT,
                              device="cuda")
        return finish(check, [phase("21 distributed spec path",
                                    distributed_spec_phase, check,
                                    dom.init(seed=0), dom, card)], card, t0)
    if only == ["recovery"]:
        return finish(check, recovery_only(check, card), card, t0)
    if only == ["families"]:
        return finish(check, families_phases(check, card), card, t0)
    if only == ["train"]:
        training_phases(check, card)
        return finish(check, [], card, t0)
    if only == ["analysis"]:
        return finish(check, analysis_phases(check, card), card, t0)
    if only == ["bf16"]:
        return finish(check, bf16_phases(check, card), card, t0)
    if only == ["spec_codegen"]:
        return finish(check, spec_codegen_only(check, card), card, t0)
    if only == ["spec_math"]:
        return finish(check, spec_shapes_phases(check, card), card, t0)
    if only == ["bf16_round"]:
        rounding_phases(check, card)
        return finish(check, [], card, t0)
    if only == ["bf16_times"]:
        phase("49 bf16 rounding times", round_timing, card)
        return finish(check, [], card, t0)
    if only == ["sharding"]:
        return finish(check, sharding_phases(check, card), card, t0)
    if only == ["chunking"]:
        return finish(check, [phase("51 chunked streaming", chunking_phase,
                                    check, card)], card, t0)
    if only == ["dryrun"]:
        return finish(check, dryrun_only(check, card), card, t0)
    if only == ["nemotron"]:
        return finish(check, phase("53 nemotron", nemotron_phase, check,
                                   card), card, t0)
    if only:
        return finish(check, distributed_only(check, card), card, t0)
    phase("1 small shapes", small_shape_phase, check)
    phase("4 spec small shapes", spec_small_phase, check)
    phase("7 attention small shapes", attention_small_phase, check)
    phase("11 scan small shapes", scan_small_phase, check)
    phase("15 K7 small shapes", band_small_phase, check)
    dom, fields, out, launches, k1_err, k4_err = phase(
        "2 main path", main_path_phase, check)
    ladder = phase("3 ladder path", ladder_path_phase, check, fields)
    spec_runs = phase("5 spec path", spec_path_phase, check, fields)
    records = phase("6 timing", timing_phase, check, dom, fields, out,
                    launches, k1_err, k4_err, ladder)
    records.append(phase("6 spec timing", spec_timing, spec_runs))
    k7_launches, mesh, dist_out, dist_runs = phase(
        "16 distributed path", distributed_path_phase, check, fields, out)
    records.append(phase("17 K7 timing", band_timing, mesh, fields,
                         k7_launches, dist_runs, card))
    phase("18 across cards", cross_card_phase, check, fields, dist_out, card)
    del dist_runs, spec_runs
    torch.cuda.empty_cache()
    phase("21 distributed spec path", distributed_spec_phase, check, fields,
          dom, card)
    phase("22 checkpoint and resume", checkpoint_phase, check, fields,
          dist_out, card)
    phase("23 resilient run", resilient_phase, check, fields, dist_out,
          card)
    del dom, fields, out, dist_out
    torch.cuda.empty_cache()
    records.append(phase("51 chunked streaming", chunking_phase, check,
                         card))
    records += phase("19-20 stencil serving", stencil_serving_phases, check,
                     card)
    torch.cuda.empty_cache()
    records += bf16_phases(check, card)
    records += spec_shapes_phases(check, card)
    rounding_phases(check, card)
    analysis_phases(check, card)
    torch.cuda.empty_cache()
    cfg, params, k8_launches = phase(
        "8 qwen serving", serving_phase, check, SERVE_ARCH,
        ("flash_attention", "flash_attention_tc"))
    phase("9 qwen prefill gate", prefill_gate_phase, check, cfg, params,
          "flash_attention", fixed_f32_limit(PREFILL_F32_TOL),
          PREFILL_BF16_REL_TOL, bf16_kernel="flash_attention_tc")
    phase("52 profiler and dry run", profiler_phase, check, card, cfg,
          params)
    del params
    torch.cuda.empty_cache()
    k8 = phase("10 K8 timing", attention_timing, k8_launches, card)
    check(k8["within_bf16_bound"], "K8 at the timed shape == plain within "
          "bf16_bound")
    records.append(k8)
    records += phase("53 nemotron", nemotron_phase, check, card)
    cfg, params, k9_serve = phase("12 ssm serving", serving_phase, check,
                                  SSM_ARCH, ("selective_scan",))
    phase("13 ssm layer gate", ssm_layer_gate_phase, check, cfg, params)
    k9_prefill = phase("13 ssm prefill gate", prefill_gate_phase, check, cfg,
                       params, "selective_scan", witness_f32_limit,
                       SSM_PREFILL_BF16_REL_TOL)
    del params
    torch.cuda.empty_cache()
    t_k9 = time.perf_counter()
    scan_attrs_lines(card)
    for shape, launches, path in (
            (SCAN_TIMED, k9_prefill, f"one {PREFILL_TOKENS}-token prefill"),
            (SCAN_SERVE_TIMED, k9_serve, "the serving path's prompts of "
             "4-23 tokens")):
        k9 = scan_timing(shape, launches, path, card)
        check(k9["within_tolerance"], f"K9 at {k9['shape']} == plain within "
              f"{SCAN_TOL} x max(1, max |plain|)")
        records.append(k9)
    k9_sweep(check, card)
    print(f"phase 14 K9 timing: {time.perf_counter() - t_k9:.1f} s",
          flush=True)
    records += families_phases(check, card)
    training_phases(check, card)
    records += sharding_phases(check, card)
    host_train_phases(check, card)
    return finish(check, records, card, t0)


def finish(check: Checks, records: list, card: str, t0: float) -> int:
    print(f"chip_smoke: {len(check.failed)} of {check.count} checks failed; "
          f"{time.perf_counter() - t0:.1f} s since the build began",
          flush=True)
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed: "
              f"{check.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
