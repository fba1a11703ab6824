#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --only distributed   # phases 15-18 alone
    python3 chip_smoke.py --only ladder        # K3's and K2's times
    python3 chip_smoke.py --only k6            # K6's six passes' times
    python3 chip_smoke.py --only k8            # K8's time and a prefill's
    python3 chip_smoke.py --only k9            # K9's times and a prefill's

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

`--only distributed` runs phases 15-18 alone. A copy of the script in a
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

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import _build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import roofline as R  # noqa: E402
from repro_torch.kernels.advection import advection as K  # noqa: E402
from repro_torch.kernels.advection import ref as REF  # noqa: E402
from repro_torch.kernels.attention import attention as A  # noqa: E402
from repro_torch.kernels.attention.ref import mha_ref  # noqa: E402
from repro_torch.kernels.ssm import ssm as SS  # noqa: E402
from repro_torch.launch.serve import (random_params,  # noqa: E402
                                      random_requests)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import blocks as BL  # noqa: E402
from repro_torch.models.blocks import Ctx  # noqa: E402
from repro_torch.pspec import tree_map  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.launch.mesh import make_stencil_mesh  # noqa: E402
from repro_torch.stencil import distributed as D  # noqa: E402
from repro_torch.stencil import spec as SP  # noqa: E402
from repro_torch.stencil.advection import (PAPER_GRIDS,  # noqa: E402
                                           AdvectionDomain)

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
SOURCE = {"advect_fused": "src/repro_torch/csrc/advect_fused.cu",
          "finite_guard": "src/repro_torch/csrc/finite_guard.cu",
          "advect_blocked": "src/repro_torch/csrc/advect_blocked.cu",
          "advect_dataflow": "src/repro_torch/csrc/advect_dataflow.cu",
          "advect_wide": "src/repro_torch/csrc/advect_dataflow.cu",
          "stencil_fused": "src/repro_torch/csrc/stencil_fused.cu",
          "flash_attention": "src/repro_torch/csrc/flash_attention_tc.cu",
          "selective_scan": "src/repro_torch/csrc/selective_scan.cu",
          "band_exchange": "src/repro_torch/csrc/band_exchange.cu"}
REPLACES = {"advect_fused": "src/repro/kernels/advection/advection.py:404",
            "finite_guard": "src/repro/kernels/advection/advection.py:469",
            "advect_blocked": "src/repro/kernels/advection/advection.py:214",
            "advect_dataflow": "src/repro/kernels/advection/advection.py:272",
            "advect_wide": "src/repro/kernels/advection/advection.py:367",
            "stencil_fused": "src/repro/kernels/advection/advection.py:677",
            "flash_attention": "src/repro/kernels/attention/attention.py:31",
            "selective_scan": "src/repro/kernels/ssm/ssm.py:39",
            "band_exchange": "src/repro/kernels/advection/advection.py:939"}
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


def rand_fields(shape, seed):
    rng = np.random.default_rng(seed)
    return REF.fields_from_numpy(*(rng.normal(size=shape) for _ in range(3)),
                                 device="cuda")


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def plain_fused(u, v, w, p, T, xm=None, ym=None):
    """The plain version on one (X, Y, Z) domain."""
    X, Y = u.shape[0], u.shape[1]
    ones = lambda n: torch.ones(n, device=u.device)  # noqa: E731
    out = K._advect_fused_plain(u[None], v[None], w[None], p, T, DT,
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


def bound_of(nbytes: int, ops: int):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the f32 operations over its peak rate."""
    t_bytes = nbytes / R.HBM_BW * 1e3
    t_ops = ops / R.PEAK_FLOPS_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_record(name, ms, plain_ms, nbytes, ops, launches, err) -> dict:
    bound, bound_by = bound_of(nbytes, ops)
    print(f"{name}: {ms:.4f} ms per launch (median of {TIMED_RUNS}), "
          f"bound {bound:.4f} ms by {bound_by} ({nbytes} B at "
          f"{R.HBM_BW:.3g} B/s: {nbytes / R.HBM_BW * 1e3:.4f} ms; {ops} f32 "
          f"ops at {R.PEAK_FLOPS_F32:.3g}/s: "
          f"{ops / R.PEAK_FLOPS_F32 * 1e3:.4f} ms), "
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
    pv = K._spec_param_vectors(spec, params, "cuda")
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
    """A spec outside the CUDA table is refused on the card with no launch;
    PW and tracer rk2 at T = 4, refused before K6 kept its ring in
    registers, run as passes == plain and within `ORACLE_TOL` of f64."""
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
    for spec, params in ((custom, None), (radius2, dp)):
        before = dict(K.LAUNCHES)
        try:
            K.stencil_fused([torch.zeros((6, 8, 8), device="cuda")], params,
                            spec, T=1)
            refused = False
        except NotImplementedError as err:
            refused = "ROADMAP Queue 2" in str(err)
        check(refused and K.LAUNCHES == before,
              f"a spec outside the CUDA table ({spec.name}) is refused on "
              f"the card, naming the queue, with no launch")
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


def spec_bound(op, spec, params, T, shape):
    """(bytes, operations) of T steps of `spec` over one (X, Y, Z) domain:
    the fields read and written once, the parameter vectors and masks read
    once; the spec's operations per interior cell at each of its stages * T
    levels, plus the 2-op update of each field and cell."""
    X, Y, Z = shape
    cells, nf, rad = X * Y * Z, spec.n_fields, spec.radius
    pv_bytes = sum(v.numel() for v in
                   K._spec_param_vectors(spec, params, "cuda")) * 4
    nbytes = (K.hbm_bytes_model(X, Y, Z, 4, "fused", T=T, n_fields=nf,
                                halo_depth=spec.halo(T))
              + pv_bytes + (X + Y) * 4)
    interior = (X - 2 * rad) * (Y - 2 * rad) * (Z - 2 * rad)
    ops = spec.stages * T * (interior * SP.spec_flops_per_cell(
        spec, SPEC_PROBE[op]()) + 2 * nf * cells)
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


def band_small_phase(check: Checks, devices=None, tag="loopback") -> None:
    """K7 against its plain version at small shapes: `BAND_BLOCKS` blocks
    in a row on the same buffers, tables and counters (both slots, blocks
    2 on passing the slot's interior views, so only the bands move); every
    extended buffer, interior included, == plain bitwise, the slot block 0
    did not write keeps `BAND_FILL`, one put per card and exchange, the
    error words stay 0. `devices(n)` lays out the shards (default: n
    shards on cuda:0)."""
    for nx, ny, axis, dim, shape, depth in BAND_CASES:
        n = nx * ny
        if devices is not None and n > torch.cuda.device_count():
            continue
        devs = ["cuda:0"] * n if devices is None else devices(n)
        mesh = make_stencil_mesh(nx, ny, devices=devs)
        got = K.BandSlabs(mesh, shape, depth, dim, fill=BAND_FILL)
        want = K.BandSlabs(mesh, shape, depth, dim, fill=BAND_FILL)
        equal = untouched = True
        puts = []
        for block in range(BAND_BLOCKS):
            slot = block % 2
            shards = [tuple(f.to(dev) for f in
                            rand_fields(shape, 900 + 10 * block + s))
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


def distributed_run(mesh, fields, exchange: str):
    """`make_distributed_run` on the 67M grid over `mesh`, the counts set
    to 0 just before and read just after; returns (global out, launches,
    wall s, run, shards)."""
    Z = fields[0].shape[2]
    p = REF.default_params(Z, device="cuda")
    run = D.make_distributed_run(mesh, p, n_blocks=DIST_BLOCKS, T=MAIN_T,
                                 dt=DT, local_kernel="fused", overlap=True,
                                 exchange=exchange)
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
                         tag="across cards")
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
        print(f"across cards: ran, exchange={ex}, a {(nx, ny)} mesh over "
              f"{[str(d) for d in mesh.devices]}; wall {wall:.3f} s; "
              f"launches {launches}", flush=True)
        err = max(float((a - b).abs().max()) for a, b in zip(out, want))
        check(err == 0.0, f"across cards {(nx, ny)} {ex} == loopback "
              f"remote_dma, bitwise ({err})")
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
    dev_ms = profiled_kernels(call, "band_", set(mesh.devices), runs)[0]
    device = f"{dev_ms:.4f} ms" if dev_ms > 0 else "not measured"
    return statistics.median(host), device


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
    p = REF.default_params(Z, device="cuda")
    blocks = {ex: D._LocalBlock(mesh, p, T=T, dt=DT, local_kernel="fused",
                                y_tile=None, overlap=True, exchange=ex)
              for ex in ("remote_dma", "collective")}
    if EXTENDED:
        blocks["remote_dma"]._band_slabs((Xl, Yl, Z), T, T)
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
        fresh = [tuple(f.to(dev) for f in rand_fields(shape, 1000 + s))
                 for s, dev in enumerate(mesh.devices)]
        slabs = K.BandSlabs(mesh, shape, T, dim)
        plain = K.BandSlabs(mesh, shape, T, dim)
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
        tot["err"] = max([tot["err"]] + [float((x - y).abs().max())
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
        ext_dev = profiled_kernels(phase["remote_dma"], "", cards, 10)[0]
        coll_ext = time_ms(phase["collective"])
        coll_ext_dev = profiled_kernels(phase["collective"], "", cards,
                                        10)[0]
        blocks["remote_dma"].check()
        # bounds: each byte read once and written once in the one card's
        # memory (loopback): the bands alone, and the extend pass (the x
        # phase also moves every shard into its slab)
        other = math.prod(shape) // shape[dim]
        sent = sum(m.cnt * other * 4
                   for m in K.band_messages(mesh, axis, shape[dim], T))
        owned = 3 * len(sh) * Xl * Yl * Z * 4 if dim == 0 else 0
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
    return {"name": "band_exchange", "route": "cuda",
            "source": SOURCE["band_exchange"],
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


def serving_phase(check: Checks, arch: str, kernels: tuple):
    """The token-serving path at full width under `attention_impl="pallas"`,
    where each of `kernels` (K8 and its tensor-core count, or K9) runs once
    per layer of every prefill; returns (cfg, params, the first kernel's
    launches)."""
    cfg = get_config(arch).replace(attention_impl="pallas")
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
    kernel, launched = kernels[0], counts[kernels[0]]
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
          f"times each = {cfg.n_layers} layers x {st['prefills']} prefills")
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
                       bf16_kernel: str = "") -> int:
    """`pallas` (where `kernel` runs once per layer, and `bf16_kernel`, its
    bf16 build's own count, where named, once per layer in bf16 only)
    against `chunked` prefill logits on one 2048-token prompt: f32 at all
    layers within `f32_limit(cfg, params, tokens, layout, chunked
    logits)`, bf16 at the first 2 layers within `bf16_rel_tol` x max
    |chunked logit|, bf16 at all layers printed. Prints each pallas
    forward's wall time. Returns `kernel`'s launches in the last pallas
    forward (bf16, all layers)."""
    layout = M.make_layout(cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_TOKENS)), device="cuda")

    def logits(c, p):
        out = {}
        for impl in ("pallas", "chunked"):
            reset_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[impl] = M.forward(p, {"inputs": toks},
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


def attention_timing(launches: int, card: str) -> dict:
    """K8 (the tensor-core kernel, bf16) at the timed shape beside its
    plain version, SDPA and its bound; the card's view of each build."""
    B, H, Hkv, S, D = ATTN_TIMED
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
    for d in A.TC_HEAD_DIMS:
        at = A.tc_kernel_attrs(q.device, d)
        print(f"flash_attention tensor-core build, head dim {d} (tiles "
              f"{A.tc_tiles(d)}): {at['registers']} registers, "
              f"{at['local_bytes']} B spilled per thread, "
              f"{at['shared_bytes']} B shared, {at['blocks_per_sm']} "
              f"resident blocks per SM", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": SOURCE["flash_attention"],
            "replaces": REPLACES["flash_attention"], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "within_bf16_bound": ok}


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
    return records


def main() -> int:
    only = sys.argv[2:] if sys.argv[1:2] == ["--only"] else None
    if sys.argv[1:] and only not in (["distributed"], ["ladder"], ["k6"],
                                     ["k8"], ["k9"]):
        print("usage: chip_smoke.py [--only distributed|ladder|k6|k8|k9]",
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
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    print(_build.build_log().strip(), flush=True)
    check = Checks()
    if only == ["ladder"]:
        return ladder_compare(card)
    if only == ["k6"]:
        return k6_compare(card)
    if only == ["k8"]:
        return k8_compare(card)
    if only == ["k9"]:
        return k9_compare(card)
    if only:
        return finish(check, distributed_only(check, card), card, t0)
    small_shape_phase(check)
    spec_small_phase(check)
    attention_small_phase(check)
    scan_small_phase(check)
    band_small_phase(check)
    dom, fields, out, launches, k1_err, k4_err = main_path_phase(check)
    ladder = ladder_path_phase(check, fields)
    spec_runs = spec_path_phase(check, fields)
    records = timing_phase(check, dom, fields, out, launches, k1_err, k4_err,
                           ladder)
    records.append(spec_timing(spec_runs))
    k7_launches, mesh, dist_out, dist_runs = distributed_path_phase(
        check, fields, out)
    records.append(band_timing(mesh, fields, k7_launches, dist_runs, card))
    cross_card_phase(check, fields, dist_out, card)
    del dom, fields, out, spec_runs, dist_out, dist_runs
    torch.cuda.empty_cache()
    cfg, params, k8_launches = serving_phase(
        check, SERVE_ARCH, ("flash_attention", "flash_attention_tc"))
    prefill_gate_phase(check, cfg, params, "flash_attention",
                       fixed_f32_limit(PREFILL_F32_TOL), PREFILL_BF16_REL_TOL,
                       bf16_kernel="flash_attention_tc")
    del params
    torch.cuda.empty_cache()
    k8 = attention_timing(k8_launches, card)
    check(k8["within_bf16_bound"], "K8 at the timed shape == plain within "
          "bf16_bound")
    records.append(k8)
    cfg, params, k9_serve = serving_phase(check, SSM_ARCH,
                                          ("selective_scan",))
    ssm_layer_gate_phase(check, cfg, params)
    k9_prefill = prefill_gate_phase(check, cfg, params, "selective_scan",
                                    witness_f32_limit,
                                    SSM_PREFILL_BF16_REL_TOL)
    del params
    torch.cuda.empty_cache()
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
