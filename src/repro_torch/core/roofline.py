"""Roofline terms and the stencil byte/FLOP models, for NVIDIA H100 SXM
cards.

    compute term    = FLOPs / peak FLOP/s
    memory term     = device-memory bytes / memory bandwidth
    collective term = halo wire bytes / wire bandwidth

The hardware constants below come from NVIDIA's H100 SXM data sheet and the
Hopper architecture white paper: data sheet, not measured. Measured times
live in PERF.md beside the card's name and power limit. The wire is NVLink
between distinct cards (`NVLINK_BW`, each way) and device memory on a
loopback mesh, whose shards share one card (`LOOPBACK_BW`: each byte is
read and written once). Across pods the wire is the cluster's network
(`CROSS_POD_BW`, an assumption); to the host it is PCIe (`PCIE_BW`), whose
measured rate PERF.md keeps. The serving models (`serving_max_batch`,
`serving_throughput_model`) price the stencil serving engine's mega-step on
the card; `model_flops` counts a model step's FLOPs (6 N D to train).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

# NVIDIA H100 SXM, data sheet, not measured (dense rates, 700 W part)
PEAK_FLOPS_BF16 = 989e12     # bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12       # f32 FLOP/s outside the tensor cores
# bf16 FLOP/s outside the tensor cores (two packed to an instruction; the
# H100 architecture whitepaper's SXM5 figure): the rate of an op that
# rounds to bf16, which gives the bits of the f32 op rounded to bf16
PEAK_FLOPS_BF16_SIMT = 133.8e12
HBM_BW = 3.35e12             # bytes/s
HBM_PER_CHIP = 80 * 10**9    # 80 GB
SMEM_PER_BLOCK = 232_448     # dynamic shared memory one block may use
SMEM_PER_SM = 233_472        # shared memory the resident blocks of one SM
                             # share (228 KB) ...
SMEM_RESERVED_PER_BLOCK = 1_024   # ... less 1 KB the system keeps per block
NVLINK_BW = 450e9            # bytes/s each way to the other cards (NVLink 4)
PCIE_BW = 64e9               # bytes/s each way to the host: PCIe Gen5 x16
# across pods (the production mesh's "pod" axis), an assumption: one
# 400 Gb/s NDR InfiniBand port a card, as the DGX H100 data sheet lists
# (eight ConnectX-7 ports for eight cards); bytes/s each way
CROSS_POD_BW = 50e9
LOOPBACK_BW = HBM_BW / 2     # a band moved within one card: read + write
MAX_GRID_Y = 65535           # CUDA's limit on a launch grid's y dimension,
                             # the slot axis of K5 and K4

# the host's time to enqueue one serving mega-step's launches (K5, then K4,
# with the engine's launch plan held), which the serving model charges once
# per mega-step whatever the batch: 0.2151 ms, the median of 20 enqueues at
# 4 x (512, 512, 64), T = 4, printed by chip_smoke.py's stencil serving
# phase on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md)
SERVING_LAUNCH_OVERHEAD_S = 215.1e-6


@dataclass
class RooflineTerms:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    model_flops_global: float = 0.0
    peak_flops: float = PEAK_FLOPS_F32   # the stencil's f32 arithmetic
    hbm_bw: float = HBM_BW
    wire_bytes: float = 0.0           # halo bytes a shard sends per step
    wire_bw: float = NVLINK_BW        # LOOPBACK_BW on a loopback mesh
    n_chips: int = 1
    cross_wire_bytes: float = 0.0     # bytes a device sends across pods
    cross_wire_bw: float = CROSS_POD_BW
    overlap_efficiency: float = 0.0   # fraction of collective_s the exchange
                                      # engine hides (overlap_efficiency_model)

    def __post_init__(self):
        if not 0.0 <= self.overlap_efficiency <= 1.0:
            raise ValueError(f"overlap_efficiency must be in [0, 1], got "
                             f"{self.overlap_efficiency}")

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_dev / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return (self.wire_bytes / self.wire_bw
                + self.cross_wire_bytes / self.cross_wire_bw)

    @property
    def collective_hidden_s(self) -> float:
        """Wire seconds the exchange engine hides behind the compute or
        memory term: at most the whole exchange, and never more than the
        on-chip work there is to hide behind."""
        hideable = min(self.collective_s, max(self.compute_s, self.memory_s))
        return self.overlap_efficiency * hideable

    @property
    def collective_exposed_s(self) -> float:
        """Wire seconds left on the critical path after overlap."""
        return self.collective_s - self.collective_hidden_s

    @property
    def bound(self) -> str:
        """The largest raw term."""
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap model: the bottleneck term defines the step."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def no_overlap_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def useful_flops_ratio(self) -> float:
        if not self.model_flops_global:
            return float("nan")
        return self.model_flops_global / (self.flops_per_dev * self.n_chips)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline step time."""
        if not self.model_flops_global:
            return float("nan")
        return (self.model_flops_global
                / (self.n_chips * self.peak_flops * self.step_time_s))

    @property
    def hw_flops_fraction(self) -> float:
        return self.compute_s / self.step_time_s

    def as_dict(self) -> Dict:
        """The fields and the derived terms."""
        d = dataclasses.asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 bound=self.bound, step_time_s=self.step_time_s,
                 mfu=self.mfu, useful_flops_ratio=self.useful_flops_ratio,
                 hw_flops_fraction=self.hw_flops_fraction,
                 collective_s=self.collective_s,
                 collective_hidden_s=self.collective_hidden_s,
                 collective_exposed_s=self.collective_exposed_s)
        return d


# fraction of a collective a library-scheduled overlap is trusted to hide:
# the `overlap=True` collective engine only removes the data dependence
# between the interior pass and the exchange. The in-kernel engine issues
# and waits its own transfers, so it gets no discount. A modelling
# assumption (the reference's), not a measurement.
XLA_OVERLAP_DISCOUNT = 0.5


def interior_compute_fraction(Xl: int, Yl: int, T: int, *,
                              nx: int = 1, ny: int = 1) -> float:
    """Fraction of a shard's cells whose depth-T dependence cone stays
    inside the owned (Xl, Yl) slab: the halo-independent work an exchange
    can hide behind (the interior pass of `make_distributed_step(
    overlap=True)`). An undecomposed axis contributes no boundary band; a
    shard of extent <= 2T leaves nothing to overlap with."""
    if Xl < 1 or Yl < 1:
        raise ValueError(f"shard extents must be >= 1, got ({Xl}, {Yl})")
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    fx = max(Xl - 2 * T, 0) / Xl if nx > 1 else 1.0
    fy = max(Yl - 2 * T, 0) / Yl if ny > 1 else 1.0
    return fx * fy


def overlap_efficiency_model(*, overlap: bool, exchange: str = "collective",
                             interior_fraction: float = 1.0) -> float:
    """Modelled fraction of the halo exchange hidden behind compute: 0.0
    without overlap; else the interior fraction, discounted by
    `XLA_OVERLAP_DISCOUNT` for the `collective` engine, whose overlap is a
    scheduling opportunity, while `remote_dma` owns its issue and wait
    schedule. A model of each engine's intended schedule per block, not a
    measurement. Feeds `RooflineTerms.overlap_efficiency`."""
    if exchange not in ("collective", "remote_dma"):
        raise ValueError(f"unknown exchange engine {exchange!r}")
    if not 0.0 <= interior_fraction <= 1.0:
        raise ValueError(f"interior_fraction must be in [0, 1], got "
                         f"{interior_fraction}")
    if not overlap:
        return 0.0
    eff = interior_fraction
    if exchange == "collective":
        eff *= XLA_OVERLAP_DISCOUNT
    return eff


def pipeline_efficiency_model(*, n_blocks: int, overlap: bool,
                              exchange: str = "collective",
                              interior_fraction: float = 1.0) -> float:
    """Hidden fraction of the per-block exchange over a K-block pipelined
    run, averaged over the blocks: the `collective` engine's is
    K-independent (`overlap_efficiency_model`); `remote_dma` hides across
    blocks (block k+1's bands land in the spare recv slot during block k's
    interior pass), which every block but the first can, hence the
    steady-state figure scaled by (K-1)/K."""
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
    eff = overlap_efficiency_model(overlap=overlap, exchange=exchange,
                                   interior_fraction=interior_fraction)
    if exchange == "remote_dma":
        eff *= (n_blocks - 1) / n_blocks
    return eff


def _check_mesh_grid(X: int, Y: int, nx: int, ny: int, T: int) -> None:
    if nx < 1 or ny < 1:
        raise ValueError(f"mesh shape must be >= 1, got ({nx}, {ny})")
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if X % nx or Y % ny:
        raise ValueError(f"grid ({X}, {Y}) not divisible by mesh "
                         f"({nx}, {ny}); the mesh requires even shards")


def halo_wire_bytes_model(X: int, Y: int, Z: int, itemsize: int, *,
                          nx: int = 1, ny: int = 1, T: int = 1,
                          n_fields: int = 3,
                          depth: int | None = None) -> int:
    """Per-shard bytes sent for ONE depth-`depth` (default T) exchange of
    the 2D (nx, ny)-decomposed step: phase 1 trades ``2 * depth * (Y/ny) *
    Z`` x-planes along the x ring, phase 2 ``2 * depth * (X/nx + 2*depth)
    * Z`` y-rows of the x-extended slab (the corner blocks ride phase 2).
    An undecomposed axis moves nothing; multi-hop moves the same total.
    `stencil.distributed.count_exchange_wire_bytes` counts the engines'
    messages against it."""
    _check_mesh_grid(X, Y, nx, ny, T)
    D = T if depth is None else depth
    if D < 1:
        raise ValueError(f"depth must be >= 1, got {D}")
    Xl, Yl = X // nx, Y // ny
    phase_x = 2 * D * Yl * Z if nx > 1 else 0
    x_ext = Xl + (2 * D if nx > 1 else 0)
    phase_y = 2 * D * x_ext * Z if ny > 1 else 0
    return (phase_x + phase_y) * n_fields * itemsize


def band_slab_bytes_model(X: int, Y: int, Z: int, itemsize: int, *,
                          nx: int = 1, ny: int = 1, T: int = 1,
                          n_fields: int = 3,
                          depth: int | None = None) -> int:
    """Per-shard device-memory bytes K7 (`halo_band_exchange_dma`) moves
    for ONE two-phase exchange of the remote_dma engine: every band read
    from its sender's field and landed in its receiver's slab (twice
    `halo_wire_bytes_model`), and the shard's own planes landed in the
    middle of its slab by the first phase (read and written once; the
    second phase sends from that slab in place). Zero where no axis is
    decomposed. The movement ledger counts K7's calls against it."""
    wire = halo_wire_bytes_model(X, Y, Z, itemsize, nx=nx, ny=ny, T=T,
                                 n_fields=n_fields, depth=depth)
    if not wire:
        return 0
    own = n_fields * (X // nx) * (Y // ny) * Z * itemsize
    return 2 * (wire + own)


INTEGRITY_WORD_ITEMSIZE = 4   # band checksums are one uint32 word each


def integrity_bytes_model(X: int, Y: int, Z: int, *, nx: int = 1,
                          ny: int = 1, T: int = 1, n_fields: int = 3,
                          depth: int | None = None) -> int:
    """Per-shard extra bytes of the checksummed exchange: one word per
    band message, ``2 * n_fields * (hops_x + hops_y)`` words, hops_a =
    ceil(depth / local extent) on a decomposed axis and 0 otherwise.
    `stencil.distributed.count_integrity_bytes` counts against it."""
    _check_mesh_grid(X, Y, nx, ny, T)
    D = T if depth is None else depth
    if D < 1:
        raise ValueError(f"depth must be >= 1, got {D}")
    Xl, Yl = X // nx, Y // ny
    hops_x = -(-D // Xl) if nx > 1 else 0
    hops_y = -(-D // Yl) if ny > 1 else 0
    return 2 * n_fields * (hops_x + hops_y) * INTEGRITY_WORD_ITEMSIZE


GUARD_FLAG_ITEMSIZE = 4   # the finite-guard flag output is f32


def serving_slot_bytes_model(X: int, Y: int, Z: int,
                             itemsize: int = 4) -> int:
    """Device bytes one slot of the stencil serving engine holds during a
    mega-step: three copies of its three (X, Y, Z) fields (the batch, the
    launch's outputs and the rollback snapshot), its x and y interior masks
    (f32), its parameter row (2 + 2Z words) and its X guard flags (f32)."""
    if min(X, Y, Z) < 1:
        raise ValueError(f"extents must be >= 1, got {(X, Y, Z)}")
    return (9 * X * Y * Z * itemsize + (X + Y) * 4 + (2 + 2 * Z) * itemsize
            + X * GUARD_FLAG_ITEMSIZE)


def serving_max_batch(slot_bytes: int, *,
                      device_budget: int = HBM_PER_CHIP) -> int:
    """Largest batch one mega-launch of the serving engine can carry on the
    card. The TPU's bound was the VMEM ring of every resident slot; K5 keeps
    no ring per slot on chip (the slot is a dimension of the launch grid, its
    blocks run one after another through the SMs), so on Hopper two things
    bind: the batch's buffers in device memory (`slot_bytes` a slot,
    `serving_slot_bytes_model`, against `device_budget`) and the launch
    grid's slot axis (`MAX_GRID_Y`, `kernels.advection.check_launch_grid`).
    Past this `serving_throughput_model` refuses rather than extrapolating."""
    if slot_bytes < 1:
        raise ValueError(f"slot_bytes must be >= 1, got {slot_bytes}")
    if slot_bytes > device_budget:
        raise ValueError(
            f"one slot's device buffers ({slot_bytes} B) already exceed the "
            f"device-memory budget ({device_budget} B); shrink the slot "
            "shape")
    return min(device_budget // slot_bytes, MAX_GRID_Y)


def serving_throughput_model(batch: int, *, hbm_bytes_per_domain: float,
                             slot_bytes: int,
                             exposed_wire_s_per_domain: float = 0.0,
                             launch_overhead_s: float =
                             SERVING_LAUNCH_OVERHEAD_S,
                             device_budget: int = HBM_PER_CHIP,
                             hbm_bw: float = HBM_BW) -> float:
    """Domains/s of a `batch`-slot mega-launch serving step, the reference's
    formula:

        step_s    = launch_overhead_s
                    + batch * (hbm_bytes / hbm_bw + exposed_wire_s)
        domains/s = batch / step_s

    One mega-step pays the fixed host cost of its launches once, then
    streams every slot's pass (slots share nothing) plus each slot's
    exposed wire seconds (0 on one card). Amortising the fixed cost makes
    this strictly increasing in `batch` until `serving_max_batch` binds,
    where it refuses (ValueError)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if hbm_bytes_per_domain <= 0:
        raise ValueError(f"hbm_bytes_per_domain must be > 0, got "
                         f"{hbm_bytes_per_domain}")
    if exposed_wire_s_per_domain < 0:
        raise ValueError(f"exposed_wire_s_per_domain must be >= 0, got "
                         f"{exposed_wire_s_per_domain}")
    if launch_overhead_s <= 0:
        raise ValueError(f"launch_overhead_s must be > 0, got "
                         f"{launch_overhead_s}")
    max_b = serving_max_batch(slot_bytes, device_budget=device_budget)
    if batch > max_b:
        raise ValueError(
            f"batch {batch} exceeds the serving bound {max_b}: "
            f"{slot_bytes} B of device buffers a slot against a "
            f"{device_budget} B budget, and at most {MAX_GRID_Y} slots in "
            "the launch grid")
    step_s = launch_overhead_s + batch * (
        hbm_bytes_per_domain / hbm_bw + exposed_wire_s_per_domain)
    return batch / step_s


def guard_bytes_model(X: int, Y: int, Z: int, *, batch: int = 1,
                      itemsize: int = 4, n_fields: int = 3) -> int:
    """Extra device-memory bytes of the finite-guard pass
    (`kernels.advection.finite_guard`): it re-reads ``n_fields * X * Y *
    Z`` field words (3 for the advection ladder, `spec.n_fields` for a
    stencil-spec operator) and writes ``X`` f32 flag words per slot. The
    guard stays a separate launch after the fused kernel, so its price is
    this read pass.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if min(X, Y, Z) < 1:
        raise ValueError(f"extents must be >= 1, got {(X, Y, Z)}")
    if n_fields < 1:
        raise ValueError(f"n_fields must be >= 1, got {n_fields}")
    parts = guard_bytes_model_parts(X, Y, Z, batch=batch,
                                    itemsize=itemsize, n_fields=n_fields)
    return parts["field_reads"] + parts["flag_words"]


def guard_bytes_model_parts(X: int, Y: int, Z: int, *, batch: int = 1,
                            itemsize: int = 4, n_fields: int = 3) -> dict:
    """`guard_bytes_model` split into ``{"field_reads", "flag_words"}``;
    their sum is `guard_bytes_model`."""
    return {"field_reads": batch * n_fields * X * Y * Z * itemsize,
            "flag_words": batch * X * GUARD_FLAG_ITEMSIZE}


def stencil_arithmetic_intensity(flops_per_cell: float,
                                 bytes_per_cell_pass: float,
                                 fusion_T: int = 1,
                                 tiling_bytes_factor: float = 1.0) -> float:
    """FLOP/byte of a temporally fused streaming stencil: one pass moves
    `bytes_per_cell_pass` per cell and does `fusion_T` steps of
    `flops_per_cell` work, so the intensity grows linearly in T."""
    if fusion_T < 1:
        raise ValueError(f"fusion_T must be >= 1, got {fusion_T}")
    if tiling_bytes_factor < 1.0:
        raise ValueError("tiling_bytes_factor must be >= 1.0, got "
                         f"{tiling_bytes_factor}")
    return fusion_T * flops_per_cell / (bytes_per_cell_pass
                                        * tiling_bytes_factor)


def stencil_ridge_T(flops_per_cell: float, bytes_per_cell_pass: float,
                    peak_flops: float = PEAK_FLOPS_F32,
                    hbm_bw: float = HBM_BW,
                    tiling_bytes_factor: float = 1.0) -> int:
    """Smallest fusion depth T at which the fused stencil's intensity
    reaches the card's ridge point (peak FLOP/s over memory bandwidth)."""
    ridge = peak_flops / hbm_bw
    ai1 = stencil_arithmetic_intensity(
        flops_per_cell, bytes_per_cell_pass,
        tiling_bytes_factor=tiling_bytes_factor)
    return max(1, math.ceil(ridge / ai1))


def stencil_tiling_bytes_factor(Y: int, y_tile: Optional[int], halo: int,
                                *, grid_tiled: bool = True) -> float:
    """Multiplier on the compulsory per-pass device-memory bytes from
    y-tiling. The in-grid `(y_tile, x)` path (`grid_tiled=True`, the
    kernels' default) serves halo re-reads from the block's shared-memory
    slab and writes each output row once: 1.0, whatever `y_tile`. The
    host-side loop restages `2*halo` rows per interior tile boundary on
    both the read and write side, inflating every pass by
    `(Y + 2*halo*(n_tiles-1)) / Y`."""
    if halo < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    if y_tile is None or y_tile >= Y or grid_tiled:
        return 1.0
    n_tiles = -(-Y // y_tile)
    return (Y + 2 * halo * (n_tiles - 1)) / Y


def differential(cost1: Dict[str, float], cost2: Dict[str, float],
                 n_layers: int, key: str) -> float:
    """total(key) = const + n_layers * (cost2-cost1) with const from cost1."""
    c1, c2 = cost1.get(key, 0.0) or 0.0, cost2.get(key, 0.0) or 0.0
    per_layer = max(c2 - c1, 0.0)
    const = max(c1 - per_layer, 0.0)
    return const + n_layers * per_layer


def kernel_core_io_bytes(cfg, shape, layout,
                         mesh_shape: Dict[str, int]) -> float:
    """Per-device memory bytes a fused kernel moves for the S^2 and scan
    cores: the reference's analytic I/O, term for term.

    The dispatched ops' bytes charge every softmax and scan intermediate
    as memory traffic, but K8 (flash attention) and K9 (the selective
    scan) keep those tiles in shared memory and registers and stream only
    their inputs and outputs:

      attention : read Q,K,V + write O  (x ~3.5 with backward recompute)
      ssm       : read xc, dt_r, B, C + write y + inter-chunk states
    """
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp = mesh_shape.get("model", 1)
    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    passes = 3.5 if train else 1.0
    bpe = 2.0  # bf16 core I/O

    def attn_io(n_layers, s_q, s_kv) -> float:
        hq = max(layout.n_q_stored // tp, 1)
        hkv = max(layout.n_kv_stored // tp, 1)
        d = cfg.head_dim
        per_b = (s_q * hq * d) * 2 + (s_kv * hkv * d) * 2  # q+o, k+v
        return n_layers * (B / dp) * per_b * bpe * passes

    fam = cfg.family
    if fam == "moe":
        m = cfg.moe
        n_moe = cfg.n_layers // m.moe_every
        toks = (B / dp) * S
        slots = toks * m.top_k * m.capacity_factor
        d = cfg.d_model
        # a fused (sort-based) dispatch/combine kernel: token reads and
        # gathered buffer writes in, the reverse out
        disp = n_moe * (toks * d + 2 * slots * d) * 2 * bpe * passes
        return attn_io(cfg.n_layers, S, S) + disp
    if fam in ("dense", "vlm"):
        return attn_io(cfg.n_layers, S, S)
    if fam == "encdec":
        e = cfg.encdec
        td = e.dec_len
        return (attn_io(e.enc_layers, S, S) + attn_io(e.dec_layers, td, td)
                + attn_io(e.dec_layers, td, S))
    if fam == "ssm":
        di = max(cfg.d_inner // tp, 1)
        n = cfg.ssm.d_state
        nchunks = max(S // cfg.scan_chunk, 1)
        io_b = 2.0   # chunks stream in bf16; the f32 state stays on chip
        per_b = (2 * S * di            # xc read + y write
                 + S * (cfg.ssm.dt_rank + 2 * n)) * io_b \
            + nchunks * di * n * 4.0   # inter-chunk state spill (f32)
        return cfg.n_layers * (B / dp) * per_b * passes
    if fam == "hybrid":
        pat = cfg._pattern_full()
        n_attn = sum(1 for p in pat if p == "attn")
        n_rec = len(pat) - n_attn
        w = cfg.hybrid.window
        dr = max(cfg.hybrid.d_rnn // tp, 1)
        attn = attn_io(n_attn, S, min(2 * w, S))
        rec = n_rec * (B / dp) * (3 * S * dr) * 4.0 * passes
        return attn + rec
    return 0.0


MATERIALIZATIONS_PER_BLOCK = 16   # fusion-boundary tensors per layer (est.)


def streaming_memory_bytes(cfg, shape, *, args_bytes_per_dev: float,
                           core_io_bytes: float,
                           mesh_shape: Dict[str, int]) -> float:
    """A well-fused program's device-memory traffic (the optimistic
    bound), the reference's model term for term:
      * state I/O: params read (forward and backward recompute), gradient
        write and AdamW moment read/write: ~4x the per-device argument
        bytes to train, 1x to prefill or decode;
      * activations: MATERIALIZATIONS_PER_BLOCK tensors of the residual
        stream's size per layer, x1 forward or x3.5 with remat backward;
      * the fused core I/O (`kernel_core_io_bytes`).
    Reported beside the dispatched-op and kernel-adjusted terms; the three
    bracket the truth from both sides."""
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp = mesh_shape.get("model", 1)
    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    passes = 3.5 if train else 1.0
    state_io = args_bytes_per_dev * (4.0 if train else 1.0)
    seq_local = S / tp if (cfg.seq_parallel and shape.kind != "decode") else S
    if shape.kind == "decode":
        seq_local = 1
    act = (B / dp) * seq_local * cfg.d_model * 2.0
    n_layers = (cfg.encdec.enc_layers + cfg.encdec.dec_layers
                if cfg.family == "encdec" else cfg.n_layers)
    act_io = n_layers * MATERIALIZATIONS_PER_BLOCK * act * passes
    return state_io + act_io + core_io_bytes


def model_flops(cfg, shape) -> float:
    """Analytic model FLOPs of a step of `shape` (a `config.RunShape`):
    6 N D to train, 2 N D to prefill, 2 N per sequence to decode, N the
    active parameters (`cfg.active_param_count()`: MoE counts its routed
    top-k) and D the tokens (encdec: encoder frames + decoder tokens)."""
    n_active = cfg.active_param_count()
    toks = shape.tokens if cfg.family != "encdec" else (
        shape.global_batch * (shape.seq_len + cfg.encdec.dec_len))
    if shape.kind == "train":
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape.global_batch
