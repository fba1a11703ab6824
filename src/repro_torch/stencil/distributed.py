"""Distributed PW advection: the 2D-decomposed depth-T halo exchange over an
(nx, ny) `StencilMesh`, with two exchange engines and optional overlap.

Counterpart of `repro.stencil.distributed`. The reference runs one
controller, `shard_map` over a mesh in one process; so does the port: one
process holds the mesh and a list of per-shard (u, v, w), ordered like
`mesh.devices`, and drives every shard (`shard`/`gather` move a global
field to shards and back). Each shard owns an (X/nx, Y/ny, Z) slab; an
axis of size 1 exchanges nothing. ONE depth-T exchange serves T Euler
substeps, since each substep contaminates one more halo plane or row. The
exchange is two-phase, x then y: phase 1 trades depth-T x-planes of the
raw shard along the x ring, phase 2 trades depth-T y-rows of the
x-EXTENDED slab along the y ring, so the four corner blocks ride phase 2
and no diagonal message exists. The rings wrap periodically: wrapped halo
data is wrong by construction and frozen by the global-interior masks.

`exchange=` selects the transport of those bands; both move the same bands
through the same phases, so `roofline.halo_wire_bytes_model` prices
either, and their results are equal bitwise:

  * ``"collective"``: each hop's band is a tensor copy to the receiver's
    device (`copy_` across cards, a copy within the card on a loopback
    mesh), scheduled by PyTorch; the hi band of hop k comes from the
    k-away predecessor, so T beyond the local extent needs no fallback.
  * ``"remote_dma"``: the bands are stored from inside a kernel,
    `kernels.advection.halo_band_exchange_dma` (K7), straight into the
    halos of the ring neighbours' double-buffered extended slabs (slot =
    block index % 2), the paper's §IV move of the transfer schedule into
    the kernel. The x phase also stores each shard's own planes into the
    middle of its slab, and the y phase sends from that x-extended slab,
    so the slab K1 reads is built by K7 alone, with no concatenation (one
    launch per card and phase). On CPU shards it runs K7's plain version,
    message for message.

`make_distributed_run(n_blocks=K)` runs K substep-blocks with the block
counter feeding the slot parity, so block k+1's bands land in the slot
block k is not reading; the extended slabs, K7's message tables and its
counters live from block to block. As in the reference, each block still
orders its exchange before its compute: the cross-block landing is what
the slots make possible. With `checkpoint_every` and `checkpoint_dir` the
run snapshots the global fields, the block index and the slot parity
through `training.checkpoint` (the reference's leaf dict, so either
package resumes what the other wrote), and `resume_distributed_run`
continues a stopped run bitwise.

`spec=` (a `stencil.spec.StencilSpec`) generalises the step and run beyond
PW advection: `spec.n_fields` fields per shard, exchanged once a block at
depth ``D = spec.halo(T)`` through the same engines, walls `spec.radius`
cells wide; `local_kernel="fused"` runs K6 (`stencil_fused`) with its x/y
masks. K7 moves (u, v, w) on the card, so a CUDA mesh refuses `spec=` with
`remote_dma`, as the reference refuses its compiled kernel; CPU shards run
K7's plain version at any field count.

`local_kernel="fused"` runs each shard's update through K1
(`advect_fused`) with its x/y interior masks; `y_tile=None` lets K1 run
its own launch plan (`advection.fused_launch_plan`) on CUDA, as
`AdvectionDomain` does. `overlap=True` adds an interior pass over the owned
slab, which needs no exchange, and takes the D-deep bands beside each cut
from the boundary pass.

`verify_integrity=True` rides a `band_checksum` word on every band message
of the collective engine and of K7's plain version, and returns per-shard
mismatch counts; `corrupt_halo=(field, rows, value)` damages one received
band on the wire. K7 itself carries no checksum channel and no fault hook,
so a CUDA mesh refuses both knobs with `remote_dma`, as the reference's
compiled Mosaic kernel does. Every message goes through the op
`repro_torch::band_send` (the counterpart of `ppermute`) or K7's op, whose
messages a ledger prices from its table, and each block runs in a block scope and each shard's update in its shard
scope (`kernels.library.scope`), so `count_exchange_wire_bytes`,
`count_integrity_bytes`, `count_pallas_hbm_bytes` and `count_guard_bytes`
read the movement ledger (`analysis.ledger`) of a run per shard and per
block: the counted side of the counted == modelled gates. The drivers
check their shared-memory plan (`analysis.smem.distributed_block_plan`)
once per shard shape, before the first block launches.

`make_distributed_advect` is the reference's legacy rung: the 1D depth-1
exchange of the source terms on a (1, ny) mesh.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import smem as SM
from repro_torch.analysis.ledger import MovementLedger
from repro_torch.kernels import library as L
from repro_torch.kernels.advection import advection as K
from repro_torch.kernels.advection.ref import (AdvectParams, pw_advect_ref,
                                               pw_step_ref, step_dt)
from repro_torch.launch.mesh import StencilMesh, dma_neighbor_coords
from repro_torch.stencil import spec as SP
from repro_torch.training import checkpoint as CKPT

EXCHANGES = ("collective", "remote_dma")

# the per-hop band schedule lives in the kernels layer (K7 stores one band
# per entry); the collective engine and the wire pricing address it here
_band_schedule = K._band_schedule

Shards = List[Tuple[torch.Tensor, ...]]


class HaloCorrupted(RuntimeError):
    """A verified exchange received a band whose checksum mismatched: the
    fields downstream of the exchange are not trustworthy. Raised by
    `check_integrity` from the mismatch counts a `verify_integrity=True`
    step or run returns; the recovery is to roll back and replay."""


def check_integrity(flags) -> None:
    """Raise `HaloCorrupted` if any shard counted a band checksum
    mismatch. `flags` is the per-shard count a verified step or run
    returns (a run accumulates over its blocks)."""
    bad = int(torch.as_tensor(flags).to(torch.int64).sum())
    if bad:
        raise HaloCorrupted(
            f"{bad} halo band checksum mismatch(es) across shards; the "
            f"exchanged fields are not trustworthy — roll back to the "
            f"last checkpoint and replay")


def _corrupt_band(g: torch.Tensor, dim: int, rows: int,
                  value: float) -> torch.Tensor:
    """Fault hook: the received band with its leading `rows` planes/rows
    set to `value`, damage on the wire after the sender's checksum."""
    g = g.clone()
    g.narrow(dim, 0, rows).fill_(value)
    return g


# ---------------------------------------------------------------------------
# counted bytes: the movement ledger of a run, per shard and block
# ---------------------------------------------------------------------------


def count_exchange_wire_bytes(fn, shards) -> int:
    """Per-shard, per-block FIELD bytes the engines sent while `fn(shards)`
    ran (`fn` a distributed step or run): the `ppermute_wire` category of
    its movement ledger: the collective engine's `band_send`s and K7's
    messages from its table.
    Checksum words are counted by `count_integrity_bytes` instead, so this
    count is the same with verification on or off. The counted side of
    `roofline.halo_wire_bytes_model`; raises where shards or blocks sent
    different bytes."""
    return _ledger_count(fn, (shards,), "ppermute_wire")


def count_integrity_bytes(fn, shards) -> int:
    """Per-shard, per-block CHECKSUM bytes (one 4-byte word per band
    message of a verified exchange; 0 unverified) sent while `fn(shards)`
    ran: the `integrity_words` category. The counted side of
    `roofline.integrity_bytes_model`."""
    return _ledger_count(fn, (shards,), "integrity_words")


def count_pallas_hbm_bytes(fn, *args) -> int:
    """Device-memory bytes the kernels streamed while `fn(*args)` ran: the
    ledger's `pallas_hbm` and `guard_field_reads` (every kernel op's
    rank >= 3 operands and results, the guard's re-read included, and K7's
    landed slabs; the reference's legacy semantics). On a distributed step
    or run (`fn(shards)`) per shard and per block, as the wire counters;
    on a program without block scopes (a kernel call, the serving
    mega-step) the whole program's bytes."""
    return _ledger_count(fn, args, "pallas_hbm", "guard_field_reads")


def count_guard_bytes(fn, *args) -> int:
    """Device-memory bytes of the finite-guard passes while `fn(*args)` ran:
    the ledger's `guard_field_reads` and `guard_flag_words`, the quantity
    of `roofline.guard_bytes_model`; per shard and block on a distributed
    program, as `count_pallas_hbm_bytes`."""
    return _ledger_count(fn, args, "guard_field_reads", "guard_flag_words")


def _ledger_count(fn, args, *categories) -> int:
    """`categories`' bytes while `fn(*args)` ran: per shard and block where
    it ran in block scopes (`args[0]` being its shards), else in all."""
    ledger = MovementLedger.record(fn, *args)
    if ledger.blocks:
        return ledger.per_shard_block(*categories, n_shards=len(args[0]))
    return ledger.total(*categories)


# ---------------------------------------------------------------------------
# shards of a global field
# ---------------------------------------------------------------------------


def shard(mesh: StencilMesh, *fields) -> Shards:
    """Split global (X, Y, Z) fields (u, v, w, or a spec's) into the mesh's
    (X/nx, Y/ny, Z) shards, each contiguous on its device."""
    nx, ny = mesh.shape
    X, Y = fields[0].shape[0], fields[0].shape[1]
    if X % nx or Y % ny:
        raise ValueError(f"grid ({X}, {Y}) not divisible by mesh "
                         f"({nx}, {ny}); the mesh requires even shards")
    Xl, Yl = X // nx, Y // ny
    out = []
    for s, dev in enumerate(mesh.devices):
        ix, iy = mesh.coords(s)
        out.append(tuple(f[ix * Xl:(ix + 1) * Xl, iy * Yl:(iy + 1) * Yl]
                         .to(dev).contiguous() for f in fields))
    return out


def gather(mesh: StencilMesh, shards: Shards, device=None):
    """The global fields of `shards`, on `device` (default: the first
    shard's): new tensors, whatever the mesh."""
    dev = shards[0][0].device if device is None else torch.device(device)
    nx, ny = mesh.shape
    return tuple(
        torch.cat([torch.cat([shards[ix * ny + iy][f].to(dev)
                              for iy in range(ny)], dim=1)
                   for ix in range(nx)], dim=0)
        for f in range(len(shards[0])))


# ---------------------------------------------------------------------------
# the two engines
# ---------------------------------------------------------------------------


def _ring(mesh: StencilMesh, s: int, axis: str, delta: int) -> int:
    n = mesh.axis_size(axis)
    return mesh.index(dma_neighbor_coords(mesh.axis_names, mesh.coords(s),
                                          axis, delta, n))


def _word(band: torch.Tensor) -> torch.Tensor:
    """`band_checksum(band)` as the one 4-byte word the wire carries: the
    low half of the int64 that holds the uint32 sum."""
    return K.band_checksum(band).view(torch.int32)[:1]


def _exchange_halos(mesh: StencilMesh, fs: Sequence[torch.Tensor],
                    axis: str, depth: int, dim: int, *,
                    integrity_out=None, corrupt=None):
    """The collective engine for one field: per shard `(hi, lo)`, the
    `depth` planes (dim 0) or rows (dim 1) just below and just above the
    shard along the ring `axis`. Hop k moves min(L, depth-(k-1)L) of them
    from the k-away neighbour, a tensor copy to the receiver's device, so
    the total is `depth` whatever the hop count.

    Each band, and each checksum word, is one `band_send` from its sender.
    `integrity_out` (a list per shard) receives one mismatch indicator per
    received band, from a `band_checksum` word moved beside it;
    `corrupt=(rows, value)` damages every shard's hop-1 hi band after the
    sender's checksum."""
    n = fs[0].shape[dim]
    hi_parts = [[] for _ in fs]
    lo_parts = [[] for _ in fs]
    for k, cnt, _, _ in _band_schedule(n, depth):
        for r, dst in enumerate(fs):
            for side, src, lo in ((0, _ring(mesh, r, axis, -k), n - cnt),
                                  (1, _ring(mesh, r, axis, k), 0)):
                sent = fs[src].narrow(dim, lo, cnt)
                got = L.band_send(sent, dst.device, src)
                if integrity_out is not None:
                    word = L.band_send(_word(sent), dst.device, src)
                if corrupt is not None and side == 0 and k == 1:
                    got = _corrupt_band(got, dim, min(corrupt[0], cnt),
                                        corrupt[1])
                if integrity_out is not None:
                    integrity_out[r].append(_word(got) != word)
                (hi_parts if side == 0 else lo_parts)[r].append(got)
    # hi: farthest predecessor first, so global coordinates ascend
    return [(torch.cat(h[::-1], dim=dim), torch.cat(lo, dim=dim))
            for h, lo in zip(hi_parts, lo_parts)]


def _exchange_band_dma(mesh: StencilMesh, shards: Shards, axis: str,
                       depth: int, dim: int, block_index: int,
                       slabs: K.BandSlabs, *,
                       integrity_out=None, corrupt=None) -> Shards:
    """The remote_dma engine: K7 over every shard's fields into `slabs`'
    extended slabs; returns per shard the extended fields, views of
    slot `block_index % 2`. On CPU shards the integrity words and the
    fault hook ride K7's plain version as its `wire`."""
    wire = None
    if integrity_out is not None or corrupt is not None:
        def wire(m, sent, got):
            if integrity_out is not None:
                word = L.band_send(_word(sent), got.device, m.sender)
            if (corrupt is not None and m.field == corrupt[0]
                    and m.side == 0 and m.k == 1):
                got = _corrupt_band(got, dim, min(corrupt[1], m.cnt),
                                    corrupt[2])
            if integrity_out is not None:
                integrity_out[m.receiver].append(_word(got) != word)
            return got
    K.halo_band_exchange_dma(shards, mesh=mesh, axis=axis, depth=depth,
                             dim=dim, block_index=block_index, slabs=slabs,
                             wire=wire, checksums=integrity_out is not None)
    return slabs.extended(block_index % 2)


def remote_dma_schedule_wire_bytes(Xl: int, Yl: int, Z: int, itemsize: int,
                                   *, nx: int = 1, ny: int = 1,
                                   T: int = 1, n_fields: int = 3) -> int:
    """Per-shard sent bytes of the remote-DMA schedule: the summed
    `_band_schedule` message sizes over both sides of the two-phase
    exchange (phase 2's messages are x-extended: the corner blocks),
    computed from the messages, not from `roofline.halo_wire_bytes_model`,
    which it must equal."""
    total = 0
    if nx > 1:
        total += sum(2 * cnt * Yl * Z
                     for _, cnt, _, _ in _band_schedule(Xl, T))
    x_ext = Xl + (2 * T if nx > 1 else 0)
    if ny > 1:
        total += sum(2 * cnt * x_ext * Z
                     for _, cnt, _, _ in _band_schedule(Yl, T))
    return total * n_fields * itemsize


# ---------------------------------------------------------------------------
# the step and run drivers
# ---------------------------------------------------------------------------


def _check_step_config(T: int, local_kernel: str, exchange: str) -> None:
    """Shared build-time validation for the step and run drivers."""
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if local_kernel not in ("reference", "fused"):
        raise ValueError(f"local_kernel must be 'reference' or 'fused', "
                         f"got {local_kernel!r}")
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, "
                         f"got {exchange!r}")


def _check_integrity_config(verify_integrity: bool, corrupt_halo,
                            exchange: str, mesh: StencilMesh,
                            n_fields: int = 3) -> None:
    """Build-time validation of the integrity knobs: K7 on a CUDA mesh
    carries neither a checksum channel nor a fault hook. `n_fields` bounds
    `corrupt_halo`'s field index: 3 (u, v, w), or `spec.n_fields`."""
    if exchange == "remote_dma" and mesh.is_cuda:
        if verify_integrity:
            raise RuntimeError(
                "verify_integrity=True rides checksum words on the tensor "
                "copies (the collective engine and K7's plain version on "
                "CPU shards); the band exchange kernel carries no checksum "
                "channel. Use exchange='collective'.")
        if corrupt_halo is not None:
            raise RuntimeError(
                "corrupt_halo injects wire damage between the tensor "
                "copies; the band exchange kernel has no injection hook. "
                "Use exchange='collective' or CPU shards.")
    if corrupt_halo is not None:
        fi, depth, _ = corrupt_halo
        if not (0 <= int(fi) < n_fields):
            raise ValueError(f"corrupt_halo field index must be "
                             f"0..{n_fields - 1}, got {fi}")
        if int(depth) < 1:
            raise ValueError(f"corrupt_halo depth must be >= 1, "
                             f"got {depth}")


def _check_spec_step_config(spec, T: int, local_kernel: str, exchange: str,
                            mesh: StencilMesh, verify_integrity: bool = False,
                            corrupt_halo=None) -> None:
    """Build-time validation of the spec-driven path."""
    _check_step_config(T, local_kernel, exchange)
    if not isinstance(spec, SP.StencilSpec):
        raise ValueError(f"spec must be a StencilSpec, got {type(spec)!r}")
    if exchange == "remote_dma" and mesh.is_cuda:
        raise RuntimeError(
            "spec-driven steps have no band exchange kernel on the card "
            "(csrc/band_exchange.cu moves the 3 fields of PW advection, as "
            "the reference's compiled kernel does); use "
            "exchange='collective', or CPU shards for its plain version's "
            "message-for-message schedule.")
    _check_integrity_config(verify_integrity, corrupt_halo, exchange, mesh,
                            n_fields=spec.n_fields)


def _on(params, device, cache: dict):
    """`params` (a NamedTuple of arrays: `AdvectParams`, or whatever a
    spec's `pack_params` takes) with every leaf on `device`, made once."""
    if device not in cache:
        cache[device] = type(params)(*(torch.as_tensor(leaf, device=device)
                                       for leaf in params))
    return cache[device]


class _LocalBlock:
    """One substep-block over every shard of the mesh: the shared body of
    `make_distributed_step` (one block) and `make_distributed_run` (K
    blocks, the block index feeding K7's slot). Holds K7's extended slabs,
    tables and counters, and each shard's interior masks, from one block
    to the next. `corrupt_halo=(field, rows, value)` damages that field's
    hop-1 hi band on the last exchanged phase (y when y is decomposed,
    else x).

    With `spec` (and `spec_params`) the block is the reference's
    `_build_spec_local_block`: `spec.n_fields` fields exchanged once at
    depth D = `spec.halo(T)`, walls `spec.radius` cells wide, the local
    update K6 (`fused`) or `spec_sources` under the masks (`reference`).
    Without, D = T, the radius 1 and the fields (u, v, w)."""

    def __init__(self, mesh: StencilMesh, params, *, T: int,
                 dt: float, local_kernel: str, y_tile: Optional[int],
                 overlap: bool, exchange: str,
                 verify_integrity: bool = False, corrupt_halo=None,
                 spec=None):
        self.mesh, self.params, self.T, self.dt = mesh, params, T, dt
        self.local_kernel, self.y_tile = local_kernel, y_tile
        self.overlap, self.exchange = overlap, exchange
        self.verify, self.corrupt_halo = verify_integrity, corrupt_halo
        self.spec = spec
        if spec is None:
            self.n_fields, self.radius, self.depth = 3, 1, T
        else:
            self.n_fields, self.radius = spec.n_fields, spec.radius
            self.depth = spec.halo(T)
        self.buffers: Optional[K.ExtendedBuffers] = None
        self.slabs: Dict[str, K.BandSlabs] = {}
        self._params: dict = {}
        self._masks: dict = {}
        self._planned: set = set()

    def _mask(self, x_int, y_int, device):
        """A pass's interior mask in the form its local kernel takes: the
        (x, y) f32 pair of K1 and K6, or one broadcast bool for the
        reference; a None mask leaves that axis all-interior (the slab edge
        is the true boundary)."""
        if self.local_kernel == "fused":
            return tuple(None if m is None else m.float()
                         for m in (x_int, y_int))
        m = torch.ones((), dtype=torch.bool, device=device)
        if x_int is not None:
            m = m & x_int[:, None, None]
        if y_int is not None:
            m = m & y_int[None, :, None]
        return m

    def _shard_masks(self, s: int, Xl: int, Yl: int, dx: int, dy: int):
        """Shard `s`'s masks, built once per shard shape: the boundary
        pass's over the extended slab, and with overlap the interior
        pass's over the owned slab and the select of its trusted cells."""
        key = (s, Xl, Yl)
        if key in self._masks:
            return self._masks[key]
        mesh, D, r = self.mesh, self.depth, self.radius
        n_x, n_y = mesh.shape
        X_g, Y_g = n_x * Xl, n_y * Yl
        ix, iy = mesh.coords(s)
        dev = mesh.devices[s]

        def interior(lo, n, extent):
            # the wall is `radius` cells wide: a radius-r stencil carries
            # no value past r frozen cells
            g = lo + torch.arange(n, device=dev)
            return (g >= r) & (g <= extent - 1 - r)

        # global-interior masks over the slab coordinates
        ext = self._mask(interior(ix * Xl - dx, Xl + 2 * dx, X_g) if dx
                         else None,
                         interior(iy * Yl - dy, Yl + 2 * dy, Y_g) if dy
                         else None, dev)
        own = sel = None
        if self.overlap and (dx or dy):
            # interior pass: owned slab only; the cut edges contaminate < D
            # cells inward, which the select drops
            own = self._mask(interior(ix * Xl, Xl, X_g) if dx else None,
                             interior(iy * Yl, Yl, Y_g) if dy else None, dev)
            sx = torch.arange(Xl, device=dev)
            sy = torch.arange(Yl, device=dev)
            ok_x = torch.ones(Xl, dtype=torch.bool, device=dev)
            ok_y = torch.ones(Yl, dtype=torch.bool, device=dev)
            if dx:
                ok_x = (((ix == 0) | (sx >= D))
                        & ((ix == n_x - 1) | (sx < Xl - D)))
            if dy:
                ok_y = (((iy == 0) | (sy >= D))
                        & ((iy == n_y - 1) | (sy < Yl - D)))
            sel = (ok_x[:, None] & ok_y[None, :])[:, :, None]
        self._masks[key] = (ext, own, sel)
        return self._masks[key]

    def _substeps(self, fields, mask):
        """T masked integrator steps on a (halo'd) slab under `_mask`'s
        mask: Euler steps of PW advection, or the spec's."""
        p = _on(self.params, fields[0].device, self._params)
        T, dt, spec = self.T, self.dt, self.spec
        if self.local_kernel == "fused":
            if spec is not None:
                return K.stencil_fused(fields, p, spec, T=T, dt=dt,
                                       y_tile=self.y_tile,
                                       x_interior_mask=mask[0],
                                       y_interior_mask=mask[1])
            return K.advect_fused(*fields, p, T=T, dt=dt,
                                  y_tile=self.y_tile, x_interior_mask=mask[0],
                                  y_interior_mask=mask[1])
        m = mask

        def update(f, s, k):
            # the reference's `f + k * where(m, s, 0)`, k weak: rounded to
            # bf16 where the product is a bf16 op
            return f + step_dt(k, s.dtype) * torch.where(m, s, 0.0)

        fields = tuple(fields)
        for _ in range(T):
            if spec is None:
                srcs = pw_advect_ref(*fields, p)
            elif spec.integrator == "rk2":
                s0 = SP.spec_sources(fields, p, spec)
                g = tuple(update(f, s, 0.5 * dt)
                          for f, s in zip(fields, s0))
                srcs = SP.spec_sources(g, p, spec)
            else:
                srcs = SP.spec_sources(fields, p, spec)
            fields = tuple(update(f, s, dt) for f, s in zip(fields, srcs))
        return fields

    def _band_slabs(self, shape, dx: int, dy: int,
                    dtype=torch.float32) -> None:
        """K7's extended slabs for shards of `shape` and `dtype`, made once:
        one set of buffers padded by (dx, dy), the x phase landing in its
        middle rows and the y phase over all of it."""
        if self.buffers is not None and (
                self.buffers.shape, self.buffers.pad,
                self.buffers.dtype) == (shape, (dx, dy), dtype):
            return
        Xl, Yl, Z = shape
        n = self.n_fields
        self.buffers = K.ExtendedBuffers(self.mesh, shape, (dx, dy),
                                         n_fields=n, dtype=dtype)
        self.slabs = {}
        if dx:
            self.slabs["x"] = K.BandSlabs(self.mesh, shape, dx, 0,
                                          buffers=self.buffers, window=dy)
        if dy:
            self.slabs["y"] = K.BandSlabs(self.mesh, (Xl + 2 * dx, Yl, Z),
                                          dy, 1, buffers=self.buffers)

    def _extend(self, fields: Shards, axis: str, dim: int, block_index,
                integrity_out, corrupt_dim) -> Shards:
        """One phase: every shard's fields extended by D planes/rows on
        both sides along `dim`, whichever engine moved them. With
        `remote_dma` the slabs are views of K7's persistent buffers, where
        the exchange put the shard and its bands; the collective engine
        concatenates."""
        D, ch = self.depth, self.corrupt_halo
        if self.exchange == "remote_dma":
            corrupt = (None if ch is None or corrupt_dim != dim
                       else (int(ch[0]), int(ch[1]), ch[2]))
            return _exchange_band_dma(self.mesh, fields, axis, D, dim,
                                      block_index, self.slabs[axis],
                                      integrity_out=integrity_out,
                                      corrupt=corrupt)
        per_field = []
        for fi in range(self.n_fields):
            corrupt = (None if ch is None or corrupt_dim != dim
                       or fi != int(ch[0]) else (int(ch[1]), ch[2]))
            per_field.append(_exchange_halos(
                self.mesh, [f[fi] for f in fields], axis, D, dim,
                integrity_out=integrity_out, corrupt=corrupt))
        bands = [tuple(pf[s] for pf in per_field)
                 for s in range(len(fields))]
        return [tuple(torch.cat([hi, f, lo], dim=dim)
                      for f, (hi, lo) in zip(trio, b))
                for trio, b in zip(fields, bands)]

    def _exchange(self, shards: Shards, block_index, dx: int, dy: int,
                  integrity_out=None, corrupt_dim=None) -> Shards:
        """The two-phase exchange: x first, then y on the x-extended slab;
        per shard the fields the boundary pass reads."""
        fields = shards
        if self.exchange == "remote_dma":
            self._band_slabs(tuple(shards[0][0].shape), dx, dy,
                             shards[0][0].dtype)
        if dx:
            fields = self._extend(fields, "x", 0, block_index,
                                  integrity_out, corrupt_dim)
        if dy:
            fields = self._extend(fields, "y", 1, block_index,
                                  integrity_out, corrupt_dim)
        return fields

    def plan(self, shape, dx: int, dy: int, itemsize: int = 4) -> None:
        """Check the block's shared-memory plan for shards of `shape`
        (`analysis.smem.distributed_block_plan`: the local kernel's block
        over the extended slab, K7's extended buffers on the busiest card),
        once per shape, before anything launches; raises
        `SmemBudgetExceeded` naming the largest buffer."""
        if (shape, itemsize) in self._planned:
            return
        cards = [d for d in self.mesh.devices]
        SM.distributed_block_plan(
            shape, T=self.T, local_kernel=self.local_kernel,
            exchange=self.exchange, y_tile=self.y_tile,
            nx=2 if dx else 1, ny=2 if dy else 1, spec=self.spec,
            shards_per_card=max(cards.count(d) for d in cards),
            itemsize=itemsize, context="distributed block").check()
        self._planned.add((shape, itemsize))

    def check(self) -> None:
        """Raise when a K7 kernel of this block's mesh timed out."""
        for slabs in self.slabs.values():
            slabs.check()

    def __call__(self, shards: Shards, block_index: int):
        mesh, D, r = self.mesh, self.depth, self.radius
        n_x, n_y = mesh.shape
        if len(shards) != len(mesh.devices):
            raise ValueError(f"{len(shards)} shards given for a mesh of "
                             f"{len(mesh.devices)}")
        if len(shards[0]) != self.n_fields:
            raise ValueError(f"shards hold {len(shards[0])} fields, the "
                             f"step {self.n_fields}")
        Xl, Yl, _ = shards[0][0].shape
        X_g, Y_g = n_x * Xl, n_y * Yl
        dx = D if n_x > 1 else 0
        dy = D if n_y > 1 else 0
        what = "T" if self.spec is None else "spec.halo(T)"
        if dy and D > Y_g - 2 * r:
            raise ValueError(
                f"halo depth {what}={D} exceeds the decomposable global Y "
                f"extent ({Y_g} rows, interior {Y_g - 2 * r}); lower T")
        if dx and D > X_g - 2 * r:
            raise ValueError(
                f"halo depth {what}={D} exceeds the decomposable global X "
                f"extent ({X_g} planes, interior {X_g - 2 * r}); lower T")
        self.plan(tuple(shards[0][0].shape), dx, dy,
                  shards[0][0].element_size())
        with L.scope(block=True):
            return self._block(shards, block_index, Xl, Yl, dx, dy)

    def _block(self, shards: Shards, block_index: int, Xl: int, Yl: int,
               dx: int, dy: int):
        integrity_out = [[] for _ in shards] if self.verify else None
        corrupt_dim = None
        if self.corrupt_halo is not None and (dx or dy):
            corrupt_dim = 1 if dy else 0

        fields = self._exchange(shards, block_index, dx, dy, integrity_out,
                                corrupt_dim)
        out = []
        for s, (own, ext) in enumerate(zip(shards, fields)):
            with L.scope(shard=s):
                out.append(self._shard_update(s, own, ext, Xl, Yl, dx, dy))
        mismatch = None
        if self.verify:
            mismatch = [sum((m.to(torch.int64).sum() for m in ms),
                            torch.zeros((), dtype=torch.int64,
                                        device=own[0].device))
                        for ms, own in zip(integrity_out, shards)]
        return out, mismatch


    def _shard_update(self, s: int, own, ext, Xl: int, Yl: int, dx: int,
                      dy: int):
        """Shard `s`'s fields after the block: the boundary pass over the
        extended slab, trimmed to the owned rows, and with overlap the
        interior pass's trusted cells."""
        ext_mask, own_mask, sel = self._shard_masks(s, Xl, Yl, dx, dy)
        # boundary pass (consumes the exchange), trimmed to owned rows
        bnd = tuple(f[dx:dx + Xl, dy:dy + Yl]
                    for f in self._substeps(ext, ext_mask))
        if sel is None:
            return tuple(f.contiguous() for f in bnd)
        inner = self._substeps(own, own_mask)
        return tuple(torch.where(sel, i, b) for i, b in zip(inner, bnd))


def _flags(mesh: StencilMesh, mismatch) -> torch.Tensor:
    """Per-shard mismatch counts as an (nx, ny) int64 tensor on the CPU."""
    return torch.stack([m.cpu() for m in mismatch]).reshape(mesh.shape)


def _build_block(mesh: StencilMesh, params, *, T: int, dt: float,
                 local_kernel: str, y_tile: Optional[int], overlap: bool,
                 exchange: str, verify_integrity: bool, corrupt_halo,
                 spec, spec_params) -> _LocalBlock:
    """The checked `_LocalBlock` of a step or run: PW advection, or with
    `spec` the spec's fields and `spec_params`."""
    if spec is not None:
        _check_spec_step_config(spec, T, local_kernel, exchange, mesh,
                                verify_integrity, corrupt_halo)
        params = spec_params
    else:
        _check_integrity_config(verify_integrity, corrupt_halo, exchange,
                                mesh)
        _check_step_config(T, local_kernel, exchange)
    return _LocalBlock(mesh, params, T=T, dt=dt, local_kernel=local_kernel,
                       y_tile=y_tile, overlap=overlap, exchange=exchange,
                       verify_integrity=verify_integrity,
                       corrupt_halo=corrupt_halo, spec=spec)


def make_distributed_step(mesh: StencilMesh, params: AdvectParams, *,
                          T: int = 1, dt: float = 1.0,
                          local_kernel: str = "reference",
                          y_tile: Optional[int] = None,
                          overlap: bool = False,
                          exchange: str = "collective",
                          dma_block_index: int = 0,
                          verify_integrity: bool = False,
                          corrupt_halo=None,
                          spec=None, spec_params=None):
    """Returns step(shards): T Euler substeps per ONE depth-T halo exchange
    over the (nx, ny) mesh, x decomposed over mesh axis "x" and y over
    "y". `shards` is a list of per-shard (u, v, w), ordered like
    `mesh.devices` (`shard` makes one); the step returns the advanced list.

    The wrapped rings are periodic, and every substep masks the source
    outside the global interior, so wrapped rows never reach the result;
    the only bound is T <= global extent - 2 along each decomposed axis.
    `exchange`, `local_kernel`, `y_tile` and `overlap` are described in the
    module docstring; `dma_block_index` is the block number k whose parity
    selects K7's recv slot.

    `spec=` (a `StencilSpec`, with `spec_params=` whatever its
    `pack_params` takes; `params` is then unused) makes the shards hold
    `spec.n_fields` fields and the one exchange run at depth
    ``spec.halo(T) = radius * stages * T``, the bound being that depth <=
    global extent - 2 * radius.

    `verify_integrity=True` makes the step return ``(shards, flags)``,
    flags being the (nx, ny) int64 per-shard count of band checksum
    mismatches (`check_integrity` raises on any); the fields are the same
    bits as unverified. `corrupt_halo=(field_idx, rows, value)` is the
    matching fault hook."""
    block = _build_block(mesh, params, T=T, dt=dt, local_kernel=local_kernel,
                         y_tile=y_tile, overlap=overlap, exchange=exchange,
                         verify_integrity=verify_integrity,
                         corrupt_halo=corrupt_halo, spec=spec,
                         spec_params=spec_params)

    def step(shards: Shards):
        out, mismatch = block(shards, dma_block_index)
        block.check()
        return (out, _flags(mesh, mismatch)) if verify_integrity else out

    return step


def _run_blocks(block: _LocalBlock, shards: Shards, start: int, end: int):
    """Blocks [start, end) of a run (start < end), block k exchanging into
    slot k % 2; returns (shards, per-shard mismatch counts summed over the
    span, or None unverified)."""
    total = None
    for k in range(start, end):
        shards, mismatch = block(shards, k)
        if block.verify:
            total = (mismatch if total is None
                     else [a + b for a, b in zip(total, mismatch)])
    block.check()
    return shards, total


_STATE_FIELDS = ("u", "v", "w")


def _run_state(mesh: StencilMesh, shards: Shards, block: int,
               flags) -> dict:
    """The checkpoint leaf dict, the reference's: the global fields
    gathered to host numpy, the block index and the recv-slot parity K7's
    double buffering depends on (stored redundantly: resume refuses a
    parity that disagrees with the block), and with verification the
    (nx, ny) mismatch counts as uint32."""
    state = {k: g.cpu() if g.dtype == torch.bfloat16 else g.cpu().numpy()
             for k, g in zip(_STATE_FIELDS, gather(mesh, shards))}
    state["block"] = np.int64(block)
    state["parity"] = np.int64(block % 2)
    if flags is not None:
        state["mismatches"] = np.asarray(flags, dtype=np.uint32)
    return state


def _checkpointed_segments(block: _LocalBlock, checkpoint_dir,
                           shards: Shards, *, start: int, n_blocks: int,
                           every: int, flags, keep_last: int,
                           save_initial: bool):
    """Run blocks [start, n_blocks) in `every`-block segments, saving a
    checkpoint at each boundary and the last block through
    `training.checkpoint`'s atomic writes. `flags` carries the mismatch
    counts summed before `start` (restored on resume), so a resumed run's
    flags equal the uninterrupted run's."""
    mesh = block.mesh
    if save_initial:
        CKPT.save(checkpoint_dir, _run_state(mesh, shards, start, flags),
                  start, keep_last=keep_last)
    b = start
    while b < n_blocks:
        e = min(b + every, n_blocks)
        shards, span = _run_blocks(block, shards, b, e)
        if flags is not None:
            flags = flags + _flags(mesh, span)
        b = e
        CKPT.save(checkpoint_dir, _run_state(mesh, shards, b, flags), b,
                  keep_last=keep_last)
    return (shards, flags) if flags is not None else shards


def make_distributed_run(mesh: StencilMesh, params: AdvectParams, *,
                         n_blocks: int, T: int = 1, dt: float = 1.0,
                         local_kernel: str = "reference",
                         y_tile: Optional[int] = None,
                         overlap: bool = False,
                         exchange: str = "collective",
                         verify_integrity: bool = False,
                         checkpoint_every: Optional[int] = None,
                         checkpoint_dir=None, keep_last: int = 3,
                         spec=None, spec_params=None):
    """Returns run(shards): `n_blocks` substep-blocks (n_blocks * T
    integrator steps, one exchange per block), block k exchanging into
    K7's recv slot k % 2 through slabs and counters kept across the
    blocks. Exactly `n_blocks` sequential `make_distributed_step` calls
    with `dma_block_index = 0 .. n_blocks-1`, bitwise. With
    `verify_integrity` the run returns ``(shards, flags)``, the counts
    summed over the blocks. `spec=` means what it means on
    `make_distributed_step`.

    `checkpoint_every=k` with `checkpoint_dir=` saves the global (u, v, w),
    the block index and the slot parity (`_run_state`, the reference's
    leaf dict) through `training.checkpoint` at block 0, every k-block
    boundary and the last block, `keep_last` bounding the disk; a run
    stopped on the way continues through `resume_distributed_run`, bitwise
    the uninterrupted run. The spec-driven run takes no checkpoints, as in
    the reference."""
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
    if (checkpoint_every is None) != (checkpoint_dir is None):
        raise ValueError("checkpoint_every and checkpoint_dir come "
                         "together: both or neither")
    if spec is not None and checkpoint_every is not None:
        raise ValueError(
            "checkpointing is not wired to the spec-driven run yet "
            "(the snapshot leaf dict is (u, v, w)-specific); run "
            "without spec= or without checkpoint_every=")
    block = _build_block(mesh, params, T=T, dt=dt, local_kernel=local_kernel,
                         y_tile=y_tile, overlap=overlap, exchange=exchange,
                         verify_integrity=verify_integrity,
                         corrupt_halo=None, spec=spec,
                         spec_params=spec_params)

    if checkpoint_every is None:
        def run(shards: Shards):
            shards, total = _run_blocks(block, shards, 0, n_blocks)
            return ((shards, _flags(mesh, total)) if verify_integrity
                    else shards)
    else:
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, "
                             f"got {checkpoint_every}")
        flag0 = (torch.zeros(mesh.shape, dtype=torch.int64)
                 if verify_integrity else None)

        def run(shards: Shards):
            return _checkpointed_segments(
                block, checkpoint_dir, shards, start=0, n_blocks=n_blocks,
                every=checkpoint_every, flags=flag0, keep_last=keep_last,
                save_initial=True)

    return run


def resume_distributed_run(mesh: StencilMesh, params: AdvectParams,
                           shards: Shards, *, n_blocks: int, checkpoint_dir,
                           checkpoint_every: Optional[int] = None,
                           step: Optional[int] = None, T: int = 1,
                           dt: float = 1.0, local_kernel: str = "reference",
                           y_tile: Optional[int] = None,
                           overlap: bool = False,
                           exchange: str = "collective",
                           verify_integrity: bool = False,
                           keep_last: int = 3):
    """Restore the latest (or `step=`) checkpoint a checkpointing
    `make_distributed_run` wrote under `checkpoint_dir` (this package's or
    the reference's) and continue to `n_blocks`, returning what the
    uninterrupted run would have, bitwise: the restored block index feeds
    the slot parity, so the replayed blocks are the blocks the stopped run
    would have run.

    `shards` are templates (one (u, v, w) per shard, as the run takes):
    their shape is checked against the snapshot and their values are
    replaced by it. `checkpoint_every=None` continues in one segment, still
    writing the last checkpoint. A checkpoint whose stored parity
    disagrees with its block index, or whose step disagrees with the
    stored block, is refused with a ValueError naming the inconsistency.
    Build arguments must match the original run's."""
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
    block = _build_block(mesh, params, T=T, dt=dt, local_kernel=local_kernel,
                         y_tile=y_tile, overlap=overlap, exchange=exchange,
                         verify_integrity=verify_integrity,
                         corrupt_halo=None, spec=None, spec_params=None)
    bf16 = shards[0][0].dtype == torch.bfloat16
    like = {k: torch.zeros((), dtype=torch.bfloat16) if bf16 else 0
            for k in _STATE_FIELDS}
    like.update(block=0, parity=0)
    if verify_integrity:
        like["mismatches"] = 0
    state, disk_step = CKPT.restore(checkpoint_dir, like, step=step)
    at = int(state["block"])
    parity = int(state["parity"])
    if parity != at % 2:
        raise ValueError(
            f"checkpoint step {disk_step} under {checkpoint_dir} is "
            f"inconsistent: stored recv-slot parity {parity} != block "
            f"{at} % 2; refusing to resume into a wrong DMA slot")
    if disk_step != at:
        raise ValueError(
            f"checkpoint step {disk_step} under {checkpoint_dir} stores "
            f"block index {at}; refusing to resume an inconsistent "
            f"snapshot")
    nx, ny = mesh.shape
    Xl, Yl, Z = shards[0][0].shape
    want = (nx * Xl, ny * Yl, Z)
    for k in _STATE_FIELDS:
        if tuple(state[k].shape) != want:
            raise ValueError(f"checkpoint step {disk_step} holds {k} of "
                             f"{tuple(state[k].shape)}, the mesh's shards "
                             f"make {want}")
    shards = shard(mesh, *(state[k] if torch.is_tensor(state[k]) else
                           torch.from_numpy(np.ascontiguousarray(state[k]))
                           for k in _STATE_FIELDS))
    flags = None
    if verify_integrity:
        flags = torch.from_numpy(np.asarray(
            state["mismatches"], dtype=np.int64)).reshape(mesh.shape)
    if at >= n_blocks:
        return (shards, flags) if verify_integrity else shards
    every = checkpoint_every if checkpoint_every else n_blocks - at
    if every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {every}")
    return _checkpointed_segments(block, checkpoint_dir, shards, start=at,
                                  n_blocks=n_blocks, every=every,
                                  flags=flags, keep_last=keep_last,
                                  save_initial=False)


def make_distributed_advect(mesh: StencilMesh, params: AdvectParams):
    """Returns advect(shards): the PW source terms of the global (u, v, w)
    on a (1, ny) mesh, per shard. The reference's LEGACY rung, the original
    1D depth-1 source-only exchange: each shard computes its sources
    without halos, exchanges one row each way, recomputes its two edge rows
    from the halo'd slab and keeps those beside a cut (the global boundary
    rows keep the unhalo'd, walled result)."""
    if mesh.shape[0] != 1:
        raise ValueError(f"make_distributed_advect decomposes y alone: it "
                         f"takes a (1, ny) mesh, got {mesh.shape}")
    n = mesh.shape[1]
    cache: dict = {}

    def advect(shards: Shards):
        if len(shards) != n:
            raise ValueError(f"{len(shards)} shards given for a mesh of {n}")
        with L.scope(block=True):
            return _advect(shards)

    def _advect(shards: Shards):
        halos = [_exchange_halos(mesh, [s[f] for s in shards], "y", 1, 1)
                 for f in range(3)]
        out = []
        for s, (u, v, w) in enumerate(shards):
            p = _on(params, u.device, cache)
            interior = pw_advect_ref(u, v, w, p)
            full = pw_advect_ref(*(torch.cat([halos[f][s][0], fld,
                                              halos[f][s][1]], dim=1)
                                   for f, fld in enumerate((u, v, w))), p)
            band = [t[:, 1:-1] for t in full]
            Y = u.shape[1]
            rows = torch.arange(Y, device=u.device)
            idx = mesh.coords(s)[1]
            edge = (rows < 1) | (rows >= Y - 1)
            glob = ((rows < 1) & (idx == 0)) | ((rows >= Y - 1)
                                                & (idx == n - 1))
            sel = (edge & ~glob)[None, :, None]
            out.append(tuple(torch.where(sel, b, i)
                             for b, i in zip(band, interior)))
        return out

    return advect


def reference_global(u, v, w, params: AdvectParams):
    """Single-device oracle for the distributed version."""
    return pw_advect_ref(u, v, w, params)


def reference_global_step(u, v, w, params: AdvectParams, *, T: int = 1,
                          dt: float = 1.0):
    """Single-device T-substep oracle for `make_distributed_step`."""
    for _ in range(T):
        u, v, w = pw_step_ref(u, v, w, params, dt)
    return u, v, w


def reference_global_spec_step(fields, spec_params, spec, *, T: int = 1,
                               dt: float = 1.0):
    """Single-device T-step oracle for the spec-driven step:
    `spec_multistep`'s zero_source wall is the global-interior mask every
    shard applies, so the sharded step reproduces it for any mesh shape."""
    return SP.spec_multistep(fields, spec_params, spec, T, dt)
