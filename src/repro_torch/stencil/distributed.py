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
the slots make possible.

`local_kernel="fused"` runs each shard's update through K1
(`advect_fused`) with its x/y interior masks; `y_tile=None` lets K1 run
its own launch plan (`advection.fused_launch_plan`) on CUDA, as
`AdvectionDomain` does. `overlap=True` adds an interior pass over the owned
slab, which needs no exchange, and takes the T-deep bands beside each cut
from the boundary pass.

`verify_integrity=True` rides a `band_checksum` word on every band message
of the collective engine and of K7's plain version, and returns per-shard
mismatch counts; `corrupt_halo=(field, rows, value)` damages one received
band on the wire. K7 itself carries no checksum channel and no fault hook,
so a CUDA mesh refuses both knobs with `remote_dma`, as the reference's
compiled Mosaic kernel does. `count_exchange_wire_bytes` and
`count_integrity_bytes` read the bytes the engines tally per message, the
counted side of the counted == modelled gates.

The `spec=` builds, checkpointed runs and their resume wait for a later
slice of the port.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import roofline as R
from repro_torch.kernels.advection import advection as K
from repro_torch.kernels.advection.ref import (AdvectParams, pw_advect_ref,
                                               pw_step_ref)
from repro_torch.launch.mesh import StencilMesh, dma_neighbor_coords

EXCHANGES = ("collective", "remote_dma")
LATER_SLICE = ("waits for a later slice of the port (E2: the spec= builds, "
               "checkpointed runs and their resume)")

# the per-hop band schedule lives in the kernels layer (K7 stores one band
# per entry); the collective engine and the wire pricing address it here
_band_schedule = K._band_schedule

Shards = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


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
# byte tally: what the engines send, per shard
# ---------------------------------------------------------------------------


class _Tally:
    """Bytes each shard sent (`wire`: band payloads, `integrity`: checksum
    words) and the blocks run, since the last `reset`. A step or run owns
    one, as its `tally` attribute."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sent: Dict[str, Dict[int, int]] = {"wire": {}, "integrity": {}}
        self.blocks = 0

    def add(self, kind: str, shard: int, nbytes: int) -> None:
        self.sent[kind][shard] = self.sent[kind].get(shard, 0) + nbytes

    def per_shard_block(self, kind: str, n_shards: int) -> int:
        sent = [self.sent[kind].get(s, 0) for s in range(n_shards)]
        if len(set(sent)) != 1:
            raise RuntimeError(f"shards sent different {kind} bytes: {sent}")
        if self.blocks == 0 or sent[0] % self.blocks:
            raise RuntimeError(f"{sent[0]} {kind} bytes over {self.blocks} "
                               f"blocks")
        return sent[0] // self.blocks


def _count(kind: str, fn, shards) -> int:
    fn.tally.reset()
    fn(shards)
    return fn.tally.per_shard_block(kind, len(shards))


def count_exchange_wire_bytes(fn, shards) -> int:
    """Per-shard, per-block FIELD bytes the engines sent while `fn(shards)`
    ran (`fn` a distributed step or run): the summed sizes of every band
    message, whichever engine moved it. Checksum words are counted by
    `count_integrity_bytes` instead, so this count is the same with
    verification on or off. The counted side of
    `roofline.halo_wire_bytes_model`."""
    return _count("wire", fn, shards)


def count_integrity_bytes(fn, shards) -> int:
    """Per-shard, per-block CHECKSUM bytes (one 4-byte word per band
    message of a verified exchange; 0 unverified) sent while `fn(shards)`
    ran. The counted side of `roofline.integrity_bytes_model`."""
    return _count("integrity", fn, shards)


# ---------------------------------------------------------------------------
# shards of a global field
# ---------------------------------------------------------------------------


def shard(mesh: StencilMesh, u, v, w) -> Shards:
    """Split global (X, Y, Z) fields into the mesh's (X/nx, Y/ny, Z)
    shards, each contiguous on its device."""
    nx, ny = mesh.shape
    X, Y = u.shape[0], u.shape[1]
    if X % nx or Y % ny:
        raise ValueError(f"grid ({X}, {Y}) not divisible by mesh "
                         f"({nx}, {ny}); the mesh requires even shards")
    Xl, Yl = X // nx, Y // ny
    out = []
    for s, dev in enumerate(mesh.devices):
        ix, iy = mesh.coords(s)
        out.append(tuple(f[ix * Xl:(ix + 1) * Xl, iy * Yl:(iy + 1) * Yl]
                         .to(dev).contiguous() for f in (u, v, w)))
    return out


def gather(mesh: StencilMesh, shards: Shards, device=None):
    """The global (u, v, w) of `shards`, on `device` (default: the first
    shard's)."""
    dev = shards[0][0].device if device is None else torch.device(device)
    nx, ny = mesh.shape
    return tuple(
        torch.cat([torch.cat([shards[ix * ny + iy][f].to(dev)
                              for iy in range(ny)], dim=1)
                   for ix in range(nx)], dim=0)
        for f in range(3))


# ---------------------------------------------------------------------------
# the two engines
# ---------------------------------------------------------------------------


def _ring(mesh: StencilMesh, s: int, axis: str, delta: int) -> int:
    n = mesh.axis_size(axis)
    return mesh.index(dma_neighbor_coords(mesh.axis_names, mesh.coords(s),
                                          axis, delta, n))


def _exchange_halos(mesh: StencilMesh, fs: Sequence[torch.Tensor],
                    axis: str, depth: int, dim: int, *, tally=None,
                    integrity_out=None, corrupt=None):
    """The collective engine for one field: per shard `(hi, lo)`, the
    `depth` planes (dim 0) or rows (dim 1) just below and just above the
    shard along the ring `axis`. Hop k moves min(L, depth-(k-1)L) of them
    from the k-away neighbour, a tensor copy to the receiver's device, so
    the total is `depth` whatever the hop count.

    `tally` (a `_Tally`) adds up what each shard sends; `integrity_out` (a
    list per shard) receives one mismatch indicator per received band,
    from a `band_checksum` word moved beside it; `corrupt=(rows, value)`
    damages every shard's hop-1 hi band after the sender's checksum."""
    tally = _Tally() if tally is None else tally
    L = fs[0].shape[dim]
    hi_parts = [[] for _ in fs]
    lo_parts = [[] for _ in fs]
    for k, cnt, _, _ in _band_schedule(L, depth):
        for r, dst in enumerate(fs):
            for side, src, lo in ((0, _ring(mesh, r, axis, -k), L - cnt),
                                  (1, _ring(mesh, r, axis, k), 0)):
                sent = fs[src].narrow(dim, lo, cnt)
                got = sent.to(dst.device, copy=True)
                tally.add("wire", src, sent.numel() * sent.element_size())
                if integrity_out is not None:
                    word = K.band_checksum(sent).to(dst.device)
                    tally.add("integrity", src, R.INTEGRITY_WORD_ITEMSIZE)
                if corrupt is not None and side == 0 and k == 1:
                    got = _corrupt_band(got, dim, min(corrupt[0], cnt),
                                        corrupt[1])
                if integrity_out is not None:
                    integrity_out[r].append(K.band_checksum(got) != word)
                (hi_parts if side == 0 else lo_parts)[r].append(got)
    # hi: farthest predecessor first, so global coordinates ascend
    return [(torch.cat(h[::-1], dim=dim), torch.cat(lo, dim=dim))
            for h, lo in zip(hi_parts, lo_parts)]


def _exchange_band_dma(mesh: StencilMesh, shards: Shards, axis: str,
                       depth: int, dim: int, block_index: int,
                       slabs: K.BandSlabs, tally: _Tally, *,
                       integrity_out=None, corrupt=None) -> Shards:
    """The remote_dma engine: K7 over every shard's (u, v, w) into `slabs`'
    extended slabs; returns per shard the extended (u, v, w), views of
    slot `block_index % 2`. On CPU shards the integrity words and the
    fault hook ride K7's plain version as its `wire`."""
    wire = None
    if integrity_out is not None or corrupt is not None:
        def wire(m, sent, got):
            if integrity_out is not None:
                word = K.band_checksum(sent).to(got.device)
                tally.add("integrity", m.sender, R.INTEGRITY_WORD_ITEMSIZE)
            if (corrupt is not None and m.field == corrupt[0]
                    and m.side == 0 and m.k == 1):
                got = _corrupt_band(got, dim, min(corrupt[1], m.cnt),
                                    corrupt[2])
            if integrity_out is not None:
                integrity_out[m.receiver].append(K.band_checksum(got)
                                                 != word)
            return got
    K.halo_band_exchange_dma(shards, mesh=mesh, axis=axis, depth=depth,
                             dim=dim, block_index=block_index, slabs=slabs,
                             wire=wire)
    for s, nbytes in enumerate(slabs.messages(axis)[1]):
        tally.add("wire", s, nbytes)
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
                            exchange: str, mesh: StencilMesh) -> None:
    """Build-time validation of the integrity knobs: K7 on a CUDA mesh
    carries neither a checksum channel nor a fault hook."""
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
        if not (0 <= int(fi) < 3):
            raise ValueError(f"corrupt_halo field index must be 0..2, "
                             f"got {fi}")
        if int(depth) < 1:
            raise ValueError(f"corrupt_halo depth must be >= 1, "
                             f"got {depth}")


def _on(params: AdvectParams, device, cache: dict) -> AdvectParams:
    if device not in cache:
        cache[device] = AdvectParams(*(torch.as_tensor(leaf, device=device)
                                       for leaf in params))
    return cache[device]


class _LocalBlock:
    """One substep-block over every shard of the mesh: the shared body of
    `make_distributed_step` (one block) and `make_distributed_run` (K
    blocks, the block index feeding K7's slot). Holds K7's extended slabs,
    tables and counters, and each shard's interior masks, from one block
    to the next. `corrupt_halo=(field, rows, value)` damages that field's
    hop-1 hi band on the last exchanged phase (y when y is decomposed,
    else x)."""

    def __init__(self, mesh: StencilMesh, params: AdvectParams, *, T: int,
                 dt: float, local_kernel: str, y_tile: Optional[int],
                 overlap: bool, exchange: str,
                 verify_integrity: bool = False, corrupt_halo=None):
        self.mesh, self.params, self.T, self.dt = mesh, params, T, dt
        self.local_kernel, self.y_tile = local_kernel, y_tile
        self.overlap, self.exchange = overlap, exchange
        self.verify, self.corrupt_halo = verify_integrity, corrupt_halo
        self.buffers: Optional[K.ExtendedBuffers] = None
        self.slabs: Dict[str, K.BandSlabs] = {}
        self.tally = _Tally()
        self._params: dict = {}
        self._masks: dict = {}

    def _mask(self, x_int, y_int, device):
        """A pass's interior mask in the form its local kernel takes: the
        (x, y) f32 pair of K1, or one broadcast bool for the reference; a
        None mask leaves that axis all-interior (the slab edge is the true
        boundary)."""
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
        mesh, T = self.mesh, self.T
        n_x, n_y = mesh.shape
        X_g, Y_g = n_x * Xl, n_y * Yl
        ix, iy = mesh.coords(s)
        dev = mesh.devices[s]

        def interior(lo, n, extent):
            g = lo + torch.arange(n, device=dev)
            return (g >= 1) & (g <= extent - 2)

        # global-interior masks over the slab coordinates
        ext = self._mask(interior(ix * Xl - dx, Xl + 2 * dx, X_g) if dx
                         else None,
                         interior(iy * Yl - dy, Yl + 2 * dy, Y_g) if dy
                         else None, dev)
        own = sel = None
        if self.overlap and (dx or dy):
            # interior pass: owned slab only; the cut edges contaminate < T
            # cells inward, which the select drops
            own = self._mask(interior(ix * Xl, Xl, X_g) if dx else None,
                             interior(iy * Yl, Yl, Y_g) if dy else None, dev)
            sx = torch.arange(Xl, device=dev)
            sy = torch.arange(Yl, device=dev)
            ok_x = torch.ones(Xl, dtype=torch.bool, device=dev)
            ok_y = torch.ones(Yl, dtype=torch.bool, device=dev)
            if dx:
                ok_x = (((ix == 0) | (sx >= T))
                        & ((ix == n_x - 1) | (sx < Xl - T)))
            if dy:
                ok_y = (((iy == 0) | (sy >= T))
                        & ((iy == n_y - 1) | (sy < Yl - T)))
            sel = (ok_x[:, None] & ok_y[None, :])[:, :, None]
        self._masks[key] = (ext, own, sel)
        return self._masks[key]

    def _substeps(self, us, vs, ws, mask):
        """T masked Euler substeps on a (halo'd) slab under `_mask`'s
        mask."""
        p = _on(self.params, us.device, self._params)
        T, dt = self.T, self.dt
        if self.local_kernel == "fused":
            return K.advect_fused(us, vs, ws, p, T=T, dt=dt,
                                  y_tile=self.y_tile, x_interior_mask=mask[0],
                                  y_interior_mask=mask[1])
        m = mask
        for _ in range(T):
            su, sv, sw = pw_advect_ref(us, vs, ws, p)
            us = us + dt * torch.where(m, su, 0.0)
            vs = vs + dt * torch.where(m, sv, 0.0)
            ws = ws + dt * torch.where(m, sw, 0.0)
        return us, vs, ws

    def _band_slabs(self, shape, dx: int, dy: int) -> None:
        """K7's extended slabs for shards of `shape`, made once: one set of
        buffers padded by (dx, dy), the x phase landing in its middle rows
        and the y phase over all of it."""
        if self.buffers is not None and (self.buffers.shape,
                                         self.buffers.pad) == (shape,
                                                               (dx, dy)):
            return
        Xl, Yl, Z = shape
        self.buffers = K.ExtendedBuffers(self.mesh, shape, (dx, dy))
        self.slabs = {}
        if dx:
            self.slabs["x"] = K.BandSlabs(self.mesh, shape, dx, 0,
                                          buffers=self.buffers, window=dy)
        if dy:
            self.slabs["y"] = K.BandSlabs(self.mesh, (Xl + 2 * dx, Yl, Z),
                                          dy, 1, buffers=self.buffers)

    def _extend(self, fields: Shards, axis: str, dim: int, block_index,
                integrity_out, corrupt_dim) -> Shards:
        """One phase: every shard's (u, v, w) extended by T planes/rows on
        both sides along `dim`, whichever engine moved them. With
        `remote_dma` the slabs are views of K7's persistent buffers, where
        the exchange put the shard and its bands; the collective engine
        concatenates."""
        T, ch = self.T, self.corrupt_halo
        if self.exchange == "remote_dma":
            corrupt = (None if ch is None or corrupt_dim != dim
                       else (int(ch[0]), int(ch[1]), ch[2]))
            return _exchange_band_dma(self.mesh, fields, axis, T, dim,
                                      block_index, self.slabs[axis],
                                      self.tally,
                                      integrity_out=integrity_out,
                                      corrupt=corrupt)
        per_field = []
        for fi in range(3):
            corrupt = (None if ch is None or corrupt_dim != dim
                       or fi != int(ch[0]) else (int(ch[1]), ch[2]))
            per_field.append(_exchange_halos(
                self.mesh, [f[fi] for f in fields], axis, T, dim,
                tally=self.tally, integrity_out=integrity_out,
                corrupt=corrupt))
        bands = [tuple(pf[s] for pf in per_field)
                 for s in range(len(fields))]
        return [tuple(torch.cat([hi, f, lo], dim=dim)
                      for f, (hi, lo) in zip(trio, b))
                for trio, b in zip(fields, bands)]

    def _exchange(self, shards: Shards, block_index, dx: int, dy: int,
                  integrity_out=None, corrupt_dim=None) -> Shards:
        """The two-phase exchange: x first, then y on the x-extended slab;
        per shard the (u, v, w) the boundary pass reads."""
        fields = shards
        if self.exchange == "remote_dma":
            self._band_slabs(tuple(shards[0][0].shape), dx, dy)
        if dx:
            fields = self._extend(fields, "x", 0, block_index,
                                  integrity_out, corrupt_dim)
        if dy:
            fields = self._extend(fields, "y", 1, block_index,
                                  integrity_out, corrupt_dim)
        return fields

    def check(self) -> None:
        """Raise when a K7 kernel of this block's mesh timed out."""
        for slabs in self.slabs.values():
            slabs.check()

    def __call__(self, shards: Shards, block_index: int):
        mesh, T = self.mesh, self.T
        n_x, n_y = mesh.shape
        if len(shards) != len(mesh.devices):
            raise ValueError(f"{len(shards)} shards given for a mesh of "
                             f"{len(mesh.devices)}")
        Xl, Yl, _ = shards[0][0].shape
        X_g, Y_g = n_x * Xl, n_y * Yl
        dx = T if n_x > 1 else 0
        dy = T if n_y > 1 else 0
        if dy and T > Y_g - 2:
            raise ValueError(
                f"halo depth T={T} exceeds the decomposable global Y "
                f"extent ({Y_g} rows, interior {Y_g - 2}); lower T")
        if dx and T > X_g - 2:
            raise ValueError(
                f"halo depth T={T} exceeds the decomposable global X "
                f"extent ({X_g} planes, interior {X_g - 2}); lower T")
        self.tally.blocks += 1
        integrity_out = [[] for _ in shards] if self.verify else None
        corrupt_dim = None
        if self.corrupt_halo is not None and (dx or dy):
            corrupt_dim = 1 if dy else 0

        fields = self._exchange(shards, block_index, dx, dy, integrity_out,
                                corrupt_dim)
        out = []
        for s, (own, ext) in enumerate(zip(shards, fields)):
            ext_mask, own_mask, sel = self._shard_masks(s, Xl, Yl, dx, dy)
            # boundary pass (consumes the exchange), trimmed to owned rows
            bnd = tuple(f[dx:dx + Xl, dy:dy + Yl]
                        for f in self._substeps(*ext, ext_mask))
            if sel is None:
                out.append(tuple(f.contiguous() for f in bnd))
                continue
            inner = self._substeps(*own, own_mask)
            out.append(tuple(torch.where(sel, i, b)
                             for i, b in zip(inner, bnd)))
        mismatch = None
        if self.verify:
            mismatch = [sum((m.to(torch.int64).sum() for m in ms),
                            torch.zeros((), dtype=torch.int64,
                                        device=own[0].device))
                        for ms, own in zip(integrity_out, shards)]
        return out, mismatch


def _flags(mesh: StencilMesh, mismatch) -> torch.Tensor:
    """Per-shard mismatch counts as an (nx, ny) int64 tensor on the CPU."""
    return torch.stack([m.cpu() for m in mismatch]).reshape(mesh.shape)


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

    `verify_integrity=True` makes the step return ``(shards, flags)``,
    flags being the (nx, ny) int64 per-shard count of band checksum
    mismatches (`check_integrity` raises on any); the fields are the same
    bits as unverified. `corrupt_halo=(field_idx, rows, value)` is the
    matching fault hook. `spec=` waits for a later slice."""
    if spec is not None or spec_params is not None:
        raise NotImplementedError(f"spec= {LATER_SLICE}")
    _check_integrity_config(verify_integrity, corrupt_halo, exchange, mesh)
    _check_step_config(T, local_kernel, exchange)
    block = _LocalBlock(mesh, params, T=T, dt=dt, local_kernel=local_kernel,
                        y_tile=y_tile, overlap=overlap, exchange=exchange,
                        verify_integrity=verify_integrity,
                        corrupt_halo=corrupt_halo)

    def step(shards: Shards):
        out, mismatch = block(shards, dma_block_index)
        block.check()
        return (out, _flags(mesh, mismatch)) if verify_integrity else out

    step.tally = block.tally
    return step


def make_distributed_run(mesh: StencilMesh, params: AdvectParams, *,
                         n_blocks: int, T: int = 1, dt: float = 1.0,
                         local_kernel: str = "reference",
                         y_tile: Optional[int] = None,
                         overlap: bool = False,
                         exchange: str = "collective",
                         verify_integrity: bool = False,
                         checkpoint_every: Optional[int] = None,
                         checkpoint_dir=None, spec=None, spec_params=None):
    """Returns run(shards): `n_blocks` substep-blocks (n_blocks * T Euler
    substeps, one depth-T exchange per block), block k exchanging into
    K7's recv slot k % 2 through slabs and counters kept across the
    blocks. Exactly `n_blocks` sequential `make_distributed_step` calls
    with `dma_block_index = 0 .. n_blocks-1`, bitwise. With
    `verify_integrity` the run returns ``(shards, flags)``, the counts
    summed over the blocks. `checkpoint_every`, `checkpoint_dir` and
    `spec=` wait for a later slice."""
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
    if checkpoint_every is not None or checkpoint_dir is not None:
        raise NotImplementedError(f"checkpointed runs {LATER_SLICE}")
    if spec is not None or spec_params is not None:
        raise NotImplementedError(f"spec= {LATER_SLICE}")
    _check_integrity_config(verify_integrity, None, exchange, mesh)
    _check_step_config(T, local_kernel, exchange)
    block = _LocalBlock(mesh, params, T=T, dt=dt, local_kernel=local_kernel,
                        y_tile=y_tile, overlap=overlap, exchange=exchange,
                        verify_integrity=verify_integrity)

    def run(shards: Shards):
        total = None
        for k in range(n_blocks):
            shards, mismatch = block(shards, k)
            if verify_integrity:
                total = (mismatch if total is None
                         else [a + b for a, b in zip(total, mismatch)])
        block.check()
        return (shards, _flags(mesh, total)) if verify_integrity else shards

    run.tally = block.tally
    return run


def reference_global(u, v, w, params: AdvectParams):
    """Single-device oracle for the distributed version."""
    return pw_advect_ref(u, v, w, params)


def reference_global_step(u, v, w, params: AdvectParams, *, T: int = 1,
                          dt: float = 1.0):
    """Single-device T-substep oracle for `make_distributed_step`."""
    for _ in range(T):
        u, v, w = pw_step_ref(u, v, w, params, dt)
    return u, v, w
