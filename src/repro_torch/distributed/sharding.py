"""Logical-axis sharding rules as DTensor placements, and the TP-aware GQA
head layout (the port of `repro.distributed.sharding`; torch and numpy).

Parameters and activations are annotated with *logical* axes, which the
rules map onto mesh axes:

  * DP / FSDP : batch and parameter "embed-ish" dims over ``data`` (+ ``pod``)
  * TP        : heads / ffn / vocab / experts over ``model``
  * EP        : MoE experts over ``model``
  * SP        : long sequences over ``data`` where the op allows it

Dims that do not divide are dropped from a spec (`_divisible`), so every
shard has the same shape. Attention heads use a group-aligned stored
layout (`HeadLayout`) that pads or replicates q and kv heads so that the
head dim always divides the tensor-parallel degree.

One design decision differs from the reference. The reference runs one
controller under GSPMD: one process sees every device and the compiler
inserts the collectives. The port runs SPMD, one rank per card: a mesh is
a `torch.distributed` `DeviceMesh`, a sharded tensor is a `DTensor` whose
placements `sharding_for` derives from the rules, and the collectives come
from DTensor's redistributions. On one card the port stays a single
process: world size 1, or no process group at all (a `launch.mesh.HostMesh`,
under which `constrain` does nothing).

A `PartitionSpec` here is a tuple with one entry per tensor dimension:
None, a mesh-axis name, or a tuple of names (the first one major, as in
JAX). `spec_for` and `_divisible` read the mesh only through `axis_sizes`:
a `DeviceMesh`'s dimension names and sizes, or any object whose `.shape`
maps names to sizes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Head layout under tensor parallelism
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HeadLayout:
    """Stored (possibly padded/replicated) attention-head layout for a TP degree.

    q weights are stored as (embed, n_kv_stored * q_per_group, head_dim) and
    kv weights as (embed, n_kv_stored, head_dim). Stored group g corresponds
    to original kv head ``g // kv_repeat`` (or a dead pad group). Dead q heads
    are masked after attention so semantics match the unpadded model exactly.
    """

    n_q: int            # logical q heads
    n_kv: int           # logical kv heads
    tp: int
    n_kv_stored: int
    kv_repeat: int      # each original kv head stored this many times
    q_per_group: int    # stored q heads per stored kv group
    n_kv_dead: int      # trailing dead kv groups (pad case only)

    @property
    def n_q_stored(self) -> int:
        return self.n_kv_stored * self.q_per_group

    @property
    def q_live_fraction(self) -> float:
        return self.n_q / self.n_q_stored

    def q_head_mask(self) -> np.ndarray:
        """(n_q_stored,) 1.0 for live stored q heads, 0.0 for padding."""
        mask = np.zeros((self.n_q_stored,), np.float32)
        q_per_kv = self.n_q // self.n_kv
        for g in range(self.n_kv_stored - self.n_kv_dead):
            orig = g // self.kv_repeat
            slot = g % self.kv_repeat
            start = slot * self.q_per_group
            live = min(max(q_per_kv - start, 0), self.q_per_group)
            mask[g * self.q_per_group : g * self.q_per_group + live] = 1.0
        assert int(mask.sum()) == self.n_q, (mask.sum(), self.n_q)
        return mask

    def q_gather_index(self) -> np.ndarray:
        """(n_q_stored,) original q-head index feeding each stored slot (0 for dead)."""
        idx = np.zeros((self.n_q_stored,), np.int64)
        q_per_kv = self.n_q // self.n_kv
        for g in range(self.n_kv_stored - self.n_kv_dead):
            orig = g // self.kv_repeat
            slot = g % self.kv_repeat
            for j in range(self.q_per_group):
                src = slot * self.q_per_group + j
                if src < q_per_kv:
                    idx[g * self.q_per_group + j] = orig * q_per_kv + src
        return idx

    def kv_gather_index(self) -> np.ndarray:
        """(n_kv_stored,) original kv head stored in each group (0 for dead)."""
        idx = np.zeros((self.n_kv_stored,), np.int64)
        for g in range(self.n_kv_stored - self.n_kv_dead):
            idx[g] = g // self.kv_repeat
        return idx


def make_head_layout(n_q: int, n_kv: int, tp: int) -> HeadLayout:
    q_per_kv = n_q // n_kv
    assert n_q % n_kv == 0, "q heads must be a multiple of kv heads"
    if tp <= 1 or n_kv % tp == 0:
        # clean case: kv groups shard directly
        return HeadLayout(n_q, n_kv, tp, n_kv, 1, q_per_kv, 0)
    if tp % n_kv == 0:
        # replicate each kv head tp/n_kv times; split its q heads over copies
        rep = tp // n_kv
        qpg = math.ceil(q_per_kv / rep)
        return HeadLayout(n_q, n_kv, tp, tp, rep, qpg, 0)
    # pad kv heads up to a multiple of tp (e.g. MHA 20 heads on tp=16 -> 32)
    n_kv_stored = math.ceil(n_kv / tp) * tp
    return HeadLayout(n_q, n_kv, tp, n_kv_stored, 1, q_per_kv, n_kv_stored - n_kv)


# ---------------------------------------------------------------------------
# Logical axis -> mesh axis rules
# ---------------------------------------------------------------------------

# parameter / activation logical axes
Rules = Dict[str, Tuple[str, ...]]
PartitionSpec = Tuple


def make_rules(*, multi_pod: bool, shape_kind: str = "train",
               fsdp_over_pod: bool = False,
               seq_shard: bool = False,
               seq_parallel: bool = False) -> Rules:
    """Sharding rules for the production mesh.

    data-parallel batch spans (pod, data); FSDP parameter sharding spans
    ``data`` (optionally pod too); TP spans ``model``. ``seq_parallel``
    shards the residual-stream sequence dim over ``model`` between blocks
    (Megatron-SP; DTensor's redistributions do the boundary gathers and
    scatters). `shape_kind` changes nothing: a decode batch may be 1, and
    the channel dims carry the parallelism there too.
    """
    batch: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    fsdp: Tuple[str, ...] = (("pod", "data") if (multi_pod and fsdp_over_pod)
                             else ("data",))
    return {
        # parameters
        "embed": fsdp,
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": (),
        "ffn": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "expert_ffn": (),
        "expert_embed": (),            # EP-resident expert weights: no FSDP
        "opt_expert_embed": ("data",),  # ...but ZeRO-1 moments shard over data
        "state": (),
        "lowrank": (),
        "conv": (),
        "layers": (),
        "norm": (),
        # activations
        "batch": batch,
        "seq": ("data",) if seq_shard else (),
        "res_seq": ("model",) if seq_parallel else (),  # Megatron-SP boundary
        "act_embed": (),
        "act_heads": ("model",),
        "act_kv_heads": ("model",),
        "act_ffn": ("model",),
        "act_expert": ("model",),
        "act_vocab": ("model",),
    }


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh-axis name -> size: a `DeviceMesh`'s dimension names and sizes,
    or the `.shape` mapping of a `HostMesh` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _divisible(dim: int, axes: Tuple[str, ...], mesh) -> Tuple[str, ...]:
    """Drop mesh axes that don't divide the dim (every shard one shape)."""
    sizes = axis_sizes(mesh)
    kept = []
    prod = 1
    for a in axes:
        if a not in sizes:
            continue
        size = sizes[a]
        if dim % (prod * size) == 0:
            kept.append(a)
            prod *= size
    return tuple(kept)


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             rules: Rules, mesh) -> PartitionSpec:
    """The PartitionSpec of an array with the given logical axes."""
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    used = set()
    parts = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            parts.append(None)
            continue
        axes = rules.get(name, ())
        axes = tuple(a for a in axes if a not in used)
        axes = _divisible(dim, axes, mesh)
        used.update(axes)
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(tuple(axes))
    return tuple(parts)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """One DTensor placement a mesh dimension: `Shard(d)` where the spec
    puts that mesh axis on tensor dimension d, else `Replicate()`. An axis
    of size 1 is `Replicate()` either way: its one device holds every
    index, and DTensor's view rules refuse reshapes that merge or split a
    dimension sharded even over one device (a batch of 1, one kv head).

    DTensor splits a dimension sharded over several mesh dimensions in
    mesh-dimension order, the first the major one; JAX takes the spec's
    tuple order. The two give every device the same block where the tuple
    lists its axes in the mesh's order (the rules' ("pod", "data") does),
    and this raises ValueError where it does not."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of "
                             f"the mesh's order {tuple(names)}: DTensor "
                             f"would hand the devices other blocks than JAX")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh, a PartitionSpec and the spec's DTensor placements on it."""
    mesh: object
    spec: PartitionSpec
    placements: tuple


def sharding_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
                 rules: Rules, mesh) -> NamedSharding:
    spec = spec_for(shape, logical_axes, rules, mesh)
    return NamedSharding(mesh, spec, placements_for(spec, mesh))


def is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, logical_axes: Sequence[Optional[str]], rules: Rules,
              mesh):
    """Redistribute `x` to the placements of its logical axes. Does
    nothing without a `DeviceMesh` or when `x` is not a DTensor."""
    if mesh is None or not is_device_mesh(mesh) or not is_dtensor(x):
        return x
    sh = sharding_for(x.shape, logical_axes, rules, mesh)
    if tuple(x.placements) == sh.placements:
        return x
    return x.redistribute(mesh, sh.placements)


def per_group(fn, q, k, v):
    """fn(q, k, v) of attention operands, q (B, S, K, G, D) and k, v (B, S,
    K, D): on DTensors rank by rank (`local_map`), each rank attending its
    own batch rows and kv groups (dims 0 and 2) with the sequence, group
    and head dims whole; the output is placed as q. Plain tensors go to fn
    as they are. Raises ValueError for other placements."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    qpl, kpl, vpl = (list(t.placements) for t in (q, k, v))
    dims = {p.dim for p in qpl + kpl + vpl if isinstance(p, Shard)}
    if (kpl != vpl or kpl != qpl or not dims <= {0, 2}
            or any(p.is_partial() for p in qpl)):
        raise ValueError(f"attention on a mesh takes q, k, v sharded alike "
                         f"on the batch and kv-group dims only; got {qpl}, "
                         f"{kpl}, {vpl}")
    return local_map(fn, out_placements=qpl, in_placements=(qpl, kpl, vpl),
                     device_mesh=q.device_mesh)(q, k, v)


# ---------------------------------------------------------------------------
# Placing tensors onto a mesh, and gathering them back
# ---------------------------------------------------------------------------


def local_block(shape: Sequence[int], spec: PartitionSpec, mesh,
                coords: Sequence[int]) -> Tuple[slice, ...]:
    """The index block of a tensor of `shape` that the device at mesh
    coordinates `coords` holds under `spec`: on each dimension the
    mixed-radix index of its axes' coordinates, the first axis major (the
    block JAX's `devices_indices_map` gives that device)."""
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        block, n = 0, 1
        for a in spec_axes(entry):
            block = block * sizes[a] + coords[names.index(a)]
            n *= sizes[a]
        step = dim // n
        out.append(slice(block * step, (block + 1) * step))
    return tuple(out)


def vocab_offset(n: int, mesh, dims: Sequence[int]) -> int:
    """The first index this rank holds of a dimension of `n` split evenly
    over mesh `dims` (the first major, as `local_block` and DTensor's
    nested `Shard` lay blocks); raises where the split is uneven."""
    block, ranks = 0, 1
    for i in dims:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
        ranks *= mesh.size(i)
    if n % ranks:
        raise ValueError(f"a dimension of {n} does not split evenly over "
                         f"{ranks} ranks")
    return block * (n // ranks)


def place(x: torch.Tensor, sharding: NamedSharding):
    """A DTensor of the plain tensor `x` (the same on every rank) placed
    by `sharding`: each rank keeps only its own block, moved to the mesh's
    device type, so no rank holds a second full-size copy on the card."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    blk = local_block(x.shape, sharding.spec, mesh, mesh.get_coordinate())
    local = x[blk].to(_mesh_device(mesh)).contiguous()
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=x.shape,
                              stride=_contiguous_stride(x.shape))


def gather(x):
    """The plain full tensor of a DTensor (every rank gets it); any other
    value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))
