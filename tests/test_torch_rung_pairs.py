"""The v1-v3 rungs' two bf16 builds: which one runs, and what their C entry
points take.

On the card a bf16 rung computes two cells a 32-bit word (the pair build,
each bf16 op of both one bf16x2 instruction) where Z is even and every
field starts on a 4-byte boundary, else one cell at a time (each bf16 op an
f32 op rounded by `rpk`). The choice is `advection.rung_pairs`, made from
the shape and the alignment before the launch; both builds are held against
the plain version on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`
phases 35, 37 and 48). Here: the choice, the entry points' declared
arguments against the C sources, and the rounding the sources name."""
from __future__ import annotations

import re

import pytest
import torch

from repro_torch import _build
from repro_torch.kernels.advection import advection as TK

BF16 = torch.bfloat16


def offset(shape, dtype=BF16, cells=1):
    """A tensor of `shape` starting `cells` cells past an allocation."""
    n = 1
    for d in shape:
        n *= d
    return torch.zeros(n + cells, dtype=dtype)[cells:].view(shape)


@pytest.mark.parametrize("shape, pairs", [
    ((6, 10, 16), True), ((5, 17, 12), True), ((8, 12, 24), True),
    ((6, 10, 14), True), ((6, 10, 15), False), ((5, 9, 13), False),
    ((1024, 1024, 64), True)])
def test_the_pair_build_runs_at_even_z_on_aligned_fields(shape, pairs):
    fields = [torch.zeros(shape, dtype=BF16) for _ in range(3)]
    assert TK.rung_pairs(*fields) is pairs


@pytest.mark.parametrize("which", [0, 1, 2])
def test_one_field_off_a_4_byte_boundary_runs_the_one_cell_build(which):
    shape = (5, 9, 12)
    fields = [torch.zeros(shape, dtype=BF16) for _ in range(3)]
    assert TK.rung_pairs(*fields)
    fields[which] = offset(shape)
    assert fields[which].data_ptr() % 4 == 2
    assert not TK.rung_pairs(*fields)
    # two cells past the allocation is a 4-byte boundary again
    fields[which] = offset(shape, cells=2)
    assert TK.rung_pairs(*fields)


def test_f32_fields_have_no_pair_build():
    fields = [torch.zeros((6, 10, 16)) for _ in range(3)]
    assert not TK.rung_pairs(*fields)


def test_wide_fields_always_qualify_for_pairs():
    """`advect_wide` takes Z % 8 == 0 and 16-byte boundaries in bf16: every
    field it accepts runs the pair build (its only bf16 build)."""
    for Z in (8, 16, 24, 64):
        fields = [torch.zeros((5, 9, Z), dtype=BF16) for _ in range(3)]
        assert all(TK.base_address(f) % 16 == 0 for f in fields)
        assert TK.rung_pairs(*fields)


def c_entry_points() -> dict:
    """{name: [parameter names]} of every `extern "C"` function in the
    built sources."""
    out = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = m.group(2).strip()
            out[m.group(1)] = ([] if params in ("", "void") else
                               [p.split()[-1].lstrip("*")
                                for p in params.split(",")])
    return out


def test_every_declared_entry_point_takes_what_its_source_takes():
    """ctypes passes what `_build.SIGNATURES` declares: a count that does
    not match the C function would shift every argument after it (here the
    rung entry points' new `pairs` argument)."""
    entries = c_entry_points()
    for name, argtypes in _build.SIGNATURES.items():
        assert name in entries, name
        assert len(entries[name]) == len(argtypes), name


@pytest.mark.parametrize("name, ints", [
    ("advect_blocked_bf16", ("X", "Y", "Z", "TY", "S", "n_ty", "L",
                             "threads", "pairs", "fuse", "coef_bf16")),
    ("advect_dataflow_bf16", ("X", "Y", "Z", "TY", "S", "n_ty", "L", "R",
                              "threads", "vec", "pairs", "fuse",
                              "coef_bf16")),
    ("advect_blocked_bf16_attrs", ("coef_bf16", "pairs", "threads")),
    ("advect_dataflow_bf16_attrs", ("vec", "pairs", "coef_bf16",
                                    "threads"))])
def test_the_bf16_rung_entry_points_take_the_build(name, ints):
    """The int arguments in the order the wrapper passes them."""
    params = c_entry_points()[name]
    types = _build.SIGNATURES[name]
    got = tuple(p for p, t in zip(params, types) if t is _build._I)
    assert got == ints, name


def test_the_rungs_round_by_rpk_and_pair_ops():
    """pw_source.cuh rounds the one-cell build's bf16 ops by `rpk` (no
    `rnd`, which is a convert on the conversion unit) and computes the
    pair build's with the bf16x2 ops of cells.cuh."""
    text = (_build.CSRC / "pw_source.cuh").read_text()
    assert "rnd<" not in text
    assert "rpk<RF>" in text and "rpk<RC>" in text
    for op in ("b2_add(", "b2_sub(", "b2_mul(", "__byte_perm("):
        assert op in text, op
    assert "pw_source.cuh" in _build.HEADERS
