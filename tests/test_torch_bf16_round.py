"""The bf16 rounding routes of `csrc/bf16_round.cu`, emulated in torch on
the CPU in the device helpers' operation order, against torch's own
f32 -> bf16 conversion (`x.to(torch.bfloat16).float()`, round to nearest
even): every one of the 2^16 high halves with the low halves at and around
a tie, the special values (each routed as its helper routes it) and a
seeded sample.

K1/K5 and K6 round by `rpk<true>` (`csrc/cells.cuh`, the route
"pack_hi"): one `cvt.rn.bf16x2.f32` of the value and 0.0f rounds each lane
to nearest even into one 32-bit word, the value's bf16 in the high half
and zero in the low half, so the word is that bf16 value as an f32. The
card checks every route on all 2^32 patterns (`chip_smoke.py` phase
47)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.kernels import bf16_round as BR

MASK32 = 0xFFFFFFFF
LOW_HALVES = (0x0000, 0x7FFF, 0x8000, 0x8001, 0xFFFF)
SPLIT_TOP = 237 << 24
SPECIALS = np.array([
    0x00000000, 0x80000000,              # +-0
    0x00000001, 0x80000001, 0x00008000, 0x00018000, 0x007FFFFF,
    0x007F8000, 0x00408000, 0x80408001,  # subnormals, ties among them
    0x00800000, 0x00808000, 0x80818000,  # f32's least normal, ties
    0x77000000, 0x77008000, 0x77FFFFFF,  # 2^111 and past it
    0x76FFFFFF, 0x76FF8000,              # just below 2^111
    0x7F7F7FFF, 0x7F7F8000, 0x7F7FFFFF,  # near bf16's largest / f32's
    0xFF7F8000, 0xFF7FFFFF,
    0x7F800000, 0xFF800000,              # +-Inf
    0x7FC00000, 0xFFC00000, 0x7F800001, 0x7F808000, 0x7FFFFFFF,
    0xFFFFFFFF, 0x7FBF8000,              # NaNs, quiet and signalling
], dtype=np.int64)


def patterns(kind: str) -> torch.Tensor:
    """f32 bit patterns as int64 in [0, 2^32)."""
    if kind == "ties":
        hi = np.arange(1 << 16, dtype=np.int64) << 16
        return torch.from_numpy((hi[:, None] | np.array(LOW_HALVES)).ravel())
    if kind == "specials":
        return torch.from_numpy(SPECIALS)
    rng = np.random.default_rng(34)
    return torch.from_numpy(rng.integers(0, 1 << 32, size=1 << 18,
                                         dtype=np.int64))


def as_f32(bits: torch.Tensor) -> torch.Tensor:
    signed = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return signed.to(torch.int32).view(torch.float32)


def bits_of(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & MASK32


def reference(bits: torch.Tensor) -> torch.Tensor:
    """torch's conversion to bf16, widened: what `__float2bfloat16_rn`
    gives."""
    return as_f32(bits).to(torch.bfloat16).float()


# --- the routes, in the device helpers' order of operations ----------------

def cvt_rn(bits: torch.Tensor) -> torch.Tensor:
    """One lane of `cvt.rn.bf16x2.f32` (and of `cvt.rn.bf16.f32`): the bf16
    half, round to nearest even, a NaN to the canonical NaN."""
    half = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    return torch.where(nan, torch.full_like(bits, 0x7FFF), half)


def route_cvt(bits):
    return as_f32(cvt_rn(bits) << 16)


def route_pair(bits):
    """Two values a paired convert (lanes a and b are patterns i and
    i + n / 2), then `bf16_lo` and `bf16_hi`."""
    n = bits.numel() // 2
    lo, hi = bits[:n], bits[n:2 * n]
    word = cvt_rn(lo) | (cvt_rn(hi) << 16)
    out = torch.cat([(word << 16) & MASK32, word & 0xFFFF0000])
    if bits.numel() % 2:
        out = torch.cat([out, (cvt_rn(bits[-1:]) << 16)])
    return as_f32(out)


def split(x: torch.Tensor) -> torch.Tensor:
    """h = c - (c - x), c = x * 65537, each op an f32 op rounded alone."""
    c = x * torch.tensor(65537.0, dtype=torch.float32)
    return c - (c - x)


def split_key(bits: torch.Tensor) -> torch.Tensor:
    return (bits + bits - 0x01000000) & MASK32


def route_split_round(bits):
    x = as_f32(bits)
    return torch.where(split_key(bits) < SPLIT_TOP, split(x),
                       route_cvt(bits))


def route_split_cell(bits):
    """Cells of two values (patterns i and i + n / 2, as the card's check
    pairs them): the split on both, and converts for a cell whose worst
    key reached the top."""
    n = bits.numel() // 2
    a, b = bits[:n], bits[n:2 * n]
    worst = torch.maximum(split_key(a), split_key(b))
    ok = worst < SPLIT_TOP
    out = [torch.where(ok, split(as_f32(p)), route_cvt(p)) for p in (a, b)]
    if bits.numel() % 2:
        out.append(route_split_round(bits[-1:]))
    return torch.cat(out)


def route_int_rne(bits):
    r = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    return as_f32(torch.where(nan, (bits | 0x00400000) & 0xFFFF0000, r))


def route_mix(bits):
    """Pairs for one half of a step's values, split_cell for the other:
    each value both ways, both must agree with the convert."""
    return route_pair(bits), route_split_cell(bits)


def route_pack_hi(bits):
    """`rpk<true>`: one value a paired convert whose low lane is 0.0f; the
    word, as an f32, is the value's bf16 widened."""
    return as_f32((cvt_rn(bits) << 16) | cvt_rn(torch.zeros_like(bits)))


ROUTES = {"cvt": route_cvt, "pair": route_pair,
          "split_round": route_split_round, "split_cell": route_split_cell,
          "int_rne": route_int_rne, "mix": route_mix,
          "pack_hi": route_pack_hi}


def agrees(got: torch.Tensor, bits: torch.Tensor) -> bool:
    want = reference(bits)
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(bits_of(got)[~nan], bits_of(want)[~nan]))


@pytest.mark.parametrize("kind", ("ties", "specials", "random"))
@pytest.mark.parametrize("route", BR.ROUTES)
def test_route_rounds_as_the_convert(route, kind):
    bits = patterns(kind)
    got = ROUTES[route](bits)
    for g in (got if isinstance(got, tuple) else (got,)):
        assert agrees(g, bits)


def test_the_chosen_route_is_pack_hi_and_every_route_is_emulated():
    assert BR.ROUTE == "pack_hi"
    assert set(BR.ROUTES) == set(ROUTES)
    assert BR.PATTERNS == 1 << 32


@pytest.mark.parametrize("bits, why, split_wrong", [
    (0x00000000, "zero", False), (0x80000000, "negative zero", False),
    (0x00000001, "the least subnormal", True),
    (0x00408001, "a subnormal past a tie", True),
    (0x777FFFFF, "just below 2^112", True),
    (0x7F800000, "Inf", True), (0x7FC00000, "NaN", False)])
def test_the_split_guard_sends_its_out_of_range_values_to_the_convert(
        bits, why, split_wrong):
    """Zero, subnormals, |x| >= 2^111, Inf and NaN lie at or past the
    key's top, so `split_round` converts them: the split alone rounds a
    subnormal to 8 significant bits where bf16 keeps fewer, overflows
    near 2^112 (NaN) and turns Inf into NaN; zero and NaN it would get
    right."""
    b = torch.tensor([bits], dtype=torch.int64)
    assert int(split_key(b)) >= SPLIT_TOP, why
    assert agrees(route_split_round(b), b), why
    assert agrees(split(as_f32(b)), b) != split_wrong, why


def test_the_split_is_exact_across_the_normal_range_below_2_111():
    """Every biased exponent 1..237 at ties and their neighbours: the split
    alone already rounds as the convert."""
    e = torch.arange(1, 238, dtype=torch.int64)
    mant = torch.tensor([0x000000, 0x007FFF, 0x008000, 0x008001, 0x018000,
                         0x7F8000, 0x7FFFFF], dtype=torch.int64)
    bits = ((e[:, None] << 23) | mant).ravel()
    bits = torch.cat([bits, bits | (1 << 31)])
    assert bool((split_key(bits) < SPLIT_TOP).all())
    assert agrees(split(as_f32(bits)), bits)


def test_the_pair_widenings_are_exact():
    """`bf16_lo` and `bf16_hi` of a packed word give back both lanes'
    bf16 values exactly, for every bf16 pattern in either lane."""
    half = torch.arange(1 << 16, dtype=torch.int64)
    word = half | (half.flip(0) << 16)
    lo = as_f32((word << 16) & MASK32)
    hi = as_f32(word & 0xFFFF0000)
    for got, h in ((lo, half), (hi, half.flip(0))):
        want = as_f32(h << 16)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(bits_of(got)[~nan], bits_of(want)[~nan])


def test_the_route_kernels_are_built_and_declared():
    assert "bf16_round.cu" in _build.SOURCES
    assert "cells.cuh" in _build.HEADERS
    for name in ("bf16_round_check", "bf16_round_rate", "bf16_round_chains"):
        assert name in _build.SIGNATURES
    src = (_build.CSRC / "bf16_round.cu").read_text()
    for i, route in enumerate(BR.ROUTES):
        assert f"//   {i} {route} " in src, route


# --- the bf16x2 ops of the rungs' pair build -----------------------------------

TORCH_OPS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}


def bf16_of_f64(x: torch.Tensor) -> torch.Tensor:
    """f64 values rounded to bf16 directly (not through f32): nearest even
    at 8 significant bits, subnormals on bf16's grid of 2^-133, overflow to
    Inf, NaN to the canonical NaN; the bf16 bit patterns as int64."""
    ax = x.abs()
    e = ((ax.view(torch.int64) >> 52) & 0x7FF) - 1023   # ax in [2^e, 2^e+1)
    qe = torch.clamp(e - 7, min=-133)          # the bf16 quantum's exponent
    quantum = ((qe + 1023) << 52).view(torch.float64)
    val = torch.round(ax / quantum) * quantum  # exact scalings; half to even
    val = torch.where((val >= 2.0 ** 128) | torch.isinf(ax), torch.inf, val)
    bits = (val.float().view(torch.int32).to(torch.int64) >> 16) & 0x7FFF
    bits |= torch.signbit(x).to(torch.int64) << 15
    return torch.where(torch.isnan(x), 0x7FC0, bits)


def bf16_values(bits: torch.Tensor) -> torch.Tensor:
    """bf16 patterns (int64) as exact f32 values."""
    return as_f32((bits & 0xFFFF) << 16)


def structured_operands() -> torch.Tensor:
    """+-0, the ends of the subnormals, both ends of every binade (the
    largest finite value the last), +-Inf and NaN; the negative of every
    eighth binade's ends too. bf16 patterns as int64."""
    ends = [(e << 7) | m for e in range(1, 255) for m in (0x00, 0x7F)]
    neg = [b | 0x8000 for b in ends[::16] + ends[1::16]]
    special = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x807F, 0x7F80,
               0xFF80, 0x7FC0]
    return torch.tensor(special + ends + neg, dtype=torch.int64)


def same_or_both_nan(got: torch.Tensor, want: torch.Tensor) -> bool:
    nan = (want & 0x7FFF) > 0x7F80
    return bool(torch.equal((got & 0x7FFF) > 0x7F80, nan)
                and torch.equal(got[~nan], want[~nan]))


def f32_op_rounded(op: str, a: torch.Tensor, b: torch.Tensor):
    """The reference's bf16 op: the f32 op of the operands, rounded to bf16
    by torch's conversion (`rpk<true>`'s value); bf16 patterns."""
    out = TORCH_OPS[op](bf16_values(a), bf16_values(b)).to(torch.bfloat16)
    return out.view(torch.int16).to(torch.int64) & 0xFFFF


def f64_op_rounded(op: str, a: torch.Tensor, b: torch.Tensor):
    """The exact op's result rounded once to bf16: the f64 op (exact for *,
    and for + and - its own rounding lies far below bf16's), rounded
    directly."""
    return bf16_of_f64(TORCH_OPS[op](bf16_values(a).double(),
                                     bf16_values(b).double()))


@pytest.mark.parametrize("op", list(TORCH_OPS))
def test_the_f32_op_rounded_once_equals_the_f64_op_rounded_once(op):
    """The premise of the pair build: for every bf16 value against the
    structured operands, the f32 op rounded to bf16 equals the f64 op
    rounded to bf16 (sub in both orders; add and mul commute in both), the
    sign of zero included and NaN as NaN. f32's 24 bits are at least
    2 * 8 + 2, so the f32 rounding never moves a result across a bf16
    rounding boundary."""
    every = torch.arange(1 << 16, dtype=torch.int64)[:, None]
    for ops in structured_operands().split(32):
        ops = ops[None, :]
        orders = [(every, ops)] + ([(ops, every)] if op == "sub" else [])
        for x, y in orders:
            x, y = torch.broadcast_tensors(x, y)
            assert same_or_both_nan(f32_op_rounded(op, x, y),
                                    f64_op_rounded(op, x, y)), op


def test_the_direct_f64_rounding_is_bf16_round_to_nearest_even():
    """`bf16_of_f64` on values torch's f32 conversion rounds exactly (f64
    values that are f32 values): the same bits, ties to even, subnormals,
    overflow and NaN."""
    x = as_f32(torch.cat([patterns("ties"), patterns("specials")]))
    want = x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    assert same_or_both_nan(bf16_of_f64(x.double()), want)


def pair_instruction(op: str, wa: torch.Tensor, wb: torch.Tensor):
    """One bf16x2 instruction (`b2_add`, `b2_sub`, `b2_mul` of
    `csrc/cells.cuh`) on 32-bit words as int64: each lane (the low half
    first) the exact result rounded once to bf16, nearest even."""
    lo = f64_op_rounded(op, wa & 0xFFFF, wb & 0xFFFF)
    hi = f64_op_rounded(op, (wa >> 16) & 0xFFFF, (wb >> 16) & 0xFFFF)
    return lo | (hi << 16)


@pytest.mark.parametrize("kind", ("ties", "specials", "random"))
@pytest.mark.parametrize("op", BR.PAIR_OPS)
def test_pair_op_computes_each_lane_as_the_reference(op, kind):
    """Words of two bf16 values (a seeded sample, the specials' and the
    tie patterns as words): each lane of the pair op equals the reference's
    bf16 op of that lane's operands."""
    wa = patterns(kind) & MASK32
    gen = torch.Generator().manual_seed(35)
    wb = wa[torch.randperm(wa.numel(), generator=gen)]
    got = pair_instruction(op, wa, wb)
    for shift in (0, 16):
        a, b = (wa >> shift) & 0xFFFF, (wb >> shift) & 0xFFFF
        assert same_or_both_nan((got >> shift) & 0xFFFF,
                                f32_op_rounded(op, a, b))


def byte_perm(x: int, y: int, sel: int) -> int:
    """`__byte_perm(x, y, sel)`: byte i of the result is byte (sel's nibble
    i) of the eight bytes of x (0-3) and y (4-7)."""
    src = x | (y << 32)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 0x7))) & 0xFF) << (8 * i)
               for i in range(4))


def test_the_z_neighbour_words_are_one_byte_permutation():
    """`lds_z_pairs`: the word of cells (z - 1, z) is `__byte_perm(word
    before, own word, 0x5432)`, the word of (z + 1, z + 2) `__byte_perm(own
    word, word after, 0x5432)`."""
    cells = list(range(0x3F80, 0x3F80 + 16))     # a row of 16 bf16 cells
    words = [cells[2 * k] | (cells[2 * k + 1] << 16) for k in range(8)]
    for k in range(1, 7):
        z = 2 * k
        assert byte_perm(words[k - 1], words[k], 0x5432) == \
            cells[z - 1] | (cells[z] << 16)
        assert byte_perm(words[k], words[k + 1], 0x5432) == \
            cells[z + 1] | (cells[z + 2] << 16)


def test_the_pair_ops_are_built_and_declared():
    for name in ("bf16_pair_check", "bf16_pair_rate"):
        assert name in _build.SIGNATURES
    assert BR.PAIR_OPS == ("add", "sub", "mul")
    src = (_build.CSRC / "bf16_round.cu").read_text()
    cells = (_build.CSRC / "cells.cuh").read_text()
    for op, intrinsic in (("add", "__hadd2_rn"), ("sub", "__hsub2_rn"),
                          ("mul", "__hmul2_rn")):
        assert f"b2_{op}" in src and intrinsic in cells
