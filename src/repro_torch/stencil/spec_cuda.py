"""K6 for user-written specs: a spec's source callback, traced once on
proxies and emitted as a CUDA functor of the spec ring
(`csrc/stencil_fused.cuh`), in the form of the shipped ones
(`csrc/stencil_ops.cuh`), then built at first use beside the shipped
kernels (`_build.load_generated`).

The trace calls `spec.source(sh, pv)` once. `sh(f, dx, dy, dz)` returns a
field read, a leaf, at any offset within the spec's radius. `pv` is a tuple
of vector proxies: `pv[i][j]` (an int j >= 0) is a scalar coefficient, and
a slice of `pv[i]` whose stop is negative or None (such as `t1[2:][1:-1]`,
or `t[2:][2:-2]` at radius 2) is a z-coefficient vector, the cell at
interior z reading element ``start + z - radius`` (the launch checks that
the slice holds exactly the Z - 2 * radius interior cells). The nodes:
`+`, `-`, `*`, `/`, unary minus, `abs()` / `torch.abs`, `torch.sqrt`,
`torch.minimum` and `torch.maximum` (between traced values, NaN
propagating as torch's), the comparisons `<`, `<=`, `>`, `>=`, `==` and
`!=` (between traced values or numbers), which only `torch.where` takes
as its condition, and `torch.where(cond, a, b)` (a and b traced values or
numbers; both are computed, as torch computes them), each keeping its
operands in the callback's order; Python numbers are weak scalars. Every
proxy carries a sample tensor for each storage build (f32; bf16 fields
with f32 coefficients; both bf16), dimensioned as the plain version's
coefficients are (`spec.CoefVector`), and each node learns its result
dtype from torch's own promotion of its operands' samples: an op that is
bf16 with bf16 fields rounds with `rpk<RF>` (`csrc/cells.cuh`: the
convert's round to nearest even by one paired convert, off the conversion
unit), one that is bf16 only with bf16 coefficients too with `rpk<RC>`,
and a product by a number +-2^k, k >= 0, exact in its operand's dtype,
with neither. Each of these operations is
correctly rounded or exact in CUDA without fast math (a division by a
Python number is emitted as torch runs it on the card, a product with the
f32 reciprocal), so with `--fmad=false` the kernel rounds as the callback
does in torch on the card, bitwise.

The trace also fixes the ring's shape (`Generated`): the radius, the x
offsets the callback reads off the centre row (x-diagonal reads: the ring
keeps a shared plane of each such slice), and from those and the field
count the builds (`Generated.builds`: the cells per thread and threads per
block of each, and the most ring levels a pass takes, so that the ring's
registers do not spill).

The tracer does not know how many vectors `pack_params` returns: it runs
the callback on 0, 1, 2, ... vectors and keeps the first count it
accepts.

Refused, with NotImplementedError naming ROADMAP Queue 2, before any
build and launch: the transcendental functions (`torch.exp`, `log`,
`tanh`, ...), powers, floor division and modulo, any other function or
attribute; a Python branch on a traced value (`if a > b:`, `bool()`,
`float()`); a comparison used as a number; a coefficient indexed another
way (from the end, with a step, by a slice whose stop is positive).

The emitted text is deterministic, so is its digest, which keys its
build; a spec whose text equals a shipped spec's runs the shipped
functor."""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import operator
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import _build

MAX_VECTORS = 8      # the most parameter vectors the tracer offers
QUEUE = "ROADMAP Queue 2"
# (field dtype, coefficient dtype) of the three storage builds
STORAGES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
            (torch.bfloat16, torch.bfloat16))
# which storages make a node bf16 -> its rounding in the functor
_ROUNDING = {(False, False, False): None, (False, True, True): "RF",
             (False, False, True): "RC"}
# the shipped functor whose builds (threads per block by cells per thread)
# a generated one takes, by field count, where its ring is a shipped one's
# (radius 1, no x-diagonal read): one field as diffusion, two and three as
# PW, four as the tracer. Any other ring takes `RING_TIERS`.
BUILDS_LIKE = {1: 2, 2: 0, 3: 0, 4: 1}
# the threads per block of a build whose ring keeps at most this many
# floats a thread (`Generated.ring_floats`), the tiers of the shipped
# builds that do not spill (PW's 2-cell ring 60 floats at 512 threads, the
# tracer's 80 at 384, diffusion's 4-cell 40 at 512); a build past the last
# tier is not made, and a ring past it even at 2 cells and the fewest
# levels runs at `RING_LAST_THREADS`
RING_TIERS = ((60, 512), (96, 384), (128, 256))
RING_LAST_THREADS = 128
# a generated ring takes no more levels a pass than keep the largest block
# of its builds a slab of at least SLAB_PER_HALO x its halo rows of a
# PLAN_Z-cell column (the paper's grids' Z): past that, a pass computes
# more halo rows than rows it owns
PLAN_Z = 64
SLAB_PER_HALO = 4
# zeros the launch lays before and after each of a generated functor's
# parameter vectors, per cell of its radius (`Generated.pad`), so that
# every window cell's z-coefficient read, walls included, lies inside its
# vector
PAD = 1
HEADER = ("// K6 functor generated by repro_torch.stencil.spec_cuda from a "
          "StencilSpec's\n// source callback (its terms in the callback's "
          "order); do not edit.\n")
_ARITH = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div}
_REFLECTED = {"+": "__radd__", "-": "__rsub__", "*": "__rmul__",
              "/": "__rtruediv__"}
_COMPARE = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
            ">=": operator.ge, "==": operator.eq, "!=": operator.ne}
_PICK = {"min": (torch.minimum, "fminf"), "max": (torch.maximum, "fmaxf")}
_UNARY = {"abs": torch.abs, "sqrt": torch.sqrt}
_TYPE = {"cmp": "bool"}      # a node's C type in the functor, by kind


class Refused(NotImplementedError):
    """A spec K6 has no CUDA instantiation for."""


class _SpecBug(ValueError):
    """A callback that breaks its spec's own contract (raised as the plain
    version's accessor raises it)."""


def _refuse(name: str, why: str):
    raise Refused(
        f"spec {name!r} has no CUDA instantiation: {why}. K6 generates "
        f"kernels for specs of any radius and field count whose source is "
        f"built from + - * /, abs, sqrt, minimum, maximum and where on "
        f"comparisons of field reads, coefficients and numbers; the rest "
        f"(transcendental functions, powers, Python branches on traced "
        f"values, coefficients indexed from a vector's end) is queued in "
        f"{QUEUE}. On CPU tensors the plain version runs any spec")


def _literal(value) -> str:
    """A Python number as the f32 the op computes with (torch takes a
    weak scalar in the op's f32 opmath), an exact hex literal."""
    return float(np.float32(value)).hex() + "f"


def _reciprocal(value) -> str:
    """The f32 reciprocal of a Python number, as torch's CUDA kernel of a
    tensor divided by a CPU scalar computes it (``opmath(1) / b``) and then
    multiplies by it."""
    with np.errstate(divide="ignore"):
        return _literal(np.float32(1.0) / np.float32(value))


def _arith(o: str, x, y):
    """x o y in torch, x a tensor or (reflected) a Python number."""
    if torch.is_tensor(x):
        return _ARITH[o](x, y)
    return getattr(y, _REFLECTED[o])(x)


def _exact_scale(node) -> bool:
    """Whether an "op" node is a product of a traced value and a number
    +-2^k, k >= 0, or its quotient by +-2^-k: exact in the value's dtype,
    which is the node's (a weak number keeps it), so a bf16 ring need not
    round it."""
    _, o, a, b = node
    if o not in ("*", "/"):
        return False
    num = [x for x in (a, b) if not isinstance(x, int)]
    if len(num) != 1 or (o == "/" and not isinstance(a, int)):
        return False
    m = np.float32(abs(float(np.float32(num[0][1]))))
    if o == "/":
        with np.errstate(divide="ignore", over="ignore"):
            m = np.float32(1.0) / m
    return bool(np.isfinite(m) and m >= 1.0 and np.frexp(m)[0] == 0.5)


def _rounding_of(dtypes) -> Optional[str]:
    key = tuple(d == torch.bfloat16 for d in dtypes)
    if key not in _ROUNDING:
        raise AssertionError(f"a node is bf16 in the storages {key}")
    return _ROUNDING[key]


class _Graph:
    """The nodes of one trace, in the order the callback made them (which
    is an order in which every node follows its operands)."""

    def __init__(self, spec):
        self.spec = spec
        self.nodes = []       # ("field", f, dx, dy, dz) | ("coef", slot) |
        #                       ("zvec", slot) | ("neg" | "abs" | "sqrt", a)
        #                       | ("op", o, a, b) | ("pick", "min" | "max",
        #                       a, b) | ("cmp", o, a, b, rounding of a
        #                       number operand) | ("where", c, a, b)
        self.samples = []     # per node: a sample per storage
        self.reads = []       # per node: whether it reads a field
        self.scalars = []     # (vector, element, cut): a slot each
        self.zslots = []      # (vector, start, cut): a slot each

    def refuse(self, why: str):
        _refuse(self.spec.name, why)

    def leaf(self, key, samples, reads=False) -> "_Node":
        self.nodes.append(key)
        self.samples.append(samples)
        self.reads.append(reads)
        return _Node(self, len(self.nodes) - 1)

    def sh(self, fi, dx, dy, dz):
        spec = self.spec
        for c in (fi, dx, dy, dz):
            if not isinstance(c, int) or isinstance(c, bool):
                self.refuse(f"sh({fi!r}, {dx!r}, {dy!r}, {dz!r}) takes ints")
        if not 0 <= fi < spec.n_fields:
            raise _SpecBug(f"spec {spec.name!r}: field index {fi} of "
                           f"{spec.n_fields} fields")
        if max(abs(dx), abs(dy), abs(dz)) > spec.radius:
            raise _SpecBug(f"field {spec.fields[fi]!r}: source reads offset "
                           f"({dx}, {dy}, {dz}) beyond the declared radius "
                           f"{spec.radius}")
        return self.leaf(("field", fi, dx, dy, dz),
                         tuple(torch.ones((2, 2, 2), dtype=fd)
                               for fd, _ in STORAGES), reads=True)

    def _slot(self, table: list, key) -> int:
        if key not in table:
            table.append(key)
        return table.index(key)

    def coef(self, vec: int, element: int, cut: int) -> "_Node":
        slot = self._slot(self.scalars, (vec, element, cut))
        return self.leaf(("coef", slot), tuple(torch.ones(1, dtype=cd)
                                               for _, cd in STORAGES))

    def zvec(self, vec: int, start: int, cut: int) -> "_Node":
        slot = self._slot(self.zslots, (vec, start, cut))
        return self.leaf(("zvec", slot), tuple(torch.ones(2, dtype=cd)
                                               for _, cd in STORAGES))

    def operand(self, x, numbers: bool = True):
        """A node's operand: a node's index, or (where `numbers`) a Python
        number."""
        if isinstance(x, _Vector):
            x = x.leaf()
        if isinstance(x, _Node):
            if x.g is not self:
                self.refuse("it mixes two traces")
            return x.i
        if numbers and isinstance(x, (int, float)) and \
                not isinstance(x, bool):
            if not np.isfinite(np.float32(x)):
                self.refuse(f"it takes the constant {x!r}, which is not "
                            f"finite in float32")
            return ("const", x)
        what = ("fields, coefficients and Python numbers" if numbers
                else "fields and coefficients")
        self.refuse(f"it takes an operand of type {type(x).__name__} "
                    f"({what} only)")

    def value(self, x, numbers: bool = True):
        """`operand`, refusing a comparison where a number is meant."""
        a = self.operand(x, numbers)
        if isinstance(a, int) and self.nodes[a][0] == "cmp":
            self.refuse("it uses a comparison as a number (a comparison is "
                        "only the condition of torch.where)")
        return a

    def _sample(self, a, s: int):
        return self.samples[a][s] if isinstance(a, int) else a[1]

    def _reads(self, *args) -> bool:
        return any(isinstance(v, int) and self.reads[v] for v in args)

    def _each(self, fn, *args):
        return tuple(fn(*(self._sample(a, s) for a in args))
                     for s in range(len(STORAGES)))

    def op(self, o: str, x, y) -> "_Node":
        a, b = self.value(x), self.value(y)
        return self.leaf(("op", o, a, b),
                         self._each(functools.partial(_arith, o), a, b),
                         self._reads(a, b))

    def unary(self, kind: str, x) -> "_Node":
        a = self.value(x, numbers=False)
        fn = (lambda t: -t) if kind == "neg" else _UNARY[kind]
        return self.leaf((kind, a), self._each(fn, a), self._reads(a))

    def neg(self, x) -> "_Node":
        return self.unary("neg", x)

    def pick(self, which: str, x, y) -> "_Node":
        a, b = self.value(x, numbers=False), self.value(y, numbers=False)
        return self.leaf(("pick", which, a, b),
                         self._each(_PICK[which][0], a, b),
                         self._reads(a, b))

    def compare(self, o: str, x, y) -> "_Node":
        a, b = self.value(x), self.value(y)
        # a number operand takes the comparison's common dtype
        common = tuple(torch.result_type(self._sample(a, s),
                                         self._sample(b, s))
                       for s in range(len(STORAGES)))
        samples = self._each(_COMPARE[o], a, b)
        return self.leaf(("cmp", o, a, b, _rounding_of(common)), samples,
                         self._reads(a, b))

    def where(self, c, x, y) -> "_Node":
        ci = self.operand(c, numbers=False)
        if self.nodes[ci][0] != "cmp":
            self.refuse("its torch.where takes a condition that is not a "
                        "comparison of traced values")
        a, b = self.value(x), self.value(y)
        return self.leaf(("where", ci, a, b),
                         self._each(torch.where, ci, a, b),
                         self._reads(ci, a, b))

    def rounding(self, i: int) -> Optional[str]:
        return _rounding_of(t.dtype for t in self.samples[i])


def _refusing(what: str):
    def method(self, *args, **kwargs):
        self.g.refuse(f"its source applies {what}")
    return method


# torch functions a traced value takes, by the graph's method
_FUNCTIONS = {torch.abs: lambda g, x: g.unary("abs", x),
              torch.sqrt: lambda g, x: g.unary("sqrt", x),
              torch.minimum: lambda g, x, y: g.pick("min", x, y),
              torch.maximum: lambda g, x, y: g.pick("max", x, y),
              torch.where: lambda g, c, x, y: g.where(c, x, y)}


class _Proxy:
    """What both proxies refuse: every operation the functor cannot run."""
    __slots__ = ()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        flat = [a for x in args for a in (x if isinstance(x, (list, tuple))
                                          else (x,))]
        proxy = next((a for a in flat if isinstance(a, _Proxy)), None)
        name = proxy.g.spec.name if proxy is not None else "?"
        if func in _FUNCTIONS and not kwargs and proxy is not None:
            try:
                return _FUNCTIONS[func](proxy.g, *args)
            except TypeError:
                pass
        _refuse(name, f"its source calls {getattr(func, '__name__', func)}")

    def __getattr__(self, name):
        self.g.refuse(f"its source reads attribute {name!r} of an operand")

    __floordiv__ = __rfloordiv__ = _refusing("floor division")
    __mod__ = __rmod__ = _refusing("a modulo")
    __pow__ = __rpow__ = _refusing("a power")
    __matmul__ = __rmatmul__ = _refusing("a matrix product")
    __bool__ = _refusing("a truth test: a Python branch on a traced value "
                         "(use torch.where)")
    __float__ = __int__ = __index__ = _refusing("a conversion to a number")
    __array__ = _refusing("numpy")


def _binary(o: str, reflected: bool = False):
    if reflected:
        return lambda self, x: self.g.op(o, x, self)
    return lambda self, x: self.g.op(o, self, x)


def _comparison(o: str):
    return lambda self, x: self.g.compare(o, self, x)


class _Node(_Proxy):
    __slots__ = ("g", "i")

    def __init__(self, g: _Graph, i: int):
        self.g, self.i = g, i

    __add__, __radd__ = _binary("+"), _binary("+", True)
    __sub__, __rsub__ = _binary("-"), _binary("-", True)
    __mul__, __rmul__ = _binary("*"), _binary("*", True)
    __truediv__, __rtruediv__ = _binary("/"), _binary("/", True)
    __lt__, __le__ = _comparison("<"), _comparison("<=")
    __gt__, __ge__ = _comparison(">"), _comparison(">=")
    __eq__, __ne__ = _comparison("=="), _comparison("!=")
    __hash__ = object.__hash__

    def __neg__(self):
        return self.g.neg(self)

    def __pos__(self):
        return self

    def __abs__(self):
        return self.g.unary("abs", self)

    __getitem__ = _refusing("an index to a field expression")
    __iter__ = _refusing("iteration to a field expression")


def _through_leaf(name: str):
    def method(self, *args):
        return getattr(self.leaf(), name)(*args)
    return method


class _Vector(_Proxy):
    """`pv[vec]` cut to elements [start, len - cut)."""
    __slots__ = ("g", "vec", "start", "cut")

    def __init__(self, g: _Graph, vec: int, start: int = 0, cut: int = 0):
        self.g, self.vec, self.start, self.cut = g, vec, start, cut

    def __getitem__(self, k):
        if isinstance(k, int) and not isinstance(k, bool):
            if k < 0:
                self.g.refuse(f"it indexes parameter vector {self.vec} from "
                              f"its end ({k})")
            return self.g.coef(self.vec, self.start + k, self.cut)
        if isinstance(k, slice):
            start = 0 if k.start is None else k.start
            stop = k.stop
            if k.step not in (None, 1) or not isinstance(start, int) or \
                    start < 0 or not (stop is None or (isinstance(stop, int)
                                                       and stop < 0)):
                self.g.refuse(f"it slices parameter vector {self.vec} as "
                              f"[{k.start}:{k.stop}:{k.step}], which does not "
                              f"line up with z (a z-coefficient vector is a "
                              f"slice [a:-b] or [a:] with a >= 0)")
            return _Vector(self.g, self.vec, self.start + start,
                           self.cut + (0 if stop is None else -stop))
        self.g.refuse(f"it indexes parameter vector {self.vec} by {k!r}")

    def leaf(self) -> _Node:
        return self.g.zvec(self.vec, self.start, self.cut)

    __add__, __radd__ = _through_leaf("__add__"), _through_leaf("__radd__")
    __sub__, __rsub__ = _through_leaf("__sub__"), _through_leaf("__rsub__")
    __mul__, __rmul__ = _through_leaf("__mul__"), _through_leaf("__rmul__")
    __truediv__ = _through_leaf("__truediv__")
    __rtruediv__ = _through_leaf("__rtruediv__")
    __neg__, __abs__ = _through_leaf("__neg__"), _through_leaf("__abs__")
    __lt__, __le__ = _through_leaf("__lt__"), _through_leaf("__le__")
    __gt__, __ge__ = _through_leaf("__gt__"), _through_leaf("__ge__")
    __eq__, __ne__ = _through_leaf("__eq__"), _through_leaf("__ne__")
    __hash__ = object.__hash__

    __iter__ = _refusing("iteration to a parameter vector (its length is "
                         "not known to the tracer)")
    __len__ = _refusing("len() to a parameter vector")


@dataclasses.dataclass(frozen=True)
class Generated:
    """A generated functor: its header (`text`, the key of its build), the
    traced graph it was emitted from (`nodes`, and the node of each field's
    source, `outs`), and what the launch needs of it: its fields, its
    z-coefficient slots ``(vector, start, cut)`` and scalar slots
    ``(vector, element, cut)``, the vectors the callback ran on (`used`,
    the fewest it takes), and its ring's shape: the radius, the x offsets
    `plane_lo`..`plane_hi` of its reads off the centre row (0, 0 where it
    reads no x neighbour there) and the floats the ring lays before its
    shared memory (`head`)."""
    text: str
    n_fields: int
    zslots: Tuple[Tuple[int, int, int], ...]
    scalars: Tuple[Tuple[int, int, int], ...]
    used: int
    nodes: Tuple[tuple, ...] = ()
    outs: Tuple[int, ...] = ()
    radius: int = 1
    plane_lo: int = 0
    plane_hi: int = 0
    head: int = 0

    @property
    def n_vectors(self) -> int:
        """The z-coefficient vectors the kernel stages per window cell."""
        return len(self.zslots)

    @property
    def lag(self) -> int:
        """Slices a ring level trails the level below: the radius, or one
        past the largest x offset read off the centre row."""
        return max(self.radius, self.plane_hi + 1)

    @property
    def slots(self) -> int:
        """Shared planes a level and field keeps: one per x offset read off
        the centre row, and the one the step writes."""
        return self.plane_hi - self.plane_lo + 2

    @property
    def like(self) -> Optional[int]:
        """The shipped functor id whose builds this one takes, or None
        where its ring is not a shipped one's."""
        if self.radius == 1 and self.lag == 1 and self.slots == 2:
            return BUILDS_LIKE.get(self.n_fields)
        return None

    def ring_floats(self, levels: int, cells: int, stages: int) -> int:
        """Floats a thread keeps across steps at `levels` ring levels and
        `cells` cells: each level's slices j-R .. j+LAG-1 and the newest,
        the slice loaded ahead, and rk2's base FIFO where it holds more
        than the step's own slice."""
        hold = self.lag - self.radius + 1
        held = levels // 2 * hold if stages == 2 and hold > 1 else 0
        return cells * self.n_fields * (levels * (self.radius + self.lag)
                                        + 2 + held)

    def _builds_at(self, levels: int, stages: int) -> Dict[int, int]:
        """{cells per thread: threads per block} by `RING_TIERS` for a ring
        of `levels` levels (a 2-cell build at `RING_LAST_THREADS` where
        none fits)."""
        out = {}
        for c in (2, 4):
            n = self.ring_floats(levels, c, stages)
            tier = next((t for most, t in RING_TIERS if n <= most), None)
            if tier is not None:
                out[c] = tier
        return out or {2: RING_LAST_THREADS}

    def max_levels(self, stages: int) -> int:
        """The most ring levels a pass runs: `_build.K6_MAX_LEVELS` for a
        shipped ring (`like`), else the most whose 2-cell ring fits the
        last of `RING_TIERS` and whose builds' largest block holds a slab
        of `SLAB_PER_HALO` x the halo (radius x levels) rows of a
        `PLAN_Z`-cell column; the fewest (one step) where none does."""
        if self.like is not None:
            return _build.K6_MAX_LEVELS
        fits = [L for L in range(stages, _build.K6_MAX_LEVELS + 1, stages)
                if self.ring_floats(L, 2, stages) <= RING_TIERS[-1][0]
                and max(c * n for c, n in self._builds_at(L, stages).items())
                >= SLAB_PER_HALO * self.radius * L * PLAN_Z]
        return max(fits, default=stages)

    def builds(self, stages: int) -> Dict[int, int]:
        """{cells per thread: threads per block} of its builds at
        `stages`: the shipped functor's of its field count (`like`), else
        by `RING_TIERS` at `max_levels`."""
        if self.like is not None:
            return dict(_build.K6_BUILDS[self.like, stages])
        return self._builds_at(self.max_levels(stages), stages)

    @property
    def pad(self) -> int:
        """Zeros the launch lays before and after each parameter vector."""
        return PAD * self.radius

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.text.encode()).hexdigest()[:16]

    def check_vectors(self, name: str, pv, Z: int) -> None:
        """Raise, before any launch, where the parameter vectors do not fit
        the trace: too few of them, a scalar past a vector's end, or a
        z-coefficient slice that does not hold the Z - 2 * radius interior
        cells."""
        if len(pv) < self.used:
            raise ValueError(f"spec {name!r}: its source indexes "
                             f"{self.used} parameter vectors, got {len(pv)}")
        for vec, element, cut in self.scalars:
            if element + cut >= pv[vec].shape[0]:
                raise ValueError(f"spec {name!r}: coefficient {element} of "
                                 f"parameter vector {vec} (cut by {cut}) is "
                                 f"past its {pv[vec].shape[0]} elements")
        inner = Z - 2 * self.radius
        for vec, start, cut in self.zslots:
            n = pv[vec].shape[0] - start - cut
            if n != inner:
                _refuse(name, f"the slice [{start}:{-cut or ''}] of parameter "
                        f"vector {vec} ({pv[vec].shape[0]} elements) holds "
                        f"{n} cells where z has Z - {2 * self.radius} = "
                        f"{inner} interior cells, so it does not line up "
                        f"with z")


def _operands(node) -> tuple:
    """The operand indices and constants of a node, in its order."""
    kind = node[0]
    if kind in ("neg", "abs", "sqrt"):
        return node[1:2]
    if kind in ("op", "pick", "cmp"):
        return node[2:4]
    if kind == "where":
        return node[1:4]
    return ()


def _shape(g: _Graph) -> Tuple[int, int, int]:
    """(plane_lo, plane_hi, head) of the trace: the x offsets of its reads
    off the centre row (0, 0 where there are none at an x neighbour), and
    the floats the ring lays before its shared memory so that a read at
    dy = -R, dz < 0 of its first plane row stays inside it where no z
    coefficient lies there."""
    R = g.spec.radius
    off_row = [n for n in g.nodes if n[0] == "field" and (n[3] or n[4])]
    xs = [n[2] for n in off_row] or [0]
    head = 0
    if not g.zslots:
        head = max([-n[4] for n in off_row if n[3] == -R and n[4] < 0],
                   default=0)
    return min(xs), max(xs), head


def _emit(g: _Graph, outs) -> str:
    R = g.spec.radius
    lo, hi, head = _shape(g)

    def operand(a, rounding=None) -> str:
        if isinstance(a, int):
            return f"t{a}"
        lit = _literal(a[1])
        return f"rpk<{rounding}>({lit})" if rounding else lit

    def rounded(body: str, r) -> str:
        return f"rpk<{r}>({body})" if r else f"({body})"

    def expr(i: int) -> str:
        node = g.nodes[i]
        kind = node[0]
        if kind == "field":
            _, f, dx, dy, dz = node
            return f"at<{f}, {dx}, {dy}, {dz}>(sh)"
        if kind == "coef":
            return f"k.s{node[1]}"
        if kind == "zvec":
            return f"sh.zc[{node[1]}]"
        if kind == "neg":
            return f"-{operand(node[1])}"
        if kind == "abs":
            return f"fabsf({operand(node[1])})"
        if kind == "sqrt":
            return rounded(f"sqrtf({operand(node[1])})", g.rounding(i))
        if kind == "pick":
            _, which, a, b = node
            x, y = operand(a), operand(b)
            return (f"({x} != {x} ? {x} : {y} != {y} ? {y} : "
                    f"{_PICK[which][1]}({x}, {y}))")
        if kind == "cmp":
            _, o, a, b, r = node
            return f"({operand(a, r)} {o} {operand(b, r)})"
        if kind == "where":
            _, c, a, b = node
            r = g.rounding(i)
            return f"({operand(c)} ? {operand(a, r)} : {operand(b, r)})"
        _, o, a, b = node
        if o == "/" and not isinstance(b, int):
            body = f"{operand(a)} * {_reciprocal(b[1])}"
        else:
            body = f"{operand(a)} {o} {operand(b)}"
        return rounded(body, None if _exact_scale(node) else g.rounding(i))

    def chain(table, pick) -> str:
        if not table:
            return "0"
        text = str(pick(table[-1]))
        for p in range(len(table) - 2, -1, -1):
            text = f"p == {p} ? {pick(table[p])} : {text}"
        return text

    nz = len(g.zslots)
    lines = [HEADER, "#pragma once", "", "struct GeneratedOp {",
             f"  static constexpr int kFields = {len(outs)};",
             f"  static constexpr int kVectors = {nz};"]
    lines.append(f"  static constexpr int kRadius = {R}, kPlaneLo = {lo}, "
                 f"kPlaneHi = {hi}, kHead = {head};")
    lines += ["  __device__ static constexpr int zvec(int p) {",
              f"    return {chain(g.zslots, lambda s: s[0])};", "  }",
              "  __device__ static constexpr int zoff(int p) {",
              f"    return {chain(g.zslots, lambda s: s[1] - R + PAD * R)};",
              "  }"]
    if g.scalars:
        names = ", ".join(f"s{i}" for i in range(len(g.scalars)))
        loads = ", ".join(f"pv[{v} * (size_t)p_len + {e + PAD * R}]"
                          for v, e, _ in g.scalars)
        lines += ["  struct Coef {", f"    float {names};", "  };",
                  "  __device__ __forceinline__ static Coef coef("
                  "const float* pv, int p_len) {",
                  f"    return {{{loads}}};", "  }"]
    else:
        lines += ["  struct Coef {};",
                  "  __device__ __forceinline__ static Coef coef("
                  "const float*, int) {", "    return {};", "  }"]
    lines += ["  template <int FI, bool RF, bool RC, class Cell>",
              "  __device__ __forceinline__ static float source("
              "const Cell& sh, const Coef& k) {"]
    for f, out in enumerate(outs):
        need, stack = set(), [out]
        while stack:
            i = stack.pop()
            if i in need:
                continue
            need.add(i)
            stack += [a for a in _operands(g.nodes[i]) if isinstance(a, int)]
        lines.append(f"    {'if' if f == 0 else '} else if'} constexpr "
                     f"(FI == {f}) {{")
        lines += [f"      const {_TYPE.get(g.nodes[i][0], 'float')} t{i} = "
                  f"{expr(i)};" for i in sorted(need)]
        lines.append(f"      return t{out};")
    lines += ["    } else {", "      return 0.0f;", "    }", "  }", "};", ""]
    return "\n".join(lines)


def _outputs(g: _Graph, srcs):
    spec = g.spec
    if not isinstance(srcs, (tuple, list)) or len(srcs) != spec.n_fields:
        raise _SpecBug(f"spec {spec.name!r} source returned "
                       f"{len(srcs) if isinstance(srcs, (tuple, list)) else srcs!r}"
                       f" for {spec.n_fields} fields")
    outs = []
    for f, s in enumerate(srcs):
        if isinstance(s, _Vector):
            s = s.leaf()
        if not isinstance(s, _Node) or s.g is not g or not g.reads[s.i]:
            g.refuse(f"the source of field {spec.fields[f]!r} reads no field")
        if g.nodes[s.i][0] == "cmp":
            g.refuse(f"the source of field {spec.fields[f]!r} is a "
                     f"comparison")
        outs.append(s.i)
    return outs


@functools.lru_cache(maxsize=None)
def _trace(source, name: str, fields: Tuple[str, ...], radius: int):
    """The `Generated` functor of `source` on a spec of these fields,
    traced once per callback."""
    view = _SpecView(name, fields, radius)
    last = None
    for n in range(MAX_VECTORS + 1):
        g = _Graph(view)
        try:
            srcs = source(g.sh, tuple(_Vector(g, i) for i in range(n)))
        except (Refused, _SpecBug):
            raise
        except (ValueError, IndexError) as e:
            last = e
            continue
        outs = _outputs(g, srcs)
        text = _emit(g, outs)
        lo, hi, head = _shape(g)
        return Generated(text, len(fields), tuple(g.zslots),
                         tuple(g.scalars), n, tuple(g.nodes), tuple(outs),
                         radius, lo, hi, head)
    _refuse(name, f"its source did not run on the tracer's 0 to "
            f"{MAX_VECTORS} parameter vectors (last: {last!r})")


@dataclasses.dataclass(frozen=True)
class _SpecView:
    name: str
    fields: Tuple[str, ...]
    radius: int

    @property
    def n_fields(self) -> int:
        return len(self.fields)


def evaluate(gen: Generated, sh, pv):
    """The traced graph run in torch, node by node in its order: `sh` an
    accessor as a callback takes it, `pv` the parameter vectors; a scalar
    coefficient is dimensioned (a (1,) slice) and a Python number weak, as
    the callback sees them. What the functor computes, in torch: equal to
    the callback where the trace is faithful to it."""
    vals = []

    def operand(a):
        return vals[a] if isinstance(a, int) else a[1]

    for node in gen.nodes:
        kind = node[0]
        if kind == "field":
            vals.append(sh(*node[1:]))
        elif kind == "coef":
            vec, element, _ = gen.scalars[node[1]]
            vals.append(pv[vec][element:element + 1])
        elif kind == "zvec":
            vec, start, cut = gen.zslots[node[1]]
            vals.append(pv[vec][start:pv[vec].shape[0] - cut])
        elif kind == "neg":
            vals.append(-operand(node[1]))
        elif kind in _UNARY:
            vals.append(_UNARY[kind](operand(node[1])))
        elif kind == "pick":
            vals.append(_PICK[node[1]][0](operand(node[2]),
                                          operand(node[3])))
        elif kind == "cmp":
            vals.append(_COMPARE[node[1]](operand(node[2]),
                                          operand(node[3])))
        elif kind == "where":
            vals.append(torch.where(*(operand(a) for a in node[1:4])))
        else:
            vals.append(_arith(node[1], operand(node[2]), operand(node[3])))
    return tuple(vals[i] for i in gen.outs)


def trace(spec) -> Generated:
    """The generated functor of `spec`'s source; raises `Refused` (a
    NotImplementedError naming ROADMAP Queue 2) for a spec K6 cannot run."""
    return _trace(spec.source, spec.name, tuple(spec.fields), spec.radius)


@functools.lru_cache(maxsize=None)
def shipped_texts() -> dict:
    """{generated text: functor id} of the shipped specs' callbacks."""
    from repro_torch.stencil import spec as SP
    out = {}
    for factory in (SP.pw_advection_spec, SP.tracer_advection_spec,
                    SP.diffusion_spec):
        spec = factory()
        out[trace(spec).text] = spec.cuda_op
    return out


def instantiation(spec):
    """What runs `spec` in K6 on the card: a shipped functor's id (the
    spec's own `cuda_op`, or the one whose generated text the spec's equals)
    or its `Generated` functor; raises `Refused` for a spec K6 cannot run."""
    if spec.cuda_op is not None:
        return spec.cuda_op
    gen = trace(spec)
    return shipped_texts().get(gen.text, gen)
