"""K6 for user-written specs: a spec's source callback, traced once on
proxies and emitted as a CUDA functor of the spec ring
(`csrc/stencil_fused.cuh`), in the form of the shipped ones
(`csrc/stencil_ops.cuh`), then built at first use beside the shipped
kernels (`_build.load_generated`).

The trace calls `spec.source(sh, pv)` once. `sh(f, dx, dy, dz)` returns a
field read, a leaf, at any offset within the spec's radius. `pv` is a tuple
of vector proxies: `pv[i][j]` is a scalar coefficient (j < 0 counts from the
vector's end), and a slice of `pv[i]` (step 1; any start and stop, such as
`t1[2:][1:-1]`, `t[2:][2:-2]` at radius 2 or `t[3:65]`) is a z-coefficient
vector, the cell at interior z reading its element ``z - radius`` (the
launch checks that the slice holds exactly the Z - 2 * radius interior
cells). A coefficient or slice whose first element is counted from the
vector's end is copied by the launch into a row of its own after the
vectors (`Generated.rows`), so that the generated text, which keys the
build, does not depend on a vector's length: one build serves every Z.

The nodes, each keeping its operands in the callback's order (Python
numbers are weak scalars): `+`, `-`, `*`, `/`, unary minus; `abs`, `sqrt`,
and the math functions `exp`, `expm1`, `log`, `log1p`, `tanh`, `sigmoid`,
`sin`, `cos`, `erf`, `rsqrt`, `reciprocal`, `floor`, `ceil` and `square`;
`torch.clamp` / `clamp_min` / `clamp_max` with number bounds; `**` /
`torch.pow` (value by number, number by value, value by value); `//` /
`torch.floor_divide` and `%` / `torch.remainder`; `torch.minimum` and
`torch.maximum` (NaN propagating as torch's); the comparisons `<`, `<=`,
`>`, `>=`, `==`, `!=` and `&`, `|`, `~` of comparisons, which are
`torch.where`'s condition or a number (1 or 0, promoted as torch promotes a
bool tensor); and `torch.where(cond, a, b)` (both branches computed, as
torch computes them). Each is accepted as a torch function (keyword
arguments included) and as a tensor method (`x.exp()`, `x.clamp(min=0.0)`).

Every proxy carries a sample tensor for each storage build (f32; bf16 fields
with f32 coefficients; both bf16), dimensioned as the plain version's
coefficients are (`spec.CoefVector`), and each node learns its result dtype
from torch's own promotion of its operands' samples: an op that is bf16 with
bf16 fields rounds with `rpk<RF>` (`csrc/cells.cuh`: the convert's round to
nearest even by one paired convert, off the conversion unit), one that is
bf16 only with bf16 coefficients too with `rpk<RC>`, and a product by a
number +-2^k, k >= 0, exact in its operand's dtype, with neither. Each node
computes what torch's CUDA kernel of its op computes, step by step
(`csrc/spec_math.cuh`): a division by a Python number as a product with the
f32 reciprocal; a math function in f32 by the CUDA math library, rounded
once for bf16; `sigmoid` as ``1 / (1 + exp(-x))``; a power by a number
through torch's special cases (0, 1, 0.5, -0.5, -1 on the number as given;
2, 3 and -2 on the number in the op's dtype); floor division and remainder
as torch's `fmod`-based kernels, in f32 and rounded once (a floor division
by a number also rounds its floor to bf16 before the last correction); a
number operand of a comparison, a remainder, a clamp or a power in the op's
dtype where torch takes it so. With `--fmad=false` the kernel then rounds
as the callback does in torch on the card, bitwise; `chip_smoke.py` phase
54 holds every node's device code against torch's op on the card over every
input of its probe (`probe_cases`).

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
build and launch: a Python branch on a traced value (`if a > b:`,
`bool()`), which JAX's trace refuses too; a conversion of a traced value
to a number (`float()`, `math.exp`); `torch.where` on a condition that is
not a comparison, which torch itself refuses for a float tensor; a value
torch types as an integer or a bool where a number is meant; a slice with
a step, which never lines up with z; any other function or attribute. At
the launch: a z-coefficient slice that does not hold the Z - 2 * radius
interior cells at the Z given.

The emitted text is deterministic, so is its digest, which keys its
build; a spec whose text equals a shipped spec's runs the shipped
functor."""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
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
_LOGIC = {"&": (operator.and_, "&&"), "|": (operator.or_, "||")}
_PICK = {"min": (torch.minimum, "fminf"), "max": (torch.maximum, "fmaxf")}
_UNARY = {"abs": torch.abs, "sqrt": torch.sqrt}
# the math functions ("fn" nodes): torch's function, and the device code
# of torch's CUDA kernel of it on the f32 (opmath) value {}
_MATH = {"exp": "expf({})", "expm1": "expm1f({})", "log": "logf({})",
         "log1p": "log1pf({})", "tanh": "tanhf({})",
         "sigmoid": "(1.0f / (1.0f + expf(-{})))", "sin": "sinf({})",
         "cos": "cosf({})", "erf": "erff({})", "rsqrt": "rsqrtf({})",
         "reciprocal": "(1.0f / {})", "floor": "floorf({})",
         "ceil": "ceilf({})"}
# the binary ops torch runs by a kernel of its own ("pow", "fdiv", "mod")
_BINARY = {"pow": torch.pow, "fdiv": torch.floor_divide,
           "mod": torch.remainder}
_BOOL = ("cmp", "logic", "not")   # nodes whose C type is bool


class Refused(NotImplementedError):
    """A spec K6 has no CUDA instantiation for."""


class _SpecBug(ValueError):
    """A callback that breaks its spec's own contract (raised as the plain
    version's accessor raises it)."""


def _refuse(name: str, why: str):
    raise Refused(
        f"spec {name!r} has no CUDA instantiation: {why}. K6 generates "
        f"kernels for specs of any radius and field count whose source is "
        f"built from field reads, coefficients and numbers by + - * /, "
        f"powers, floor division, remainders, torch's math functions, "
        f"clamps, minimum, maximum, comparisons and where; what is left (a "
        f"Python branch on a traced value or a conversion of one to a "
        f"number, as JAX's trace refuses them; where on a condition that is "
        f"not a comparison, as torch refuses it) is listed in {QUEUE}. On "
        f"CPU tensors the plain version runs any spec")


def _literal(value) -> str:
    """A Python number as the f32 the op computes with (torch takes a
    weak scalar in the op's f32 opmath), an exact hex literal; +-inf as
    its bits."""
    v = np.float32(value)
    if np.isinf(v):
        return "__int_as_float(0x7f800000)" if v > 0 else \
            "__int_as_float(0xff800000)"
    return float(v).hex() + "f"


def _reciprocal(value) -> str:
    """The f32 reciprocal of a Python number, as torch's CUDA kernel of a
    tensor divided by a CPU scalar computes it (``opmath(1) / b``) and then
    multiplies by it."""
    with np.errstate(divide="ignore"):
        return _literal(np.float32(1.0) / np.float32(value))


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


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


def _in_dtype(value, bf16: bool) -> float:
    """A Python number as torch converts a Scalar to the op's dtype
    (``Scalar::to<scalar_t>``: to f32, then to bf16 by round to nearest
    even)."""
    v = torch.tensor(float(np.float32(value)), dtype=torch.float32)
    return float(v.to(torch.bfloat16)) if bf16 else float(v)


# --- the parameter vectors' slots --------------------------------------------
#
# A slot is a tuple (vector, start, cut[, ops]). Without `ops`, the slot's
# view is elements [start, len - cut) of the vector (a scalar's is its one
# element `start`). With `ops`, the view is the vector's indices sliced by
# `ops` in turn (Python's own semantics, `_positions`): pairs (start, stop)
# and, for a scalar, a last int index. `start` is then the view's first
# element where no slice or index counts from the end (a read at a fixed
# element, whatever the length), else -1: the launch copies the view into a
# row of its own (`Generated.rows`).

def _positions(slot, n: int, scalar: bool = False) -> range:
    """The elements of a vector of n elements that `slot` (a scalar's,
    where `scalar`) reads; raises IndexError for a scalar past its view."""
    if len(slot) == 3:
        _, start, cut = slot
        if scalar:
            if start >= n - cut:
                raise IndexError(start)
            return range(start, start + 1)
        return range(start, max(start, n - cut))
    r = range(n)
    for op in slot[3]:
        if isinstance(op, tuple):
            r = r[op[0]:op[1]]
        else:
            r = r[op:op + 1] if op >= 0 else r[len(r) + op:len(r) + op + 1]
            if len(r) != 1:
                raise IndexError(op)
    return r


def _resolved(slot) -> bool:
    return len(slot) == 4 and slot[1] < 0


class _Graph:
    """The nodes of one trace, in the order the callback made them (which
    is an order in which every node follows its operands)."""

    def __init__(self, spec):
        self.spec = spec
        self.nodes = []       # ("field", f, dx, dy, dz) | ("coef", slot) |
        #                       ("zvec", slot) | ("neg" | "abs" | "sqrt", a)
        #                       | ("fn", name, a) | ("op", o, a, b) |
        #                       ("pow" | "fdiv" | "mod", a, b) | ("clamp",
        #                       a, lo, hi) | ("pick", "min" | "max", a, b) |
        #                       ("cmp", o, a, b, rounding of a number
        #                       operand) | ("logic", o, a, b) | ("not", a) |
        #                       ("where", c, a, b)
        self.samples = []     # per node: a sample per storage
        self.reads = []       # per node: whether it reads a field
        self.scalars = []     # scalar slots, a slot each
        self.zslots = []      # z-coefficient slots, a slot each
        self.used = 0         # the parameter vectors the callback ran on

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

    def coef(self, slot) -> "_Node":
        i = self._slot(self.scalars, slot)
        return self.leaf(("coef", i), tuple(torch.ones(1, dtype=cd)
                                            for _, cd in STORAGES))

    def zvec(self, slot) -> "_Node":
        i = self._slot(self.zslots, slot)
        return self.leaf(("zvec", i), tuple(torch.ones(2, dtype=cd)
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
        if numbers and _number(x):
            if not np.isfinite(np.float32(x)):
                self.refuse(f"it takes the constant {x!r}, which is not "
                            f"finite in float32")
            return ("const", x)
        what = ("fields, coefficients and Python numbers" if numbers
                else "fields and coefficients")
        self.refuse(f"it takes an operand of type {type(x).__name__} "
                    f"({what} only)")

    def _sample(self, a, s: int):
        return self.samples[a][s] if isinstance(a, int) else a[1]

    def _reads(self, *args) -> bool:
        return any(isinstance(v, int) and self.reads[v] for v in args)

    def _each(self, fn, *args):
        return tuple(fn(*(self._sample(a, s) for a in args))
                     for s in range(len(STORAGES)))

    def node(self, key, fn, *args, boolean: bool = False) -> "_Node":
        """A node `key` of operands `args`, its samples `fn` of theirs: a
        float in every storage (a bool where `boolean`), else refused."""
        try:
            samples = self._each(fn, *args)
        except (RuntimeError, TypeError) as e:
            self.refuse(f"torch refuses its {key[0]} node ({e})")
        want = (torch.bool,) if boolean else (torch.float32, torch.bfloat16)
        bad = [t.dtype for t in samples if t.dtype not in want]
        if bad:
            self.refuse(f"its {key[0]} node gives a {bad[0]} value where "
                        f"{'a comparison' if boolean else 'a number'} is "
                        f"meant")
        return self.leaf(key, samples, self._reads(*args))

    def op(self, o: str, x, y) -> "_Node":
        a, b = self.operand(x), self.operand(y)
        return self.node(("op", o, a, b), functools.partial(_arith, o), a, b)

    def unary(self, kind: str, x) -> "_Node":
        a = self.operand(x, numbers=False)
        fn = (lambda t: -t) if kind == "neg" else _UNARY[kind]
        return self.node((kind, a), fn, a)

    def neg(self, x) -> "_Node":
        return self.unary("neg", x)

    def math(self, name: str, x) -> "_Node":
        a = self.operand(x, numbers=False)
        return self.node(("fn", name, a), getattr(torch, name), a)

    def binary(self, kind: str, x, y) -> "_Node":
        """A power, floor division or remainder: value by value, value by
        number or number by value."""
        a, b = self.operand(x), self.operand(y)
        if not isinstance(a, int) and not isinstance(b, int):
            self.refuse(f"its {kind} takes two numbers")
        return self.node((kind, a, b), _BINARY[kind], a, b)

    def clamp(self, x, lo=None, hi=None) -> "_Node":
        a = self.operand(x, numbers=False)
        lo_, hi_ = (None if v is None else self.operand(v) for v in (lo, hi))
        if any(isinstance(v, int) for v in (lo_, hi_)):
            self.refuse("its clamp takes a traced bound (number bounds "
                        "only: write torch.minimum / torch.maximum)")
        if lo_ is None and hi_ is None:
            self.refuse("its clamp has neither bound")

        def fn(t):
            return torch.clamp(t, min=None if lo_ is None else lo_[1],
                               max=None if hi_ is None else hi_[1])
        return self.node(("clamp", a, lo_, hi_), fn, a)

    def pick(self, which: str, x, y) -> "_Node":
        a, b = self.operand(x, numbers=False), self.operand(y, numbers=False)
        return self.node(("pick", which, a, b), _PICK[which][0], a, b)

    def compare(self, o: str, x, y) -> "_Node":
        a, b = self.operand(x), self.operand(y)
        # a number operand takes the comparison's common dtype
        try:
            common = tuple(torch.result_type(self._sample(a, s),
                                             self._sample(b, s))
                           for s in range(len(STORAGES)))
        except (RuntimeError, TypeError) as e:
            self.refuse(f"torch refuses its comparison ({e})")
        return self.node(("cmp", o, a, b, _rounding_of(common)),
                         _COMPARE[o], a, b, boolean=True)

    def logic(self, o: str, x, y) -> "_Node":
        a, b = self.operand(x, numbers=False), self.operand(y, numbers=False)
        return self.node(("logic", o, a, b), _LOGIC[o][0], a, b,
                         boolean=True)

    def invert(self, x) -> "_Node":
        a = self.operand(x, numbers=False)
        return self.node(("not", a), operator.inv, a, boolean=True)

    def where(self, c, x, y) -> "_Node":
        ci = self.operand(c, numbers=False)
        if self.nodes[ci][0] not in _BOOL:
            self.refuse("its torch.where takes a condition that is not a "
                        "comparison of traced values")
        a, b = self.operand(x), self.operand(y)
        return self.node(("where", ci, a, b), torch.where, ci, a, b)

    def rounding(self, i: int) -> Optional[str]:
        return _rounding_of(t.dtype for t in self.samples[i])


def _refusing(what: str):
    def method(self, *args, **kwargs):
        self.g.refuse(f"its source applies {what}")
    return method


def _math(name):
    def fn(g, input):
        return g.math(name, input)
    return fn


def _clamp(g, input, min=None, max=None):
    return g.clamp(input, min, max)


def _clamp_min(g, input, min):
    return g.clamp(input, min, None)


def _clamp_max(g, input, max):
    return g.clamp(input, None, max)


def _binary_fn(kind):
    def fn(g, input, other):
        return g.binary(kind, input, other)
    return fn


def _pow(g, input, exponent):
    return g.binary("pow", input, exponent)


def _square(g, input):
    return g.binary("pow", input, 2)


def _pick_fn(which):
    def fn(g, input, other):
        return g.pick(which, input, other)
    return fn


def _where(g, condition, input, other):
    return g.where(condition, input, other)


# torch functions a traced value takes, by the graph's method, each taking
# torch's own parameter names as keywords
_FUNCTIONS = {torch.abs: lambda g, input: g.unary("abs", input),
              torch.sqrt: lambda g, input: g.unary("sqrt", input),
              torch.neg: lambda g, input: g.neg(input),
              torch.minimum: _pick_fn("min"), torch.maximum: _pick_fn("max"),
              torch.where: _where, torch.clamp: _clamp,
              torch.clip: _clamp, torch.clamp_min: _clamp_min,
              torch.clamp_max: _clamp_max, torch.pow: _pow,
              torch.square: _square,
              torch.floor_divide: _binary_fn("fdiv"),
              torch.remainder: _binary_fn("mod")}
_FUNCTIONS.update({getattr(torch, n): _math(n) for n in _MATH})
_BY_NAME = {f.__name__: f for f in _FUNCTIONS}


def _call(proxy, func, args, kwargs):
    """`func(*args, **kwargs)` on the trace of `proxy`, or refused."""
    name = proxy.g.spec.name
    handler = _FUNCTIONS.get(func)
    if handler is None:
        _refuse(name, f"its source calls {getattr(func, '__name__', func)}")
    try:
        inspect.signature(handler).bind(proxy.g, *args, **kwargs)
    except TypeError as e:
        _refuse(name, f"its source calls {func.__name__} with arguments it "
                f"does not take ({e})")
    return handler(proxy.g, *args, **kwargs)


class _Proxy:
    """What both proxies share: torch's functions and the tensor methods
    of them (`x.exp()`, `x.clamp(min=0.0)`), and the refusal of every
    operation the functor cannot run."""
    __slots__ = ()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        flat = [a for x in (*args, *(kwargs or {}).values())
                for a in (x if isinstance(x, (list, tuple)) else (x,))]
        proxy = next((a for a in flat if isinstance(a, _Proxy)), None)
        if proxy is None:
            _refuse("?", f"its source calls {getattr(func, '__name__', func)}")
        return _call(proxy, func, args, kwargs or {})

    def __getattr__(self, name):
        func = _BY_NAME.get(name)
        if func is None or name.startswith("_"):
            self.g.refuse(f"its source reads attribute {name!r} of an "
                          f"operand")
        if func is torch.where:     # x.where(condition, y): x where it holds
            return lambda condition, other: self.g.where(condition, self,
                                                         other)
        return lambda *args, **kwargs: _call(self, func, (self, *args),
                                             kwargs)

    __matmul__ = __rmatmul__ = _refusing("a matrix product")
    __bool__ = _refusing("a truth test: a Python branch on a traced value "
                         "(use torch.where)")
    __float__ = __int__ = __index__ = _refusing("a conversion to a number")
    __array__ = _refusing("numpy")


def _binary(o: str, reflected: bool = False):
    if reflected:
        return lambda self, x: self.g.op(o, x, self)
    return lambda self, x: self.g.op(o, self, x)


def _kernel_op(kind: str, reflected: bool = False):
    if reflected:
        return lambda self, x: self.g.binary(kind, x, self)
    return lambda self, x: self.g.binary(kind, self, x)


def _comparison(o: str):
    return lambda self, x: self.g.compare(o, self, x)


def _logical(o: str):
    return lambda self, x: self.g.logic(o, self, x)


class _Node(_Proxy):
    __slots__ = ("g", "i")

    def __init__(self, g: _Graph, i: int):
        self.g, self.i = g, i

    __add__, __radd__ = _binary("+"), _binary("+", True)
    __sub__, __rsub__ = _binary("-"), _binary("-", True)
    __mul__, __rmul__ = _binary("*"), _binary("*", True)
    __truediv__, __rtruediv__ = _binary("/"), _binary("/", True)
    __pow__, __rpow__ = _kernel_op("pow"), _kernel_op("pow", True)
    __floordiv__ = _kernel_op("fdiv")
    __rfloordiv__ = _kernel_op("fdiv", True)
    __mod__, __rmod__ = _kernel_op("mod"), _kernel_op("mod", True)
    __lt__, __le__ = _comparison("<"), _comparison("<=")
    __gt__, __ge__ = _comparison(">"), _comparison(">=")
    __eq__, __ne__ = _comparison("=="), _comparison("!=")
    __and__ = __rand__ = _logical("&")
    __or__ = __ror__ = _logical("|")
    __hash__ = object.__hash__

    def __neg__(self):
        return self.g.neg(self)

    def __pos__(self):
        return self

    def __abs__(self):
        return self.g.unary("abs", self)

    def __invert__(self):
        return self.g.invert(self)

    __getitem__ = _refusing("an index to a field expression")
    __iter__ = _refusing("iteration to a field expression")


def _through_leaf(name: str):
    def method(self, *args):
        return getattr(self.leaf(), name)(*args)
    return method


class _Vector(_Proxy):
    """`pv[vec]` sliced by `ops` ((start, stop) pairs, in turn)."""
    __slots__ = ("g", "vec", "ops")

    def __init__(self, g: _Graph, vec: int, ops: tuple = ()):
        self.g, self.vec, self.ops = g, vec, ops

    def _slot(self, index: Optional[int] = None):
        """The slot of this view (of its element `index`): (vec, start,
        cut) where every slice starts at a fixed element and stops at the
        vector's end or a fixed count before it, else (vec, start or -1, 0,
        ops)."""
        ops = self.ops + (() if index is None else (index,))
        starts = [op[0] if isinstance(op, tuple) else op for op in ops]
        start = sum(starts) if min(starts, default=0) >= 0 else -1
        if start >= 0 and all(op[1] is None or op[1] < 0
                              for op in self.ops):
            return (self.vec, start, -sum(op[1] or 0 for op in self.ops))
        return (self.vec, start, 0, ops)

    def __getitem__(self, k):
        if isinstance(k, int) and not isinstance(k, bool):
            return self.g.coef(self._slot(k))
        if isinstance(k, slice):
            if k.step not in (None, 1):
                self.g.refuse(f"it slices parameter vector {self.vec} as "
                              f"[{k.start}:{k.stop}:{k.step}]: a slice with "
                              f"a step never lines up with z")
            for v in (k.start, k.stop):
                if v is not None and (not isinstance(v, int) or
                                      isinstance(v, bool)):
                    self.g.refuse(f"it slices parameter vector {self.vec} "
                                  f"by {v!r}")
            return _Vector(self.g, self.vec,
                           self.ops + ((k.start or 0, k.stop),))
        self.g.refuse(f"it indexes parameter vector {self.vec} by {k!r}")

    def leaf(self) -> _Node:
        return self.g.zvec(self._slot())

    __add__, __radd__ = _through_leaf("__add__"), _through_leaf("__radd__")
    __sub__, __rsub__ = _through_leaf("__sub__"), _through_leaf("__rsub__")
    __mul__, __rmul__ = _through_leaf("__mul__"), _through_leaf("__rmul__")
    __truediv__ = _through_leaf("__truediv__")
    __rtruediv__ = _through_leaf("__rtruediv__")
    __pow__, __rpow__ = _through_leaf("__pow__"), _through_leaf("__rpow__")
    __floordiv__ = _through_leaf("__floordiv__")
    __rfloordiv__ = _through_leaf("__rfloordiv__")
    __mod__, __rmod__ = _through_leaf("__mod__"), _through_leaf("__rmod__")
    __neg__, __abs__ = _through_leaf("__neg__"), _through_leaf("__abs__")
    __lt__, __le__ = _through_leaf("__lt__"), _through_leaf("__le__")
    __gt__, __ge__ = _through_leaf("__gt__"), _through_leaf("__ge__")
    __eq__, __ne__ = _through_leaf("__eq__"), _through_leaf("__ne__")
    __hash__ = object.__hash__

    def __getattr__(self, name):
        if name in _BY_NAME:
            return getattr(self.leaf(), name)
        return _Proxy.__getattr__(self, name)

    __iter__ = _refusing("iteration to a parameter vector (its length is "
                         "not known to the tracer)")
    __len__ = _refusing("len() to a parameter vector")


@dataclasses.dataclass(frozen=True)
class Generated:
    """A generated functor: its header (`text`, the key of its build), the
    traced graph it was emitted from (`nodes`, and the node of each field's
    source, `outs`), and what the launch needs of it: its fields, its
    z-coefficient slots and scalar slots (see `_positions`), the vectors
    the callback ran on (`used`, the fewest it takes), and its ring's
    shape: the radius, the x offsets `plane_lo`..`plane_hi` of its reads
    off the centre row (0, 0 where it reads no x neighbour there) and the
    floats the ring lays before its shared memory (`head`)."""
    text: str
    n_fields: int
    zslots: Tuple[tuple, ...]
    scalars: Tuple[tuple, ...]
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

    @property
    def resolved(self) -> Tuple[tuple, ...]:
        """The slots the launch copies into rows of their own, after the
        `used` vectors, in order: the z slots', then the scalars'."""
        return tuple(s for s in self.zslots + self.scalars if _resolved(s))

    def ops_per_cell(self) -> int:
        """Operations the functor runs per interior cell and level: each
        field's source as emitted, every node it needs but the leaves (an
        arithmetic op, a comparison, a select, a min or max, a clamp, and a
        math function, a power, a floor division or a remainder as one
        operation each, though each of the last four runs several
        instructions), counted field by field."""
        total = 0
        for out in self.outs:
            need = _needed(self.nodes, out)
            total += sum(self.nodes[i][0] not in ("field", "coef", "zvec")
                         for i in need)
        return total

    def check_vectors(self, name: str, pv, Z: int) -> None:
        """Raise, before any launch, where the parameter vectors do not fit
        the trace: too few of them, a scalar past a vector's end, or a
        z-coefficient slice that does not hold the Z - 2 * radius interior
        cells."""
        if len(pv) < self.used:
            raise ValueError(f"spec {name!r}: its source indexes "
                             f"{self.used} parameter vectors, got {len(pv)}")
        for slot in self.scalars:
            vec, n = slot[0], pv[slot[0]].shape[0]
            try:
                r = _positions(slot, n, scalar=True)
            except IndexError:
                r = range(0)
            if len(r) != 1:
                raise ValueError(f"spec {name!r}: coefficient "
                                 f"{_describe(slot)} of parameter vector "
                                 f"{vec} is past its {n} elements")
        inner = Z - 2 * self.radius
        for slot in self.zslots:
            vec, n = slot[0], pv[slot[0]].shape[0]
            got = len(_positions(slot, n))
            if got != inner:
                _refuse(name, f"the slice {_describe(slot)} of parameter "
                        f"vector {vec} ({n} elements) holds {got} cells "
                        f"where z has Z - {2 * self.radius} = {inner} "
                        f"interior cells, so it does not line up with z")

    def rows(self, pv) -> tuple:
        """The vectors the launch lays in the kernel's table: `pv`, or,
        where a slot is resolved by the launch, the `used` vectors and a
        row for each `resolved` slot (its elements, in order)."""
        if not self.resolved:
            return tuple(pv)
        out = list(pv[:self.used])
        for slot in self.resolved:
            r = _positions(slot, pv[slot[0]].shape[0], slot in self.scalars)
            out.append(pv[slot[0]][r.start:r.start + len(r)])
        return tuple(out)


def _describe(slot) -> str:
    """A slot as the callback wrote it."""
    if len(slot) == 3:
        _, start, cut = slot
        return f"[{start}:{-cut or ''}]"
    return "".join(f"[{op[0]}:{'' if op[1] is None else op[1]}]"
                   if isinstance(op, tuple) else f"[{op}]" for op in slot[3])


def _operands(node) -> tuple:
    """The operand indices and constants of a node, in its order."""
    kind = node[0]
    if kind in ("neg", "abs", "sqrt", "not"):
        return node[1:2]
    if kind == "fn":
        return node[2:3]
    if kind in ("op", "pick", "cmp", "logic"):
        return node[2:4]
    if kind in ("pow", "fdiv", "mod"):
        return node[1:3]
    if kind == "clamp":
        return tuple(a for a in node[1:4] if a is not None)
    if kind == "where":
        return node[1:4]
    return ()


def _needed(nodes, out: int) -> set:
    """The nodes the source `out` needs, itself included."""
    need, stack = set(), [out]
    while stack:
        i = stack.pop()
        if i in need:
            continue
        need.add(i)
        stack += [a for a in _operands(nodes[i]) if isinstance(a, int)]
    return need


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


def _flag(r: Optional[str]) -> str:
    """A node's rounding as the functor's template flag."""
    return r or "false"


def _pow_code(x: str, e, r: Optional[str]) -> str:
    """x ** e, e a Python number, as torch's CUDA kernel of a tensor by a
    scalar computes it in the op's dtype (bf16 where `r`): 0 and 1 are
    handled before any kernel, 0.5, -0.5 and -1 run sqrt, rsqrt and
    reciprocal, and on the number in the op's dtype 2, 3 and -2 are
    products (each bf16 product rounded to bf16), any other a `powf`."""
    if e == 0:
        return "1.0f"
    if e == 1:
        return x
    special = {0.5: f"sqrtf({x})", -0.5: f"rsqrtf({x})", -1: f"(1.0f / {x})"}
    if e in special:
        return f"rpk<{_flag(r)}>({special[e]})"

    f = _flag(r)

    def code(es: float) -> str:
        if es == 2:
            return f"rpk<{f}>({x} * {x})"
        if es == 3:
            return f"rpk<{f}>(rpk<{f}>({x} * {x}) * {x})"
        if es == -2:
            return f"rpk<{f}>((float)(1.0 / (double)rpk<{f}>({x} * {x})))"
        return f"rpk<{f}>(powf({x}, {_literal(es)}))"
    f32 = code(_in_dtype(e, False))
    if r is None:
        return f32
    bf16 = code(_in_dtype(e, True))
    return bf16 if f32 == bf16 else f"({r} ? {bf16} : {f32})"


def _number_code(value, r: Optional[str]) -> str:
    """A Python number converted to the op's dtype as torch converts a
    Scalar operand of a kernel that takes it in `scalar_t` (bf16 where
    `r`)."""
    lit = _literal(value)
    return f"rpk<{r}>({lit})" if r else lit


def _emit(g: _Graph, outs) -> str:
    R = g.spec.radius
    lo, hi, head = _shape(g)
    used = g.used
    resolved = [s for s in g.zslots + g.scalars if _resolved(s)]

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
        if kind == "fn":
            _, name, a = node
            return rounded(_MATH[name].format(operand(a)), g.rounding(i))
        if kind == "pow":
            _, a, b = node
            r = g.rounding(i)
            if not isinstance(b, int):
                return _pow_code(operand(a), b[1], r)
            if not isinstance(a, int) and a[1] == 1:
                return "1.0f"
            base = operand(a) if isinstance(a, int) else \
                _number_code(a[1], r)
            return rounded(f"powf({base}, {operand(b)})", r)
        if kind == "fdiv":
            _, a, b = node
            r = g.rounding(i)
            if not isinstance(b, int):
                if float(np.float32(b[1])) == 0.0:
                    return rounded(f"{operand(a)} * {_reciprocal(b[1])}", r)
                return (f"k6_fdiv_scalar<{_flag(r)}>({operand(a)}, "
                        f"{_literal(b[1])}, {_reciprocal(b[1])})")
            x = operand(a) if isinstance(a, int) else _number_code(a[1], r)
            return rounded(f"k6_fdiv({x}, {operand(b)})", r)
        if kind == "mod":
            _, a, b = node
            r = g.rounding(i)
            x, y = (operand(v) if isinstance(v, int) else
                    _number_code(v[1], r) for v in (a, b))
            return rounded(f"k6_mod({x}, {y})", r)
        if kind == "clamp":
            _, a, lo_, hi_ = node
            r = g.rounding(i)
            x = operand(a)
            body = x
            if lo_ is not None:
                body = f"fmaxf({body}, {_number_code(lo_[1], r)})"
            if hi_ is not None:
                body = f"fminf({body}, {_number_code(hi_[1], r)})"
            return f"({x} != {x} ? (float){x} : {body})"
        if kind == "pick":
            _, which, a, b = node
            x, y = operand(a), operand(b)
            return (f"({x} != {x} ? {x} : {y} != {y} ? {y} : "
                    f"{_PICK[which][1]}({x}, {y}))")
        if kind == "cmp":
            _, o, a, b, r = node
            return f"({operand(a, r)} {o} {operand(b, r)})"
        if kind == "logic":
            _, o, a, b = node
            return f"({operand(a)} {_LOGIC[o][1]} {operand(b)})"
        if kind == "not":
            return f"!{operand(node[1])}"
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

    def row(slot) -> int:
        return used + resolved.index(slot) if _resolved(slot) else slot[0]

    def first(slot) -> int:
        return 0 if _resolved(slot) else slot[1]

    nz = len(g.zslots)
    lines = [HEADER, "#pragma once", "", "struct GeneratedOp {",
             f"  static constexpr int kFields = {len(outs)};",
             f"  static constexpr int kVectors = {nz};"]
    lines.append(f"  static constexpr int kRadius = {R}, kPlaneLo = {lo}, "
                 f"kPlaneHi = {hi}, kHead = {head};")
    lines += ["  __device__ static constexpr int zvec(int p) {",
              f"    return {chain(g.zslots, row)};", "  }",
              "  __device__ static constexpr int zoff(int p) {",
              f"    return {chain(g.zslots, lambda s: first(s) - R + PAD * R)};",
              "  }"]
    if g.scalars:
        names = ", ".join(f"s{i}" for i in range(len(g.scalars)))
        loads = ", ".join(f"pv[{row(s)} * (size_t)p_len + "
                          f"{first(s) + PAD * R}]" for s in g.scalars)
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
        need = _needed(g.nodes, out)
        lines.append(f"    {'if' if f == 0 else '} else if'} constexpr "
                     f"(FI == {f}) {{")
        lines += [f"      const {'bool' if g.nodes[i][0] in _BOOL else 'float'}"
                  f" t{i} = {expr(i)};" for i in sorted(need)]
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
        if g.nodes[s.i][0] in _BOOL:
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
        g.used = n
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

    def view(slot, scalar=False):
        r = _positions(slot, pv[slot[0]].shape[0], scalar)
        return pv[slot[0]][r.start:r.start + len(r)]

    for node in gen.nodes:
        kind = node[0]
        if kind == "field":
            vals.append(sh(*node[1:]))
        elif kind == "coef":
            vals.append(view(gen.scalars[node[1]], scalar=True))
        elif kind == "zvec":
            vals.append(view(gen.zslots[node[1]]))
        elif kind == "neg":
            vals.append(-operand(node[1]))
        elif kind in _UNARY:
            vals.append(_UNARY[kind](operand(node[1])))
        elif kind == "fn":
            vals.append(getattr(torch, node[1])(operand(node[2])))
        elif kind in _BINARY:
            vals.append(_BINARY[kind](operand(node[1]), operand(node[2])))
        elif kind == "clamp":
            lo, hi = (None if v is None else v[1] for v in node[2:4])
            vals.append(torch.clamp(operand(node[1]), min=lo, max=hi))
        elif kind == "pick":
            vals.append(_PICK[node[1]][0](operand(node[2]),
                                          operand(node[3])))
        elif kind == "cmp":
            vals.append(_COMPARE[node[1]](operand(node[2]),
                                          operand(node[3])))
        elif kind == "logic":
            vals.append(_LOGIC[node[1]][0](operand(node[2]),
                                           operand(node[3])))
        elif kind == "not":
            vals.append(~operand(node[1]))
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


# --- the probe of the nodes ---------------------------------------------------

def _probe(fn, arity: int = 1):
    """A one-node callback of field a (and b, where `arity` is 2: b's own
    source is b, so the probe's field 0 is the node)."""
    if arity == 1:
        return lambda sh, pv: (fn(sh(0, 0, 0, 0)),)
    return lambda sh, pv: (fn(sh(0, 0, 0, 0), sh(1, 0, 0, 0)),
                           sh(1, 0, 0, 0))


def _math_probe(name):
    return _probe(lambda a: getattr(torch, name)(a))


def _pow_probe(e):
    return _probe(lambda a: a ** e)


def _rpow_probe(b):
    return _probe(lambda a: b ** a)


def _scalar_probe(kind, b, reflected=False):
    fn = _BINARY[kind]
    return _probe((lambda a: fn(b, a)) if reflected else (lambda a: fn(a, b)))


# exponents of the power-by-number probes: torch's special cases (0, 1,
# 0.5, -0.5, -1 as given; 2, 3, -2 in the op's dtype), a number that is 2
# in bf16 only, and generic ones
PROBE_EXPONENTS = (0, 1, 0.5, -0.5, -1, 2, 3, -2, 2.001, 1.5, -1.5, 2.5,
                   1.0 / 3.0)
# divisors of the floor-division and remainder-by-number probes
PROBE_DIVISORS = (360.0, -0.75, 0.1, 3.0, 0.0)


@functools.lru_cache(maxsize=None)
def probe_cases() -> Tuple[Tuple[str, int, object], ...]:
    """(name, operands, callback) of every case the probe holds against
    torch: each new node kind in one-line specs of one or two fields, each
    math function, each exponent case of a power by a number, a number by a
    value and a value by a value, the clamps, floor division and remainder
    by values, by numbers (0 included) and of numbers, a comparison as a
    number and a select on `&`, `~` and `|` of comparisons; with `sqrt` and
    `/` for reference."""
    out = [(n, 1, _math_probe(n)) for n in _MATH]
    out += [("sqrt", 1, _probe(torch.sqrt)), ("square", 1,
                                              _probe(torch.square)),
            ("a / b", 2, _probe(operator.truediv, 2))]
    out += [(f"a ** {e!r}", 1, _pow_probe(e)) for e in PROBE_EXPONENTS]
    out += [(f"{b!r} ** a", 1, _rpow_probe(b)) for b in (2.0, 0.5, 10.0,
                                                          1.0)]
    out += [("a ** b", 2, _probe(operator.pow, 2)),
            ("clamp(a, -1.5, 2.0)", 1, _probe(lambda a: a.clamp(-1.5, 2.0))),
            ("clamp_min(a, 0.0)", 1, _probe(lambda a: torch.clamp_min(a,
                                                                      0.0))),
            ("clamp(a, max=0.3)", 1, _probe(lambda a: torch.clamp(a,
                                                                  max=0.3))),
            ("clamp(a, 1.1, 0.7)", 1, _probe(lambda a: torch.clamp(a, 1.1,
                                                                   0.7)))]
    for kind, sym in (("fdiv", "//"), ("mod", "%")):
        out.append((f"a {sym} b", 2, _probe(_BINARY[kind], 2)))
        out += [(f"a {sym} {b!r}", 1, _scalar_probe(kind, b))
                for b in PROBE_DIVISORS]
        out.append((f"7.5 {sym} a", 1, _scalar_probe(kind, 7.5, True)))
    out += [("(a > b) * a", 2, _probe(lambda a, b: (a > b) * a, 2)),
            ("where((a > 0) & ~(b < 0) | (a == b), a, b)", 2,
             _probe(lambda a, b: torch.where(
                 (a > 0.0) & ~(b < 0.0) | (a == b), a, b), 2))]
    return tuple(out)


def probe_functor(case: int) -> Generated:
    name, arity, fn = probe_cases()[case]
    return _trace(fn, f"probe {name}", ("a", "b")[:arity], 1)


def probe_header() -> str:
    """The probe's cases as `_build.PROBE_HEADER`: each case's functor in
    namespace k6p<case>, as the tracer emits it for a spec."""
    parts = [HEADER, "#pragma once", ""]
    for i, (name, _, _) in enumerate(probe_cases()):
        body = probe_functor(i).text.replace(HEADER, "").replace(
            "#pragma once\n", "")
        parts += [f"// {name}", f"namespace k6p{i} {{", body.strip(),
                  f"}}  // namespace k6p{i}", ""]
    parts.append("#define K6_PROBE_CASES(X) " + " ".join(
        f"X({i})" for i in range(len(probe_cases()))))
    return "\n".join(parts) + "\n"


def probe_reference(case: int, a, b=None):
    """torch's op of the case on `a` (and `b`): the case's own callback,
    the plain version the probe is held to."""
    fields = (a, a if b is None else b)
    return probe_cases()[case][2](lambda f, dx, dy, dz: fields[f], ())[0]


def run_probe(case: int, a: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probe's node `case` applied elementwise on the card to `a` (and
    `b`), 1-D contiguous CUDA tensors of f32 or bf16 cells, in the
    generated builds' flags; built at first use (`_build.load_probe`)."""
    if a.device.type != "cuda":
        raise ValueError("the probe runs on CUDA tensors only (on the CPU, "
                         "`probe_reference` is torch's op)")
    b = a if b is None else b
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype \
            or a.shape != b.shape or a.ndim != 1:
        raise ValueError("the probe takes 1-D f32 or bf16 operands of one "
                         "shape and dtype")
    a, b = a.contiguous(), b.contiguous()
    lib = _build.load_probe(probe_header())
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.k6_probe(case, int(a.dtype == torch.bfloat16), a.data_ptr(),
                           b.data_ptr(), out.data_ptr(), a.numel(),
                           torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "k6_probe")
    return out
