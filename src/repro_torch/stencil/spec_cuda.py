"""K6 for user-written specs: a radius-1 spec's source callback, traced once
on proxies and emitted as a CUDA functor of the spec ring
(`csrc/stencil_fused.cuh`), in the form of the shipped ones
(`csrc/stencil_ops.cuh`), then built at first use beside the shipped
kernels (`_build.load_generated`).

The trace calls `spec.source(sh, pv)` once. `sh(f, dx, dy, dz)` returns a
field read, a leaf. `pv` is a tuple of vector proxies: `pv[i][j]` (an int
j >= 0) is a scalar coefficient, and a slice of `pv[i]` whose stop is
negative or None (such as `t1[2:][1:-1]`) is a z-coefficient vector, the
cell at interior z reading element ``start + z - 1`` (the launch checks
that the slice holds exactly the Z - 2 interior cells). `+`, `-`, `*`,
unary minus and Python numbers build nodes, each keeping its operands in
the callback's order. Every proxy carries a sample tensor for each storage
build (f32; bf16 fields with f32 coefficients; both bf16), dimensioned as
the plain version's coefficients are (`spec.CoefVector`), and each node
learns its result dtype from torch's own promotion of its operands'
samples: an op that is bf16 with bf16 fields rounds with `rnd<RF>`, one
that is bf16 only with bf16 coefficients too with `rnd<RC>`. With
`--fmad=false` the kernel then rounds as the callback does in torch,
bitwise.

The tracer does not know how many vectors `pack_params` returns: it runs
the callback on 0, 1, 2, ... vectors and keeps the first count it
accepts.

Refused, with NotImplementedError naming ROADMAP Queue 2, before any
build and launch: radius > 1; more than four fields (the C interface's
four pointers); a read at x +- 1 with a nonzero dy or dz (the ring keeps
x neighbours in registers, without their planes); any other operation or
function (division, powers, `torch.exp`, comparisons, ...); a
coefficient indexed another way (from the end, with a step, by a slice
whose stop is positive).

The emitted text is deterministic, so is its digest, which keys its
build; a spec whose text equals a shipped spec's runs the shipped
functor."""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

MAX_FIELDS = 4       # the C interface's four field pointers
MAX_VECTORS = 8      # the most parameter vectors the tracer offers
QUEUE = "ROADMAP Queue 2"
# (field dtype, coefficient dtype) of the three storage builds
STORAGES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
            (torch.bfloat16, torch.bfloat16))
# which storages make a node bf16 -> its rounding in the functor
_ROUNDING = {(False, False, False): None, (False, True, True): "RF",
             (False, False, True): "RC"}
# the shipped functor whose builds (threads per block by cells per thread)
# a generated one takes, by field count: one field as diffusion, two and
# three as PW, four as the tracer
BUILDS_LIKE = {1: 2, 2: 0, 3: 0, 4: 1}
# zeros the launch lays before and after each of a generated functor's
# parameter vectors (`Generated.pad`), so that every window cell's
# z-coefficient read, walls included, lies inside its vector
PAD = 1
HEADER = ("// K6 functor generated by repro_torch.stencil.spec_cuda from a "
          "StencilSpec's\n// source callback (its terms in the callback's "
          "order); do not edit.\n")


class Refused(NotImplementedError):
    """A spec K6 has no CUDA instantiation for."""


class _SpecBug(ValueError):
    """A callback that breaks its spec's own contract (raised as the plain
    version's accessor raises it)."""


def _refuse(name: str, why: str):
    raise Refused(
        f"spec {name!r} has no CUDA instantiation: {why}. K6 generates "
        f"kernels for radius-1 specs whose source is built from + - * on at "
        f"most {MAX_FIELDS} fields with no x-diagonal read; the rest (radius "
        f"> 1, x-diagonal reads, more than {MAX_FIELDS} fields, other "
        f"operations) is queued in {QUEUE}. On CPU tensors the plain version "
        f"runs any spec")


def _literal(value) -> str:
    """A Python number as the f32 the op computes with (torch takes a
    weak scalar in the op's f32 opmath), an exact hex literal."""
    return float(np.float32(value)).hex() + "f"


class _Graph:
    """The nodes of one trace, in the order the callback made them (which
    is an order in which every node follows its operands)."""

    def __init__(self, spec):
        self.spec = spec
        self.nodes = []       # ("field", f, dx, dy, dz) | ("coef", slot) |
        #                       ("zvec", slot) | ("neg", a) | ("op", o, a, b)
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
        if dx and (dy or dz):
            self.refuse(f"it reads field {spec.fields[fi]!r} at ({dx}, {dy}, "
                        f"{dz}), an x neighbour off the centre row; the ring "
                        f"keeps x neighbours in registers")
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

    def operand(self, x):
        """A node's operand: a node's index, or a Python number."""
        if isinstance(x, _Vector):
            x = x.leaf()
        if isinstance(x, _Node):
            if x.g is not self:
                self.refuse("it mixes two traces")
            return x.i
        if isinstance(x, (int, float)) and not isinstance(x, bool):
            if not np.isfinite(np.float32(x)):
                self.refuse(f"it takes the constant {x!r}, which is not "
                            f"finite in float32")
            return ("const", x)
        self.refuse(f"it takes an operand of type {type(x).__name__} "
                    f"(fields, coefficients and Python numbers only)")

    def _sample(self, a, s: int):
        return self.samples[a][s] if isinstance(a, int) else a[1]

    def op(self, o: str, x, y) -> "_Node":
        a, b = self.operand(x), self.operand(y)
        fn = {"+": torch.add, "-": torch.sub, "*": torch.mul}[o]
        samples = tuple(fn(self._sample(a, s), self._sample(b, s))
                        for s in range(len(STORAGES)))
        reads = any(isinstance(v, int) and self.reads[v] for v in (a, b))
        return self.leaf(("op", o, a, b), samples, reads)

    def neg(self, x) -> "_Node":
        a = self.operand(x)
        return self.leaf(("neg", a), tuple(-self._sample(a, s)
                                           for s in range(len(STORAGES))),
                         self.reads[a])

    def rounding(self, i: int) -> Optional[str]:
        key = tuple(t.dtype == torch.bfloat16 for t in self.samples[i])
        if key not in _ROUNDING:
            raise AssertionError(f"node {self.nodes[i]} is bf16 in the "
                                 f"storages {key}")
        return _ROUNDING[key]


def _refusing(what: str):
    def method(self, *args, **kwargs):
        self.g.refuse(f"its source applies {what}")
    return method


class _Proxy:
    """What both proxies refuse: every operation the functor cannot run."""
    __slots__ = ()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        flat = [a for x in args for a in (x if isinstance(x, (list, tuple))
                                          else (x,))]
        name = next((a.g.spec.name for a in flat if isinstance(a, _Proxy)),
                    "?")
        _refuse(name, f"its source calls {getattr(func, '__name__', func)}")

    def __getattr__(self, name):
        self.g.refuse(f"its source reads attribute {name!r} of an operand")

    __truediv__ = __rtruediv__ = _refusing("division")
    __floordiv__ = __rfloordiv__ = _refusing("floor division")
    __mod__ = __rmod__ = _refusing("a modulo")
    __pow__ = __rpow__ = _refusing("a power")
    __matmul__ = __rmatmul__ = _refusing("a matrix product")
    __abs__ = _refusing("abs")
    __lt__ = __le__ = __gt__ = __ge__ = _refusing("a comparison")
    __bool__ = _refusing("a truth test")
    __float__ = __int__ = __index__ = _refusing("a conversion to a number")
    __array__ = _refusing("numpy")


class _Node(_Proxy):
    __slots__ = ("g", "i")

    def __init__(self, g: _Graph, i: int):
        self.g, self.i = g, i

    def __add__(self, o):
        return self.g.op("+", self, o)

    def __radd__(self, o):
        return self.g.op("+", o, self)

    def __sub__(self, o):
        return self.g.op("-", self, o)

    def __rsub__(self, o):
        return self.g.op("-", o, self)

    def __mul__(self, o):
        return self.g.op("*", self, o)

    def __rmul__(self, o):
        return self.g.op("*", o, self)

    def __neg__(self):
        return self.g.neg(self)

    def __pos__(self):
        return self

    __getitem__ = _refusing("an index to a field expression")
    __iter__ = _refusing("iteration to a field expression")


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

    def __add__(self, o):
        return self.leaf() + o

    def __radd__(self, o):
        return o + self.leaf()

    def __sub__(self, o):
        return self.leaf() - o

    def __rsub__(self, o):
        return o - self.leaf()

    def __mul__(self, o):
        return self.leaf() * o

    def __rmul__(self, o):
        return o * self.leaf()

    def __neg__(self):
        return -self.leaf()

    __iter__ = _refusing("iteration to a parameter vector (its length is "
                         "not known to the tracer)")
    __len__ = _refusing("len() to a parameter vector")


@dataclasses.dataclass(frozen=True)
class Generated:
    """A generated functor: its header (`text`, the key of its build), the
    traced graph it was emitted from (`nodes`, and the node of each field's
    source, `outs`), and what the launch needs of it: its fields, its
    z-coefficient slots ``(vector, start, cut)`` and scalar slots
    ``(vector, element, cut)``, and the vectors the callback ran on
    (`used`, the fewest it takes)."""
    text: str
    n_fields: int
    zslots: Tuple[Tuple[int, int, int], ...]
    scalars: Tuple[Tuple[int, int, int], ...]
    used: int
    nodes: Tuple[tuple, ...] = ()
    outs: Tuple[int, ...] = ()

    @property
    def n_vectors(self) -> int:
        """The z-coefficient vectors the kernel stages per window cell."""
        return len(self.zslots)

    @property
    def like(self) -> int:
        """The shipped functor id whose builds this one takes."""
        return BUILDS_LIKE[self.n_fields]

    @property
    def pad(self) -> int:
        """Zeros the launch lays before and after each parameter vector."""
        return PAD

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.text.encode()).hexdigest()[:16]

    def check_vectors(self, name: str, pv, Z: int) -> None:
        """Raise, before any launch, where the parameter vectors do not fit
        the trace: too few of them, a scalar past a vector's end, or a
        z-coefficient slice that does not hold the Z - 2 interior cells."""
        if len(pv) < self.used:
            raise ValueError(f"spec {name!r}: its source indexes "
                             f"{self.used} parameter vectors, got {len(pv)}")
        for vec, element, cut in self.scalars:
            if element + cut >= pv[vec].shape[0]:
                raise ValueError(f"spec {name!r}: coefficient {element} of "
                                 f"parameter vector {vec} (cut by {cut}) is "
                                 f"past its {pv[vec].shape[0]} elements")
        for vec, start, cut in self.zslots:
            n = pv[vec].shape[0] - start - cut
            if n != Z - 2:
                _refuse(name, f"the slice [{start}:{-cut or ''}] of parameter "
                        f"vector {vec} ({pv[vec].shape[0]} elements) holds "
                        f"{n} cells where z has Z - 2 = {Z - 2} interior "
                        f"cells, so it does not line up with z")


def _emit(g: _Graph, outs) -> str:
    def operand(a) -> str:
        return f"t{a}" if isinstance(a, int) else _literal(a[1])

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
        _, o, a, b = node
        body = f"{operand(a)} {o} {operand(b)}"
        r = g.rounding(i)
        return f"rnd<{r}>({body})" if r else f"({body})"

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
             f"  static constexpr int kVectors = {nz};",
             "  __device__ static constexpr int zvec(int p) {",
             f"    return {chain(g.zslots, lambda s: s[0])};", "  }",
             "  __device__ static constexpr int zoff(int p) {",
             f"    return {chain(g.zslots, lambda s: s[1] - 1 + PAD)};",
             "  }"]
    if g.scalars:
        names = ", ".join(f"s{i}" for i in range(len(g.scalars)))
        loads = ", ".join(f"pv[{v} * (size_t)p_len + {e + PAD}]"
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
            node = g.nodes[i]
            args = node[1:2] if node[0] == "neg" else \
                node[2:] if node[0] == "op" else ()
            stack += [a for a in args if isinstance(a, int)]
        lines.append(f"    {'if' if f == 0 else '} else if'} constexpr "
                     f"(FI == {f}) {{")
        lines += [f"      const float t{i} = {expr(i)};" for i in sorted(need)]
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
        return Generated(text, len(fields), tuple(g.zslots),
                         tuple(g.scalars), n, tuple(g.nodes), tuple(outs))
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
        else:
            _, o, a, b = node
            fn = {"+": torch.add, "-": torch.sub, "*": torch.mul}[o]
            x, y = operand(a), operand(b)
            vals.append(fn(x, y) if torch.is_tensor(x) else
                        {"+": y.__radd__, "-": y.__rsub__,
                         "*": y.__rmul__}[o](x))
    return tuple(vals[i] for i in gen.outs)


def trace(spec) -> Generated:
    """The generated functor of `spec`'s source; raises `Refused` (a
    NotImplementedError naming ROADMAP Queue 2) for a spec K6 cannot run."""
    if spec.n_fields > MAX_FIELDS:
        _refuse(spec.name, f"it has {spec.n_fields} fields, and the kernel's "
                f"C interface takes {MAX_FIELDS}")
    if spec.radius > 1:
        _refuse(spec.name, f"its radius is {spec.radius}, and the CUDA ring "
                f"is built for radius 1")
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
