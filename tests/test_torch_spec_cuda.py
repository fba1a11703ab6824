"""K6 for user-written specs (`repro_torch.stencil.spec_cuda`): the tracer
that turns a radius-1 spec's source callback into a CUDA functor, its
refusals, its generated text and digest, and the wrapper's route to the
generated build.

On the CPU the kernel wrappers run the plain version (the callback itself);
the generated functor compiles and runs only on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase 43). What is held here:
the traced graph, evaluated in torch node by node (`spec_cuda.evaluate`),
equals the callback bitwise in f32 and in bf16 with f32 and bf16
coefficients, so the functor emitted from it mirrors the callback op for
op; and each node's rounding in the text is torch's promotion of its
operands. No tolerance: every comparison is bitwise."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF
from repro_torch.stencil import spec as TSP
from repro_torch.stencil import spec_cuda as G

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
SHAPE = (6, 7, 10)
STORAGES = ((torch.float32, torch.float32), (BF16, torch.float32),
            (BF16, BF16))
STAR = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
        (0, 0, -1), (0, 0, 1))


# --- user specs ------------------------------------------------------------

def lap_xyz(sh, pv):
    (t,) = pv
    cx, cy, cz = t[0], t[1], t[2:][1:-1]
    c = sh(0, 0, 0, 0)
    return (cx * (sh(0, -1, 0, 0) + sh(0, 1, 0, 0))
            + cy * (sh(0, 0, -1, 0) + sh(0, 0, 1, 0))
            + cz * (sh(0, 0, 0, -1) + sh(0, 0, 0, 1))
            - 2.0 * (cx + cy + cz) * c,)


def yz_cross(sh, pv):
    k, kz = pv
    return (k[0] * (sh(0, 0, 1, 1) - sh(0, 0, 1, -1) - sh(0, 0, -1, 1)
                    + sh(0, 0, -1, -1))
            + kz[1:-1] * sh(0, 0, 0, 1) - sh(0, 1, 0, 0),)


def gray_scott(sh, pv):
    del pv

    def lap(f):
        return (sh(f, -1, 0, 0) + sh(f, 1, 0, 0) + sh(f, 0, -1, 0)
                + sh(f, 0, 1, 0) + sh(f, 0, 0, -1) + sh(f, 0, 0, 1)
                - 6.0 * sh(f, 0, 0, 0))

    u, v = sh(0, 0, 0, 0), sh(1, 0, 0, 0)
    uvv = u * v * v
    return (0.16 * lap(0) - uvv + 0.035 * (1.0 - u),
            0.08 * lap(1) + uvv - 0.095 * v)


def neg_shift(sh, pv):
    (t,) = pv
    return (-sh(0, 1, 0, 0) + t[3] * -sh(1, 0, 0, -1),
            t[0:][2:-2] * sh(0, 0, 0, 0) - 1,)


def spec_of(name, integrator="euler"):
    src, fields, pack, extra = {
        "lap_xyz": (lap_xyz, ("phi",), lambda q: (q,), ()),
        "yz_cross": (yz_cross, ("a",), lambda q: q,
                     ((0, 1, 1), (0, -1, -1))),
        "gray_scott": (gray_scott, ("u", "v"), lambda q: (), ()),
        "neg_shift": (neg_shift, ("a", "b"), lambda q: (q,), ()),
    }[name]
    return TSP.StencilSpec(name=name, fields=fields,
                           offsets={f: STAR + extra for f in fields},
                           source=src, pack_params=pack,
                           integrator=integrator)


def params_of(name, Z, dtype):
    """What `pack_params` of each spec takes, in `dtype`."""
    if name == "lap_xyz":
        return torch.cat([torch.tensor([0.1, 0.15]),
                          torch.linspace(0.05, 0.1, Z)]).to(dtype)
    if name == "yz_cross":
        return (torch.tensor([0.25, 3.0]).to(dtype),
                torch.linspace(0.1, 0.3, Z).to(dtype))
    if name == "neg_shift":
        return torch.linspace(-1.0, 1.0, Z + 2).to(dtype)
    return None


SHIPPED = {"pw": (TSP.pw_advection_spec,
                  lambda Z, d: TREF.default_params(Z, dtype=d,
                                                   device="cpu")),
           "tracer": (TSP.tracer_advection_spec,
                      lambda Z, d: TREF.default_params(Z, dtype=d,
                                                       device="cpu")),
           "diffusion": (TSP.diffusion_spec,
                         lambda Z, d: TSP.default_diffusion_params(
                             Z, dtype=d, device="cpu"))}
USER = ("lap_xyz", "yz_cross", "gray_scott", "neg_shift")


def case(name):
    """(spec, params factory of (Z, dtype))."""
    if name in SHIPPED:
        factory, params = SHIPPED[name]
        return factory(), params
    return spec_of(name), lambda Z, d: params_of(name, Z, d)


def accessor(fields, r=1):
    X, Y, Z = fields[0].shape

    def sh(fi, dx, dy, dz):
        return fields[fi][r + dx:X - r + dx, r + dy:Y - r + dy,
                          r + dz:Z - r + dz]
    return sh


def bitwise(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _refuse(*args, **kwargs):
    raise RuntimeError("kernel loader unavailable")


# --- the traced graph == the callback ------------------------------------

@pytest.mark.parametrize("name", list(SHIPPED) + list(USER))
@pytest.mark.parametrize("storage", range(3))
def test_graph_evaluated_in_torch_equals_the_callback(name, storage):
    """The graph the tracer took from the callback, run op by op in torch,
    == the callback bitwise, with the fields and coefficients of each
    storage build: the emitted functor mirrors the callback op for op."""
    spec, params = case(name)
    fd, cd = STORAGES[storage]
    X, Y, Z = SHAPE
    rng = np.random.default_rng(storage)
    fields = [torch.tensor(rng.normal(size=SHAPE), dtype=torch.float32)
              .to(fd) for _ in range(spec.n_fields)]
    pv = TK._spec_param_vectors(spec, params(Z, cd), "cpu", fd)
    wrapped = tuple(TSP.CoefVector(p) for p in pv)
    gen = G.trace(spec)
    got = G.evaluate(gen, accessor(fields), wrapped)
    want = spec.source(accessor(fields), wrapped)
    assert bitwise(got, want)
    assert all(g.shape == (X - 2, Y - 2, Z - 2) for g in got)


@pytest.mark.parametrize("name", list(SHIPPED) + list(USER))
def test_rounding_in_the_text_is_torchs_promotion(name):
    """Each binary node rounds in the text as torch types its result: with
    bf16 fields (`rnd<RF>`) or only with bf16 coefficients too (`rnd<RC>`);
    none in f32. A field op is RF, a product with a coefficient RC."""
    spec, _ = case(name)
    gen = G.trace(spec)
    lines = {ln.split("=", 1)[0].split()[-1]: ln for ln in
             gen.text.splitlines() if ln.strip().startswith("const float t")}
    rc = {i for i, node in enumerate(gen.nodes)
          if node[0] in ("coef", "zvec")}
    emitted = 0
    for i, node in enumerate(gen.nodes):
        if node[0] != "op" or f"t{i}" not in lines:
            continue
        emitted += 1
        line = lines[f"t{i}"]
        assert line.count("rnd<RF>(") + line.count("rnd<RC>(") == 1, line
        if any(isinstance(x, int) and x in rc for x in node[2:]):
            assert "rnd<RC>(" in line, line
            rc.add(i)
        else:
            assert "rnd<RF>(" in line, line
    assert emitted >= 3


@pytest.mark.parametrize("name", USER)
def test_the_plain_version_is_the_callback(name):
    """On CPU tensors `stencil_fused` on a user spec is the plain version:
    the callback's masked steps, in the fields' dtype."""
    spec, params = case(name)
    X, Y, Z = SHAPE
    rng = np.random.default_rng(4)
    for fd, cd in STORAGES:
        fields = [torch.tensor(rng.normal(size=SHAPE), dtype=torch.float32)
                  .to(fd) for _ in range(spec.n_fields)]
        p = params(Z, cd)
        got = TK.stencil_fused(fields, p, spec, T=2, dt=0.1)
        pv = TK._spec_param_vectors(spec, p, "cpu", fd)
        want = TK._stencil_fused_plain([f[None] for f in fields], pv, spec, 2,
                                       0.1, torch.ones(X), torch.ones(Y))
        assert bitwise(got, [w[0] for w in want])
        assert all(g.dtype == fd for g in got)


# --- the text and its digest --------------------------------------------

DIGEST_CHILD = """
import sys
sys.path.insert(0, "tests")
from test_torch_spec_cuda import spec_of
print(spec_of("lap_xyz").cuda_functor().digest,
      spec_of("gray_scott").cuda_functor().digest)
"""


def test_generated_text_and_digest_are_deterministic():
    """The same callback gives the same text (and digest) on a retrace and
    in another interpreter; the key of its build follows the text and the
    flags."""
    gens = {n: G.trace(spec_of(n)) for n in ("lap_xyz", "gray_scott")}
    G._trace.cache_clear()
    again = {n: G.trace(spec_of(n)) for n in ("lap_xyz", "gray_scott")}
    assert all(gens[n].text == again[n].text and gens[n] == again[n]
               for n in gens)
    out = subprocess.run([sys.executable, "-c", DIGEST_CHILD], cwd=ROOT,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [gens["lap_xyz"].digest,
                                  gens["gray_scott"].digest]
    text = gens["lap_xyz"].text
    f1 = _build.generated_flags(1, False, False, {2: 512, 4: 512})
    f2 = _build.generated_flags(1, True, False, {2: 512, 4: 512})
    keys = {_build.generated_digest(t, f) for t in (text, text + " ")
            for f in (f1, f2)}
    assert len(keys) == 4
    assert _build.generated_digest(text, f1) == \
        _build.generated_digest(text, f1)


def test_text_is_a_functor_of_the_shipped_form():
    gen = G.trace(spec_of("gray_scott"))
    for part in ("struct GeneratedOp {", "static constexpr int kFields = 2;",
                 "static constexpr int kVectors = 0;", "struct Coef {};",
                 "template <int FI, bool RF, bool RC, class Cell>",
                 "if constexpr (FI == 0) {", "} else if constexpr (FI == 1) {",
                 "at<1, 0, 0, 0>(sh)", "0x1.47ae140000000p-3f"):
        assert part in gen.text, part
    lap = G.trace(spec_of("lap_xyz"))
    assert lap.zslots == ((0, 3, 1),) and lap.scalars == ((0, 0, 0),
                                                          (0, 1, 0))
    # zoff: element 2 + z of the vector, one zero laid before it
    assert f"return {2 + G.PAD};" in lap.text
    assert f"pv[0 * (size_t)p_len + {G.PAD}]" in lap.text
    # 0.16 as the f32 torch computes with
    assert float.fromhex("0x1.47ae140000000p-3") == float(np.float32(0.16))


def test_shipped_callbacks_keep_their_functors():
    """A shipped spec keeps its id; a spec of a shipped callback whose
    generated text equals it reuses that functor, whatever its pack."""
    for key, (factory, _) in SHIPPED.items():
        for integ in TSP.INTEGRATORS:
            spec = factory(integ)
            assert spec.cuda_functor() == spec.cuda_op
    mixed = TSP.StencilSpec(name="mixed", fields=("u", "v", "w"),
                            offsets={f: TSP._STAR for f in "uvw"},
                            source=TSP._pw_source,
                            pack_params=TSP._diff_pack)
    assert mixed.cuda_op is None and mixed.cuda_functor() == 0
    assert set(G.shipped_texts().values()) == {0, 1, 2}


# --- refusals ---------------------------------------------------------------

def _five(sh, pv):
    return tuple(sh(f, 1, 0, 0) for f in range(5))


REFUSED = {
    "radius 2": (TSP.StencilSpec(
        name="r2", fields=("a",),
        offsets={"a": ((2, 0, 0), (-2, 0, 0))},
        source=lambda sh, pv: (sh(0, 2, 0, 0) - sh(0, -2, 0, 0),),
        pack_params=lambda p: ()), "radius is 2"),
    "x-diagonal": (TSP.StencilSpec(
        name="xdiag", fields=("a",), offsets={"a": ((1, 1, 0),)},
        source=lambda sh, pv: (sh(0, 1, 1, 0),),
        pack_params=lambda p: ()), "x neighbour off the centre row"),
    "five fields": (TSP.StencilSpec(
        name="five", fields=tuple("abcde"),
        offsets={f: ((1, 0, 0),) for f in "abcde"}, source=_five,
        pack_params=lambda p: ()), "5 fields"),
    "division": (TSP.StencilSpec(
        name="div", fields=("a",), offsets={"a": ((1, 0, 0),)},
        source=lambda sh, pv: (sh(0, 1, 0, 0) / 2.0,),
        pack_params=lambda p: ()), "division"),
    "torch.exp": (TSP.StencilSpec(
        name="exp", fields=("a",), offsets={"a": ((1, 0, 0),)},
        source=lambda sh, pv: (torch.exp(sh(0, 1, 0, 0)),),
        pack_params=lambda p: ()), "calls exp"),
    "index from the end": (TSP.StencilSpec(
        name="end", fields=("a",), offsets={"a": ((1, 0, 0),)},
        source=lambda sh, pv: (pv[0][-1] * sh(0, 1, 0, 0),),
        pack_params=lambda p: (p,)), "from its end"),
    "slice off z": (TSP.StencilSpec(
        name="sl", fields=("a",), offsets={"a": ((1, 0, 0),)},
        source=lambda sh, pv: (pv[0][1:3] * sh(0, 1, 0, 0),),
        pack_params=lambda p: (p,)), "does not line up with z"),
    "a comparison": (TSP.StencilSpec(
        name="cmp", fields=("a",), offsets={"a": ((1, 0, 0),)},
        source=lambda sh, pv: (torch.where(sh(0, 1, 0, 0) > 0,
                                           sh(0, 0, 0, 0), 0.0),),
        pack_params=lambda p: ()), "comparison"),
    "a field read as a number": (TSP.StencilSpec(
        name="num", fields=("a",), offsets={"a": ((1, 0, 0),)},
        source=lambda sh, pv: (float(sh(0, 1, 0, 0)) * sh(0, 0, 0, 0),),
        pack_params=lambda p: ()), "conversion to a number"),
}


@pytest.mark.parametrize("case_name", sorted(REFUSED))
def test_refusals_name_the_queue_and_launch_nothing(case_name, monkeypatch):
    """Each spec K6 cannot generate raises NotImplementedError naming
    ROADMAP Queue 2 and why, before any build or launch (the loaders
    monkeypatched to raise), on the route and in the planner."""
    monkeypatch.setattr(_build, "load", _refuse)
    monkeypatch.setattr(_build, "load_generated", _refuse)
    spec, why = REFUSED[case_name]
    before = dict(TK.LAUNCHES)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2") as e:
        TK._cuda_instantiation(spec)
    assert why in str(e.value)
    fields = [torch.zeros(1, 6, 6, 6) for _ in range(spec.n_fields)]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
        TK._stencil_fused_cuda(fields, (torch.zeros(8),), spec, 1, 0.01,
                               torch.ones(6), torch.ones(6))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
        TK.spec_launch_plan(16, 16, 8, spec, 1, 1, 132, 1)
    assert not TK.spec_on_card(spec)
    assert TK.LAUNCHES == before


@pytest.mark.parametrize("name,pv,Z,err,match", [
    ("lap_xyz", (torch.zeros(12),), 12, NotImplementedError, "line up"),
    ("lap_xyz", (), 10, ValueError, "indexes 1 parameter vectors"),
    ("yz_cross", (torch.zeros(0), torch.zeros(10)), 10, ValueError,
     "past its 0 elements"),
    ("yz_cross", (torch.zeros(2), torch.zeros(11)), 10, NotImplementedError,
     "holds 9 cells")])
def test_vectors_are_checked_before_the_build(name, pv, Z, err, match,
                                              monkeypatch):
    """The parameter vectors must fit the trace (enough of them, each
    scalar inside its vector, each z slice the Z - 2 interior cells); the
    route checks them before any build or launch."""
    monkeypatch.setattr(_build, "load_generated", _refuse)
    spec = spec_of(name)
    before = dict(TK.LAUNCHES)
    fields = [torch.zeros(1, 6, 6, Z)]
    with pytest.raises(err, match=match):
        TK._stencil_fused_cuda(fields, pv, spec, 1, 0.01, torch.ones(6),
                               torch.ones(6))
    assert TK.LAUNCHES == before


# --- the route to the generated build -------------------------------------

def test_generated_specs_plan_with_the_builds_of_their_field_count():
    """A generated functor plans as K6 does, with the builds of the
    shipped functor of its field count and its own z vectors."""
    for name, like, vectors in (("lap_xyz", 2, 1), ("yz_cross", 2, 1),
                                ("gray_scott", 0, 0), ("neg_shift", 0, 1)):
        spec = spec_of(name)
        op, stages = TK._cuda_instantiation(spec)
        assert op.like == like and op.n_vectors == vectors
        k = TK.spec_plan_knobs(spec, 2)
        assert k.n_fields == spec.n_fields and k.n_coef == vectors
        assert dict(k.builds) == _build.K6_BUILDS[like, 1]
        plan = TK.spec_launch_plan(64, 1024, 64, spec, 2, 1, 132, 1)
        assert plan.shared_bytes == TK.fused_shared_bytes(
            2, plan.S, plan.W, plan.cells_per_thread,
            n_fields=spec.n_fields, n_coef=vectors)


def test_build_spec_kernels_starts_each_build_once(monkeypatch):
    """The parallel build takes one job per distinct (text, flags): a
    shipped spec needs none, a second case of the same storage none."""
    jobs = []
    monkeypatch.setattr(_build, "build_generated", jobs.extend)
    cases = [(spec_of("lap_xyz"), torch.float32, False),
             (spec_of("lap_xyz"), torch.float32, True),    # f32: one build
             (spec_of("lap_xyz"), BF16, True),
             (spec_of("lap_xyz", "rk2"), BF16, False),
             (TSP.pw_advection_spec(), BF16, True)]
    assert TK.build_spec_kernels(cases) == 3
    assert len(jobs) == 3 and len(set(jobs)) == 3
    text, flags = jobs[1]
    assert "-DK6G_BF16=1" in flags and "-DK6G_COEF_BF16=1" in flags
    assert "-DK6G_THREADS_C2=512" in flags and "-DK6G_THREADS_C4=512" in flags
    assert "-DK6G_STAGES=2" in jobs[2][1]


def test_generated_source_is_registered():
    src = (_build.CSRC / _build.GENERATED_SOURCE).read_text()
    assert f'#include "{_build.K6_GENERATED_HEADER}"' in src
    assert '#include "stencil_fused.cuh"' in src
    assert set(_build.GENERATED_SIGNATURES) == {"k6_generated",
                                               "k6_generated_attrs"}
    assert len(_build.GENERATED_SIGNATURES["k6_generated"]) == 35
    for name in ("stencil_fused_bf16", "stencil_fused_bf16_coef"):
        assert len(_build.SIGNATURES[name]) == 35
        assert name + ".cu" in _build.SOURCES
    assert "stencil_fused.cuh" in _build.HEADERS


@pytest.mark.parametrize("name", ["lap_xyz", "yz_cross", "neg_shift"])
@pytest.mark.parametrize("Z", [6, 10])
def test_padded_parameter_table_serves_every_read(name, Z):
    """The table the launch passes a generated functor (`_param_block`
    with `Generated.pad`), read as the kernel reads it: each window cell's
    z coefficient at `zoff + z` of its vector lies inside the vector for
    every z, walls included, and at interior z is the element the callback
    reads (start + z - 1); each scalar's index is its element."""
    spec = spec_of(name)
    gen = spec.cuda_functor()
    pv = TK._spec_param_vectors(spec, params_of(name, Z, torch.float32),
                                "cpu")
    gen.check_vectors(name, pv, Z)
    table, p_len = TK._param_block(pv, "cpu", gen.pad)
    assert table.shape == (len(pv) * p_len,)
    assert p_len == max(p.shape[0] for p in pv) + 2 * gen.pad
    for p, (vec, start, cut) in enumerate(gen.zslots):
        zoff = start - 1 + gen.pad
        for z in range(Z):
            assert 0 <= zoff + z < p_len
            if 1 <= z <= Z - 2:
                assert table[vec * p_len + zoff + z] == pv[vec][start + z - 1]
    for vec, element, _ in gen.scalars:
        assert table[vec * p_len + element + gen.pad] == pv[vec][element]
    unpadded, n = TK._param_block(pv, "cpu")
    assert n == max(p.shape[0] for p in pv)
    assert torch.equal(unpadded[:pv[0].shape[0]], pv[0])
