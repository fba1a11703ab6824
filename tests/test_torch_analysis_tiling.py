"""The tiling and alignment linter (`repro_torch.analysis.tiling`): every
kernel op of a recorded program against what the card's kernels assume.
Mirrors the reference's `tests/test_analysis_tiling.py` cases (the repo's
kernels error-free, aligned rows without warnings, misaligned rows warning,
a window out of bounds, an in-place window that diverges, the grid cap),
plus the card's own: 16-byte bases, TMA strides and dense operands. The
programs are traced on fake CUDA tensors: nothing runs."""
import pytest
import torch

from repro_torch.analysis import programs as PR
from repro_torch.analysis import tiling as TL
from repro_torch.analysis import trace as TR
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection.ref import default_params
from repro_torch.kernels.attention import attention as TA

DT = 0.01


def lint(prog, **kw):
    with TR.fake_mode():
        fn, args = prog.build("cuda")
        return TL.lint_tiling(fn, *args, **kw)


@pytest.mark.parametrize("prog", PR.programs(small=True)
                         + (PR.ladder_program(8, 16, 32),
                            PR.ladder_program(8, 16, 32,
                                              dtype=torch.bfloat16)),
                         ids=lambda p: p.name)
def test_repo_programs_are_error_free(prog):
    report = lint(prog)
    assert report.kernels >= 1
    assert not report.errors, [str(e) for e in report.errors]
    report.raise_if_errors()


def test_line_aligned_rows_have_no_warnings():
    report = lint(PR.advance_program(8, 16, 32))   # 32 x 4 B = one line
    assert report.kernels == 5 and not report.issues


def test_misaligned_rows_warn_not_error():
    report = lint(PR.advance_program(6, 10, 12))   # 12 x 4 B = 48 B rows
    assert not report.errors
    kinds = {(i.kind, i.kernel) for i in report.warnings}
    assert kinds == {("line", "advect_fused"), ("line", "finite_guard")}
    assert "48 B is not a whole number of 128-byte lines" in \
        report.warnings[0].detail


def test_linter_takes_bf16_wide_rows_on_16_byte_bases():
    """2-byte rows of Z = 16 (32 B: two 16-byte vectors) on 16-byte bases
    lint clean but for the line warning; a base 8 bytes in is refused."""
    def lint_at(base):
        with TR.fake_mode():
            p = PR.place(default_params(16, dtype=torch.bfloat16, device="cpu"),
                         "cuda")
            bufs = [torch.empty(base + 4 * 8 * 16, dtype=torch.bfloat16, device="cuda")
                    for _ in range(3)]
            u, v, w = (b[base:].view(4, 8, 16) for b in bufs)
            return TL.lint_tiling(lambda: TK.advect_wide(
                u, v, w, p, fuse_update=True, dt=DT))

    report = lint_at(0)
    assert report.kernels == 1 and not report.errors
    assert {i.kind for i in report.warnings} == {"line"}
    with pytest.raises(ValueError, match="16-byte boundary"):
        lint_at(4)


def k1_call(shape, T=2, y_tile=0):
    """One K1 op on fake CUDA fields."""
    X, Y, Z = shape
    p = PR.place(default_params(Z, device="cpu"), "cuda")
    ones = PR.place((torch.ones(X), torch.ones(Y)), "cuda")
    u, v, w = (torch.empty((1,) + shape, device="cuda") for _ in range(3))
    return lambda: TK._OP_K1(u, v, w, *p, *ones, T, DT, y_tile)


def lint_k1_on_plan(monkeypatch, shape, plan, T):
    """The linter over one K1 op whose planner returns `plan`."""
    with monkeypatch.context() as m:
        m.setattr(TK, "fused_launch_plan", lambda *a, **k: plan)
        with TR.fake_mode():
            return TL.lint_tiling(k1_call(shape, T))


def test_tile_window_out_of_bounds_is_an_error(monkeypatch):
    shape, T = (6, 40, 64), 2
    good = TK.fused_launch_plan(*shape, T, 1, 132, 1, y_tile=8)
    ok = lint_k1_on_plan(monkeypatch, shape, good, T)
    # a slab taller than the tile and its halo: the last tile's slab
    # reaches past Y
    oob = lint_k1_on_plan(monkeypatch, shape, good._replace(S=good.S + 30), T)
    # a z window wider than the row
    zoob = lint_k1_on_plan(monkeypatch, shape, good._replace(W=80), T)
    assert not ok.errors
    for report, what in ((oob, "slab rows"), (zoob, "z window")):
        assert [i.kind for i in report.errors] == ["tile-oob"]
        assert what in report.errors[0].detail
        with pytest.raises(AssertionError, match="tile-oob"):
            report.raise_if_errors()


def test_in_place_window_divergence_is_an_error():
    with TR.fake_mode():
        q = torch.empty(1, 4, 128, 64, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(1, 2, 128, 64, device="cuda", dtype=torch.bfloat16)
        out = torch.empty(1, 4, 64, 64, device="cuda", dtype=torch.bfloat16)
        shape = TL.lint_tiling(
            lambda: TA._OP_K8(q, k, k, out, True, 0.125, 128, 128))
    assert [i.kind for i in shape.errors] == ["alias-shape"]
    # a written window reaching past its allocation (a record made by hand:
    # no tensor can be built so)
    with TR.fake_mode():
        recs = TR.record_ops(lambda: TA._OP_K8(q, k, k, torch.empty_like(q),
                                               True, 0.125, 128, 128))
    rec = recs[-1]
    args = dict(rec.args)
    args["out"] = args["out"].__class__(**{**args["out"].__dict__,
                                           "offset": 64})
    bad = rec.__class__(**{**rec.__dict__, "args": tuple(args.items())})
    report = TL.lint_records([bad])
    assert [i.kind for i in report.errors] == ["alias-window"]
    assert "past the buffer it aliases" in report.errors[0].detail


def test_grid_cap_falls_back_to_corners():
    assert len(TL._grid_points((4, 3, 2), 4096)) == 24
    corners = TL._grid_points((100, 100, 3), 16)
    assert sorted(corners) == sorted(
        [(a, b, c) for a in (0, 99) for b in (0, 99) for c in (0, 2)])
    # a K1 launch over a grid beyond the cap is checked at its corners
    shape, T = (300, 64, 64), 1
    plan = TK.fused_launch_plan(*shape, T, 1, 132, 1, y_tile=2)
    assert plan.n_ty * plan.n_cz * plan.n_cx > 8
    with TR.fake_mode():
        report = TL.lint_tiling(k1_call(shape, T, y_tile=2),
                                max_grid_points=8)
    assert not report.errors


def test_16_byte_bases_tma_strides_and_dense_operands():
    with TR.fake_mode():
        p = PR.place(default_params(16, device="cpu"), "cuda")
        base = torch.empty(3 * 8 * 16 + 1, device="cuda")
        # fields 4 bytes past their allocation: K2 wide moves float4s
        u = base[1:].view(3, 8, 16)
        wide = TL.lint_tiling(lambda: TK._OP_K2(u, u, u, *p, 0, True,
                                                True, DT))
        flow = TL.lint_tiling(lambda: TK._OP_K2(u, u, u, *p, 0, False,
                                                True, DT))
        # a transposed field: K1-K7 read their fields as one dense block
        t = torch.empty(8, 3, 16, device="cuda").transpose(0, 1)
        dense = TL.lint_tiling(lambda: TK._OP_K3(t, t, t, *p, 0, True,
                                                 DT))
        # bf16 K8 rows of 12 x 2 bytes: TMA takes 16-byte strides
        q = torch.empty(1, 2, 128, 12, device="cuda", dtype=torch.bfloat16)
        tma = TL.lint_tiling(lambda: TA._OP_K8(q, q, q, torch.empty_like(q),
                                               True, 0.3, 128, 128))
    assert [(i.kind, i.operand) for i in wide.errors] == \
        [("align16", n) for n in "uvw"]
    assert not flow.errors
    assert {i.kind for i in dense.errors} == {"contiguous"}
    assert {i.kind for i in tma.errors} == {"tma-stride"}
