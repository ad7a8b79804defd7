"""The spans and counters of ``relp_tpu_torch.utils.metrics`` inside the dual
re-solve and the driver's solve, on the CPU: the spans are the profiler's
``cpu_op`` events, nested as the dual's module docstring lists them, their
counts agree with the solve's iterations, reads and refactorizations, each
entry point leaves one record in ``metrics.recent()``, and nothing of it
changes the solve's arithmetic or runs while no profiler records."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from relp_tpu_torch.model.computational_form import build_computational_form
from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation
from relp_tpu_torch.model.general_form import GeneralForm, Variable
from relp_tpu_torch.simplex import reoptimize as reoptimize_module
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.simplex.driver import solve_computational_form
from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
from relp_tpu_torch.utils import metrics
from relp_tpu_torch.utils.config import SolverConfig

# span -> its parent (None: a solve's top span)
PARENT = {
    "reoptimize": None,
    "reoptimize.prepare": "reoptimize",
    "reoptimize.fallback": "reoptimize",
    "solve": None,
    "dual.solve": ("reoptimize", "solve"),
    "dual.refactor": "dual.solve",
    "dual.step": "dual.solve",
    "dual.read": "dual.solve",
    "dual.extract": "dual.solve",
    "dual.leaving": "dual.step",
    "dual.row": "dual.step",
    "dual.ratio": "dual.step",
    "dual.pivot": "dual.step",
}
DUAL_SPANS = {"reoptimize", "reoptimize.prepare", "dual.solve", "dual.refactor", "dual.step",
              "dual.read", "dual.extract", "dual.leaving", "dual.row", "dual.ratio",
              "dual.pivot"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dense_lp(m=16, n=48, seed=3):
    """portbench's dense family at a toy size: min c·x, A x = A x0, 0 <= x <= 2."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (m, n))
    x0 = rng.uniform(0.2, 1.0, n)
    return A, A @ x0, rng.uniform(0.1, 1.0, n), np.zeros(n), np.full(n, 2.0), x0


def tightened(seed=1, bounds=8):
    """The dense LP, its primal optimum, and upper bounds tightened to x0 on
    ``bounds`` columns: a re-solve the dual answers with bound flips."""
    A, b, c, lb, ub, x0 = dense_lp(seed=seed)
    t = [torch.tensor(v, dtype=torch.float64) for v in (A, b, c, lb, ub)]
    prior = solve_core(*t, SolverConfig(), 2000)
    assert int(prior.status) == st.OPTIMAL
    J = np.random.default_rng(seed).choice(A.shape[1], bounds, replace=False)
    ub2 = ub.copy()
    ub2[J] = x0[J]
    return (A, b, c, lb, ub2), prior


def spans_of(prof):
    """``(name, start, end)`` of the span events in a profile, by kind."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in PARENT:
            out.setdefault(e.activity_type(), []).append(
                (e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def innermost_parent(ev, events):
    """The name of the innermost span that encloses ``ev`` (None if none)."""
    name, s, t = ev
    around = [(s0, -t0, n0) for n0, s0, t0 in events
              if (n0, s0, t0) != ev and s0 <= s and t <= t0]
    return max(around)[2] if around else None


def resolve(cfg=None, profiled=False, data=None):
    (A, b, c, lb, ub), prior = data or tightened()
    cfg = cfg or SolverConfig()
    if not profiled:
        out = reoptimize_with_bounds(A, b, c, lb, ub, prior, cfg, device="cpu")
        return out, metrics.recent()[-1], None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = reoptimize_with_bounds(A, b, c, lb, ub, prior, cfg, device="cpu")
    return out, metrics.recent()[-1], prof


def test_spans_are_cpu_ops_nested_as_listed():
    out, rec, prof = resolve(profiled=True)
    assert int(out.status) == st.OPTIMAL and int(out.flips) > 0
    by_kind = spans_of(prof)
    assert set(by_kind) == {"cpu_op"}
    events = by_kind["cpu_op"]
    assert {n for n, _, _ in events} == DUAL_SPANS
    for ev in events:
        want = PARENT[ev[0]]
        got = innermost_parent(ev, events)
        assert got == want or (isinstance(want, tuple) and got in want), (ev[0], got)


@pytest.mark.parametrize("refactor_mode", ["polish", "full"])
def test_span_counts_match_the_solve(refactor_mode):
    cfg = SolverConfig(refactor_mode=refactor_mode)
    out, rec, prof = resolve(cfg, profiled=True)
    it = int(out.it)
    counts = {k: n for k, (n, _) in rec.spans.items()}
    for name in ("dual.step", "dual.leaving", "dual.row", "dual.ratio", "dual.pivot"):
        assert counts[name] == it
    assert counts["dual.read"] == it + 1
    assert counts["dual.refactor"] == rec.refactorizations >= 2
    assert counts["reoptimize"] == counts["dual.solve"] == counts["dual.extract"] == 1
    # the profile holds as many events as the record counts
    names = [n for n, _, _ in spans_of(prof)["cpu_op"]]
    assert {k: names.count(k) for k in counts} == counts
    if refactor_mode == "polish":
        assert out.host_reads == counts["dual.read"] + rec.refactorizations
        assert 1 <= rec.inverse_rebuilds < rec.refactorizations
    else:
        assert out.host_reads == counts["dual.read"]
        assert rec.inverse_rebuilds == rec.refactorizations
    assert all(sec > 0 for _, sec in rec.spans.values())
    assert rec.spans["dual.ratio"][1] <= rec.spans["dual.step"][1] <= rec.spans["dual.solve"][1]


def test_the_record_in_recent():
    before = len(metrics.recent())
    out, rec, _ = resolve(profiled=True)
    assert len(metrics.recent()) == min(before + 1, 1024)
    assert rec.call == "reoptimize" and rec.engine == "dual"
    assert rec.status == st.STATUS_TO_TYPE[st.OPTIMAL].value
    assert rec.iterations == int(out.it) and rec.bound_flips == int(out.flips) > 0
    assert rec.host_reads == out.host_reads == rec.spans["dual.read"][0] + rec.refactorizations
    assert rec.wall_s > rec.spans["dual.solve"][1] > 0
    assert (rec.m_padded, rec.n_padded, rec.device) == (16, 48, "cpu")
    _, rec2, _ = resolve()
    assert rec2.solve_id > rec.solve_id


def test_no_profiler_no_spans(monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("a span was entered while no profiler records")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Refused)
    out, rec, _ = resolve()
    assert rec.spans == {}
    assert rec.iterations == int(out.it) > 0 and rec.refactorizations >= 2
    assert rec.host_reads == out.host_reads == int(out.it) + 1 + rec.refactorizations
    assert rec.bound_flips == int(out.flips) and rec.inverse_rebuilds >= 1
    # and the guard is what keeps it off: on, the patched mark is entered
    with pytest.raises(AssertionError, match="no profiler"):
        resolve(profiled=True)


def test_the_profiler_changes_no_bit():
    data = tightened(seed=10)
    off, rec_off, _ = resolve(data=data)
    on, rec_on, _ = resolve(data=data, profiled=True)
    for f in ("x", "pi", "it", "basis", "vstat", "flips", "status"):
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    assert off.host_reads == on.host_reads
    assert (rec_off.iterations, rec_off.refactorizations, rec_off.inverse_rebuilds) == \
        (rec_on.iterations, rec_on.refactorizations, rec_on.inverse_rebuilds)


def test_without_record_function_fast_the_spans_fall_back(monkeypatch):
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    out, rec, prof = resolve(profiled=True)
    kinds = spans_of(prof)
    assert "cpu_op" not in kinds
    assert {n for n, _, _ in kinds["user_annotation"]} == DUAL_SPANS
    assert rec.spans["dual.step"][0] == int(out.it)


def _general_form(A, b, c, lb, ub):
    m, n = A.shape
    return GeneralForm(
        objective=Objective.MINIMIZE, A=sp.csc_matrix(A),
        constraint_types=[RangedConstraintRelation.equal()] * m, b=b,
        variables=[Variable(f"x{j}", cost=float(c[j]), lower=float(lb[j]), upper=float(ub[j]))
                   for j in range(n)],
        name="dense", row_names=[f"r{i}" for i in range(m)])


def test_the_driver_records_its_solve():
    A, b, c, lb, ub, _ = dense_lp(seed=4)
    cf = build_computational_form(_general_form(A, b, c, lb, ub), scale=False)
    cfg = SolverConfig(algorithm="dual", scale=False, presolve=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solve_computational_form(cf, cfg, device="cpu")
    rec = metrics.recent()[-1]
    assert res.is_optimal and rec is res.metrics
    assert rec.call == "solve" and rec.engine == "dual"
    assert rec.spans["solve"][0] == rec.spans["dual.solve"][0] == 1
    assert rec.spans["dual.step"][0] == rec.iterations == res.iterations
    assert rec.spans["dual.refactor"][0] == rec.refactorizations >= 2
    assert rec.host_reads == rec.spans["dual.read"][0] + rec.refactorizations
    assert 0 < rec.spans["solve"][1] <= rec.wall_s
    events = spans_of(prof)["cpu_op"]
    solve_ev = next(e for e in events if e[0] == "dual.solve")
    assert innermost_parent(solve_ev, events) == "solve"
    # untraced, the same record without spans
    res2 = solve_computational_form(cf, cfg, device="cpu")
    assert res2.metrics.spans == {} and res2.metrics.refactorizations == rec.refactorizations
    assert res2.metrics.solve_id > rec.solve_id


@pytest.mark.parametrize("warm_decides", [True, False])
def test_a_resolve_the_dual_cannot_answer_falls_back(monkeypatch, warm_decides):
    (A, b, c, lb, ub), prior = data = tightened()
    real = solve_core

    def warm_or_cold(*args, **kwargs):
        if kwargs.get("basis0") is not None and not warm_decides:
            return real(*args[:6], 0, **kwargs)  # a warm primal that cannot decide
        return real(*args, **kwargs)

    monkeypatch.setattr(reoptimize_module, "solve_core", warm_or_cold)
    # a dual that gives up at once: an iteration limit
    monkeypatch.setattr(reoptimize_module, "solve_core_dual",
                        lambda *a, **k: real(*a[:5], a[7], 0))
    out, rec, prof = resolve(profiled=True, data=data)
    assert int(out.status) == st.OPTIMAL
    assert rec.engine == ("dual→primal" if warm_decides else "dual→primal-cold")
    assert rec.spans["reoptimize.fallback"][0] == 1
    assert rec.iterations == int(out.it)  # the engines before it made none
    events = spans_of(prof)["cpu_op"]
    fb = next(e for e in events if e[0] == "reoptimize.fallback")
    assert innermost_parent(fb, events) == "reoptimize"
