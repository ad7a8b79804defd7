"""The dual loop's captured step (``relp_tpu_torch/simplex/dual.py``:
``StepGraph``, kept in its operator's ``Kept`` record).

On the CPU, with a stand-in for the capture whose replay runs the captured
body eagerly (``static_loop``): the loop over the static tensors (inputs and
state copied in, the step's replaced fields copied back, each
refactorization stored into the one graph's row-major state, the state
copied out) gives the eager loop's x, π, it, basis, vstat and flips bit for
bit, over full solves and re-solves sharing one operator, under each weight
rule and ratio test, with one capture per operator and options over LU
rebuilds and polishes alike, and so do re-solves that two threads run at
once on one operator; the CPU itself steps eagerly, with the graph counters
at 0 and the inner spans entered; the graphs die with their operator.

On the card (the ``cuda`` marker; skips here; this file imports no JAX, so
``python -m pytest --noconftest tests/test_torch_dual_graph.py -q`` runs it
there): the replayed graph against the eager step on the benchmark's dense
LP over its 16 what-ifs, one capture, in the first re-solve on an
operator, changed bounds on one operator, a second operator after a larger
scratch replaced the capture stream's, threads re-solving at once on one
operator and on two while another solves with the primal, and the ELL and
hybrid operators.
"""

import copy
import functools
import gc
import threading
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from relp_tpu_torch.model.computational_form import build_computational_form
from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation
from relp_tpu_torch.model.general_form import GeneralForm, Variable
from relp_tpu_torch.models.dense import SEED as DENSE_SEED
from relp_tpu_torch.ops import select_epilogue
from relp_tpu_torch.ops.amatrix import DenseMatrix
from relp_tpu_torch.simplex import dual
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.simplex.driver import _round_up, solve_computational_form
from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
from relp_tpu_torch.utils import metrics
from relp_tpu_torch.utils.config import SolverConfig

FIELDS = ("x", "pi", "it", "basis", "vstat", "flips", "status")
OPTIONS = [dict(dual_pricing=p, dual_ratio=r) for p in ("dse", "devex") for r in ("sort", "bisect")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dense_data(m, n, seed):
    """portbench's dense family: min c·x, A x = A x0, 0 <= x <= 2."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (m, n))
    x0 = rng.uniform(0.2, 1.0, n)
    return A, A @ x0, rng.uniform(0.1, 1.0, n), x0


def general_form(A, b, c, ub):
    m, n = A.shape
    return GeneralForm(
        objective=Objective.MINIMIZE, A=sp.csc_matrix(A),
        constraint_types=[RangedConstraintRelation.equal()] * m, b=b,
        variables=[Variable(f"x{j}", cost=float(c[j]), lower=0.0, upper=float(ub[j]))
                   for j in range(n)],
        name="dense", row_names=[f"r{i}" for i in range(m)])


def what_if(x0, k, bounds, pool_seed=17):
    """The upper bounds of what-if ``k``: ``bounds`` columns tightened to x0
    (portbench's pool, ``kinds/resolve.py``)."""
    n = len(x0)
    ub = np.full(n, 2.0)
    J = np.random.default_rng([pool_seed, k]).choice(n, bounds, replace=False)
    ub[J] = x0[J]
    return ub


def assert_same(a, b, where):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), (where, f)


def kept_dual_outputs(mp):
    """Keep every ``solve_core_dual`` output the driver makes."""
    kept, real = [], dual.solve_core_dual

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        kept.append(out)
        return out

    mp.setattr(dual, "solve_core_dual", keep)
    return kept


def graphs_of(op):
    """The step graphs ``op`` keeps, by options."""
    return getattr(dual._KEPT.get(op), "graphs", {})


# ---- the CPU ----

def static_loop(mp):
    """Run the CPU's dual loop over the static state, as on the card, with a
    stand-in for the capture whose replay runs the captured body eagerly (on
    a weak proxy of the operator, which a graph does not keep alive)."""
    def capture(self, Ks):
        Ks = copy.copy(Ks)
        Ks.A = weakref.proxy(Ks.A)
        self.replay = functools.partial(self.body, Ks)

    mp.setattr(dual, "_graphable", lambda A: True)
    mp.setattr(dual.StepGraph, "_capture", capture)


def threaded(jobs):
    """Run each job in a thread of its own, all at once; their results."""
    out = [None] * len(jobs)
    errors = []
    start = threading.Barrier(len(jobs))

    def run(i):
        try:
            start.wait()
            out[i] = jobs[i]()
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def cpu_solves(mp, opts, data):
    """A full dual solve through the driver and three re-solves on one
    operator; their outputs, the operator and the re-solves' records."""
    A, b, c, x0 = data
    cfg = SolverConfig(algorithm="dual", scale=False, presolve=False, refactor_period=5, **opts)
    kept = kept_dual_outputs(mp)
    res = solve_computational_form(build_computational_form(
        general_form(A, b, c, np.full(A.shape[1], 2.0)), scale=False), cfg, device="cpu")
    assert res.is_optimal and len(kept) == 1
    t = [torch.tensor(v, dtype=torch.float64) for v in (A, b, c)]
    lb = torch.zeros(A.shape[1], dtype=torch.float64)
    prior = solve_core(*t, lb, lb + 2.0, SolverConfig(), 2000)
    op = DenseMatrix(t[0])
    recs = []
    for k in range(3):
        kept.append(reoptimize_with_bounds(op, t[1], t[2], lb, what_if(x0, k, 8), prior, cfg))
        recs.append(metrics.recent()[-1])
        assert int(kept[-1].status) == st.OPTIMAL
    assert sum(int(out.flips) for out in kept[1:]) > 0  # the ratio test flipped bounds
    return kept, op, recs


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: f"{o['dual_pricing']}-{o['dual_ratio']}")
def test_the_static_loop_repeats_the_eager_bits(monkeypatch, opts):
    data = dense_data(16, 48, seed=3)
    with monkeypatch.context() as mp:
        eager, op_eager, _ = cpu_solves(mp, opts, data)
    assert not graphs_of(op_eager)
    with monkeypatch.context() as mp:
        static_loop(mp)
        static, op, recs = cpu_solves(mp, opts, data)
        # the re-solves share one graph, captured once, over LU rebuilds and
        # polishes alike: every B⁻¹ is row-major
        assert sum(r.inverse_rebuilds for r in recs) >= 1
        assert sum(r.refactorizations - r.inverse_rebuilds for r in recs) >= 1
        assert [r.graph_captures for r in recs] == [1, 0, 0]
        (graph,) = dual._KEPT[op].graphs.values()
        assert graph.state.Binv.is_contiguous()
    for k, (e, s) in enumerate(zip(eager, static)):
        assert_same(e, s, k)
        # nothing returned is a static tensor
        assert s.basis.data_ptr() != graph.state.basis.data_ptr()


def test_the_cpu_steps_eagerly():
    data = dense_data(16, 48, seed=5)
    A, b, c, x0 = data
    t = [torch.tensor(v, dtype=torch.float64) for v in (A, b, c)]
    lb = torch.zeros(48, dtype=torch.float64)
    prior = solve_core(*t, lb, lb + 2.0, SolverConfig(), 2000)
    op = DenseMatrix(t[0])
    with profile(activities=[ProfilerActivity.CPU]):
        out = reoptimize_with_bounds(op, t[1], t[2], lb, what_if(x0, 0, 8), prior)
    rec = metrics.recent()[-1]
    assert int(out.status) == st.OPTIMAL
    assert rec.graph_steps == rec.graph_captures == 0
    for name in ("dual.step", "dual.leaving", "dual.row", "dual.ratio", "dual.pivot"):
        assert rec.spans[name][0] == int(out.it)
    assert "dual.capture" not in rec.spans
    assert not graphs_of(op)
    cfg = SolverConfig(algorithm="dual", scale=False, presolve=False)
    res = solve_computational_form(build_computational_form(
        general_form(A, b, c, np.full(48, 2.0)), scale=False), cfg, device="cpu")
    assert res.is_optimal
    assert res.metrics.graph_steps == res.metrics.graph_captures == 0


def test_graphs_engage_by_device_and_type():
    # the device decides; an operator of any type on the card replays
    assert not dual._graphable(DenseMatrix(torch.zeros(2, 2, dtype=torch.float64)))
    assert dual._graphable(SimpleNamespace(device=torch.device("cuda", 0)))


def test_threads_resolving_on_one_operator_match_their_eager_twins(monkeypatch):
    A, b, c, x0 = dense_data(16, 48, seed=3)
    t = [torch.tensor(v, dtype=torch.float64) for v in (A, b, c)]
    lb = torch.zeros(48, dtype=torch.float64)
    cfg = SolverConfig(refactor_period=5)
    prior = solve_core(*t, lb, lb + 2.0, SolverConfig(), 2000)
    ks = [list(range(i, 24, 3)) for i in range(3)]
    eager = {k: reoptimize_with_bounds(DenseMatrix(t[0]), t[1], t[2], lb, what_if(x0, k, 8),
                                       prior, cfg) for k in sum(ks, [])}
    static_loop(monkeypatch)
    op = DenseMatrix(t[0])
    outs = threaded([
        lambda mine=mine: {k: reoptimize_with_bounds(op, t[1], t[2], lb, what_if(x0, k, 8),
                                                     prior, cfg) for k in mine}
        for mine in ks])
    for mine, out in zip(ks, outs):
        for k in mine:
            assert_same(eager[k], out[k], k)


def test_the_graphs_die_with_their_operator(monkeypatch):
    A, b, c, x0 = dense_data(16, 48, seed=3)
    t = [torch.tensor(v, dtype=torch.float64) for v in (A, b, c)]
    lb = torch.zeros(48, dtype=torch.float64)
    prior = solve_core(*t, lb, lb + 2.0, SolverConfig(), 2000)
    static_loop(monkeypatch)
    op = DenseMatrix(t[0].clone())
    reoptimize_with_bounds(op, t[1], t[2], lb, what_if(x0, 1, 8), prior)
    assert dual._KEPT[op].graphs
    before = len(dual._KEPT)
    del op
    gc.collect()
    assert len(dual._KEPT) == before - 1


# ---- the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


def padded_problem(m, n, seed, dev):
    """portbench's ``kinds/resolve.py`` set-up: the base LP solved cold by
    the device dual, its padded arrays on ``dev`` and the prior."""
    A, b, c, x0 = dense_data(m, n, seed)
    cfg = SolverConfig(algorithm="dual", scale=False, presolve=False)
    cf = build_computational_form(general_form(A, b, c, np.full(n, 2.0)), scale=False)
    root = solve_computational_form(cf, cfg, device=dev)
    assert root.is_optimal
    m_pad, n_pad = _round_up(m, cfg.row_align), _round_up(n, cfg.col_align)
    Ap = np.zeros((m_pad, n_pad))
    Ap[:m, :n] = A

    def pad(v, size):
        out = np.zeros(size)
        out[: len(v)] = v
        return out

    f64 = dict(dtype=torch.float64, device=dev)
    prior = SimpleNamespace(**{k: torch.as_tensor(getattr(root, k), device=dev)
                               for k in ("basis", "vstat", "art_sign")})
    return dict(A=torch.tensor(Ap, **f64), b=torch.tensor(pad(b, m_pad), **f64),
                c=torch.tensor(pad(c, n_pad), **f64), n_pad=n_pad, x0=x0, prior=prior,
                cfg=cfg, max_iter=cfg.resolve_max_iter(m_pad, n_pad), base=root)


def resolve_on(P, op, k, bounds=16, graphed=True, monkeypatch=None):
    ub = np.zeros(P["n_pad"])
    ub[: len(P["x0"])] = what_if(P["x0"], k, bounds)
    lb = np.zeros(P["n_pad"])
    with monkeypatch.context() as mp:
        if not graphed:
            mp.setattr(dual, "_graphable", lambda A: False)
        out = reoptimize_with_bounds(op, P["b"], P["c"], lb, ub, P["prior"], config=P["cfg"],
                                     max_iter=P["max_iter"])
    return out, metrics.recent()[-1]


def differences(e, g):
    return {f: float((getattr(e, f).double() - getattr(g, f).double()).abs().max())
            for f in ("x", "pi")}


@pytest.fixture(scope="module")
def bench_lp():
    """The benchmark's cell: dense-768x1536 at its base seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return padded_problem(768, 1536, DENSE_SEED, torch.device("cuda"))


@pytest.mark.cuda
def test_the_graph_repeats_the_eager_step_on_the_benchmark_lp(cuda, bench_lp, monkeypatch):
    P = bench_lp
    assert P["base"].metrics.graph_captures == 1
    assert P["base"].metrics.graph_steps == P["base"].metrics.iterations
    op_eager, op = DenseMatrix(P["A"]), DenseMatrix(P["A"])
    captures = []
    for k in range(16):
        e, rec_e = resolve_on(P, op_eager, k, graphed=False, monkeypatch=monkeypatch)
        g, rec_g = resolve_on(P, op, k, monkeypatch=monkeypatch)
        assert int(g.status) == st.OPTIMAL
        assert rec_e.graph_steps == rec_e.graph_captures == 0
        assert rec_g.graph_steps == rec_g.iterations == int(g.it)
        captures.append(rec_g.graph_captures)
        for f in ("it", "basis", "vstat", "flips", "status"):
            assert torch.equal(getattr(e, f), getattr(g, f)), (k, f)
        assert torch.equal(e.x, g.x) and torch.equal(e.pi, g.pi), (k, differences(e, g))
    # one capture, in the first re-solve only, for LU rebuilds and polishes
    assert captures == [1] + [0] * 15
    assert len(dual._KEPT[op].graphs) == 1


@pytest.mark.cuda
def test_one_capture_serves_every_resolve(cuda, bench_lp, monkeypatch):
    P = bench_lp
    op = DenseMatrix(P["A"])
    recs = [resolve_on(P, op, k % 16, monkeypatch=monkeypatch)[1] for k in range(6)]
    assert [r.graph_captures for r in recs] == [1] + [0] * 5
    assert sum(r.graph_steps for r in recs) == sum(r.iterations for r in recs)


@pytest.fixture(scope="module")
def small_lp():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return padded_problem(256, 512, 7, torch.device("cuda"))


@pytest.mark.cuda
def test_changed_bounds_on_one_operator_match_their_eager_twins(cuda, small_lp, monkeypatch):
    P = small_lp
    op = DenseMatrix(P["A"])
    for k in (3, 9, 3, 12):  # back and forth: no static input may be stale
        e, _ = resolve_on(P, DenseMatrix(P["A"]), k, 24, graphed=False, monkeypatch=monkeypatch)
        g, rec = resolve_on(P, op, k, 24, monkeypatch=monkeypatch)
        assert rec.graph_steps == int(g.it) > 0
        assert_same(e, g, k)


@pytest.mark.cuda
def test_a_second_operator_and_a_larger_scratch_leave_the_first_graph_sound(
        cuda, small_lp, bench_lp, monkeypatch):
    P, Q = small_lp, bench_lp
    op = DenseMatrix(P["A"])
    first, _ = resolve_on(P, op, 5, 24, monkeypatch=monkeypatch)
    # another shape gets its own graphs; then the capture stream's scratch
    # is replaced by a larger one, its old memory handed out and scribbled on
    op2 = DenseMatrix(Q["A"])
    _, rec2 = resolve_on(Q, op2, 1, monkeypatch=monkeypatch)
    assert rec2.graph_captures == 1 and op2 in dual._KEPT
    stream = dual._capture_stream(cuda).cuda_stream
    old = select_epilogue.current_workspace(cuda, stream)
    with torch.cuda.stream(dual._capture_stream(cuda)):
        select_epilogue.workspace(cuda, stream, 1 << 16, 1 << 12, 1 << 24)
        del old
        gc.collect()
        junk = [torch.full((1 << 18,), -1, dtype=torch.int32, device=cuda) for _ in range(64)]
    torch.cuda.synchronize()
    again, rec = resolve_on(P, op, 5, 24, monkeypatch=monkeypatch)
    assert rec.graph_captures == 0 and rec.graph_steps == int(again.it)
    assert_same(first, again, "after")
    eager, _ = resolve_on(P, DenseMatrix(P["A"]), 5, 24, graphed=False, monkeypatch=monkeypatch)
    assert_same(eager, again, "eager")
    del junk


@pytest.mark.cuda
def test_threads_resolving_at_once_match_their_eager_twins(cuda, small_lp, monkeypatch):
    P = small_lp
    ks = [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10)]
    eager = {k: resolve_on(P, DenseMatrix(P["A"]), k, 24, graphed=False,
                           monkeypatch=monkeypatch)[0] for k in sum(ks, ())}
    ub = torch.full((P["n_pad"],), 2.0, dtype=torch.float64, device=cuda)
    lb = torch.zeros_like(ub)
    primal = solve_core(P["A"], P["b"], P["c"], lb, ub, P["cfg"], 4000)
    shared, own = DenseMatrix(P["A"]), DenseMatrix(P["A"].clone())

    def resolves(op, mine):
        return {k: reoptimize_with_bounds(op, P["b"], P["c"], np.zeros(P["n_pad"]),
                                          np.r_[what_if(P["x0"], k, 24),
                                                np.zeros(P["n_pad"] - len(P["x0"]))],
                                          P["prior"], config=P["cfg"], max_iter=P["max_iter"])
                for k in mine}

    def primal_solves():  # allocates on the device while the others capture
        return [solve_core(P["A"], P["b"], P["c"], lb, ub, P["cfg"], 4000) for _ in range(3)]

    # two threads on one operator, a third capturing on another
    *outs, primals = threaded([functools.partial(resolves, shared, ks[0]),
                               functools.partial(resolves, shared, ks[1]),
                               functools.partial(resolves, own, ks[2]), primal_solves])
    torch.cuda.synchronize()
    for mine, out in zip(ks, outs):
        for k in mine:
            assert_same(eager[k], out[k], k)
    for again in primals:
        assert torch.equal(again.x, primal.x) and int(again.it) == int(primal.it)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["ell", "hybrid"])
def test_sparse_operators_replay_as_they_step(cuda, fmt, monkeypatch):
    from relp_tpu_torch.models.networks import max_flow_lp, random_arcs

    general = max_flow_lp(256, random_arcs(256, 4, seed=2), 0, 255)
    cf = build_computational_form(general, scale=False)
    cfg = SolverConfig(algorithm="dual", matrix_format=fmt, presolve=False, scale=False)
    outs = {}
    for graphed in (False, True):
        with monkeypatch.context() as mp:
            if not graphed:
                mp.setattr(dual, "_graphable", lambda A: False)
            kept = kept_dual_outputs(mp)
            res = solve_computational_form(cf, cfg, device=cuda)
        assert res.is_optimal and res.metrics.matrix_format == fmt
        assert (res.metrics.graph_steps > 0) == graphed
        outs[graphed] = kept[-1]
    assert_same(outs[False], outs[True], fmt)
