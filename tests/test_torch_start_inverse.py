"""The start inverses that warm dual re-solves keep (``relp_tpu_torch/simplex/
dual.py``: ``StartInverse``, in its operator's ``Kept`` record;
``solve_core_dual(keep_start=True)``, which ``reoptimize_with_bounds`` asks
for).

On the CPU, on a dense LP and on a small GENRMF max flow on the ELL operator,
each re-solved warm from its base solve's basis through one operator: a hit
gives the miss's x, π, it, basis, vstat, flips, status and final B⁻¹ (its
strides too) bit for bit, the miss made on a fresh operator of the same
data, under other bounds and again after a hit, on the eager step and on
the static loop that stands in for the card's graph (the kept B⁻¹ is never
written); another basis, another ``art_sign`` or another ``refactor_mode``
misses and replaces the entry; a singular start is not kept; the entry dies
with its operator; threads re-solving on one operator match their twins; a
hit counts ``start_inverse_hits`` and one ``dual.start`` span, one
refactorization and one host read fewer than the miss; the driver's cold
dual keeps nothing.

On the card (the ``cuda`` marker; skips here; this file imports no JAX, so
``python -m pytest --noconftest tests/test_torch_start_inverse.py -q`` runs
it there): hit against miss through the graph path, equal in bits, on the
benchmark's dense LP and on a GENRMF max flow on ELL, with one capture on
an operator, in its first re-solve, and none for a hit.
"""

import copy
import dataclasses
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
from relp_tpu_torch.models.networks import max_flow_lp
from relp_tpu_torch.simplex import dual
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.driver import device_problem, solve_computational_form
from relp_tpu_torch.simplex.reoptimize import _repair_statuses, reoptimize_with_bounds
from relp_tpu_torch.utils import metrics
from relp_tpu_torch.utils.config import SolverConfig

FIELDS = ("x", "pi", "it", "basis", "vstat", "flips", "status")
DUAL = SolverConfig(algorithm="dual", scale=False, presolve=False, refactor_period=5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the problems: a base LP solved cold, re-solved warm under what-ifs ----

def dense_general(m, n, seed):
    """portbench's dense family: min c·x, A x = A x0, 0 <= x <= 2; and x0."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (m, n))
    x0 = rng.uniform(0.2, 1.0, n)
    c = rng.uniform(0.1, 1.0, n)
    general = GeneralForm(
        objective=Objective.MINIMIZE, A=sp.csc_matrix(A),
        constraint_types=[RangedConstraintRelation.equal()] * m, b=A @ x0,
        variables=[Variable(f"x{j}", cost=float(c[j]), lower=0.0, upper=2.0) for j in range(n)],
        name="dense", row_names=[f"r{i}" for i in range(m)])
    return general, x0


def rmf_arcs(frame, frames, seed, c1=1, c2=10_000):
    """Goldfarb and Grigoriadis's RMF network as DIMACS ``genrmf`` lays it
    out: ``frames`` frames of ``frame × frame`` grid nodes, grid arcs both
    ways of capacity ``c2 · frame²``, one arc from each node to a random
    permutation of the next frame of capacity U{c1..c2}."""
    rng = np.random.default_rng(seed)
    a2 = frame * frame
    node = np.arange(frames * a2).reshape(frames, frame, frame)
    arcs = []
    for u, v in ((node[:, :, :-1], node[:, :, 1:]), (node[:, :-1, :], node[:, 1:, :])):
        for t, h in zip(u.ravel(), v.ravel()):
            arcs += [(int(t), int(h), c2 * a2), (int(h), int(t), c2 * a2)]
    layer = node.reshape(frames, a2)
    for f in range(frames - 1):
        for t, h in zip(layer[f], layer[f + 1][rng.permutation(a2)]):
            arcs.append((int(t), int(h), int(rng.integers(c1, c2 + 1))))
    return sorted(arcs)


def problem(case, dev, cfg=DUAL):
    """The base LP of ``case`` solved cold by the dual on ``dev``, its padded
    arrays (``driver.device_problem``), the prior and the what-ifs: a dense
    LP with 8 upper bounds tightened to x0, or a GENRMF max flow on ELL with
    8 arcs that carry flow cut to half their flow."""
    if case == "dense":
        general, x0 = dense_general(16, 48, seed=3)
    elif case == "bench-dense":
        general, x0 = dense_general(768, 1536, seed=DENSE_SEED)
    else:
        frame, frames = (3, 4) if case == "maxflow" else (8, 16)
        nodes = frame * frame * frames
        general = max_flow_lp(nodes, rmf_arcs(frame, frames, seed=7), 0, nodes - 1)
        cfg = dataclasses.replace(cfg, matrix_format="ell")
    cf = build_computational_form(general, scale=False)
    root = solve_computational_form(cf, cfg, device=dev)
    assert root.is_optimal
    P = device_problem(cf, cfg, dev)
    assert P.A.format == ("dense" if "dense" in case else "ell")
    n = cf.n
    if "dense" in case:
        def ub_of(k, bounds=8):
            ub = P.ub.clone()
            J = np.random.default_rng([17, k]).choice(n, bounds, replace=False)
            ub[J] = torch.as_tensor(x0[J], dtype=ub.dtype, device=ub.device)
            return ub
    else:
        flow = root.x_structural
        carrying = np.flatnonzero(flow > 0)

        def ub_of(k, bounds=8):
            ub = P.ub.clone()
            J = np.random.default_rng([17, k]).choice(carrying, bounds, replace=False)
            ub[J] = torch.as_tensor(flow[J] / 2, dtype=ub.dtype, device=ub.device)
            return ub
    prior = SimpleNamespace(**{k: torch.as_tensor(getattr(root, k), device=dev)
                               for k in ("basis", "vstat", "art_sign")})
    return SimpleNamespace(cf=cf, cfg=cfg, dev=dev, P=P, ub_of=ub_of, prior=prior)


def fresh(Q):
    """A new operator of ``Q``'s data: one the store has never seen."""
    return device_problem(Q.cf, Q.cfg, Q.dev).A


def warm(Q, op, k, cfg=None, basis=None, art_sign=None):
    """What-if ``k`` re-solved warm on ``op`` as ``reoptimize_with_bounds``
    solves it (``keep_start``); its output, final B⁻¹ and counters."""
    P, prior = Q.P, Q.prior
    ub = Q.ub_of(k)
    vstat0 = _repair_statuses(prior.vstat[: P.n_pad], P.lb, ub)
    final = []
    with metrics.recording("test") as rec:
        out = dual.solve_core_dual(
            op, P.b, P.c, P.lb, ub, prior.basis if basis is None else basis, vstat0,
            cfg or Q.cfg, P.max_iter,
            art_sign0=prior.art_sign if art_sign is None else art_sign,
            final_state=final, keep_start=True)
    return out, final[0][1].Binv, rec


def assert_same(a, b, where):
    (out_a, binv_a, _), (out_b, binv_b, _) = a, b
    for f in FIELDS:
        assert torch.equal(getattr(out_a, f), getattr(out_b, f)), (where, f)
    assert torch.equal(binv_a, binv_b) and binv_a.stride() == binv_b.stride(), where


def kept_start(op):
    """The start inverse kept for ``op``, or None."""
    return getattr(dual._KEPT.get(op), "start", None)


def starts():
    """How many operators keep a start inverse."""
    return sum(kept.start is not None for kept in list(dual._KEPT.values()))


def static_loop(mp):
    """The CPU's loop over the graphs' static state, as on the card, with a
    stand-in for the capture whose replay runs the captured body eagerly
    (tests/test_torch_dual_graph.py)."""
    def capture(self, Ks):
        Ks = copy.copy(Ks)
        Ks.A = weakref.proxy(Ks.A)
        self.replay = functools.partial(self.body, Ks)

    mp.setattr(dual, "_graphable", lambda A: True)
    mp.setattr(dual.StepGraph, "_capture", capture)


@pytest.fixture(scope="module", params=["dense", "maxflow"])
def cpu_problem(request):
    return problem(request.param, torch.device("cpu"))


# ---- the CPU ----

@pytest.mark.parametrize("path", ["eager", "static"])
def test_a_hit_repeats_the_miss_bit_for_bit(cpu_problem, path, monkeypatch):
    Q = cpu_problem
    if path == "static":
        static_loop(monkeypatch)
    op = fresh(Q)
    runs = []
    for i, k in enumerate((0, 1, 0, 2)):  # a miss, then hits under other bounds
        got = warm(Q, op, k)
        twin = warm(Q, fresh(Q), k)
        assert got[2].start_inverse_hits == (i > 0) and twin[2].start_inverse_hits == 0
        assert int(got[0].status) == st.OPTIMAL
        assert_same(twin, got, (path, k))
        runs.append(got)
        kept = kept_start(op)
        if i == 0:
            first_kept = kept.Binv.clone()
        # the steps never write the kept inverse
        assert kept.Binv is kept_start(op).Binv and torch.equal(kept.Binv, first_kept)
    assert_same(runs[0], runs[2], (path, "again"))
    assert sum(int(r[0].flips) for r in runs) + sum(int(r[0].it) for r in runs) > 0


def another_basis(Q):
    """The optimal basis of what-if 1: a start the store has not seen."""
    out, _, _ = warm(Q, fresh(Q), 1)
    assert not torch.equal(out.basis, Q.prior.basis)
    return dict(basis=out.basis)


@pytest.mark.parametrize("change", ["basis", "art_sign", "refactor_mode"])
def test_another_start_misses_and_replaces_the_entry(cpu_problem, change):
    Q = cpu_problem
    op = fresh(Q)
    warm(Q, op, 0)
    assert warm(Q, op, 0)[2].start_inverse_hits == 1
    other = {"basis": lambda: another_basis(Q),
             "art_sign": lambda: dict(art_sign=-Q.prior.art_sign),
             "refactor_mode": lambda: dict(cfg=dataclasses.replace(Q.cfg, refactor_mode="full"))
             }[change]()
    miss = warm(Q, op, 2, **other)
    assert miss[2].start_inverse_hits == 0
    assert_same(warm(Q, fresh(Q), 2, **other), miss, change)
    kept = kept_start(op)
    if change == "refactor_mode":
        assert kept.refactor_mode == "full"
    else:
        assert torch.equal(getattr(kept, change), other[change])
    # the new start hits now, the old one misses
    assert warm(Q, op, 3, **other)[2].start_inverse_hits == 1
    assert warm(Q, op, 3)[2].start_inverse_hits == 0


@pytest.mark.parametrize("mode", ["polish", "full"])
def test_a_singular_start_is_not_kept(cpu_problem, mode):
    Q = cpu_problem
    cfg = dataclasses.replace(Q.cfg, refactor_mode=mode)
    op = fresh(Q)
    basis = Q.prior.basis.clone()
    basis[1] = basis[0]  # two equal columns of B
    out, _, rec = warm(Q, op, 0, cfg=cfg, basis=basis)
    assert int(out.status) == st.NUMERICAL and rec.start_inverse_hits == 0
    assert kept_start(op) is None
    out, _, rec = warm(Q, op, 0, cfg=cfg, basis=basis)
    assert rec.start_inverse_hits == 0 and kept_start(op) is None
    # a sound start on the same operator is kept
    warm(Q, op, 0, cfg=cfg)
    assert kept_start(op) is not None


def test_the_entry_dies_with_its_operator(cpu_problem):
    Q = cpu_problem
    op = fresh(Q)
    warm(Q, op, 0)
    assert kept_start(op) is not None
    gc.collect()
    before = starts()
    del op
    gc.collect()
    assert starts() == before - 1


def threaded(jobs):
    """Run each job in a thread of its own, all at once; their results."""
    out, errors = [None] * len(jobs), []
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
        t.join(timeout=300)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("path", ["eager", "static"])
def test_threads_resolving_on_one_operator_match_their_twins(cpu_problem, path, monkeypatch):
    Q = cpu_problem
    ks = [list(range(i, 12, 3)) for i in range(3)]
    twins = {k: warm(Q, fresh(Q), k) for k in range(12)}
    if path == "static":
        static_loop(monkeypatch)
    op = fresh(Q)
    outs = threaded([lambda mine=mine: {k: warm(Q, op, k) for k in mine} for mine in ks])
    hits = 0
    for mine, out in zip(ks, outs):
        for k in mine:
            assert_same(twins[k], out[k], k)
            hits += out[k][2].start_inverse_hits
    assert 9 <= hits <= 11  # each thread's first re-solve may race the first store


def test_a_hit_counts_and_spans(cpu_problem):
    Q = cpu_problem
    op = fresh(Q)
    recs = []
    for _ in range(2):  # a miss, then a hit
        with profile(activities=[ProfilerActivity.CPU]):
            out = reoptimize_with_bounds(op, Q.P.b, Q.P.c, Q.P.lb, Q.ub_of(4), Q.prior, Q.cfg,
                                         max_iter=Q.P.max_iter)
        assert int(out.status) == st.OPTIMAL
        rec = metrics.recent()[-1]
        assert rec.host_reads == rec.spans["dual.read"][0] + rec.refactorizations
        assert rec.spans["dual.refactor"][0] == rec.refactorizations
        recs.append(rec)
    miss, hit = recs
    assert (miss.start_inverse_hits, hit.start_inverse_hits) == (0, 1)
    assert "dual.start" not in miss.spans and hit.spans["dual.start"][0] == 1
    assert hit.refactorizations == miss.refactorizations - 1
    assert hit.host_reads == miss.host_reads - 1
    assert hit.inverse_rebuilds == miss.inverse_rebuilds - 1  # the start's LU
    assert (hit.iterations, hit.bound_flips) == (miss.iterations, miss.bound_flips)


def test_the_cold_dual_keeps_nothing(cpu_problem):
    Q = cpu_problem
    gc.collect()
    before = starts()
    res = solve_computational_form(Q.cf, Q.cfg, device="cpu")
    assert res.is_optimal and res.metrics.start_inverse_hits == 0
    assert starts() == before


# ---- the card ----

@pytest.fixture(scope="module", params=["bench-dense", "genrmf-1024"])
def card_problem(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return problem(request.param, torch.device("cuda"),
                   dataclasses.replace(DUAL, refactor_period=SolverConfig().refactor_period))


@pytest.mark.cuda
def test_a_hit_repeats_the_miss_through_the_graph(card_problem):
    Q = card_problem
    op = fresh(Q)
    for i, k in enumerate((0, 1, 0, 2, 3)):
        got = warm(Q, op, k)
        twin = warm(Q, fresh(Q), k)
        rec, rec_twin = got[2], twin[2]
        assert int(got[0].status) == st.OPTIMAL
        assert rec.graph_steps == int(got[0].it) > 0
        assert rec.start_inverse_hits == (i > 0) and rec_twin.start_inverse_hits == 0
        assert_same(twin, got, k)
        assert len(dual._KEPT[op].graphs) == 1
        # one capture on an operator, in its first re-solve: a hit captures nothing
        assert (rec.graph_captures, rec_twin.graph_captures) == (i == 0, 1)
        if i > 0:
            assert rec.refactorizations == rec_twin.refactorizations - 1
    torch.cuda.synchronize()
