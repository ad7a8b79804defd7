"""The dual step's update kernel (``relp_tpu_torch/ops/dual_kernels.py``:
``dual_update``, ``csrc/dual_kernels.cu``) and its plain version
(``simplex/dual.py::dual_update_plain``).

On the CPU: the dual's update (``dual.pivot_update``) is the plain version
on a mid-solve state and launches nothing, and the kernel's wrapper refuses
CPU tensors and operands it does not take; ``DualKernel.step`` gives, at every step of cold solves and
re-solves on the dense and ELL operators under each weight rule and ratio
test, the bits of the step as it was before its update moved into
``dual_update`` (:func:`step_before`, kept here as the reference); the
kernel's status codes are ``simplex/status.py``'s; ``update_kernel_steps``
reads 0.

On the card (the ``cuda`` marker; skips here; this file imports no JAX, so
``python -m pytest --noconftest tests/test_torch_dual_update.py -q`` runs it
there): the kernel against the plain version on CUDA tensors, every output
bit for bit, at every step of the benchmark's dense LP over its 16 what-ifs
under ``dse``/``devex`` × ``sort``/``bisect`` and of a GENRMF max flow on
ELL; on states built from a mid-solve one (primal feasible and fresh, no
entering column, NaN in xB, a pivot under ``eps_pivot`` and one of 0, no
flips, an artificial leaving, a fixed leaving column); whole re-solves with
``dual_update_plain`` in the kernel's place equal in bits (and
``update_kernel_steps`` 0 for those); and ``update_kernel_steps`` equal to
the iterations, graphed and eager.
"""

import copy
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.families.genrmf import rmf_arcs
from relp_tpu_torch.model.computational_form import build_computational_form
from relp_tpu_torch.models.networks import max_flow_lp
from relp_tpu_torch.ops import dual_kernels
from relp_tpu_torch.ops.amatrix import DenseMatrix
from relp_tpu_torch.ops.dual_kernels import Pivot, dual_update
from relp_tpu_torch.ops.linalg import rank_one_basis_update
from relp_tpu_torch.simplex import dual
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import _at, _put, solve_core
from relp_tpu_torch.simplex.dual import dual_update_plain, pivot_update
from relp_tpu_torch.simplex.driver import solve_computational_form
from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
from relp_tpu_torch.utils import metrics
from relp_tpu_torch.utils.config import SolverConfig
from test_torch_dual_graph import (
    OPTIONS,
    assert_same,
    dense_data,
    general_form,
    padded_problem,
    resolve_on,
    what_if,
)

F64 = torch.float64
OUTPUTS = ("basis", "vstat", "xB", "pi", "d", "beta", "status", "it", "since_refactor", "flips")
KERNEL_SOURCE = Path(dual_kernels.__file__).resolve().parent.parent / "csrc" / "dual_kernels.cu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(t):
    """``t`` with every f64 read as its 64 bits (so NaNs compare too)."""
    return t.view(torch.int64) if t.dtype == F64 else t


def equal_bits(a, b) -> torch.Tensor:
    """Whether two tensors hold the same bits, as a 0-dim device tensor."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return (bits(a) == bits(b)).all()


def update_bits(got, want) -> torch.Tensor:
    """Per output of an update, whether ``got`` and ``want`` agree in bits:
    the state's fields (``OUTPUTS``), then the flags and ``do_pivot``."""
    (s1, f1, p1), (s2, f2, p2) = got, want
    pairs = [(getattr(s1, k), getattr(s2, k)) for k in OUTPUTS] + [(f1, f2), (p1, p2)]
    return torch.stack([equal_bits(a, b) for a, b in pairs])


def assert_update_bits(got, want, where=""):
    ok = update_bits(got, want).tolist()
    names = OUTPUTS + ("flags", "do_pivot")
    assert all(ok), (where, [k for k, good in zip(names, ok) if not good])


def step_before(K, s):
    """``DualKernel.step`` as it was before its update moved into
    ``dual_update_plain`` and the kernel (spans left out): the CPU's
    reference bits."""
    A, cfg, n = K.A, K.cfg, K.n
    lb, ub, lb_tot, ub_tot = K.lb, K.ub, K.lb_tot, K.ub_tot
    broken = ~torch.isfinite(s.xB.sum() + s.pi.sum())
    fresh = s.since_refactor == 0
    k = s.basis
    lbk = lb_tot[k]
    ubk = ub_tot[k]
    below = lbk - s.xB
    above = s.xB - ubk
    viol = torch.maximum(below, above).clamp_min(0.0)
    r = torch.argmax(viol * viol / s.beta.clamp_min(1e-12))
    primal_feasible = viol.max() <= cfg.eps_feas
    r = torch.where(primal_feasible, torch.argmax(viol), r)
    rho = s.Binv.index_select(0, r.reshape(1))[0]
    alpha = A.rmatvec(rho)
    d = s.d
    vs = s.vstat[:n]
    leaving_below = _at(below, r) > _at(above, r)
    alpha_eff = torch.where(leaving_below, alpha, -alpha)
    is_free = vs == st.NB_FREE
    at_l = (vs == st.NB_LOWER) | is_free
    at_u = (vs == st.NB_UPPER) | is_free
    cand = (at_l & (alpha_eff < -cfg.eps_pivot)) | (at_u & (alpha_eff > cfg.eps_pivot))
    cand = cand & K.can_enter & (vs != st.BASIC)
    abs_alpha = alpha_eff.abs()
    ratio = torch.where(cand, d.abs() / abs_alpha.clamp_min(1e-300), float("inf"))
    cap = torch.where(cand, K.boxed_range * abs_alpha, 0.0)
    viol_r = _at(viol, r)
    ratio_test = K._ratio_bisect if cfg.dual_ratio == "bisect" else K._ratio_sort
    q, has_entering, flip_mask = ratio_test(cand, ratio, cap, abs_alpha, viol_r)
    n_flips = flip_mask.sum()
    u = A.ftran(s.Binv, q)
    p = _at(u, r)
    ok_pivot = p.abs() > cfg.eps_pivot
    p_safe = torch.where(p.abs() > 1e-300, p, 1.0)
    do_pivot = ~primal_feasible & has_entering & ~broken & ok_pivot
    at_lower = vs == st.NB_LOWER
    dx = torch.where(flip_mask, torch.where(at_lower, K.boxed_range, -K.boxed_range), 0.0)
    xB_f = torch.where(do_pivot & (n_flips > 0), s.xB - s.Binv @ A.matvec(dx), s.xB)
    flip_to = torch.where(at_lower, st.NB_UPPER, st.NB_LOWER)
    vstat_flip = torch.where(flip_mask, flip_to, vs)
    bound_r = torch.where(leaving_below, _at(lbk, r), _at(ubk, r))
    theta_p = (_at(xB_f, r) - bound_r) / p_safe
    vq = _at(vs, q)
    start_val = torch.where(vq == st.NB_UPPER, _at(ub, q),
                            torch.where(vq == st.NB_LOWER, _at(lb, q), 0.0))
    xB_new = _put(xB_f - theta_p * u, r, start_val + theta_p)
    d_q = _at(d, q)
    theta_d = d_q / p_safe
    pi_new = s.pi + theta_d * rho
    d_new = _put(d - theta_d * alpha, q, torch.zeros_like(d_q))
    ratio_u = u / p_safe
    beta_r = _at(s.beta, r)
    if cfg.dual_pricing == "devex":
        beta_new = torch.maximum(s.beta, ratio_u * ratio_u * beta_r)
        beta_new = _put(beta_new, r, (beta_r / (p_safe * p_safe)).clamp_min(1.0))
        beta_new = beta_new.clamp(1e-12, 1e12)
    else:
        tau = s.Binv @ rho
        beta_new = s.beta - 2.0 * ratio_u * tau + ratio_u * ratio_u * beta_r
        beta_new = _put(beta_new, r, beta_r / (p_safe * p_safe)).clamp_min(1e-12)
    kr = _at(k, r)
    leave_stat = torch.where(leaving_below, st.NB_LOWER, st.NB_UPPER)
    leave_stat = torch.where(_at(lb_tot, kr) == _at(ub_tot, kr), st.NB_FIXED, leave_stat)
    vstat_new = torch.cat([vstat_flip, s.vstat[n:]])
    vstat_new = _put(_put(vstat_new, kr, leave_stat), q, torch.full_like(kr, st.BASIC))
    status_new = torch.where(
        primal_feasible & fresh & ~broken, st.OPTIMAL,
        torch.where(~primal_feasible & ~has_entering & fresh & ~broken, st.INFEASIBLE, s.status))
    wants_terminal = primal_feasible | (~primal_feasible & ~has_entering)
    force_refac = (wants_terminal & ~fresh) | broken | (
        ~primal_feasible & has_entering & ~ok_pivot)
    rank_one_basis_update(s.Binv, u, r, apply=do_pivot)
    s_out = dual.DState(
        basis=torch.where(do_pivot, _put(k.clone(), r, q), k),
        vstat=torch.where(do_pivot, vstat_new, s.vstat),
        xB=torch.where(do_pivot, xB_new, s.xB), Binv=s.Binv,
        pi=torch.where(do_pivot, pi_new, s.pi), d=torch.where(do_pivot, d_new, s.d),
        beta=torch.where(do_pivot, beta_new, s.beta), status=status_new, it=s.it + 1,
        since_refactor=torch.where(
            force_refac, cfg.refactor_period, s.since_refactor + do_pivot.long()),
        repairs=s.repairs, flips=s.flips + torch.where(do_pivot, n_flips, 0))
    return s_out, K.flags(s_out)


def copied(s, piv):
    """Copies of a state and of an update's operands."""
    return dual._cloned(s), Pivot(*(None if t is None else t.clone() for t in piv))


def checked_steps(mp):
    """Hold every ``DualKernel.step`` to :func:`step_before` on a copy of its
    state, field by field in bits (B⁻¹ included) and its flags; the count of
    steps checked."""
    real = dual.DualKernel.step
    steps = []

    def step(self, s):
        want, want_flags = step_before(self, dual._cloned(s))
        got, flags = real(self, s)
        for f in dataclasses.fields(dual.DState):
            assert bool(equal_bits(getattr(got, f.name), getattr(want, f.name))), \
                (len(steps), f.name)
        assert torch.equal(flags, want_flags), len(steps)
        steps.append(int(got.it))
        return got, flags

    mp.setattr(dual.DualKernel, "step", step)
    return steps


def genrmf_form(frame, frames, seed=7):
    """A GENRMF max flow (``portbench/families/genrmf.py``) as the port's
    computational form."""
    tail, head, cap = rmf_arcs(frame, frames, 1, 10_000, seed)
    nodes = frame * frame * frames
    general = max_flow_lp(nodes, list(zip(tail.tolist(), head.tolist(), cap.tolist())),
                          0, nodes - 1)
    return build_computational_form(general, scale=False)


# ---- the CPU ----

def captured_update(mp, at=5):
    """Run a CPU re-solve and keep the ``at``-th update's operands."""
    kept = []
    real = dual.pivot_update

    def spy(K, s, piv):
        if len(kept) == at:
            kept.append((K, *copied(s, piv)))
        elif len(kept) < at:
            kept.append(None)
        return real(K, s, piv)

    mp.setattr(dual, "pivot_update", spy)
    A, b, c, x0 = dense_data(16, 48, seed=3)
    t = [torch.tensor(v, dtype=F64) for v in (A, b, c)]
    lb = torch.zeros(48, dtype=F64)
    prior = solve_core(*t, lb, lb + 2.0, SolverConfig(), 2000)
    out = reoptimize_with_bounds(DenseMatrix(t[0]), t[1], t[2], lb, what_if(x0, 0, 8), prior,
                                 SolverConfig(refactor_period=5))
    assert int(out.status) == st.OPTIMAL and len(kept) > at
    return kept[at]


def launch(K, s, piv):
    """One launch of the kernel's wrapper on the operands of ``K``'s update,
    as ``pivot_update`` makes it: ``(state, flags, do_pivot)``."""
    fields, flags, do_pivot = dual_update(
        piv, s, K.lb, K.ub, K.lb_tot, K.ub_tot, refactor_period=K.cfg.refactor_period,
        max_iter=K.max_iter, eps_pivot=K.cfg.eps_pivot, devex=K.cfg.dual_pricing == "devex")
    return dataclasses.replace(s, **fields), flags, do_pivot


def test_the_cpu_wrapper_is_the_plain_version(monkeypatch):
    K, s, piv = captured_update(monkeypatch)
    launches, steps = dual_update.launches, K.update_kernel_steps
    got = pivot_update(K, s, piv)
    assert dual_update.launches == launches and K.update_kernel_steps == steps == 0
    assert_update_bits(got, dual_update_plain(K, s, piv))
    assert got[0].Binv is s.Binv and got[0].repairs is s.repairs
    assert bool(got[2])  # a pivot, not a no-op
    with pytest.raises(ValueError, match="unsupported device cpu"):
        launch(K, s, piv)  # the kernel's wrapper has no CPU path


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: f"{o['dual_pricing']}-{o['dual_ratio']}")
def test_the_step_gives_the_bits_it_gave_before_on_the_dense_operator(monkeypatch, opts):
    A, b, c, x0 = dense_data(16, 48, seed=3)
    cfg = SolverConfig(algorithm="dual", scale=False, presolve=False, refactor_period=5, **opts)
    steps = checked_steps(monkeypatch)
    res = solve_computational_form(build_computational_form(
        general_form(A, b, c, np.full(48, 2.0)), scale=False), cfg, device="cpu")
    assert res.is_optimal and res.metrics.update_kernel_steps == 0
    t = [torch.tensor(v, dtype=F64) for v in (A, b, c)]
    lb = torch.zeros(48, dtype=F64)
    prior = solve_core(*t, lb, lb + 2.0, SolverConfig(), 2000)
    op = DenseMatrix(t[0])
    flips = 0
    for k in range(3):
        out = reoptimize_with_bounds(op, t[1], t[2], lb, what_if(x0, k, 8), prior, cfg)
        assert int(out.status) == st.OPTIMAL
        assert metrics.recent()[-1].update_kernel_steps == 0
        flips += int(out.flips)
    assert flips > 0 and len(steps) > 30  # the ratio test flipped bounds


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: f"{o['dual_pricing']}-{o['dual_ratio']}")
def test_the_step_gives_the_bits_it_gave_before_on_a_genrmf_max_flow(monkeypatch, opts):
    cfg = SolverConfig(algorithm="dual", matrix_format="ell", scale=False, presolve=False,
                       **opts)
    steps = checked_steps(monkeypatch)
    res = solve_computational_form(genrmf_form(2, 4), cfg, device="cpu")
    assert res.is_optimal and res.metrics.matrix_format == "ell" and len(steps) > 5
    assert res.metrics.update_kernel_steps == 0


def test_the_kernel_has_the_status_codes_of_the_simplex():
    src = KERNEL_SOURCE.read_text()
    codes = dict(re.findall(r"\b(k[A-Z]\w*) = (\d+)", src))
    assert {k: int(v) for k, v in codes.items() if k != "kThreads"} == {
        "kRunning": st.RUNNING, "kOptimal": st.OPTIMAL, "kInfeasible": st.INFEASIBLE,
        "kNbLower": st.NB_LOWER, "kNbUpper": st.NB_UPPER, "kBasic": st.BASIC,
        "kNbFixed": st.NB_FIXED}


def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    K, s, piv = captured_update(monkeypatch)
    with pytest.raises(ValueError, match="tau"):
        launch(K, s, piv._replace(tau=None))  # "dse" reads τ
    with pytest.raises(ValueError, match="flip_mask"):
        launch(K, s, piv._replace(flip_mask=piv.flip_mask[:-1]))
    with pytest.raises(ValueError, match="u "):
        launch(K, s, piv._replace(u=piv.u.float()))
    with pytest.raises(ValueError, match="lb_tot"):
        dual_update(piv, s, K.lb, K.ub, K.lb_tot[:-1], K.ub_tot, refactor_period=5,
                    max_iter=9, eps_pivot=1e-9, devex=False)


# ---- the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


def held_to_plain(mp):
    """Have every ``pivot_update`` also run ``dual_update_plain`` on the same
    operands; the per-call agreement in bits, kept on the device."""
    real, checks = dual.pivot_update, []

    def update(K, s, piv):
        got = real(K, s, piv)
        checks.append(update_bits(got, dual_update_plain(K, s, piv)))
        return got

    mp.setattr(dual, "pivot_update", update)
    return checks


def assert_all_held(checks):
    assert checks
    ok = torch.stack(checks)
    bad = (~ok).nonzero().tolist()
    names = OUTPUTS + ("flags", "do_pivot")
    assert not bad, [(call, names[field]) for call, field in bad[:10]]


@pytest.fixture(scope="module")
def bench_lp():
    """The benchmark's cell: dense-768x1536 at its base seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    from relp_tpu_torch.models.dense import SEED

    return padded_problem(768, 1536, SEED, torch.device("cuda"))


def with_options(P, opts):
    return {**P, "cfg": dataclasses.replace(P["cfg"], **opts)}


@pytest.mark.cuda
@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: f"{o['dual_pricing']}-{o['dual_ratio']}")
def test_the_kernel_gives_the_plain_bits_on_the_benchmark_lp(cuda, bench_lp, monkeypatch, opts):
    P = with_options(bench_lp, opts)
    launches = dual_update.launches
    with monkeypatch.context() as mp:
        checks = held_to_plain(mp)
        its = 0
        for k in range(16):
            out, rec = resolve_on(P, DenseMatrix(P["A"]), k, graphed=False, monkeypatch=mp)
            assert int(out.status) == st.OPTIMAL
            assert rec.update_kernel_steps == rec.iterations == int(out.it)
            its += int(out.it)
    assert dual_update.launches - launches == len(checks) == its
    assert_all_held(checks)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: f"{o['dual_pricing']}-{o['dual_ratio']}")
def test_the_kernel_gives_the_plain_bits_on_a_genrmf_max_flow(cuda, monkeypatch, opts):
    cfg = SolverConfig(algorithm="dual", matrix_format="ell", scale=False, presolve=False,
                       **opts)
    with monkeypatch.context() as mp:
        checks = held_to_plain(mp)
        mp.setattr(dual, "_graphable", lambda A: False)
        res = solve_computational_form(genrmf_form(4, 8), cfg, device=cuda)
    assert res.is_optimal and res.metrics.matrix_format == "ell"
    assert res.metrics.update_kernel_steps == res.iterations == len(checks) > 50
    assert_all_held(checks)


@pytest.fixture(scope="module")
def mid_updates():
    """Per weight rule, the operands of a mid-solve update on the card that
    pivots and flips bounds (the dense LP 256 × 512)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    P = padded_problem(256, 512, 7, torch.device("cuda"))
    kept = {}
    for pricing in ("dse", "devex"):
        Q = with_options(P, {"dual_pricing": pricing})
        real = dual.pivot_update

        def spy(K, s, piv):
            got = real(K, s, piv)
            if pricing not in kept and int(piv.n_flips) > 0 and bool(got[2]) \
                    and int(s.basis[piv.r]) < K.n:
                kept[pricing] = (K, *copied(s, piv))
            return got

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dual, "pivot_update", spy)
            for k in range(16):
                resolve_on(Q, DenseMatrix(Q["A"]), k, 24, graphed=False, monkeypatch=mp)
                if pricing in kept:
                    break
        assert pricing in kept, pricing
    return kept


def built(K, s, piv, kind):
    """The update's operands changed to reach ``kind``'s path."""
    s, piv = copied(s, piv)
    yes, no = torch.ones_like(piv.fresh), torch.zeros_like(piv.fresh)
    r = int(piv.r)
    if kind == "optimal":
        piv = piv._replace(primal_feasible=yes, fresh=yes)
        s.since_refactor.zero_()
    elif kind == "infeasible":
        piv = piv._replace(has_entering=no, fresh=yes)
        s.since_refactor.zero_()
    elif kind == "broken":
        s.xB[0] = float("nan")
        s.pi[1] = float("nan")
        piv = piv._replace(broken=yes)
    elif kind == "small_pivot":
        piv.u[r] = K.cfg.eps_pivot / 2
    elif kind == "zero_pivot":
        piv.u[r] = 0.0
    elif kind == "no_flips":
        piv = piv._replace(flip_mask=torch.zeros_like(piv.flip_mask),
                           n_flips=torch.zeros_like(piv.n_flips))
    elif kind == "artificial_leaving":
        s.basis[r] = K.n + r
    elif kind == "fixed_leaving":
        kr = int(s.basis[r])
        assert kr < K.n
        K = copy.copy(K)
        K.lb_tot, K.ub_tot = K.lb_tot.clone(), K.ub_tot.clone()
        K.ub_tot[kr] = K.lb_tot[kr]
    return K, s, piv


BUILT = ("optimal", "infeasible", "broken", "small_pivot", "zero_pivot", "no_flips",
         "artificial_leaving", "fixed_leaving")


@pytest.mark.cuda
@pytest.mark.parametrize("pricing", ["dse", "devex"])
@pytest.mark.parametrize("kind", BUILT)
def test_the_kernel_gives_the_plain_bits_on_built_states(cuda, mid_updates, kind, pricing):
    K, s, piv = built(*mid_updates[pricing], kind)
    got = launch(K, s, piv)
    assert_update_bits(got, dual_update_plain(K, s, piv), kind)
    out, flags, do_pivot = got
    kr, period = int(s.basis[piv.r]), K.cfg.refactor_period
    expect = {
        "optimal": lambda: int(out.status) == st.OPTIMAL and not flags[0],
        "infeasible": lambda: int(out.status) == st.INFEASIBLE and not flags[0],
        "broken": lambda: not do_pivot and int(out.since_refactor) == period and bool(flags[1])
        and bool(equal_bits(out.xB, s.xB)),
        "small_pivot": lambda: not do_pivot and int(out.since_refactor) == period,
        "zero_pivot": lambda: not do_pivot and int(out.since_refactor) == period,
        "no_flips": lambda: bool(do_pivot) and int(out.flips) == int(s.flips),
        "artificial_leaving": lambda: bool(do_pivot) and kr >= K.n
        and int(out.vstat[kr]) == st.NB_FIXED,
        "fixed_leaving": lambda: bool(do_pivot) and int(out.vstat[kr]) == st.NB_FIXED,
    }
    assert expect[kind](), kind


@pytest.mark.cuda
@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: f"{o['dual_pricing']}-{o['dual_ratio']}")
def test_whole_resolves_with_the_plain_update_are_equal_in_bits(cuda, bench_lp, monkeypatch,
                                                                opts):
    P = with_options(bench_lp, opts)
    op_plain, op = DenseMatrix(P["A"]), DenseMatrix(P["A"])
    for k in range(16):
        with monkeypatch.context() as mp:
            mp.setattr(dual, "pivot_update", dual_update_plain)
            want, rec_plain = resolve_on(P, op_plain, k, monkeypatch=mp)
        got, rec = resolve_on(P, op, k, monkeypatch=monkeypatch)
        assert int(got.status) == st.OPTIMAL
        assert rec.graph_steps == rec.update_kernel_steps == rec.iterations
        # the plain chain's graph recorded no launch of the kernel
        assert rec_plain.graph_steps == rec_plain.iterations > 0
        assert rec_plain.update_kernel_steps == 0
        assert_same(want, got, k)
        assert torch.equal(bits(want.x), bits(got.x)) and torch.equal(bits(want.pi),
                                                                       bits(got.pi)), k


@pytest.mark.cuda
def test_graphed_solves_count_every_update_and_launch_it_at_capture(cuda, bench_lp, monkeypatch):
    P = bench_lp
    op = DenseMatrix(P["A"])
    launches = dual_update.launches
    recs = [resolve_on(P, op, k, monkeypatch=monkeypatch)[1] for k in range(4)]
    # the capture's eager step and its recorded one; the replays launch it
    assert dual_update.launches - launches == 2 * sum(r.graph_captures for r in recs) == 2
    assert all(r.update_kernel_steps == r.graph_steps == r.iterations > 0 for r in recs)
