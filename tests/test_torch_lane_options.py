"""The lane-batched primal under every primal option, against the JAX
package's vmapped core and against the port's single solve, on the CPU:
``inverse="eta"``, partial pricing (``price_blocks``), the per-iteration
trace (``trace_iters``) and the periodic invariant check
(``check_every_n``), alone and together, through
``relp_tpu_torch.parallel.solve_batched`` (also over a mesh) and
``solve_general_forms_batched``.

Fixtures: tests/test_torch_batched.py's four seeded (16, 64) LPs
(tests/test_parallel.py::problem, seeds 10-13), shared and stacked, cold and
from its ``_warm`` starts; its ``dense_fleet`` (4 scenarios) for the fleet
driver.  Per lane (``_same_lanes``): status, iterations and basis equal,
objective and x within 1e-9; every lane stays under 200 iterations, the JAX
package's least chunk.  The JAX side's partial pricing runs behind
tests/test_torch_options.py's int64 cast of the block start (ROADMAP queue 3),
under ``vmap`` as in the single solve.

The trace: the JAX fleet writes lane rows into a buffer of
``trace_capacity`` rows (default 8192) and stops at the lane's ``it``; the
port returns ``[L, T, 8]`` with T the largest lane's ``it``, zero rows past
each lane's own.  Phase, events, q and r are compared exactly, the f32
values (cB·xB, artificial mass, d_q, step) to 1e-5 against the JAX package
and to one f32 rounding against the port's single solve (whose d_q comes
from a dot where a lane's comes from a row sum).
"""

import dataclasses

import numpy as np
import pytest
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.model import elements as jax_el
from relp_tpu.model import general_form as jax_gf
from relp_tpu.parallel.batched import solve_batched as jax_solve_batched
from relp_tpu.simplex.driver import solve_general_forms_batched as jax_fleet
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch import interop
from relp_tpu_torch.model import elements as torch_el
from relp_tpu_torch.model import general_form as torch_gf
from relp_tpu_torch.parallel import make_solver_mesh, solve_batched
from relp_tpu_torch.simplex import core as torch_core
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.simplex.driver import solve_general_forms_batched
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_torch_batched import _compare_fleets, _same_lanes, _stack, _warm, dense_fleet
from tests.test_torch_options import jax_partial_pricing  # noqa: F401  (a fixture)

EXACT_COLS = [0, 5, 6, 7]  # phase, events, q, r
VALUE_COLS = slice(1, 5)   # cB·xB, artificial mass, d_q, step
ALL_FOUR = dict(inverse="eta", price_blocks=2, trace_iters=True, check_every_n=7)
OPTIONS = {
    "eta_block2_period5": dict(inverse="eta", eta_block=2, refactor_period=5),
    "eta": dict(inverse="eta"),
    "check1": dict(check_every_n=1),
    "check7": dict(check_every_n=7),
    "trace": dict(trace_iters=True),
    "blocks2": dict(price_blocks=2),
    "blocks4": dict(price_blocks=4),
    "all_four": ALL_FOUR,
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_warm(warm):
    return {k: (v.astype(np.int32) if v.dtype.kind == "i" else v) for k, v in warm.items()}


def _same_trace_as_jax(out, ref):
    """The port's trace rows against the JAX fleet's, lane by lane."""
    got, want = out.trace.numpy(), np.asarray(ref.trace)
    assert got.shape == (out.it.shape[0], int(out.it.max()), 8)
    for s, it in enumerate(out.it.tolist()):
        np.testing.assert_array_equal(got[s, :it][:, EXACT_COLS], want[s, :it][:, EXACT_COLS])
        np.testing.assert_allclose(got[s, :it, VALUE_COLS], want[s, :it, VALUE_COLS],
                                   rtol=1e-5, atol=1e-5)
        assert not got[s, it:].any() and not want[s, it:].any()
        assert got[s, it - 1, 0] == 2.0  # every lane ends in phase 2


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
@pytest.mark.parametrize("name", list(OPTIONS))
def test_lanes_match_the_jax_fleet(name, shared, jax_partial_pricing):
    opts = OPTIONS[name]
    arrays = _stack(16, 64, 4, shared)
    ref = jax_solve_batched(*arrays, cfg=JaxConfig(**opts), max_iter=500)
    out = solve_batched(*arrays, cfg=SolverConfig(**opts), max_iter=500, device="cpu")
    assert np.all(np.asarray(ref.status) == st.OPTIMAL)
    _same_lanes(out, ref)
    if opts.get("price_blocks"):
        # the blocks changed the pivot paths: partial pricing was on
        plain = solve_batched(*arrays, cfg=SolverConfig(), max_iter=500, device="cpu")
        assert out.it.tolist() != plain.it.tolist()
    if opts.get("trace_iters"):
        _same_trace_as_jax(out, ref)
    else:
        assert out.trace.shape == (4, 0, 8)
    viol = out.viol.numpy()
    assert viol.shape == (4,)
    if opts.get("check_every_n"):
        # the f64 rounding of each package's own sums: noise, which differs
        # from one package to the other (the planted test below reads a
        # known value); it is read wherever the JAX fleet reads one
        ref_viol = np.asarray(ref.viol)
        assert np.all((0.0 <= viol) & (viol < 1e-9))
        assert np.all((0.0 <= ref_viol) & (ref_viol < 1e-9))
        np.testing.assert_array_equal(viol > 0, ref_viol > 0)
    else:
        assert not viol.any()


def _same_as_single(out, arrays, opts, warm=None):
    """Every lane against the port's single ``solve_core`` of its LP."""
    A, b, c, lb, ub = (torch.tensor(v) for v in arrays)
    cfg = SolverConfig(**opts)
    for s in range(b.shape[0]):
        kw = {} if warm is None else dict(
            basis0=torch.tensor(warm["basis0"][s]), vstat0=torch.tensor(warm["vstat0"][s]),
            art_sign0=torch.tensor(warm["art_sign0"][s]), phase0=int(warm["phase0"][s]))
        one = solve_core(A if A.dim() == 2 else A[s], b[s], c[s], lb[s], ub[s], cfg, 500, **kw)
        it = int(one.it)
        assert it == int(out.it[s]) and int(one.status) == int(out.status[s]), s
        assert torch.equal(one.basis, out.basis[s]) and torch.equal(one.vstat, out.vstat[s])
        torch.testing.assert_close(one.x, out.x[s], rtol=1e-12, atol=1e-12)
        assert one.trace.shape[0] == (it if opts.get("trace_iters") else 0)
        lane = out.trace[s, :one.trace.shape[0]]
        assert torch.equal(lane[:, EXACT_COLS], one.trace[:, EXACT_COLS])
        torch.testing.assert_close(lane[:, VALUE_COLS], one.trace[:, VALUE_COLS],
                                   rtol=2 ** -23, atol=1e-12)
        assert not out.trace[s, it:].any()
        assert abs(float(one.viol) - float(out.viol[s])) < 1e-12
        assert (float(one.viol) > 0) == (float(out.viol[s]) > 0)


SINGLE_CASES = dict(OPTIONS, all_four_capacity16=dict(ALL_FOUR, trace_capacity=16))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
@pytest.mark.parametrize("name", list(SINGLE_CASES))
def test_each_lane_takes_its_single_solve(name, shared):
    """Equal iterations and bases, the whole trace (every row also past a
    ``trace_capacity`` of 16, below every lane's iterations) and ``viol``
    within 1e-12."""
    opts = SINGLE_CASES[name]
    arrays = _stack(16, 64, 4, shared)
    out = solve_batched(*arrays, cfg=SolverConfig(**opts), max_iter=500, device="cpu")
    if opts.get("trace_capacity"):
        assert int(out.it.min()) > 3 * opts["trace_capacity"]
    _same_as_single(out, arrays, opts)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
def test_warm_starts_under_eta_and_blocks_match(shared, jax_partial_pricing):
    """``_warm``'s starts (lane 0 at its optimum, the others a few pivots
    from theirs) under the eta inverse and partial pricing, with the trace
    and the check: against the JAX fleet and the single solves."""
    opts = ALL_FOUR
    arrays, warm = _warm(_stack(16, 64, 4, shared), shared)
    ref = jax_solve_batched(*arrays, cfg=JaxConfig(**opts), max_iter=500, warm=_jax_warm(warm))
    out = solve_batched(*arrays, cfg=SolverConfig(**opts), max_iter=500, warm=warm, device="cpu")
    _same_lanes(out, ref)
    _same_trace_as_jax(out, ref)
    _same_as_single(out, arrays, opts, warm)


def test_a_lane_that_finishes_early_stops_changing_its_options_state(monkeypatch):
    """The cold fleet under all four options (eta blocks of 4, a check every
    step): once the lane that finishes first (lane 3, 19 steps before the
    last) is no longer live, its eta block, its check value and its trace
    rows stop changing (the rows past its ``it`` stay zero), and every lane
    still ends where its single solve ends."""
    opts = dict(ALL_FOUR, eta_block=4, check_every_n=1)
    arrays = _stack(16, 64, 4, shared=True)
    e = 3
    seen = []
    step = torch_core.LanePrimalKernel.step

    def watched(self, s, live, keep):
        new, needs_repair = step(self, s, live, keep)
        seen.append((bool(live[e]), new.etaZ[e].clone(), new.etaR[e].clone(),
                     int(new.eta_count[e]), float(self.viol[e])))
        return new, needs_repair

    monkeypatch.setattr(torch_core.LanePrimalKernel, "step", watched)
    out = solve_batched(*arrays, cfg=SolverConfig(**opts), max_iter=500, device="cpu")
    monkeypatch.undo()
    its = out.it.tolist()
    assert its[e] == min(its) and max(its) - its[e] >= 10
    dead = [rec for rec in seen if not rec[0]]
    assert len(dead) == max(its) - its[e]
    live = [rec for rec in seen if rec[0]]
    assert max(rec[3] for rec in live) > 0  # the lane pivoted into its block while live
    last_live = live[-1]  # (its last steps follow a refactorization: an empty block)
    for rec in dead:
        assert torch.equal(rec[1], last_live[1]) and torch.equal(rec[2], last_live[2])
        assert rec[3:] == last_live[3:]
    assert out.trace[e, its[e] - 1].any() and not out.trace[e, its[e]:].any()
    assert out.trace.shape[1] == max(its)
    _same_as_single(out, arrays, opts)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
def test_the_check_reads_a_violation_planted_in_its_own_lane(shared, monkeypatch):
    """The check on a state whose violation is known.  At one firing step of
    each lane, while it is live, ``_check_violation`` is handed that lane's
    state with one interior structural basic value moved up by
    δ_s = (s + 1)·1e-6 (the solve itself goes on from the true state): the
    row residual is then δ_s·max|A[:, j]| and the bound violation 0.  Each
    lane's ``viol`` reads its own plant to 1e-5 relative, and no other
    lane's; a plant of 1e-3 on the lane that finished first, at a firing
    step after its last, does not show; the iterations and bases are the
    unplanted run's."""
    opts = ALL_FOUR
    every = opts["check_every_n"]
    arrays = _stack(16, 64, 4, shared)
    A, lb, ub = arrays[0], arrays[3], arrays[4]
    n = lb.shape[1]
    plain = solve_batched(*arrays, cfg=SolverConfig(**opts), max_iter=500, device="cpu")
    its = plain.it.tolist()
    e = its.index(min(its))
    dead = every * (its[e] // every + 1)  # the first firing step after lane e's last
    assert dead < max(its)
    plants = {every * (s + 1): [(s, (s + 1) * 1e-6)] for s in range(4)}
    plants.setdefault(dead, []).append((e, 1e-3))
    assert all(t < its[s] for t, p in plants.items() for s, _ in p if t != dead)
    want = np.zeros(4)
    check = torch_core.LanePrimalKernel._check_violation

    def planting(self, s, phase1):
        if self.steps in plants:
            xB = s.xB.clone()
            for lane, delta in plants[self.steps]:
                basis, x = s.basis[lane].numpy(), xB[lane].numpy()
                room = [(min(x[i] - lb[lane, j], ub[lane, j] - x[i]), i)
                        for i, j in enumerate(basis) if j < n]
                margin, i = max(room)
                assert margin > 1e-3
                xB[lane, i] += delta
                if self.steps != dead:
                    col = (A if shared else A[lane])[:, basis[i]]
                    want[lane] = delta * np.abs(col).max()
            s = dataclasses.replace(s, xB=xB)
        return check(self, s, phase1)

    monkeypatch.setattr(torch_core.LanePrimalKernel, "_check_violation", planting)
    out = solve_batched(*arrays, cfg=SolverConfig(**opts), max_iter=500, device="cpu")
    monkeypatch.undo()
    assert out.it.tolist() == its and torch.equal(out.basis, plain.basis)
    assert np.all(want > 1e-7)
    np.testing.assert_allclose(out.viol.numpy(), want, rtol=1e-5, atol=0)


def test_solve_batched_over_a_mesh_pads_the_groups_traces():
    """Two 'batch' rows of two lanes each, with the trace and the check: the
    unmeshed run's lanes, the row with fewer steps padded with zero rows."""
    opts = dict(trace_iters=True, check_every_n=7, inverse="eta")
    arrays = _stack(16, 64, 4, True)
    mesh = make_solver_mesh(batch=2, cols=1, devices=["cpu"] * 2)
    out = solve_batched(*arrays, cfg=SolverConfig(**opts), max_iter=500, mesh=mesh)
    flat = solve_batched(*arrays, cfg=SolverConfig(**opts), max_iter=500, device="cpu")
    its = flat.it.tolist()
    assert max(its[:2]) != max(its[2:])  # the groups ran different numbers of steps
    assert out.it.tolist() == its and torch.equal(out.basis, flat.basis)
    assert out.trace.shape == flat.trace.shape == (4, max(its), 8)
    assert torch.equal(out.trace[..., EXACT_COLS], flat.trace[..., EXACT_COLS])
    # a shared A's lanes go through one product X·Aᵀ, whose CPU rounding
    # depends on how many lanes it holds
    torch.testing.assert_close(out.trace[..., VALUE_COLS], flat.trace[..., VALUE_COLS],
                               rtol=1e-6, atol=1e-12)
    for s, it in enumerate(its):
        assert not out.trace[s, it:].any()
    torch.testing.assert_close(out.viol, flat.viol, rtol=0, atol=1e-12)
    torch.testing.assert_close(out.x, flat.x, rtol=0, atol=1e-12)


def test_the_lane_output_crosses_to_numpy_and_back():
    """The lanes' ``trace`` ``[L, T, 8]`` and ``viol`` ``[L]`` go to the JAX
    package's ``SolveOutput`` fields and come back unchanged."""
    from relp_tpu.simplex.core import SolveOutput as JaxOutput

    out = solve_batched(*_stack(16, 64, 4, True), cfg=SolverConfig(**ALL_FOUR), max_iter=500,
                        device="cpu")
    arrays = interop.solve_output_to_numpy(out)
    jax_out = JaxOutput(**arrays)
    assert np.asarray(jax_out.trace).shape == tuple(out.trace.shape)
    back = interop.solve_output_from_numpy(jax_out, device="cpu")
    assert back.trace.dtype == torch.float32 and torch.equal(back.trace, out.trace)
    assert back.viol.shape == (4,) and torch.equal(back.viol, out.viol)


FLEET_CASES = {name: dict(opts) for name, opts in OPTIONS.items()
               if name in ("eta", "check7", "trace", "blocks2", "all_four")}
FLEET_CASES["all_four_dual"] = dict(ALL_FOUR, algorithm="dual")


@pytest.mark.parametrize("name", list(FLEET_CASES))
def test_fleet_driver_matches_the_jax_driver(name, jax_partial_pricing):
    """``solve_general_forms_batched`` on the dense fleet (4 scenarios, one
    shared A, warm from one base solve) under each option and all four,
    against the JAX driver; the results carry no trace, as the JAX driver's."""
    opts = FLEET_CASES[name]
    stats = []
    got = solve_general_forms_batched(dense_fleet(torch_el, torch_gf), SolverConfig(**opts),
                                      device="cpu", stats=stats)
    ref = jax_fleet(dense_fleet(jax_el, jax_gf), JaxConfig(bucket_shapes=False, **opts))
    _compare_fleets(ref, got)
    assert [g["engine"] for g in stats] == ["primal"] and stats[0]["shared_A"]
    assert all(r.solution is not None for r in got)
    assert all(getattr(r.simplex, "trace", None) is None for r in got)
