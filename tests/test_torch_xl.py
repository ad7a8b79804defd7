"""The XL gate of the port's driver (``SolverConfig.refactor_external_m`` and
``xl_engine``) against the JAX package's, on the CPU.

The same LPs go through ``solve_general_form`` of both packages (the JAX side
with ``bucket_shapes=False``, so both pad to the same ``m_pad``) under
``algorithm`` primal and dual, every ``xl_engine``, and a gate below every
LP's ``m_pad`` (4: every ``m_pad`` is a multiple of 8) or the default 12,288.
Both sides record the chain of engines that ran (the host LU dual, the
device dual, the device primal) by wrapping their entry points, and the
chains must be equal; then the status, the objective within 1e-9 relative,
``SolveMetrics.engine``, ``x`` within 1e-7 where the optimum is unique, and
the iterations: equal wherever the host LU dual answered (the two
``lu_host`` modules take the same pivots) and wherever the device engines
answered, as tests/test_torch_dual.py holds them, except after the JAX
package's externally refactorized primal.  Also the
first-order engine falling into the XL dual, ``perturb`` above the gate,
the port's CUDA-only second host-LU attempt (its predicate flipped here,
held against HiGHS and the JAX package's host LU dual from the same slack
start) and the validation of the field.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
import relp_tpu.simplex.core as jax_core
import relp_tpu.simplex.driver as jax_driver
import relp_tpu.simplex.dual as jax_dual
import relp_tpu.simplex.lu_host as jax_lu_host
from relp_tpu.io.mps_convert import mps_to_general_form as jax_to_general
from relp_tpu.io.mps_parse import parse_free as jax_parse_free
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch.io.mps_convert import mps_to_general_form as torch_to_general
from relp_tpu_torch.io.mps_parse import parse_free as torch_parse_free
from relp_tpu_torch.simplex import driver
from relp_tpu_torch.simplex import dual as torch_dual
from relp_tpu_torch.simplex import lu_host as torch_lu_host
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_torch_dual import GENERAL

OBJ_REL = 1e-9
X_TOL = 1e-7
BELOW = 4  # below every m_pad: row_align pads to a multiple of 8
DEFAULT_GATE = SolverConfig().refactor_external_m

# min x + y over x + y = 5, x, y <= 1 (tests/test_dual_simplex.py's
# infeasible LP): the dual's verdict under the temporary box is no
# certificate, so every dual engine hands on to the primal
INFEASIBLE_MPS = """NAME infeas
ROWS
 N COST
 E R1
COLUMNS
    X  COST  1.0  R1  1.0
    Y  COST  1.0  R1  1.0
RHS
    RHS  R1  5.0
BOUNDS
 UP BND X 1.0
 UP BND Y 1.0
ENDATA
"""

# min -x over x - y = 0, x, y >= 0: unbounded; the temporary box binds
UNBOUNDED_MPS = """NAME unbnd
ROWS
 N COST
 E R1
COLUMNS
    X  COST  -1.0  R1  1.0
    Y  R1  -1.0
RHS
    RHS  R1  0.0
ENDATA
"""


def _mps(text):
    return (lambda: jax_to_general(jax_parse_free(text)),
            lambda: torch_to_general(torch_parse_free(text)))


# name: (makers, extra config of both sides, status, x unique at the optimum)
LPS = {
    "wiki": (GENERAL["wiki"], {}, "finite_optimum", True),
    "max_flow_48": (GENERAL["max_flow_48"], {}, "finite_optimum", False),
    "boxed_24x60": (GENERAL["boxed_24x60"], {}, "finite_optimum", True),
    # presolve would decide these two before any engine runs
    "infeasible": (_mps(INFEASIBLE_MPS), {"presolve": False}, "infeasible", False),
    "unbounded": (_mps(UNBOUNDED_MPS), {"presolve": False}, "unbounded", False),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The vectors here are tens of elements: a simplex step is a few hundred
    tiny ops, which a pool of threads only slows down (and, with several test
    workers on one machine, starves the others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def chains(monkeypatch):
    """The engines each package runs, in order (a repeat of the last one,
    a chunk of the same loop, is not recorded again).  The JAX side names
    its externally refactorized device loops "dual-xl" and "primal-xl": this
    package's dual and primal loops stand for them (``_same_chain``)."""
    seen = {"jax": [], "port": []}

    def spy(module, name, side, engine):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            if not seen[side] or seen[side][-1] != engine:
                seen[side].append(engine)
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(jax_lu_host, "solve_dual_lu", "jax", "lu")
    spy(jax_dual, "solve_core_dual", "jax", "dual")
    spy(jax_dual, "dual_xl_iterate", "jax", "dual-xl")
    spy(jax_driver, "solve_core", "jax", "primal")
    spy(jax_core, "primal_xl_iterate", "jax", "primal-xl")
    spy(torch_lu_host, "solve_dual_lu", "port", "lu")
    spy(torch_dual, "solve_core_dual", "port", "dual")
    spy(driver, "solve_core", "port", "primal")
    return seen


def _same_chain(seen):
    """Whether both packages ran the same engines."""
    return [e.removesuffix("-xl") for e in seen["jax"]] == seen["port"]


def _expected_chain(algorithm, xl_engine, xl):
    """The engines an LP that every dual engine certifies runs through."""
    if (xl_engine == "lu" and algorithm == "dual") or (xl and xl_engine in ("auto", "lu")):
        return ["lu"]
    if algorithm == "dual" or xl:
        return ["dual"]
    return ["primal"]


def _engine_of(chain):
    """``SolveMetrics.engine`` of a simplex solve's chain of engines."""
    answered = {"lu": "dual-lu", "dual": "dual", "primal": "primal"}[chain[-1]]
    return answered if len(chain) == 1 else f"dual→{answered}"


def _solve_both(name, opts):
    (make_jax, make_port), extra, _, _ = LPS[name]
    rj = jax_driver.solve_general_form(make_jax(), JaxConfig(bucket_shapes=False,
                                                             **extra, **opts))
    rt = driver.solve_general_form(make_port(), SolverConfig(**extra, **opts), device="cpu")
    return rj, rt


def _assert_same_answer(name, rj, rt):
    _, _, status, unique = LPS[name]
    assert rt.kind.value == rj.kind.value == status
    if status != "finite_optimum":
        return
    assert rt.solution.objective_value == pytest.approx(
        rj.solution.objective_value, rel=OBJ_REL, abs=OBJ_REL)
    if unique:
        xj, xt = dict(rj.solution.solution_values), dict(rt.solution.solution_values)
        assert xt == pytest.approx(xj, rel=X_TOL, abs=X_TOL)


@pytest.mark.parametrize("gate", [BELOW, DEFAULT_GATE], ids=["xl", "default"])
@pytest.mark.parametrize("xl_engine", ["auto", "lu", "dense", "primal"])
@pytest.mark.parametrize("algorithm", ["primal", "dual"])
@pytest.mark.parametrize("name", sorted(LPS))
def test_routing_matches_the_jax_driver(name, algorithm, xl_engine, gate, chains):
    rj, rt = _solve_both(name, dict(algorithm=algorithm, xl_engine=xl_engine,
                                    refactor_external_m=gate))
    _assert_same_answer(name, rj, rt)
    assert _same_chain(chains)
    chain = chains["port"]
    if LPS[name][2] == "finite_optimum":
        assert chain == _expected_chain(algorithm, xl_engine, gate == BELOW)
    else:
        # no dual engine certifies these: the primal answers last
        assert chain[-1] == "primal" and chain[0] == _expected_chain(
            algorithm, xl_engine, gate == BELOW)[0]
    met = rt.simplex.metrics
    assert met.engine == _engine_of(chain)
    if chain[-1] == "lu":
        assert met.matrix_format == "csc"
        assert met.lu_engine in ("forrest-tomlin", "product-form")
    else:
        assert met.lu_engine == ""
    # the JAX package's externally refactorized primal (which xl_engine=
    # "primal" runs on the CPU too) refactorizes on a cadence of its own and
    # need not take the port's pivots; its externally refactorized dual does
    if "primal-xl" not in chains["jax"]:
        assert met.iterations == rj.simplex.iterations


# a budget the first-order engine cannot meet: a KKT tolerance no point
# reaches within one call of 256 rounds of 256 PDHG iterations (max_iter is
# the simplex's budget too, which the host LU dual needs far less of), or
# one interior-point iteration
FIRST_ORDER = {"pdlp": dict(algorithm="pdlp", max_iter=256 * 256, pdlp_tol=1e-300,
                            pdlp_accept=1e-300),
               "ipm": dict(algorithm="ipm", ipm_max_iter=1)}


@pytest.mark.parametrize("gate", [BELOW, DEFAULT_GATE], ids=["xl", "default"])
@pytest.mark.parametrize("algorithm", sorted(FIRST_ORDER))
def test_first_order_engine_falls_into_the_xl_dual(algorithm, gate, chains):
    # above the gate the JAX driver sends the solve on to the XL dual chain,
    # which the host LU answers; below it, to the primal
    rj, rt = _solve_both("boxed_24x60", dict(FIRST_ORDER[algorithm],
                                             refactor_external_m=gate))
    _assert_same_answer("boxed_24x60", rj, rt)
    assert _same_chain(chains)
    met = rt.simplex.metrics
    if gate == BELOW:
        assert chains["port"] == ["lu"]
        assert met.engine == f"{algorithm}→dual-lu" and met.matrix_format == "csc"
    else:
        assert chains["port"] == ["primal"]
        assert met.engine == f"{algorithm}→primal"
    if algorithm == "pdlp":
        assert met.fo_iterations > 0
    # every engine's iterations count, the first-order engine's too
    assert met.iterations == rj.simplex.iterations


@pytest.mark.parametrize("xl_engine", ["auto", "lu"])
def test_perturb_above_the_gate_skips_the_dual_on_the_cpu(xl_engine, chains):
    # want_dual needs perturb == 0, and the CPU makes no second host-LU
    # attempt: both drivers solve perturbed, then true bounds, on the primal
    opts = dict(perturb=1e-6, xl_engine=xl_engine, refactor_external_m=BELOW)
    rj, rt = _solve_both("boxed_24x60", opts)
    _assert_same_answer("boxed_24x60", rj, rt)
    assert chains["port"] == chains["jax"] == ["primal"]
    assert rt.simplex.metrics.engine == "primal"
    assert rt.simplex.metrics.iterations == rj.simplex.iterations


def _highs(cf):
    """HiGHS's optimum of a computational form, in its objective's units."""
    res = linprog(cf.c, A_eq=sp.csc_matrix(cf.A), b_eq=cf.b,
                  bounds=list(zip(np.where(np.isfinite(cf.lb), cf.lb, None),
                                  np.where(np.isfinite(cf.ub), cf.ub, None))),
                  method="highs")
    assert res.status == 0
    return cf.objective_of(res.x)


def _slack_start(m_pad, n_pad, cf):
    """A caller's warm start at the all-artificial basis, the slack crash."""
    lb = np.zeros(n_pad)
    ub = np.zeros(n_pad)
    lb[: cf.n], ub[: cf.n] = cf.lb, cf.ub
    return n_pad + np.arange(m_pad), driver._cold_vstat(lb, ub)


@pytest.mark.parametrize("start", ["slack", "perturb"])
@pytest.mark.parametrize("name", ["boxed_24x60", "max_flow_48"])
def test_second_host_lu_attempt_of_the_card(name, start, chains, monkeypatch):
    """The port's CUDA branch, taken on the CPU by flipping its predicate: a
    primal solve above the gate that skips the dual chain (a caller's warm
    start, or ``perturb``) tries the host LU dual with repair before the
    device primal, under ``perturb`` first on the perturbed bounds."""
    from relp_tpu_torch.model.computational_form import build_computational_form

    monkeypatch.setattr(driver, "_routes_xl_on_host", lambda dev: True)
    (make_jax, make_port), _, _, _ = LPS[name]
    cf = build_computational_form(make_port(), scale=True)
    opts = dict(refactor_external_m=BELOW, presolve=False)
    if start == "slack":
        res = driver.solve_computational_form(
            cf, SolverConfig(**opts), device="cpu",
            warm_start_builder=lambda m_pad, n_pad: _slack_start(m_pad, n_pad, cf))
    else:
        res = driver.solve_computational_form(cf, SolverConfig(perturb=1e-6, **opts),
                                              device="cpu")
    met = res.metrics
    assert res.kind.value == "finite_optimum"
    assert chains["port"] == ["lu"]
    assert met.engine == "dual-lu" and met.matrix_format == "csc"
    assert met.lu_engine in ("forrest-tomlin", "product-form")
    assert res.objective == pytest.approx(_highs(cf), rel=OBJ_REL, abs=OBJ_REL)
    # the JAX package's host LU dual from the same slack start (its
    # algorithm="dual" start is the slack basis with each nonbasic on the
    # bound sign(c_j) asks for, which the repair reaches too)
    rj = jax_driver.solve_general_form(make_jax(), JaxConfig(
        bucket_shapes=False, algorithm="dual", xl_engine="lu", presolve=False))
    assert res.objective == pytest.approx(rj.solution.objective_value, rel=OBJ_REL,
                                          abs=OBJ_REL)
    if start == "slack":
        assert met.iterations == rj.simplex.iterations


@pytest.mark.parametrize("xl_engine", ["auto", "lu"])
def test_second_host_lu_attempt_falls_to_the_primal(xl_engine, chains, monkeypatch):
    # no host LU certifies an infeasible LP: after the dual chain and the
    # second attempt the device primal decides, as the JAX driver's on a card
    monkeypatch.setattr(driver, "_routes_xl_on_host", lambda dev: True)
    _, rt = _solve_both("infeasible", dict(xl_engine=xl_engine, refactor_external_m=BELOW))
    assert rt.kind.value == "infeasible"
    assert chains["port"] == (["lu", "dual", "lu", "primal"] if xl_engine == "auto"
                              else ["lu", "primal"])
    assert rt.simplex.metrics.engine == "dual→primal"


def test_mesh_cols_routes_the_same(chains):
    # the host LU dual ignores the column shards: above the gate it answers
    # as on one device, before any operator is sharded
    make_port = LPS["boxed_24x60"][0][1]
    opts = dict(refactor_external_m=BELOW)
    rj, _ = _solve_both("boxed_24x60", opts)
    rt = driver.solve_general_form(make_port(), SolverConfig(mesh_cols=2, **opts),
                                   device="cpu", devices=["cpu", "cpu"])
    _assert_same_answer("boxed_24x60", rj, rt)
    assert chains["port"] == ["lu"] and rt.simplex.metrics.engine == "dual-lu"
    assert rt.simplex.metrics.iterations == rj.simplex.iterations


def test_refactor_external_m_is_validated():
    assert SolverConfig().refactor_external_m == 12288 == JaxConfig().refactor_external_m
    assert SolverConfig(refactor_external_m=1).refactor_external_m == 1
    for bad in (0, -5, 2.5, "12288", True, None):
        with pytest.raises(ValueError, match="refactor_external_m"):
            SolverConfig(refactor_external_m=bad)
    # the port keeps the field's name: a config reads the same in both packages
    assert {"refactor_external_m", "xl_engine"} <= {
        f.name for f in dataclasses.fields(SolverConfig)}
