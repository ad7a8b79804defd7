"""The port's sensitivity ranging (relp_tpu_torch/analysis/ranging.py,
``api.ranging_of`` and the CLI's ``--ranging``) against the JAX package's.

Both packages range one basis: the port solves, and its computational form
and basis go to ``relp_tpu.analysis.ranging`` through
``relp_tpu_torch.interop``.  Every ``CostRange``/``RhsRange`` must agree
within 1e-9 relative (infinite ends equal), on bases from the port's
primal, dual, ``pdlp+crossover`` and ``ipm+crossover`` solves of
``WIKI_MPS``, the N = 256 max flow and seeded boxed LPs.  The non-corpus
cases of tests/test_ranging.py run here on the port (textbook values, the
signs under maximization, an at-upper variable, the vertex requirement, and
the same-basis properties on a seeded LP: linear inside a range, tight at
its edge, rhs slope equal to the dual), each also against the JAX ranging
of the same basis.
"""

import copy
import json

import numpy as np
import pytest
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu import cli as jax_cli
from relp_tpu.analysis import ranging as jax_ranging
from relp_tpu.model.computational_form import ComputationalForm as JaxCF
from relp_tpu.model.elements import LinearProgramType as JaxLPT
from relp_tpu.simplex.driver import SimplexResult as JaxSimplexResult
from relp_tpu.utils.metrics import SolveMetrics as JaxMetrics
from relp_tpu_torch import api, cli, interop
from relp_tpu_torch.analysis import ranging
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.model.computational_form import ComputationalForm as TorchCF
from relp_tpu_torch.model.elements import LinearProgramType
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.simplex.driver import solve_computational_form
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_pipeline_fixture import WIKI_MPS
from tests.test_torch_core import _boxed_sparse, _cf

CFG = SolverConfig()
INF = float("inf")
REL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_cf_of(cf):
    """The JAX package's computational form with the port's data."""
    fields = interop.computational_form_to_numpy(cf)
    orig = fields.pop("_orig_cost")
    out = JaxCF(**fields)
    out._orig_cost = orig
    return out


def jax_result_of(res):
    """The JAX package's ``SimplexResult`` carrying the port's basis."""
    f = interop.simplex_result_to_numpy(res)
    return JaxSimplexResult(
        kind=JaxLPT(f["kind"]), objective=f["objective"], x_structural=f["x_structural"],
        duals=f["duals"], basis=f["basis"], vstat=f["vstat"], art_sign=f["art_sign"],
        metrics=None if f["n_padded"] is None else JaxMetrics(n_padded=f["n_padded"]),
    )


def _close(a, b):
    if np.isinf(a) or np.isinf(b):
        return a == b
    return abs(a - b) <= REL * max(1.0, abs(a), abs(b))


def assert_same_ranges(rt, rj):
    assert len(rt.cost) == len(rj.cost) and len(rt.rhs) == len(rj.rhs)
    for a, b in zip(rt.cost, rj.cost):
        assert (a.name, a.basic, a.computed) == (b.name, b.basic, b.computed)
        for f in ("value", "cost", "lo", "hi", "reduced_cost"):
            assert _close(getattr(a, f), getattr(b, f)), (a.name, f, getattr(a, f), getattr(b, f))
    for a, b in zip(rt.rhs, rj.rhs):
        assert a.name == b.name
        for f in ("rhs", "lo", "hi", "dual"):
            assert _close(getattr(a, f), getattr(b, f)), (a.name, f, getattr(a, f), getattr(b, f))


def range_both(cf, res, row_names=None):
    """The port's ranging of ``res`` and the JAX package's of the same basis
    (held equal), and the port's."""
    rt = ranging(cf, res, row_names=row_names)
    rj = jax_ranging(jax_cf_of(cf), jax_result_of(res), row_names=row_names)
    assert_same_ranges(rt, rj)
    return rt


def make_cf(A, b, c, lb=None, ub=None, maximize=False):
    return _cf(TorchCF, A, b, c, lb, ub, maximize)


def _solve(cf):
    return solve_computational_form(cf, CFG, device="cpu")


def test_textbook_cost_and_rhs_ranges():
    # min -2x0 - 3x1  s.t.  x0 + x1 + s0 = 4,  x0 + 3x1 + s1 = 6; optimum
    # x = (3, 1): c0 in [-3, -1], c1 in [-6, -2]; b0 in [2, 6], b1 in [4, 12]
    cf = make_cf([[1, 1, 1, 0], [1, 3, 0, 1]], [4, 6], [-2, -3, 0, 0])
    r = range_both(cf, _solve(cf))
    c = r.cost_by_name()
    assert (c["x0"].lo, c["x0"].hi) == pytest.approx((-3.0, -1.0))
    assert (c["x1"].lo, c["x1"].hi) == pytest.approx((-6.0, -2.0))
    assert c["x0"].basic and c["x1"].basic
    assert c["x2"].reduced_cost == pytest.approx(1.5)
    assert c["x2"].lo == pytest.approx(-1.5) and c["x2"].hi == INF
    b = r.rhs
    assert (b[0].lo, b[0].hi) == pytest.approx((2.0, 6.0))
    assert (b[1].lo, b[1].hi) == pytest.approx((4.0, 12.0))
    assert (b[0].dual, b[1].dual) == pytest.approx((-1.5, -0.5))


def test_maximize_sign_conventions():
    cf = make_cf([[1, 1, 1, 0], [1, 3, 0, 1]], [4, 6], [-2, -3, 0, 0], maximize=True)
    res = _solve(cf)
    assert res.objective == pytest.approx(9.0)
    r = range_both(cf, res)
    c = r.cost_by_name()
    assert (c["x0"].lo, c["x0"].hi) == pytest.approx((1.0, 3.0))
    assert (c["x1"].lo, c["x1"].hi) == pytest.approx((2.0, 6.0))
    assert (r.rhs[0].dual, r.rhs[1].dual) == pytest.approx((1.5, 0.5))


def test_at_upper_bound_variable():
    # min -x0 - x1  s.t.  x0 + x1 + s = 10,  x0 <= 3 (x0 nonbasic at upper)
    cf = make_cf([[1, 1, 1]], [10], [-1, -1, 0], lb=[0, 0, 0], ub=[3, INF, INF])
    res = _solve(cf)
    assert res.x_structural[:2] == pytest.approx([3.0, 7.0])
    c = range_both(cf, res).cost_by_name()
    assert c["x0"].hi == pytest.approx(-1.0) and c["x0"].lo == -INF
    assert (c["x1"].lo, c["x1"].hi) == pytest.approx((-1.0, 0.0))


def test_requires_vertex():
    cf = make_cf([[1, 1]], [2], [1, 1])
    res = _solve(cf)
    res.basis = None
    with pytest.raises(ValueError):
        ranging(cf, res)
    with pytest.raises(ValueError):
        jax_ranging(jax_cf_of(cf), jax_result_of(res))


@pytest.fixture(scope="module")
def random_lp():
    # max c@x  s.t.  A x <= b,  0 <= x <= 10 — almost surely nondegenerate
    rng = np.random.default_rng(7)
    m, n = 12, 20
    A = rng.normal(size=(m, n))
    b = A @ rng.uniform(0.5, 1.5, n) + rng.uniform(0.5, 1.0, m)
    c = rng.uniform(0.2, 2.0, n)
    cf = make_cf(np.hstack([A, np.eye(m)]), b, np.concatenate([-c, np.zeros(m)]),
                 lb=np.zeros(n + m), ub=np.concatenate([np.full(n, 10.0), np.full(m, INF)]),
                 maximize=True)
    res = _solve(cf)
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    return cf, res


def _resolve_with(cf, dc=None, db=None):
    """Re-solve a copy of cf with original-unit cost/rhs deltas applied."""
    cf2 = copy.deepcopy(cf)
    sigma = -1.0 if cf2.maximize else 1.0
    for j, delta in (dc or {}).items():
        cf2.c[j] += sigma * cf2.col_scale[j] * delta
        cf2._orig_cost[j] += delta
    if db:
        b = np.array(cf2.b)
        for i, delta in db.items():
            b[i] += cf2.row_scale[i] * delta
        cf2.b = b
    return _solve(cf2)


def test_cost_ranging_is_linear(random_lp):
    cf, sres = random_lp
    r = range_both(cf, sres)
    checked = 0
    for cr in r.cost:
        width = cr.hi - cr.lo
        if not np.isfinite(width) or width < 1e-6 or not cr.basic:
            continue
        delta = (min(cr.hi, cr.cost + 1) + max(cr.lo, cr.cost - 1)) / 2 - cr.cost
        if abs(delta) < 1e-9:
            continue
        out = _resolve_with(cf, dc={cf.col_names.index(cr.name): delta})
        assert out.kind is LinearProgramType.FINITE_OPTIMUM
        assert out.objective == pytest.approx(sres.objective + delta * cr.value,
                                              rel=1e-7, abs=1e-7), cr.name
        checked += 1
    assert checked >= 3


def test_cost_ranging_edge_is_tight(random_lp):
    cf, sres = random_lp
    r = range_both(cf, sres)
    checked = 0
    for cr in r.cost:
        if not cr.basic or not np.isfinite(cr.hi) or cr.hi - cr.lo < 1e-6:
            continue
        j = cf.col_names.index(cr.name)
        delta = cr.hi - cr.cost  # to the endpoint: still exactly linear
        out = _resolve_with(cf, dc={j: delta})
        assert out.objective == pytest.approx(sres.objective + delta * cr.value,
                                              rel=1e-7, abs=1e-7), cr.name
        out2 = _resolve_with(cf, dc={j: delta + 1e-3})  # beyond: superlinear
        assert out2.objective >= sres.objective + delta * cr.value - 1e-9
        checked += 1
        if checked >= 2:
            break
    assert checked >= 1


def test_rhs_ranging_slope_is_dual(random_lp):
    cf, sres = random_lp
    r = range_both(cf, sres)
    checked = 0
    for i, rr in enumerate(r.rhs):
        if rr.hi - rr.lo < 1e-5:
            continue
        delta = (min(rr.hi, rr.rhs + 1) + max(rr.lo, rr.rhs - 1)) / 2 - rr.rhs
        if abs(delta) < 1e-9:
            continue
        out = _resolve_with(cf, db={i: delta})
        assert out.kind is LinearProgramType.FINITE_OPTIMUM
        assert out.objective == pytest.approx(sres.objective + delta * rr.dual,
                                              rel=1e-7, abs=1e-7), rr.name
        checked += 1
    assert checked >= 3


@pytest.fixture(scope="module")
def lp_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranging")
    wiki = root / "testprob.mps"
    wiki.write_text(WIKI_MPS)
    flow = root / "maxflow_256.mps"
    export_mps(max_flow_lp(256, random_arcs(256, 8, seed=7), 0, 255), str(flow))
    return {"wiki": str(wiki), "maxflow": str(flow)}


ENGINES = {"primal": ("primal", "primal"), "dual": ("dual", "dual"),
           "pdlp": ("pdlp", "pdlp+crossover"), "ipm": ("ipm", "ipm+crossover")}


@pytest.mark.parametrize("problem", ["wiki", "maxflow"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_ranges_of_each_engines_basis_match_jax(lp_files, problem, engine):
    algorithm, name = ENGINES[engine]
    res = api.solve(lp_files[problem], SolverConfig(algorithm=algorithm), device="cpu")
    assert res.simplex.metrics.engine == name
    r = range_both(res.cf, res.simplex, row_names=res.row_names)
    # every interval brackets the current data; the duals are the solver's
    for cr in r.cost:
        assert cr.lo <= cr.cost + 1e-7 and cr.cost - 1e-7 <= cr.hi, cr.name
    for i, rr in enumerate(r.rhs):
        assert rr.lo <= rr.rhs + 1e-7 and rr.rhs - 1e-7 <= rr.hi, rr.name
        assert rr.dual == pytest.approx(float(res.simplex.duals[i]), abs=1e-7)
    assert r.rhs[0].name == res.row_names[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("algorithm", ["primal", "dual"])
def test_ranges_on_seeded_boxed_lps_match_jax(seed, algorithm):
    cf = make_cf(*_boxed_sparse(40, 96, 0.1, seed))
    res = solve_computational_form(cf, SolverConfig(algorithm=algorithm), device="cpu")
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    r = range_both(cf, res)
    assert any(not cr.basic and cr.reduced_cost != 0 for cr in r.cost)


def test_ranges_of_a_jax_basis_match_jax(random_lp):
    """The other direction: the JAX package solves, and its form and basis
    come into the port through ``interop``'s ``*_from_numpy``."""
    from relp_tpu.simplex.driver import solve_computational_form as jax_solve_cf
    from relp_tpu.utils.config import SolverConfig as JaxConfig

    cf_j = jax_cf_of(random_lp[0])
    res_j = jax_solve_cf(cf_j, JaxConfig(bucket_shapes=False))
    cf_t = interop.computational_form_from_numpy(interop.computational_form_to_numpy(cf_j))
    res_t = interop.simplex_result_from_numpy(interop.simplex_result_to_numpy(res_j))
    assert res_t.kind is LinearProgramType.FINITE_OPTIMUM and res_t.basis is not None
    assert_same_ranges(ranging(cf_t, res_t), jax_ranging(cf_j, res_j))


def test_api_ranging_of(lp_files):
    res = api.solve(lp_files["wiki"], device="cpu")
    r = api.ranging_of(res)
    assert r.cost and r.rhs
    assert [x.name for x in r.rhs] == res.row_names
    first_order = api.solve(lp_files["wiki"], SolverConfig(algorithm="ipm", pdlp_crossover=False),
                            device="cpu")
    with pytest.raises(ValueError):
        api.ranging_of(first_order)


def _both_clis(path, flags, capsys, monkeypatch):
    monkeypatch.setenv("RELP_TPU_TORCH_DEVICE", "cpu")
    rc_t = cli.main([*flags, path])
    out_t = capsys.readouterr()
    rc_j = jax_cli.main([*flags, path])
    out_j = capsys.readouterr()
    return (rc_t, out_t), (rc_j, out_j)


def test_cli_ranging_json(lp_files, capsys, monkeypatch):
    (rc_t, out_t), (rc_j, out_j) = _both_clis(lp_files["wiki"], ["--json", "--ranging", "-q"],
                                              capsys, monkeypatch)
    assert rc_t == rc_j == 0
    assert "ranging note: presolve modified the problem" in out_t.err
    pt, pj = json.loads(out_t.out), json.loads(out_j.out)
    rng = pt["ranging"]
    assert rng["cost"] and rng["rhs"]
    assert set(next(iter(rng["rhs"].values()))) == {"rhs", "lo", "hi", "dual"}
    assert rng.keys() == pj["ranging"].keys()
    for part in ("cost", "rhs"):
        assert rng[part].keys() == pj["ranging"][part].keys()
        for name, row in rng[part].items():
            for key, v in row.items():
                w = pj["ranging"][part][name][key]
                assert (v is None) == (w is None) and (v is None or v == pytest.approx(w)), \
                    (part, name, key)


def test_cli_ranging_text_prints_the_jax_cli_lines(lp_files, capsys, monkeypatch):
    (rc_t, out_t), (rc_j, out_j) = _both_clis(lp_files["wiki"], ["--ranging", "--no-presolve"],
                                              capsys, monkeypatch)
    assert rc_t == rc_j == 0
    assert "cost ranging" in out_t.out and "rhs ranging" in out_t.out
    assert out_t.out == out_j.out
