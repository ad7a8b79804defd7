"""The cell ``maxflow-n4096.dual-resolve`` (kind ``cut``) on the CPU at 128
nodes (8 frames of 4 × 4): its traffic cuts arcs that carry flow to half their flow, a run on
the driver's own ELL operator is correct and names that operator in every
re-solve's record, the reader of ``binv_roofline.resolve`` reads the bytes
of the B⁻¹ each record kept (None without them), the control in float32
and three planted faults read not correct.

``small.SIZES`` gets the configuration's CPU size here, so that
``test_portbench_harness.py`` runs the cell at that size when the
benchmark's tests run as a directory.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

import small
from portbench import control, harness, pool
from small import ROOT

CUT = "maxflow-n4096.dual-resolve"
small.SIZES.setdefault("maxflow-n4096", {"frame": 4, "frames": 8})
SEED = 2**31 + 11
READ = harness.reader(ROOT, "binv_roofline.resolve")


def ell_cell():
    """The cell at its CPU size, on the ELL operator as at full size (at 128
    nodes ``matrix_format="auto"`` picks the dense one)."""
    bench, cell, config = small.small_cell(CUT)
    return bench, {**cell, "solver": {**cell["solver"], "matrix_format": "ell"}}, config


def run_ell(trace=True):
    bench, cell, config = ell_cell()
    return harness.run_cell(ROOT, bench, CUT, cell, config, SEED, 0.3, trace, "cpu",
                            time.perf_counter())


def kind_of(cell, config, seed=SEED):
    family = harness._module("families", config["family"])
    return harness._module("kinds", cell["kind"]).Kind(cell, config, family, seed, "cpu")


def test_each_what_if_cuts_arcs_that_carry_flow_to_half():
    _, cell, config = ell_cell()
    kind = kind_of(cell, config)
    kind.prepare()
    base, flow = kind.base, kind.base.extra["flow"]
    cycle, bounds = int(cell["traffic"]["cycle"]), int(cell["traffic"]["bounds"])
    assert kind.carrying.tolist() == np.flatnonzero(flow > 0).tolist()
    members = set()
    for k in range(1, cycle + 1):
        J = kind.columns(k)
        assert len(set(J.tolist())) == bounds and np.all(flow[J] > 0)
        lp = kind.lp_of(k)
        cut = np.zeros(base.n, bool)
        cut[J] = True
        assert np.array_equal(lp.ub[J], flow[J] / 2)
        assert np.array_equal(lp.ub[~cut], base.ub[~cut])
        assert lp.A is base.A  # one operator for the judge
        members.add(pool.member(SEED, k, cycle))
    assert members == set(range(cycle))


def test_sound_run_on_the_ell_operator():
    from relp_tpu_torch.utils import metrics

    result, compared = run_ell()
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(compared) == set(harness.MEASURES)
    values = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(isinstance(v, float) for v in values.values())
    # what the CPU can read of the cell's metrics: its counters and spans (the
    # device's share, launches and roofline read None without a card)
    for name in ("dual_ms_per_iter", "dual_iters_per_resolve", "dual_dispatch_ms_per_iter",
                 "dual_wait_ms_per_iter", "refactor_ms_per_resolve", "base_solve_s"):
        assert values[name] > 0, name
    assert values["dual_graph_share"] == 0.0
    resolves = [r for r in metrics.recent() if r.call == "reoptimize"][-18:]
    assert {(r.engine, r.matrix_format, r.inverse_bytes) for r in resolves} == {
        ("dual", "ell", 128 ** 2 * 8)}


def test_binv_roofline_reads_the_records(monkeypatch):
    from portbench import spans

    recs = [SimpleNamespace(spans={"dual.step": (1, 0.1)}, iterations=it, inverse_bytes=2**27)
            for it in (200, 100, 7)]
    monkeypatch.setattr(spans, "records", lambda call: recs)
    busy = 0.5
    ctx = SimpleNamespace(traced=[{"iterations": 200}, {"iterations": 100}, {"iterations": 7}],
                          peak_bytes_per_s=3.35e12,
                          summaries=lambda: [SimpleNamespace(busy_s=busy / 2)] * 2)
    # the last record is the host-traced call's: 300 iterations
    assert READ(ctx) == pytest.approx(100.0 * 300 * 2 * 2**27 / 3.35e12 / busy)
    recs[0].inverse_bytes = 0
    assert READ(ctx) is None
    for r in recs:
        del r.inverse_bytes
    assert READ(ctx) is None


def test_control_fails_small():
    _, cell, config = ell_cell()
    for seed in (1, 2, 2**31 + 3):
        attempted, failed, worst = control.control_run(ROOT, CUT, seed, 2, "cpu", cell, config)
        assert attempted > 0 and failed > 0
        assert any(worst[k] > cell["limits"][k] for k in worst)


@pytest.mark.parametrize("fault", ["unchanged", "altered", "objective"])
def test_cut_faults(monkeypatch, fault):
    from relp_tpu_torch.simplex import reoptimize

    real = reoptimize.reoptimize_with_bounds
    _, cell, config = ell_cell()
    capacity = harness._module("families", config["family"]).make(config, SEED, 0).ub

    def broken(A, b, c, new_lb, new_ub, prior, **kw):
        if fault == "unchanged":  # the base LP's answer, whatever the cuts
            ub = np.array(new_ub, copy=True)
            ub[: len(capacity)] = capacity
            return real(A, b, c, new_lb, ub, prior, **kw)
        out = real(A, b, c, new_lb, new_ub, prior, **kw)
        if fault == "objective":  # x and duals as computed, the objective off by 1e-3
            return out._replace(obj=out.obj * (1 + 1e-3))
        x = out.x.clone()
        x[0] += 0.25
        return out._replace(x=x)

    monkeypatch.setattr(reoptimize, "reoptimize_with_bounds", broken)
    result, _ = run_ell(trace=False)
    assert result["correct"] is False and result["failed"] > 0
