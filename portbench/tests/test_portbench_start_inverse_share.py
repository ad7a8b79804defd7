"""The reader of ``start_inverse_hit_share``: the share of the traced
re-solves that started from a kept start inverse, None for a program whose
records keep no such counter, and 100 in a CPU run of each cell, whose
requests all start from one base basis on one operator (the warm-up in
set-up is the one miss)."""

from types import SimpleNamespace

import pytest

import small
from portbench import harness
from small import ROOT, run_small

READ = harness.reader(ROOT, "start_inverse_hit_share")
small.SIZES.setdefault("maxflow-n4096", {"frame": 4, "frames": 8})


def records(monkeypatch, recs):
    from portbench import spans

    monkeypatch.setattr(spans, "records", lambda call: recs)


def test_the_share_of_started_resolves(monkeypatch):
    recs = [SimpleNamespace(spans={"dual.step": (1, 0.1)}, iterations=it, start_inverse_hits=h)
            for it, h in ((30, 1), (20, 0), (10, 1), (7, 1))]
    records(monkeypatch, recs)
    ctx = SimpleNamespace(traced=[{"iterations": r.iterations} for r in recs])
    assert READ(ctx) == 100.0 * 2 / 3  # the last record is the host-traced call's
    for r in recs:
        del r.start_inverse_hits
    assert READ(ctx) is None


@pytest.mark.parametrize("workload", ["dense-768x1536.dual-resolve",
                                      "maxflow-n4096.dual-resolve"])
def test_a_cpu_run_starts_every_traced_resolve_from_the_kept_inverse(workload):
    result, _ = run_small(workload, trace=True)
    assert result["correct"] and result["metrics"]["start_inverse_hit_share"]["value"] == 100.0
