"""The reader of ``update_kernel_share``: the share of the traced re-solves'
iterations whose update ran the ``dual_update`` kernel, None for a program
whose records keep no such counter, and 0 in a CPU run of each cell, whose
updates run the plain version."""

from types import SimpleNamespace

import pytest

import small
from portbench import harness
from small import ROOT, run_small

READ = harness.reader(ROOT, "update_kernel_share")
small.SIZES.setdefault("maxflow-n4096", {"frame": 4, "frames": 8})


def records(monkeypatch, recs):
    from portbench import spans

    monkeypatch.setattr(spans, "records", lambda call: recs)


def test_the_share_of_kernel_updates(monkeypatch):
    recs = [SimpleNamespace(spans={"dual.step": (1, 0.1)}, iterations=it, update_kernel_steps=u)
            for it, u in ((300, 300), (100, 60), (7, 0))]
    records(monkeypatch, recs)
    ctx = SimpleNamespace(traced=[{"iterations": r.iterations} for r in recs])
    assert READ(ctx) == 100.0 * 360 / 400  # the last record is the host-traced call's
    for r in recs:
        del r.update_kernel_steps
    assert READ(ctx) is None


@pytest.mark.parametrize("workload", ["dense-768x1536.dual-resolve",
                                      "maxflow-n4096.dual-resolve"])
def test_a_cpu_run_updates_with_the_plain_version(workload):
    result, _ = run_small(workload, trace=True)
    assert result["correct"] and result["metrics"]["update_kernel_share"]["value"] == 0.0
