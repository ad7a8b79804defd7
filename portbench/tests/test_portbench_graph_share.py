"""The reader of ``dual_graph_share``: the share of the traced re-solves'
iterations that the program replayed from a CUDA graph, and None for a
program whose records keep no such counter."""

from types import SimpleNamespace

from portbench import harness
from small import ROOT, run_small

READ = harness.reader(ROOT, "dual_graph_share")


def records(monkeypatch, recs):
    from portbench import spans

    monkeypatch.setattr(spans, "records", lambda call: recs)


def test_the_share_of_replayed_iterations(monkeypatch):
    recs = [SimpleNamespace(spans={"dual.step": (1, 0.1)}, iterations=it, graph_steps=g)
            for it, g in ((300, 300), (100, 99), (7, 7))]
    records(monkeypatch, recs)
    ctx = SimpleNamespace(traced=[{"iterations": 300}, {"iterations": 100}, {"iterations": 7}])
    assert READ(ctx) == 100.0 * 399 / 400  # the last record is the host-traced call's
    for r in recs:
        del r.graph_steps
    assert READ(ctx) is None


def test_a_cpu_run_replays_nothing():
    result, _ = run_small("dense-768x1536.dual-resolve", trace=True)
    assert result["correct"] and result["metrics"]["dual_graph_share"]["value"] == 0.0
