"""The cell cfl-50x50.mip-solve at its CPU size (``small_cfl.py``): a sound
run, traced and not; the readers of the branch and bound's counters and
spans on stub records; and the kind's refusal, before any solve, of a
program whose ``MipResult`` carries no certificate."""

import dataclasses
from types import SimpleNamespace

import pytest

import small_cfl  # noqa: F401  (registers the configuration's CPU size)
from portbench import harness
from small import ROOT, run_small, small_cell

CELL = "cfl-50x50.mip-solve"
READERS = ["mip_nodes_per_solve", "mip_root_ms_per_solve", "mip_cuts_ms_per_solve",
           "mip_node_ms", "mip_tree_ms_per_node"]


@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_is_sound(trace):
    result, compared = run_small(CELL, trace=trace)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert all(v <= lim for v, lim in compared.values())
    if not trace:
        assert set(result["metrics"]) == {"resolve_s", "setup_s"}
    else:
        # mip_node_ms reads nothing where the traced instance's root was integral
        assert set(READERS) - {"mip_node_ms"} <= set(result["metrics"]) <= set(READERS)


def stub(monkeypatch, recs):
    from portbench import spans

    monkeypatch.setattr(spans, "records", lambda call: recs if call == "mip" else [])


def mip_record(nodes, root, cuts, node, tree):
    return SimpleNamespace(nodes=nodes, spans={
        "mip.solve": (1, 9.0), "mip.root": (1, root), "mip.cuts": (2, cuts),
        "mip.node": (nodes - 1, node), "mip.tree": (nodes, tree)})


def test_the_readers_on_stub_records(monkeypatch):
    recs = [mip_record(5, 0.5, 0.25, 0.4, 0.01), mip_record(9, 0.7, 0.35, 0.8, 0.09),
            mip_record(3, 9.0, 9.0, 9.0, 9.0)]  # the last: the host-traced call
    stub(monkeypatch, recs)
    ctx = SimpleNamespace(records=[{"nodes": 5}, {"nodes": 8}],
                          traced=[{"nodes": r.nodes} for r in recs])
    read = {name: harness.reader(ROOT, name) for name in READERS}
    assert read["mip_nodes_per_solve"](ctx) == 6.5
    assert read["mip_root_ms_per_solve"](ctx) == pytest.approx(600.0)
    assert read["mip_cuts_ms_per_solve"](ctx) == pytest.approx(300.0)
    assert read["mip_node_ms"](ctx) == pytest.approx(1200.0 / 12)
    assert read["mip_tree_ms_per_node"](ctx) == pytest.approx(100.0 / 14)
    # a traced call whose record does not match, records without spans, or a
    # program that keeps no mip records: nothing to read
    ctx.traced[0]["nodes"] = 6
    assert all(read[n](ctx) is None for n in READERS[1:])
    ctx.traced[0]["nodes"] = 5
    for r in recs:
        r.spans = {}
    assert all(read[n](ctx) is None for n in READERS[1:])
    stub(monkeypatch, [])
    assert all(read[n](ctx) is None for n in READERS[1:])
    assert read["mip_nodes_per_solve"](SimpleNamespace(records=[])) is None


def test_a_program_without_a_certificate_is_refused_at_once(monkeypatch):
    from portbench.kinds import mip
    from relp_tpu_torch.models import branch_bound

    @dataclasses.dataclass
    class OldResult:  # MipResult as it was before it carried a certificate
        kind: object
        objective: float = None
        values: dict = None
        nodes: int = 0
        lp_iterations: int = 0
        best_bound: float = None

    def no_solve(*args, **kwargs):
        raise AssertionError("no instance may be solved")

    monkeypatch.setattr(branch_bound, "MipResult", OldResult)
    monkeypatch.setattr(branch_bound, "solve_mip", no_solve)
    monkeypatch.setattr(mip, "highs_optimum", no_solve)
    _, cell, config = small_cell(CELL)
    family = harness._module("families", config["family"])
    kind = mip.Kind(cell, config, family, 7, "cpu")
    with pytest.raises(RuntimeError, match="no certificate"):
        kind.setup()
