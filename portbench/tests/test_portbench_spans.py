"""The readers of the program's own spans: a traced run on the CPU reports
each of them as a positive number, read from the records the program keeps
of the calls traced with device activity only."""

from small import run_small

SPAN_METRICS = ("dual_dispatch_ms_per_iter", "dual_wait_ms_per_iter", "ratio_test_ms_per_iter",
                "refactor_ms_per_resolve", "base_solve_s")


def test_a_traced_run_reads_the_program_spans():
    from relp_tpu_torch.utils import metrics

    result, _ = run_small("dense-768x1536.dual-resolve", trace=True)
    assert result["correct"]
    got = {k: result["metrics"][k]["value"] for k in SPAN_METRICS}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    assert got["ratio_test_ms_per_iter"] <= got["dual_dispatch_ms_per_iter"]
    # the window's re-solves ran untraced: their records hold no spans
    resolves = [r for r in metrics.recent() if r.call == "reoptimize"]
    assert resolves[-1].spans and resolves[-2].spans and not resolves[-3].spans
