"""A run with its timed path broken underneath comes out not correct: for
each fault a cell can have (one card, so no exchange between chips)."""

import numpy as np
import pytest

from small import run_small

RESOLVE = "dense-768x1536.dual-resolve"


@pytest.mark.parametrize("fault", ["unchanged", "altered", "objective"])
def test_resolve_faults(monkeypatch, fault):
    from relp_tpu_torch.simplex import reoptimize

    real = reoptimize.reoptimize_with_bounds

    def broken(A, b, c, new_lb, new_ub, prior, **kw):
        if fault == "unchanged":  # the base state, whatever the bounds
            out = real(A, b, c, new_lb, np.maximum(new_ub, 2.0 * (new_ub > 0)), prior, **kw)
            return out
        out = real(A, b, c, new_lb, new_ub, prior, **kw)
        if fault == "objective":  # x and duals as computed, the objective off by 1e-5
            return out._replace(obj=out.obj * (1 + 1e-5))
        x = out.x.clone()
        x[0] += 0.25
        return out._replace(x=x)

    monkeypatch.setattr(reoptimize, "reoptimize_with_bounds", broken)
    result, _ = run_small(RESOLVE)
    assert result["correct"] is False and result["failed"] > 0
