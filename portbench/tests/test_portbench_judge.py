"""The judge solves each distinct LP once per run, and still reads every
answer on its own: the same ``(attempted, failed, worst)`` as a judge that
solves the reference again for every answer."""

import pytest

from portbench import harness, pool
from portbench.reference import ipm
from small import run_small, small_cell

RESOLVE = "dense-768x1536.dual-resolve"
SEED = 2**31 + 17


@pytest.fixture
def judged(monkeypatch):
    """A small run of the dense cell: what it handed its judge, and the
    reference solves the judge made."""
    handed, solves = [], []
    real_judge, real_solve = harness.judge, ipm.solve

    def keep(kind, records, limits, device):
        handed.append((kind, records, limits, device))
        return real_judge(kind, records, limits, device)

    def count(lp, *args, **kw):
        solves.append(lp.name)
        return real_solve(lp, *args, **kw)

    monkeypatch.setattr(harness, "judge", keep)
    monkeypatch.setattr(ipm, "solve", count)
    result, _ = run_small(RESOLVE, seed=SEED, trace=True)
    assert result["correct"]
    return result, handed[0], solves


def test_one_reference_solve_per_distinct_lp(judged):
    result, (kind, records, _, _), solves = judged
    cycle = int(small_cell(RESOLVE)[1]["traffic"]["cycle"])
    members = {pool.member(SEED, ans.key, cycle) for rec in records for ans in rec["answers"]}
    assert len(solves) == len(members) == cycle
    assert result["attempted"] > len(solves)


def test_the_same_verdict_as_a_solve_per_answer(judged, monkeypatch):
    _, (kind, records, limits, device), solves = judged
    once = harness.judge(kind, records, limits, device)
    solves.clear()
    monkeypatch.setattr(harness, "lp_identity", lambda lp: object())  # no two LPs alike
    each = harness.judge(kind, records, limits, device)
    assert each == once
    assert len(solves) == once[0]


def test_each_answer_is_read_on_its_own(judged):
    """Of two answers to one LP, the one altered fails and the other does not."""
    _, (kind, records, limits, device), _ = judged
    answers = [ans for rec in records for ans in rec["answers"]]
    twin = next(a for a in answers[1:] if kind.columns(a.key).tolist()
                == kind.columns(answers[0].key).tolist())
    twin.x = twin.x.copy()
    twin.x[0] += 0.25
    attempted, failed, worst = harness.judge(kind, records, limits, device)
    assert attempted == len(answers) and failed == 1 and worst["res"] > limits["res"]


def test_identity_of_an_lp():
    _, cell, config = small_cell(RESOLVE)
    family = harness._module("families", config["family"])
    kind = harness._module("kinds", cell["kind"]).Kind(cell, config, family, SEED, "cpu")
    kind.prepare()
    lp, again = kind.lp_of(3), kind.lp_of(3)
    assert lp is not again and harness.lp_identity(lp) == harness.lp_identity(again)
    moved = kind.lp_of(3)
    moved.ub = moved.ub.copy()
    moved.ub[0] /= 2
    copied = kind.lp_of(3)
    copied.dense = copied.dense.copy()  # equal arrays, another A
    flipped = kind.lp_of(3)
    flipped.maximize = not flipped.maximize
    for other in (moved, copied, flipped):
        assert harness.lp_identity(other) != harness.lp_identity(lp)
