"""What every request kind has: the cell, its configuration, the family
that makes its LPs, the seed and the device.

A kind sets the program up and warms it (``setup``), serves request ``k``
(``request``: the timed call and what it answered), frees the program's
state (``release``) and makes again the LP behind each answer (``lp_of``),
so that the reference works it out from the benchmark's own arrays.

A request's record holds ``wall`` (host seconds of the timed call) and
``answers``: one ``Answer`` per LP it solved.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import numpy as np

from portbench.families.lp import LP


@dataclass
class Answer:
    key: Any              # what lp_of needs to make the LP again
    ok: bool              # the program reported an optimum
    objective: float = float("nan")
    x: np.ndarray = None  # the LP's columns, in its own order
    y: np.ndarray = None  # row duals of the LP's own sense (of max for a maximisation)


class Kind:
    def __init__(self, cell: dict, config: dict, family, seed: int, device: str):
        self.cell, self.config, self.family = cell, config, family
        self.seed, self.device = seed, device
        # wraps each timed call: the harness puts a profiler here in a traced slice
        self.timed = contextlib.nullcontext
        self.notes: list = []  # what set-up found, for the progress lines

    def prepare(self) -> None:
        """Make what ``lp_of`` needs, without the program."""

    def setup(self) -> None:
        raise NotImplementedError

    def keys(self, k: int) -> list:
        """The keys of the LPs that request ``k`` solves."""
        return [k]

    def request(self, k: int) -> dict:
        raise NotImplementedError

    def release(self) -> None:
        """Drop the program's state before the reference runs."""

    def lp_of(self, key) -> LP:
        raise NotImplementedError

    def close(self) -> None:
        """Remove what the kind wrote."""


def general_form(lp: LP):
    """``lp`` as the program's ``GeneralForm`` (equality rows, its names); a
    sparse A goes over as it is, without being made dense."""
    import scipy.sparse as sp

    from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation
    from relp_tpu_torch.model.general_form import GeneralForm, Variable

    return GeneralForm(
        objective=Objective.MAXIMIZE if lp.maximize else Objective.MINIMIZE,
        A=sp.csc_matrix(lp.A),
        constraint_types=[RangedConstraintRelation.equal()] * lp.m,
        b=lp.b,
        variables=[Variable(nm, cost=float(lp.c[j]), lower=float(lp.lb[j]), upper=float(lp.ub[j]))
                   for j, nm in enumerate(lp.col_names)],
        name=lp.name, row_names=list(lp.row_names))
