"""Basis checkpoint / resume (numpy and ``.npz`` only).

A copy of ``relp_tpu/simplex/checkpoint.py``: a checkpoint is the state a
warm start needs, (basis indices, variable statuses, iteration count), a few
kilobytes saved as ``.npz``; the basis inverse is refactorized on load by the
warm-start path.  The file layout is the JAX package's, so a checkpoint
written by one package loads in the other.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Union

import numpy as np


def _host(v) -> np.ndarray:
    """A tensor (of any device) or array as a numpy array."""
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


@dataclass
class BasisCheckpoint:
    basis: np.ndarray   # i32[m_padded] (may reference artificial columns)
    vstat: np.ndarray   # i32[n_padded + m_padded]
    n_padded: int
    iterations: int = 0

    def save(self, path: Union[str, os.PathLike]) -> None:
        np.savez_compressed(
            path,
            basis=self.basis.astype(np.int32),
            vstat=self.vstat.astype(np.int32),
            n_padded=np.int64(self.n_padded),
            iterations=np.int64(self.iterations),
        )

    @staticmethod
    def load(path: Union[str, os.PathLike]) -> "BasisCheckpoint":
        with np.load(path) as z:
            return BasisCheckpoint(
                basis=z["basis"],
                vstat=z["vstat"],
                n_padded=int(z["n_padded"]),
                iterations=int(z["iterations"]),
            )

    @staticmethod
    def from_solve_output(out, n_padded: int) -> "BasisCheckpoint":
        return BasisCheckpoint(
            basis=_host(out.basis),
            vstat=_host(out.vstat),
            n_padded=n_padded,
            iterations=int(out.it),
        )

    def warm_start_args(self):
        """(basis0, vstat0) for ``solve_core`` on the same padded shapes."""
        return self.basis.astype(np.int32), self.vstat[: self.n_padded].astype(np.int32)
