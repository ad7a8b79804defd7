"""State carried across from the JAX package, as numpy arrays.

With these, a solve can start in ``relp_tpu`` and finish here: the JAX
package's operator arrays become this package's operator, and the basis
state of a JAX ``SolveOutput`` becomes this package's ``solve_core``
warm-start arguments.  Nothing here imports JAX; callers pass
``np.asarray(...)`` of the JAX arrays.  Every array is copied: a JAX
array's buffer is read-only, and the port updates some of these tensors in
place (``Binv.addr_``, ``index_copy_``), which must never write into JAX's
memory.
"""

from __future__ import annotations

import numpy as np
import torch

from relp_tpu_torch.ops.amatrix import DenseMatrix, EllMatrix
from relp_tpu_torch.utils.device import DeviceLike, resolve_device


def operator_from_numpy(*, device: DeviceLike, A=None, data=None, rows=None,
                        rdata=None, rcols=None, m=None):
    """The port's operator on ``device`` from a JAX ``DenseMatrix``'s ``A``
    (m×n) or an ``EllMatrix``'s ``data``/``rows`` ([n, K]), row twin
    ``rdata``/``rcols`` ([m, Kr]) and row count ``m``."""
    dev = resolve_device(device)
    if A is not None:
        if data is not None:
            raise ValueError("pass either A or the ELL arrays, not both")
        return DenseMatrix(torch.tensor(np.asarray(A, np.float64), device=dev))
    if data is None or rows is None or rdata is None or rcols is None or m is None:
        raise ValueError("an ELL operator needs data, rows, rdata, rcols and m")

    def k_major(a, dtype):
        return torch.tensor(np.ascontiguousarray(np.asarray(a, dtype).T), device=dev)

    return EllMatrix(
        k_major(data, np.float64), k_major(rows, np.int32), int(m),
        k_major(rdata, np.float64), k_major(rcols, np.int32),
    )


def warm_start_from_numpy(basis, vstat, art_sign, phase, *, device: DeviceLike):
    """``solve_core`` warm-start keyword arguments from a JAX
    ``SolveOutput``'s ``basis``, ``vstat[:n_pad]``, ``art_sign`` and
    ``phase``."""
    dev = resolve_device(device)
    return dict(
        basis0=torch.tensor(np.asarray(basis, np.int64), device=dev),
        vstat0=torch.tensor(np.asarray(vstat, np.int64), device=dev),
        art_sign0=torch.tensor(np.asarray(art_sign, np.float64), device=dev),
        phase0=int(np.asarray(phase)),
    )
