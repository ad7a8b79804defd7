"""State carried across from the JAX package, as numpy arrays.

With these, a solve can start in ``relp_tpu`` and finish here: the JAX
package's operator arrays become this package's operator, and the basis
state of a JAX ``SolveOutput`` becomes this package's ``solve_core``
warm-start arguments, a JAX ``SolveOutput`` becomes this package's (and back),
so a prior solve of one package warm-starts ``reoptimize_with_bounds`` of the
other (a fleet's stacked problem arrays and lane-batched ``SolveOutput`` and
``PdhgState`` cross the same way), a JAX dual ``DState`` becomes this package's, and a JAX ``PdhgState``
becomes this package's (and back), so both packages' ``solve_pdhg_chunk`` can
start from one state; so does an ``IpmState`` for the interior point's
functions, and a solve's computational form and basis (``SimplexResult``)
go both ways as plain fields, so both packages' ranging and exact
certificate can read one basis.
Nothing here imports JAX; callers pass
``np.asarray(...)`` of the JAX arrays.  Every array is copied: a JAX
array's buffer is read-only, and the port updates some of these tensors in
place (``Binv.addr_``, ``index_copy_``), which must never write into JAX's
memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import scipy.sparse as sp

from relp_tpu_torch.fom.pdhg import PdhgState
from relp_tpu_torch.model.computational_form import ComputationalForm
from relp_tpu_torch.model.elements import LinearProgramType
from relp_tpu_torch.ops.amatrix import DenseMatrix, EllMatrix
from relp_tpu_torch.simplex.core import SolveOutput
from relp_tpu_torch.simplex.driver import SimplexResult
from relp_tpu_torch.simplex.dual import DState
from relp_tpu_torch.simplex.primal_dual import IpmState
from relp_tpu_torch.utils.metrics import SolveMetrics
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


_PROBLEM_FIELDS = ("A", "b", "c", "lb", "ub")


def stacked_problem_from_numpy(A, b, c, lb, ub, *, device: DeviceLike) -> dict:
    """The stacked arrays of a fleet, as ``solve_batched`` and the JAX
    package's ``solve_batched`` take them (``A`` ``[m, n]`` shared or
    ``[L, m, n]``, ``b`` ``[L, m]``, ``c``/``lb``/``ub`` ``[L, n]``), as f64
    tensors on ``device``, each copied, by name."""
    dev = resolve_device(device)
    out = {name: torch.tensor(np.asarray(v, np.float64), device=dev)
           for name, v in zip(_PROBLEM_FIELDS, (A, b, c, lb, ub))}
    L, m = out["b"].shape
    n = out["A"].shape[-1]
    if (out["A"].shape not in ((m, n), (L, m, n))
            or any(out[k].shape != (L, n) for k in ("c", "lb", "ub"))):
        raise ValueError("stacked problem: A must be [m, n] or [L, m, n], b [L, m] and "
                         f"c, lb, ub [L, n]; got {[tuple(out[k].shape) for k in _PROBLEM_FIELDS]}")
    return out


def stacked_problem_to_numpy(arrays) -> dict:
    """The stacked problem tensors (a mapping by name) as numpy copies."""
    return {name: arrays[name].detach().cpu().numpy().copy() for name in _PROBLEM_FIELDS}


def pdhg_state_from_numpy(fields, *, device: DeviceLike) -> PdhgState:
    """This package's ``PdhgState`` on ``device`` from the fields of a JAX
    ``PdhgState`` as numpy arrays (a mapping, or the fields in order, e.g.
    ``[np.asarray(v) for v in jax_state]``), one LP's or a fleet's (every
    leaf with a leading lane axis).  Every leaf keeps its dtype and is
    copied."""
    dev = resolve_device(device)
    if not hasattr(fields, "keys"):
        fields = dict(zip(PdhgState._fields, fields, strict=True))
    return PdhgState(**{
        name: torch.tensor(np.asarray(fields[name]), device=dev) for name in PdhgState._fields
    })


def pdhg_state_to_numpy(state: PdhgState) -> dict:
    """The fields of a ``PdhgState`` as numpy arrays (copies, on the host),
    by name: what ``relp_tpu.fom.pdhg.PdhgState(**...)`` takes once each is
    wrapped in ``jnp.asarray``."""
    return {name: value.detach().cpu().numpy().copy()
            for name, value in state._asdict().items()}


def _by_name(fields, names) -> dict:
    """``fields`` (a mapping, or the values in the order of ``names``) by name."""
    return fields if hasattr(fields, "keys") else dict(zip(names, fields, strict=True))


def _copied(fields, names, dev) -> dict:
    """A tensor copy on ``dev`` of every named field; integers become int64,
    the index type of this package's loops."""
    fields = _by_name(fields, names)
    out = {}
    for name in names:
        a = np.asarray(fields[name])
        out[name] = torch.tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a, device=dev)
    return out


_JAX_OUTPUT_FIELDS = ("x", "status", "it", "phase", "basis", "vstat", "art_inf", "pi",
                      "obj", "art_sign", "trace", "viol")


def solve_output_from_numpy(fields, *, device: DeviceLike) -> SolveOutput:
    """This package's ``SolveOutput`` on ``device`` from the fields of a JAX
    ``SolveOutput`` as numpy arrays (a mapping, or the fields in order, e.g.
    ``[np.asarray(v) for v in jax_out]``): what ``reoptimize_with_bounds``
    takes as its prior solve.  A fleet's (``solve_batched``'s, every field
    with a leading lane axis) crosses over the same way."""
    return SolveOutput(host_reads=0, **_copied(fields, _JAX_OUTPUT_FIELDS,
                                               resolve_device(device)))


def solve_output_to_numpy(out: SolveOutput) -> dict:
    """The fields a JAX ``SolveOutput`` has, as numpy arrays (copies, on the
    host; integers as int32): ``relp_tpu.simplex.core.SolveOutput(**...)``."""
    arrays = {}
    for name in _JAX_OUTPUT_FIELDS:
        a = getattr(out, name).detach().cpu().numpy().copy()
        arrays[name] = a.astype(np.int32) if a.dtype.kind == "i" else a
    return arrays


def dstate_from_numpy(fields, *, device: DeviceLike) -> DState:
    """This package's dual ``DState`` on ``device`` from the fields of a JAX
    ``DState`` as numpy arrays (a mapping, or the fields in order)."""
    names = [f.name for f in dataclasses.fields(DState)]
    return DState(**_copied(fields, names, resolve_device(device)))


def ipm_state_from_numpy(fields, *, device: DeviceLike) -> IpmState:
    """This package's ``IpmState`` on ``device`` from the fields of a JAX
    ``IpmState`` as numpy arrays (a mapping, or ``x, y, zl, zu`` in order)."""
    fields = _by_name(fields, IpmState._fields)
    dev = resolve_device(device)
    return IpmState(*(torch.tensor(np.asarray(fields[k], np.float64), device=dev)
                      for k in IpmState._fields))


def ipm_state_to_numpy(state: IpmState) -> dict:
    """The fields of an ``IpmState`` as numpy arrays (copies, on the host)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in state._asdict().items()}


_CF_FIELDS = ("b", "c", "lb", "ub", "n_structural", "slack_rows", "col_names", "maximize",
              "fixed_cost", "row_scale", "col_scale", "_orig_cost")


def computational_form_to_numpy(cf) -> dict:
    """A computational form's fields as plain values (copies; ``A`` as a
    scipy CSC): what either package's ``ComputationalForm`` is built from
    (``_orig_cost`` is set after construction)."""
    out = {"A": sp.csc_matrix(cf.A, copy=True)}
    for name in _CF_FIELDS:
        v = getattr(cf, name)
        out[name] = v.copy() if isinstance(v, (np.ndarray, list)) else v
    return out


def computational_form_from_numpy(fields) -> ComputationalForm:
    """This package's ``ComputationalForm`` from ``computational_form_to_numpy``
    of either package's (every array copied)."""
    kw = {k: (v.copy() if isinstance(v, (np.ndarray, list)) else v)
          for k, v in fields.items() if k != "_orig_cost"}
    kw["A"] = sp.csc_matrix(fields["A"], copy=True)
    cf = ComputationalForm(**kw)
    cf._orig_cost = np.array(fields["_orig_cost"], np.float64)
    return cf


def simplex_result_to_numpy(res) -> dict:
    """The basis state of either package's ``SimplexResult``, as what the
    other's ranging and certificate read: the status's value, the objective,
    the padded basis, statuses and artificial signs (copies; ``None`` where
    the solve has none) and the padded column count."""
    def copy(v):
        return None if v is None else np.array(v)

    return {
        "kind": res.kind.value, "objective": res.objective,
        "basis": copy(res.basis), "vstat": copy(res.vstat), "art_sign": copy(res.art_sign),
        "duals": copy(res.duals), "x_structural": copy(res.x_structural),
        "n_padded": res.metrics.n_padded if res.metrics is not None else None,
    }


def simplex_result_from_numpy(fields) -> SimplexResult:
    """This package's ``SimplexResult`` from ``simplex_result_to_numpy`` of
    either package's (its metrics carry only the padded column count)."""
    metrics = (None if fields["n_padded"] is None
               else SolveMetrics(n_padded=int(fields["n_padded"])))
    return SimplexResult(
        kind=LinearProgramType(fields["kind"]), objective=fields["objective"],
        x_structural=fields["x_structural"], duals=fields["duals"], metrics=metrics,
        basis=None if fields["basis"] is None else np.asarray(fields["basis"], np.int32),
        vstat=None if fields["vstat"] is None else np.asarray(fields["vstat"], np.int32),
        art_sign=fields["art_sign"],
    )
