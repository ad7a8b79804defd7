"""Wrapper of the dual simplex's update kernel, ``dual_update``.

``dual_update`` is one dual pivot's arithmetic after the products with A and
B⁻¹: the new basis, statuses, xB, π, d and row weights, the status and
counters, whether the pivot applies, and the packed loop flags.  The kernel
is in ``relp_tpu_torch/csrc/dual_kernels.cu``; it replaces no Pallas kernel
(the JAX package's loop body is one XLA program, whose compiler fuses the
same chain), but ~105 small PyTorch kernels an iteration: its plain version
is ``simplex/dual.py::dual_update_plain``, which the dual runs off a CUDA
device.  Every output is an elementwise function of its own element and a
dozen gathered scalars, so one thread per element of the n + m statuses
writes fresh outputs with no grid synchronisation; it moves
``112·m + 41·n`` bytes under ``"dse"`` and is bound by its launch's latency
at the solver's shapes.  It gives the plain version's bits: every f64
operation is rounded on its own, in PyTorch's order.

The wrapper takes the pivot, the state's fields, the bounds and the scalars
explicitly and launches on a CUDA device; it raises on any other: there is
no fallback.  It counts its launches in a plain integer attribute,
``launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

_I64, _F64 = torch.int64, torch.float64


class Pivot(NamedTuple):
    """What the update reads besides the state and the bounds."""

    r: torch.Tensor                 # i64 0-dim, the leaving row
    q: torch.Tensor                 # i64 0-dim, the entering column
    has_entering: torch.Tensor      # bool 0-dim
    n_flips: torch.Tensor           # i64 0-dim, the ratio test's bound flips
    flip_mask: torch.Tensor         # bool [n]
    primal_feasible: torch.Tensor   # bool 0-dim
    broken: torch.Tensor            # bool 0-dim, a non-finite xB or π
    fresh: torch.Tensor             # bool 0-dim, no pivot since the refactorization
    leaving_below: torch.Tensor     # bool 0-dim, xB_r under its lower bound
    u: torch.Tensor                 # f64 [m], B⁻¹·a_q
    bdx: torch.Tensor               # f64 [m], B⁻¹·(A·dx), the flips' product
    tau: Optional[torch.Tensor]     # f64 [m], B⁻¹·ρ under "dse"; None under "devex"
    rho: torch.Tensor               # f64 [m], B⁻¹[r, :]
    alpha: torch.Tensor             # f64 [n], ρ·A


# the state's fields the update reads and replaces, in DualUpdateArgs's order
STATE = ("basis", "vstat", "xB", "pi", "d", "beta", "status", "it", "since_refactor", "flips")
# the operands of DualUpdateArgs (csrc/dual_kernels.cu), in its order
_PIVOT_IN = ("r", "q", "n_flips", "has_entering", "primal_feasible", "broken", "fresh",
             "leaving_below", "flip_mask", "u", "bdx", "tau", "rho", "alpha")
_BOUNDS = ("lb", "ub", "lb_tot", "ub_tot")


class DualUpdateArgs(ctypes.Structure):
    """``relp::DualUpdateArgs`` of ``csrc/dual_kernels.cu``."""

    _fields_ = ([(k, ctypes.c_void_p) for k in _PIVOT_IN + STATE + _BOUNDS]
                + [(f"{k}_out", ctypes.c_void_p) for k in STATE + ("do_pivot", "flags")]
                + [("m", ctypes.c_int64), ("n", ctypes.c_int64),
                   ("refactor_period", ctypes.c_int64), ("max_iter", ctypes.c_int64),
                   ("eps_pivot", ctypes.c_double)])


def _check(piv: Pivot, state, bounds: dict, devex: bool):
    """Raise unless the operands are what the kernel reads; their device."""
    m, n = state.basis.shape[0], bounds["lb"].shape[0]
    want = {  # name -> (tensor, dtype, shape)
        **{k: (getattr(piv, k), _I64, ()) for k in ("r", "q", "n_flips")},
        **{k: (getattr(piv, k), torch.bool, ())
           for k in ("has_entering", "primal_feasible", "broken", "fresh", "leaving_below")},
        "flip_mask": (piv.flip_mask, torch.bool, (n,)),
        **{k: (getattr(piv, k), _F64, (m,)) for k in ("u", "bdx", "rho")},
        "alpha": (piv.alpha, _F64, (n,)),
        "basis": (state.basis, _I64, (m,)), "vstat": (state.vstat, _I64, (n + m,)),
        **{k: (getattr(state, k), _F64, (m,)) for k in ("xB", "pi", "beta")},
        "d": (state.d, _F64, (n,)),
        **{k: (getattr(state, k), _I64, ()) for k in ("status", "it", "since_refactor", "flips")},
        "lb": (bounds["lb"], _F64, (n,)), "ub": (bounds["ub"], _F64, (n,)),
        "lb_tot": (bounds["lb_tot"], _F64, (n + m,)),
        "ub_tot": (bounds["ub_tot"], _F64, (n + m,)),
    }
    if not devex:
        want["tau"] = (piv.tau, _F64, (m,))
    dev = state.xB.device
    for name, (t, dtype, shape) in want.items():
        if t is None or t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            got = None if t is None else (str(t.device), t.dtype, tuple(t.shape))
            raise ValueError(f"dual_update: {name} must be a contiguous {dtype} of shape "
                             f"{shape} on {dev}, got {got}")
    if dev.type != "cuda":
        raise ValueError(f"dual_update: unsupported device {dev}")
    return dev


def dual_update(piv: Pivot, state, lb, ub, lb_tot, ub_tot, *, refactor_period: int,
                max_iter: int, eps_pivot: float, devex: bool):
    """One launch of the update on the CUDA device of its operands.

    ``state`` holds the fields ``STATE`` as attributes (the dual's
    ``DState``); ``lb``/``ub`` are the column bounds [n], ``lb_tot``/
    ``ub_tot`` those with the artificials' [n + m]; ``devex`` picks the
    weight rule (else ``"dse"``, which reads ``piv.tau``).  Returns
    ``(fields, flags, do_pivot)``: the new ``STATE`` by name, fresh tensors;
    the packed flags (running, refactorization due); whether the pivot
    applies, 0-dim."""
    bounds = {"lb": lb, "ub": ub, "lb_tot": lb_tot, "ub_tot": ub_tot}
    dev = _check(piv, state, bounds, devex)
    from relp_tpu_torch.ops.cuda_build import load_kernels, raise_on

    out = {k: torch.empty_like(getattr(state, k)) for k in STATE}
    do_pivot = torch.empty((), dtype=torch.bool, device=dev)
    flags = torch.empty(2, dtype=torch.bool, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = DualUpdateArgs(
        *(ptr(getattr(piv, k)) for k in _PIVOT_IN), *(ptr(getattr(state, k)) for k in STATE),
        *(ptr(bounds[k]) for k in _BOUNDS), *(ptr(out[k]) for k in STATE),
        ptr(do_pivot), ptr(flags), state.basis.shape[0], lb.shape[0], refactor_period,
        max_iter, eps_pivot)
    with torch.cuda.device(dev):
        err = load_kernels().lib.relp_dual_update(
            ctypes.byref(args), int(devex), torch.cuda.current_stream(dev).cuda_stream)
    raise_on("dual_update", err)
    dual_update.launches += 1
    return out, flags, do_pivot


dual_update.launches = 0
