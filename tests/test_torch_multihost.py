"""Multi-process execution of the port (relp_tpu_torch/parallel/multihost.py)
on the CPU: two processes join a gloo process group, build the global solver
mesh ('batch' across processes, 'cols' within) and solve one scenario each
of tests/multihost_worker.py's closed-form fleet,

    min −x1 − 2·x2  s.t.  x1 + x2 + s = b,  0 ≤ x ≤ 4,  s ≥ 0,

for b ∈ {3, 6}: the optimum −(2·min(b, 4) + max(b − 4, 0)) = (−6, −10).
``process_allgather`` gathers the statuses and objectives, which both
processes report with the world size.

The processes are spawned (``torch.multiprocessing``, the ``spawn``
context), so each imports this file afresh: it imports neither JAX nor the
JAX package.  Each join has a timeout, and a process still alive then is
killed.
"""

import queue
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

JOIN_S = 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fleet(b_scen=(3.0, 6.0), m_pad=8, n_pad=128):
    """tests/multihost_worker.py's fleet: stacked A, b, c, lb, ub."""
    batch = len(b_scen)
    A = np.zeros((batch, m_pad, n_pad))
    b = np.zeros((batch, m_pad))
    c = np.zeros((batch, n_pad))
    lb = np.zeros((batch, n_pad))
    ub = np.zeros((batch, n_pad))
    for s in range(batch):
        A[s, 0, :3] = 1.0
        b[s, 0] = b_scen[s]
        c[s, :2] = [-1.0, -2.0]
        ub[s, :2] = 4.0
        ub[s, 2] = np.inf
    return A, b, c, lb, ub


def _worker(rank: int, port: int, out) -> None:
    """One process of the two: join, solve this process's scenario, gather."""
    torch.set_num_threads(1)
    from relp_tpu_torch.parallel import global_solver_mesh, initialize_distributed, solve_batched
    from relp_tpu_torch.parallel.multihost import process_allgather
    from relp_tpu_torch.utils.config import SolverConfig

    try:
        initialize_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                               device="cpu")
        mesh = global_solver_mesh(device="cpu")
        res = solve_batched(*fleet(), cfg=SolverConfig(), max_iter=64, mesh=mesh)
        status = process_allgather(res.status)
        objs = process_allgather(res.obj)
        out.put((rank, dist.get_world_size(), mesh.shape, mesh.local_rows(),
                 res.obj.shape[0], status.tolist(), objs.tolist()))
    except Exception as exc:  # reported to the parent, which fails the test
        out.put((rank, "error", repr(exc)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_processes_solve_the_fleet_over_gloo():
    from relp_tpu_torch.simplex import status as st

    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(rank, port, out)) for rank in range(2)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in procs:  # drain the queue before joining
            results.append(out.get(timeout=JOIN_S))
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    assert len(results) == 2, results
    for rank, *rest in sorted(results, key=lambda r: r[0]):
        assert rest[0] != "error", rest
        world, shape, local_rows, lanes, status, objs = rest
        assert world == 2 and shape == {"batch": 2, "cols": 1}
        assert local_rows == [rank] and lanes == 1
        assert status == [st.OPTIMAL] * 2
        np.testing.assert_allclose(objs, [-6.0, -10.0], rtol=0, atol=1e-9)
    assert [p.exitcode for p in procs] == [0, 0]


def test_one_process_needs_no_group():
    from relp_tpu_torch.parallel import global_solver_mesh, initialize_distributed
    from relp_tpu_torch.parallel.multihost import process_allgather

    initialize_distributed(num_processes=1)
    initialize_distributed("127.0.0.1:1", num_processes=None, process_id=0)
    assert not dist.is_initialized()
    mesh = global_solver_mesh(device="cpu")
    assert mesh.shape == {"batch": 1, "cols": 1} and mesh.local_rows() == [0]
    t = torch.arange(3.0)
    assert process_allgather(t) is t
    with pytest.raises(ValueError, match="does not cover"):
        global_solver_mesh(batch=2, device="cpu")
