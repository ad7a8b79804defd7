"""The port's whole pipeline against the JAX package's: MPS → GeneralForm →
presolve → computational form, ``api.solve`` on a max-flow LP written by the
port's MPS writer, the command line, the explicit device and the rule that
the port never imports JAX."""

import ast
import dataclasses
import enum
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import maximum_flow

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
import relp_tpu.api
from relp_tpu.io.mps_convert import mps_to_general_form as jax_to_general
from relp_tpu.io.mps_parse import parse_free as jax_parse_free
from relp_tpu.model.computational_form import build_computational_form as jax_build_cf
from relp_tpu.presolve.engine import presolve as jax_presolve
from relp_tpu_torch import api, cli
from relp_tpu_torch.io.mps_convert import mps_to_general_form as torch_to_general
from relp_tpu_torch.io.mps_parse import parse_free as torch_parse_free
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.model.computational_form import build_computational_form as torch_build_cf
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.presolve.engine import presolve as torch_presolve
from relp_tpu_torch.utils.config import SolverConfig
from relp_tpu_torch.utils.device import resolve_device
from tests.test_mps_parse import TESTPROB
from tests.test_pipeline_fixture import WIKI_MPS

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = ROOT / "relp_tpu_torch"


def _plain(x):
    """A package-neutral snapshot: enums by value, objects by their fields,
    arrays and sparse matrices as nested lists."""
    if isinstance(x, enum.Enum):
        return x.value
    if sp.issparse(x):
        return _plain(x.toarray())
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "__dict__"):
        return {k: _plain(v) for k, v in vars(x).items()}
    return x


@pytest.mark.parametrize("text", [WIKI_MPS, TESTPROB], ids=["wiki", "testprob"])
def test_general_presolve_and_computational_forms_are_identical(text):
    gj = jax_to_general(jax_parse_free(text))
    gt = torch_to_general(torch_parse_free(text))
    assert _plain(gt) == _plain(gj)

    outcome_j, outcome_t = jax_presolve(gj), torch_presolve(gt)
    assert _plain(outcome_t) == _plain(outcome_j)
    assert _plain(gt) == _plain(gj)

    for scale in (True, False):
        assert _plain(torch_build_cf(gt, scale=scale)) == _plain(jax_build_cf(gj, scale=scale))


def test_api_solve_max_flow_matches_jax_and_scipy(tmp_path):
    n_nodes = 200
    arcs = random_arcs(n_nodes, 8, seed=7)
    u, v, cap = (np.array(col) for col in zip(*arcs))
    graph = sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(n_nodes, n_nodes))
    flow = maximum_flow(graph, 0, n_nodes - 1).flow_value
    path = tmp_path / "maxflow_200.mps"
    export_mps(max_flow_lp(n_nodes, arcs, 0, n_nodes - 1), path)

    rt = api.solve(path, device="cpu")
    rj = relp_tpu.api.solve(path)
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value,
                                                        rel=1e-9)
    assert rt.solution.objective_value == pytest.approx(flow, abs=1e-6)
    assert rt.simplex.metrics.device == "cpu"


def _run(module, path, env_extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **env_extra)
    return subprocess.run([sys.executable, "-m", module, "-q", str(path)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_prints_the_jax_cli_line(tmp_path):
    path = tmp_path / "testprob.mps"
    path.write_text(WIKI_MPS)
    port = _run("relp_tpu_torch", path, {"RELP_TPU_TORCH_DEVICE": "cpu"})
    ref = _run("relp_tpu", path, {"RELP_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu"})
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout.strip() == ref.stdout.strip() == "objective -8"


def test_cli_refuses_flags_not_ported(tmp_path, capsys):
    path = tmp_path / "testprob.mps"
    path.write_text(WIKI_MPS)
    for flags, said in ((["--algorithm", "dual"], "--algorithm dual is not ported"),
                        (["--algorithm", "ipm"], "--algorithm ipm is not ported"),
                        (["--algorithm", "pdlp", "--pdlp-matrix", "bricks"],
                         "--pdlp-matrix bricks is not ported"),
                        (["--mip"], "--mip is not ported")):
        with pytest.raises(SystemExit) as exc:
            cli.main([*flags, str(path)])
        assert exc.value.code == 2
        assert said in capsys.readouterr().err


def test_package_never_imports_jax():
    # at run time: importing every module of the port loads neither
    code = (
        "import pkgutil, sys, relp_tpu_torch\n"
        "for mod in pkgutil.walk_packages(relp_tpu_torch.__path__, 'relp_tpu_torch.'):\n"
        "    if mod.name != 'relp_tpu_torch.__main__':\n"
        "        __import__(mod.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'relp_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # in the sources: no import of either, not even inside a function
    for src in PORT_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(src.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "relp_tpu"), (src, name)


def test_cuda_without_a_gpu_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    path = tmp_path / "testprob.mps"
    path.write_text(WIKI_MPS)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        api.solve(path, device="cuda")
    monkeypatch.delenv("RELP_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError):  # the default device is cuda
        api.solve(path)
    assert resolve_device("cpu") == torch.device("cpu")


def test_config_refuses_engines_not_ported():
    assert SolverConfig(algorithm="pdlp").pdlp_matrix == "auto"
    for field, value in (("algorithm", "dual"), ("algorithm", "ipm"),
                         ("pdlp_matrix", "bricks"), ("mesh_cols", 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SolverConfig(**{field: value})
    with pytest.raises(ValueError):
        SolverConfig(pricing="steepest")
    with pytest.raises(ValueError):
        SolverConfig(inverse="lu")
    assert SolverConfig().pricing == "devex" and SolverConfig().matrix_format == "auto"
