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


@pytest.mark.parametrize("text", [WIKI_MPS, TESTPROB], ids=["wiki", "testprob"])
def test_native_scanner_gives_what_the_python_parser_gives(tmp_path, text, monkeypatch):
    from relp_tpu_torch.io import import_mps, native
    from relp_tpu_torch.utils import native_build

    assert native.native_available()
    # the port's own build, beside its CUDA kernels' and not in native/_build/
    assert native_build.BUILD_DIR == PORT_DIR / "_build"
    assert list(native_build.BUILD_DIR.glob("libmps_scan_*.so"))
    path = tmp_path / "problem.mps"
    path.write_text(text)
    scanned = import_mps(path)
    monkeypatch.setenv("RELP_TPU_NO_NATIVE", "1")
    parsed = import_mps(path)
    for field in dataclasses.fields(parsed):
        if field.name != "cost_row_name":  # the scanner leaves it empty: unused downstream
            assert getattr(scanned, field.name) == getattr(parsed, field.name), field.name


def _run(module, path, env_extra, flags=()):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **env_extra)
    return subprocess.run([sys.executable, "-m", module, "-q", *flags, str(path)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_prints_the_jax_cli_line(tmp_path):
    path = tmp_path / "testprob.mps"
    path.write_text(WIKI_MPS)
    port = _run("relp_tpu_torch", path, {"RELP_TPU_TORCH_DEVICE": "cpu"})
    ref = _run("relp_tpu", path, {"RELP_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu"})
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout.strip() == ref.stdout.strip() == "objective -8"


# a small 0/1 knapsack (min −5a −7b −4c −3d, 2a + 3b + 2c + d ≤ 5): optimum −12
KNAPSACK_MPS = """NAME          KNAP
ROWS
 N  COST
 L  CAP
COLUMNS
    MARKER    'MARKER'      'INTORG'
    A         COST         -5   CAP          2
    B         COST         -7   CAP          3
    C         COST         -4   CAP          2
    D         COST         -3   CAP          1
    MARKER    'MARKER'      'INTEND'
RHS
    RHS       CAP          5
BOUNDS
 UP BND       A            1
 UP BND       B            1
 UP BND       C            1
 UP BND       D            1
ENDATA
"""


@pytest.mark.parametrize("flags,fixture", [
    (("--algorithm", "dual"), WIKI_MPS),
    (("--algorithm", "dual", "--dual-pricing", "devex"), WIKI_MPS),
    (("--algorithm", "dual", "--xl-engine", "lu"), WIKI_MPS),
    (("--mip",), KNAPSACK_MPS),
    (("--mip", "--mip-cuts", "0", "--mip-branch", "fractional"), KNAPSACK_MPS),
    (("--algorithm", "ipm"), WIKI_MPS),
    (("--algorithm", "ipm", "--ipm-ladder", "mixed", "--no-crossover", "--ipm-tol", "1e-9",
      "--ipm-accept", "1e-7", "--ipm-max-iter", "50"), WIKI_MPS),
], ids=["dual", "dual-devex", "dual-lu", "mip", "mip-plain", "ipm", "ipm-flags"])
def test_cli_new_flags_print_the_jax_cli_line(tmp_path, flags, fixture):
    path = tmp_path / "problem.mps"
    path.write_text(fixture)
    port = _run("relp_tpu_torch", path, {"RELP_TPU_TORCH_DEVICE": "cpu"}, flags)
    ref = _run("relp_tpu", path, {"RELP_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu"}, flags)
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout.strip() == ref.stdout.strip()
    assert port.stdout.startswith("objective ")


def test_cli_mip_json_carries_the_search_counters(tmp_path, capsys):
    import json

    path = tmp_path / "knap.mps"
    path.write_text(KNAPSACK_MPS)
    os.environ["RELP_TPU_TORCH_DEVICE"] = "cpu"
    try:
        rc = cli.main(["--mip", "--json", "-q", str(path)])
    finally:
        del os.environ["RELP_TPU_TORCH_DEVICE"]
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["status"] == "finite_optimum"
    assert {"nodes", "lp_iterations", "best_bound", "objective"} <= set(payload)


def test_cli_refuses_flags_not_ported(tmp_path, capsys, monkeypatch):
    """Every flag of the JAX package's CLI is ported now: --mesh-cols 2
    solves (on one CPU it logs that it cannot shard and solves there)."""
    path = tmp_path / "testprob.mps"
    path.write_text(WIKI_MPS)
    monkeypatch.setenv("RELP_TPU_TORCH_DEVICE", "cpu")
    assert cli.main(["--mesh-cols", "2", "-q", str(path)]) == 0
    assert capsys.readouterr().out.strip() == "objective -8"
    with pytest.raises(SystemExit) as exc:
        cli.main(["--no-such-flag", str(path)])
    assert exc.value.code == 2


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
    assert SolverConfig(algorithm="dual").dual_ratio == "sort"  # the JAX default is "bisect"
    assert SolverConfig(algorithm="ipm").ipm_ladder == "auto"
    assert SolverConfig(algorithm="pdlp", pdlp_matrix="bricks").pdlp_matrix == "bricks"
    for k in (0, 1, 2, -1):  # every int: 0 and 1 one device, -1 every device
        assert SolverConfig(mesh_cols=k).mesh_cols == k
    for bad in (2.0, "2", True):
        with pytest.raises(ValueError):
            SolverConfig(mesh_cols=bad)
    with pytest.raises(ValueError):
        SolverConfig(pricing="steepest")
    with pytest.raises(ValueError):
        SolverConfig(inverse="lu")
    for field in ("algorithm", "dual_pricing", "dual_ratio", "mip_branch", "xl_engine",
                  "ipm_ladder", "pdlp_matrix"):
        with pytest.raises(ValueError):
            SolverConfig(**{field: "nonsense"})
    assert SolverConfig().pricing == "devex" and SolverConfig().matrix_format == "auto"
