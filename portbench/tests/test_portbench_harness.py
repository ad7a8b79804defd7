"""The harness finds every piece by name, refuses an unknown cell, and keeps
BENCHMARK.json to the benchmark's contract."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness
from small import ROOT, run_small

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_unknown_cell_is_refused():
    with pytest.raises(harness.UnknownCell):
        harness.find_cell(ROOT, "no-such.cell")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "no-such.cell",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == "" and "unknown workload" in out.stderr


def test_contract_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.fullmatch(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(1 <= len(c[k]) <= 200 and "\n" not in c[k] for k in ("source", "why"))
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", CELLS)]
        assert len(mine) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_is_a_file_found_by_name(cell):
    bench, entry, cell_file, config = harness.find_cell(ROOT, cell)
    assert (ROOT / "portbench" / "kinds" / f"{cell_file['kind']}.py").is_file()
    assert (ROOT / "portbench" / "families" / f"{config['family']}.py").is_file()
    for trace in (False, True):
        for m in harness.metrics_of(bench, cell, trace):
            assert callable(harness.reader(ROOT, m["name"]))


def test_a_new_cell_needs_new_files_only(tmp_path):
    """A cell of another size, added as a configuration file, a cell file and
    BENCHMARK.json entries, runs with every existing file as it is."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    conf = json.loads((ROOT / "portbench/configs/dense-768x1536.json").read_text())
    conf.update(name="dense-24x48", rows=24, cols=48)
    (tmp_path / "portbench/configs/dense-24x48.json").write_text(json.dumps(conf))
    cell = json.loads((ROOT / "portbench/cells/dense-768x1536.dual-resolve.json").read_text())
    cell.update(config="dense-24x48")
    cell["traffic"].update(bounds=4, cycle=3)
    (tmp_path / "portbench/cells/dense-24x48.dual-resolve.json").write_text(json.dumps(cell))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({**bench["configs"][0], "name": "dense-24x48",
                             "file": "portbench/configs/dense-24x48.json"})
    bench["workloads"].append({**bench["workloads"][0], "name": "dense-24x48.dual-resolve",
                               "config": "dense-24x48"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dense-768x1536.dual-resolve" in m.get("workloads", []):
            m["workloads"].append("dense-24x48.dual-resolve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = harness.run("dense-24x48.dual-resolve", 5, 0.2, False, "cpu",
                            time.perf_counter(), root=tmp_path)
    assert result["correct"] and set(result["metrics"]) == {"resolve_s", "setup_s"}
    after = {p: (tmp_path / p).read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_the_cpu(cell):
    result, compared = run_small(cell, trace=True)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared" and set(compared) == set(harness.MEASURES)
    assert result["device"]["platform"] == "cpu"
    assert all(isinstance(v["value"], float) for v in result["metrics"].values())
