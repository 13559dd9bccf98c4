"""Cells, traffic mixes, loop kinds and metrics are found by name from
BENCHMARK.json; a new one is new files and entries, with no file edited."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def test_benchmark_names_resolve(bench):
    from rpbench.harness import spec
    b = spec.load_benchmark()
    assert [w["name"] for w in b["workloads"]] == [
        "adult-3way.release", "synth-10x100-3way.release"]
    for w in b["workloads"]:
        cell = spec.load_cell(b, w["name"])
        assert cell.chips == 1
        assert cell.traffic["loop"] == "release_loop"
        assert spec.load_module("loops", cell.traffic["loop"]).run
        assert {m["name"] for m in cell.end_to_end} == {
            "setup_s", "release_cells_per_s", "peak_device_gib"}
        assert len(cell.per_layer) == 7
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
        assert cell.config["reduced"] == []
        assert set(cell.config["check"]["limits"]) == {
            "sigma2_rel", "omega_rel", "table_rel"}


def test_every_traffic_file_names_a_loop(bench):
    from rpbench.harness import spec
    for path in sorted((ROOT / "rpbench" / "traffic").glob("*.json")):
        tr = json.loads(path.read_text())
        assert callable(spec.load_module("loops", tr["loop"]).setup), path


def test_config_entries_match_their_files(bench):
    from rpbench.harness import spec
    b = spec.load_benchmark()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_unknown_names_raise(bench):
    from rpbench.harness import spec
    with pytest.raises(KeyError):
        spec.load_cell(spec.load_benchmark(), "no-such.cell")
    with pytest.raises(FileNotFoundError):
        spec.load_module("metrics", "no_such_metric")


def test_a_new_cell_is_files_and_entries_only(bench, tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix and a metric
    as new files with their entries, and run the new cell on the CPU: the
    new metric is in the result, and no file that was there changed."""
    from rpbench.harness import spec
    shutil.copytree(ROOT / "rpbench", tmp_path / "rpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}

    cfg = json.loads((ROOT / "rpbench/tests/data/tiny-3way.json").read_text())
    cfg.update(name="fake-2way", workload={"k": 2, "include_lower": True})
    (tmp_path / "rpbench/configs/fake-2way.json").write_text(json.dumps(cfg))
    (tmp_path / "rpbench/traffic/fake_mix.json").write_text(
        json.dumps({"loop": "release_loop", "tenants": 1}))
    (tmp_path / "rpbench/metrics/fake_count.release.py").write_text(
        "def read(obs):\n    return float(len(obs.releases))\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "fake-2way", "source": "test",
                         "file": "rpbench/configs/fake-2way.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "fake-2way.fake_mix", "config": "fake-2way",
                           "traffic": "fake_mix", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "fake_count.release", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine entry", "moves": "release_cells_per_s",
                           "workloads": ["fake-2way.fake_mix"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and m["name"] != "fake_count.release":
            m["workloads"].append("fake-2way.fake_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell(spec.load_benchmark(tmp_path), "fake-2way.fake_mix",
                          tmp_path)
    res, _ = bench.run_cell(cell, 2 ** 40 + 3, 0.3, True, device="cpu",
                            log=lambda m: None, root=tmp_path)
    assert res["correct"]
    # a traced run reads host-clock metrics over the window's first half
    assert 1 <= res["metrics"]["fake_count.release"]["value"] < res["attempted"]
    changed = [p for p, data in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != data]
    assert not changed
