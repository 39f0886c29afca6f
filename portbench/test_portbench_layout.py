"""``BENCHMARK.json`` keeps to the benchmark's contract, and a new
configuration (its scenes resident or in band files, the program's entry
named or not), traffic mix, per-layer metric or kernel's work count is a
new file under ``portbench/`` that the harness finds by its name, with no
edit to any file that is there."""
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_benchmark_file_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file() and len(c["why"]) <= 200
    names = [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4), four
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] == "host_clock" and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        run.reader(m["name"])                    # every metric has a reader
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        e, p = run.cell_metrics(BENCH, cell)
        assert {"setup_s"} < {m["name"] for m in e} and p


def test_a_new_cell_and_metric_are_new_files_only(tmp_path, tiny_cfg):
    """Copy the benchmark, add a configuration, a traffic mix, a metric and
    a kernel's work count as new files, and the harness finds and reads
    them; every file that was there is unchanged."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    (tmp_path / "portbench/configs/difet-small.json").write_text(
        json.dumps(tiny_cfg))
    (tmp_path / "portbench/traffic/corners.json").write_text(json.dumps(
        {"kind": "closed_loop", "clients": 1, "pool_scenes": 1,
         "check_slots": 1, "trace_scenes": 1,
         "algorithms": ["harris", "shi_tomasi", "fast"]}))
    (tmp_path / "portbench/metrics/host_events_per_scene.py").write_text(
        "def read(trace):\n    return len(trace.host) / trace.scenes\n")
    (tmp_path / "portbench/work/matcher.py").write_text(
        "WRAPPER = 'match_best2'\nDEVICE_NAMES = ('difet_match',)\n\n\n"
        "def work(shape, db, *args, **kwargs):\n"
        "    n, d = shape\n    m = db.shape[0]\n"
        "    return 3 * n * m * d, 4 * (n + m) * d\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "difet-small", "source": "x",
                             "file": "portbench/configs/difet-small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "small.corners",
                               "config": "difet-small",
                               "traffic": "corners", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "host_events_per_scene",
                               "unit": "events", "better": "lower",
                               "source": "program_span", "layer": "x",
                               "moves": "scene_s",
                               "workloads": ["small.corners"]})
    bench["per_layer"].append({"name": "matcher_roofline", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "hand kernels", "moves": "scene_s",
                               "workloads": ["small.corners"]})
    cell, cfg, traffic = run.cell_spec(bench, "small.corners", tmp_path)
    assert cfg["tile"] == 64 and traffic["algorithms"][-1] == "fast"
    e2e, per_layer = run.cell_metrics(bench, "small.corners")
    assert [m["name"] for m in per_layer] == ["host_events_per_scene",
                                              "matcher_roofline"]
    entry = run.program_entry(cfg, traffic["algorithms"])
    out, _ = run.measure(cfg, traffic, 3, 0.01, True, "cpu", entry, e2e,
                         per_layer, root=tmp_path)
    assert out["correct"] and out["metrics"]["host_events_per_scene"][
        "value"] > 0
    # the new kernel's work is found by its name; a cell that never calls
    # it leaves its roofline out of the line
    assert out["trace"].modules["matcher"].WRAPPER == "match_best2"
    assert out["trace"].calls["matcher"] == []
    assert "matcher_roofline" not in out["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


STUB_FACTORY = '''
from portbench import run


def factory(algorithms, cfg, mesh):
    return run.band_entry(algorithms, cfg, mesh)
'''


@pytest.mark.parametrize("extra", [{"input": "band_files"},
                                   {"input": "band_files",
                                    "entry": "stub_factory:factory"}])
def test_a_band_or_entry_configuration_is_new_files_only(
        tmp_path, tiny_cfg, monkeypatch, extra):
    """A configuration that keeps its scenes as band files, or names the
    program's entry (here a stub factory beside the checkout), and a
    traffic mix are new files: the harness finds them, runs the cell and
    checks it; every file that was there is unchanged."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    (tmp_path / "stubs").mkdir()
    (tmp_path / "stubs/stub_factory.py").write_text(STUB_FACTORY)
    monkeypatch.syspath_prepend(str(tmp_path / "stubs"))
    (tmp_path / "portbench/configs/difet-bands.json").write_text(
        json.dumps(dict(tiny_cfg, scene_hw=[131, 77], **extra)))
    (tmp_path / "portbench/traffic/corners.json").write_text(json.dumps(
        {"kind": "closed_loop", "clients": 1, "pool_scenes": 2,
         "check_slots": 1, "trace_scenes": 1,
         "algorithms": ["harris", "shi_tomasi", "fast"]}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "difet-bands", "source": "x",
                             "file": "portbench/configs/difet-bands.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "bands.corners",
                               "config": "difet-bands",
                               "traffic": "corners", "chips": 1, "why": "x"})
    cell, cfg, traffic = run.cell_spec(bench, "bands.corners", tmp_path)
    assert run.input_kind(cfg) == "band_files"
    e2e, _ = run.cell_metrics(bench, "bands.corners")
    entry = run.program_entry(cfg, traffic["algorithms"])
    out, _ = run.measure(cfg, traffic, 2 ** 35 + 1, 0.01, False, "cpu",
                         entry, e2e, root=tmp_path, name="bands.corners")
    assert out["correct"] and out["compared_scenes"] >= 1
    assert {m for m in out["metrics"]} == {"scene_s", "scene_p90_s",
                                           "setup_s"}
    assert not any((tmp_path / "build/portbench/scenes").iterdir())
    for p, data in before.items():
        assert p.read_bytes() == data, p


@pytest.mark.parametrize("name,family", [("blur_roofline", "roofline"),
                                         ("torch_ops_ms", "torch_ops_ms")])
def test_metric_names_find_their_readers(name, family):
    assert callable(run.reader(name))
    assert (ROOT / "portbench" / "metrics" / f"{family}.py").is_file()


def test_a_per_layer_metric_names_its_cells():
    bench = json.loads(json.dumps(BENCH))
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(SystemExit, match="lists no workloads"):
        run.cell_metrics(bench, "paper-t512.all7")
