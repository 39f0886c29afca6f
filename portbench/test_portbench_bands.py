"""A configuration whose scenes live on disk as band files
(``"input": "band_files"``), and one that names the program's entry
(``"entry"``): the band files in the program's layout, the plain tiler
against the program's streamed tiles, the band route through
`run.measure` (one entry and a mesh of four), a run with the timed path
broken, ``control.py``'s readings, a configured entry, and an entry that
the program lacks.
~30 s in one process."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import run, scenes
from portbench.reference import bands

ROOT = run.ROOT


@pytest.fixture
def band_cfg(tiny_cfg):
    """The tiny paper configuration at an odd scene size, from band
    files: 3 x 3 tiles of 64, the last row and column partial."""
    return dict(tiny_cfg, scene_hw=[149, 171], input="band_files")


def _levels(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (3, h, w),
                                                dtype=np.uint8)


def test_the_band_files_are_the_programs_layout(tmp_path):
    """`scenes.write_bands` writes byte for byte what the program's
    ``write_scene_bands`` writes for the same RGBA scene."""
    from repro_torch.data.landsat import write_scene_bands
    levels = _levels(37, 53, 1)
    ours = scenes.write_bands(tmp_path / "a", "s", levels)
    rgba = np.concatenate([levels, np.full((1, 37, 53), 255, np.uint8)])
    theirs = write_scene_bands(tmp_path / "b", "s",
                               np.moveaxis(rgba, 0, -1))
    names = sorted(p.name for p in ours.iterdir())
    assert names == ["B2.npy", "B3.npy", "B4.npy", "scene.json"]
    assert names == sorted(p.name for p in theirs.iterdir())
    for n in names:
        assert (ours / n).read_bytes() == (theirs / n).read_bytes(), n


def test_the_bands_are_drawn_from_the_seed():
    def draw(seed):
        gen = scenes.generator(seed, "cpu")
        return scenes.band_scene(scenes.synthetic_scene(40, 50, gen))
    a = draw(2 ** 40 + 3)
    assert a.dtype == torch.uint8 and a.shape == (3, 40, 50)
    assert torch.equal(a, draw(2 ** 40 + 3))
    assert not torch.equal(a, draw(2 ** 40 + 4))
    assert (a[0] >= a[1]).all() and (a[1] >= a[2]).all()


@pytest.mark.parametrize("h,w,tile", [
    (149, 171, 64),     # odd h and w: a partial last tile row and column
    (40, 90, 64),       # h < tile: one tile row, reflected past the scene
    (130, 64, 64),      # a last tile row of 2 rows
    (7, 5, 16),         # a scene smaller than the halo in both axes
])
def test_the_plain_tiler_equals_the_programs_streamed_tiles(
        tmp_path, tiny_cfg, h, w, tile):
    """Bit for bit: the plain tiler, the program's ``BandSceneReader`` +
    ``iter_tile_batches`` (one scene a batch, the scene id its place in
    the job), and `scenes.tile_scene` on the same gray image."""
    from repro_torch.data.landsat import BandSceneReader
    from repro_torch.data.pipeline import iter_tile_batches, scene_tile_count
    cfg = dict(tiny_cfg, scene_hw=[h, w], tile=tile)
    d = scenes.write_bands(tmp_path, "s", _levels(h, w, h * w))
    dc = run.difet_config(cfg)
    reader = BandSceneReader(d)
    n = scene_tile_count(reader.shape, dc)
    got = list(iter_tile_batches([reader, reader], dc, n))
    assert [i for i, _ in got] == [0, 1]
    gray = bands.read_gray(d)
    assert gray.dtype == np.float32
    assert np.array_equal(gray.view(np.uint32), np.concatenate(
        list(reader.stripes(7))).view(np.uint32))
    resident = [x.numpy() for x in scenes.tile_scene(
        torch.from_numpy(gray), tile, cfg["halo"], 1)]
    for sid, (_, bundle) in enumerate(got):
        tiles, headers = bands.tile_scene(d, tile, cfg["halo"], sid)
        assert tiles.shape == (n, tile + 2 * cfg["halo"],
                               tile + 2 * cfg["halo"])
        assert tiles.tobytes() == np.asarray(bundle.tiles).tobytes()
        assert np.array_equal(headers, np.asarray(bundle.headers))
    assert tiles.tobytes() == resident[0].tobytes()
    assert np.array_equal(headers, resident[1])


@pytest.mark.parametrize("trace", [False, True])
def test_the_band_route_runs_end_to_end(tmp_path, band_cfg, tiny_traffic,
                                        trace):
    """Through `run.measure`: the pool written, every landed scene kept
    and compared with the reference on the plain tiler's tiles, correct,
    and the files removed."""
    bench = run.load_json(ROOT / "BENCHMARK.json")
    e2e, per_layer = run.cell_metrics(bench, "paper-t512.all7")
    entry = run.program_entry(band_cfg, tiny_traffic["algorithms"])
    where = tmp_path / "scenes"
    out, values = run.measure(band_cfg, tiny_traffic, 2 ** 40 + 9, 0.05,
                              trace, "cpu", entry, e2e, per_layer,
                              scenes_dir=where)
    assert out["correct"], values
    landed = out["attempted"] + (1 if trace else 0)   # a traced job's fill
    assert out["attempted"] >= 2 and out["compared_scenes"] == landed
    if not trace:
        assert {"scene_s", "scene_p90_s", "setup_s"} <= set(out["metrics"])
        assert out["metrics"]["scene_p90_s"]["value"] > 0
    assert not where.exists()


def test_the_band_route_over_a_mesh_of_four(tmp_path, band_cfg,
                                            tiny_traffic):
    """The prefetcher stages each batch's rows on the mesh's entries and
    the distributed extractor serves them: correct, as on one entry."""
    from repro_torch.distributed.sharding import Mesh
    mesh = Mesh(["cpu"] * 4)
    entry = run.program_entry(band_cfg, tiny_traffic["algorithms"], mesh)
    out, values = run.measure(band_cfg, tiny_traffic, 17, 0.05, False, "cpu",
                              entry, mesh=mesh, scenes_dir=tmp_path / "s")
    assert out["correct"] and out["compared_scenes"] >= 2, values


def _tile_row_left_out(monkeypatch):
    """The program's extractor leaves out each batch's last tile row."""
    from repro_torch.core import engine
    real = engine.extract_features_multi

    def broken(tiles, headers, *args, **kwargs):
        keep = headers[:, 1] < headers[:, 1].max()
        return real(tiles[keep], headers[keep], *args, **kwargs)
    monkeypatch.setattr(engine, "extract_features_multi", broken)


def _altered_answer(monkeypatch):
    from repro_torch.core import engine
    real = engine.extract_features_multi

    def broken(*args, **kwargs):
        res = real(*args, **kwargs)
        res["harris"]["top_xs"] = res["harris"]["top_xs"].clone()
        res["harris"]["top_xs"][-1] += 1
        return res
    monkeypatch.setattr(engine, "extract_features_multi", broken)


def _stale(monkeypatch):
    from repro_torch.core import engine
    real, first = engine.extract_features_multi, {}

    def broken(*args, **kwargs):
        if not first:
            first.update(real(*args, **kwargs))
        return first
    monkeypatch.setattr(engine, "extract_features_multi", broken)


@pytest.mark.parametrize("fault", [_tile_row_left_out, _altered_answer,
                                   _stale])
def test_a_band_run_with_the_timed_path_broken_is_not_correct(
        tmp_path, band_cfg, tiny_traffic, monkeypatch, fault):
    fault(monkeypatch)
    entry = run.program_entry(band_cfg, tiny_traffic["algorithms"])
    out, values = run.measure(band_cfg, tiny_traffic, 2 ** 31 + 3, 0.05,
                              False, "cpu", entry,
                              scenes_dir=tmp_path / "s")
    assert out["attempted"] >= 2 and out["compared_scenes"] >= 2
    assert out["correct"] is False, values


@pytest.mark.parametrize("fault", [None, "bfloat16", "tile row"])
def test_the_control_readings_of_a_band_cell(tmp_path, band_cfg,
                                             tiny_traffic, monkeypatch,
                                             fault):
    """``control.py``'s readings of a band cell: the program within every
    limit; the control (the reference in bfloat16 in its place), and the
    program with a tile row left out, over them."""
    from portbench import compare, control
    if fault == "tile row":
        _tile_row_left_out(monkeypatch)
    entry = run.program_entry(band_cfg, tiny_traffic["algorithms"])
    line = control.readings(band_cfg, tiny_traffic, 2 ** 31 + 9, entry,
                            "cpu", control=fault == "bfloat16",
                            where=tmp_path / "s")
    assert compare.verdict(line["program"]) is (fault != "tile row"), line
    if fault == "tile row":
        assert line["program"]["counts_off"] > 0
    if fault == "bfloat16":
        assert not line["control_correct"]
        assert line["control"]["counts_off"] > 0
    assert not (tmp_path / "s").exists()


STUB = '''
from portbench import run

CALLS = []


def factory(algorithms, cfg, mesh):
    """Today's entry, counted."""
    inner = (run.band_entry if {band!r} else run.extractor)(
        algorithms, cfg, mesh)

    def entry(*args):
        CALLS.append(len(args))
        return inner(*args)
    return entry
'''


@pytest.mark.parametrize("band", [False, True])
def test_a_configured_entry_is_the_one_that_runs(tmp_path, tiny_cfg,
                                                 tiny_traffic, monkeypatch,
                                                 band):
    """``"entry": "module:function"`` is imported and called as
    ``factory(algorithms, DifetConfig, mesh)``; its ``run`` takes the
    tiles and headers, or for band files the job's directories."""
    (tmp_path / "stub_entry_mod.py").write_text(STUB.format(band=band))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "stub_entry_mod", raising=False)
    cfg = dict(tiny_cfg, entry="stub_entry_mod:factory")
    if band:
        cfg["input"] = "band_files"
    entry = run.program_entry(cfg, tiny_traffic["algorithms"])
    out, values = run.measure(cfg, tiny_traffic, 23, 0.05, False, "cpu",
                              entry, scenes_dir=tmp_path / "s")
    assert out["correct"], values
    calls = sys.modules["stub_entry_mod"].CALLS
    # resident: the warm scene and each scene of the window; band files:
    # the warm job and the window's job, one directory list each
    assert calls == ([1, 1] if band else [2] * (out["attempted"] + 1))


def _checkout(tmp_path, entry):
    """A checkout with one cell whose configuration names ``entry``."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    cfg = json.loads((ROOT / "portbench/configs/difet-paper-t512.json")
                     .read_text())
    (tmp_path / "portbench/configs/x.json").write_text(
        json.dumps(dict(cfg, entry=entry)))
    bench = run.load_json(ROOT / "BENCHMARK.json")
    bench["configs"] = [{"name": "x", "source": "x", "reduced": [],
                         "file": "portbench/configs/x.json", "why": "x"}]
    bench["workloads"] = [{"name": "x.all7", "config": "x", "chips": 1,
                           "traffic": "all7", "why": "x"}]
    for m in bench["per_layer"]:
        m["workloads"] = ["x.all7"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("entry", ["repro_torch.launch.scale:no_such_entry",
                                   "no_such_module_of_the_program:factory",
                                   "repro_torch.launch.scale"])
def test_an_entry_the_program_lacks_ends_the_run_at_once(tmp_path, entry):
    """Non-zero, no result, one line that names the entry, before any
    scene (and before the look for a card)."""
    _checkout(tmp_path, entry)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "x.all7", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                            "HOME": str(tmp_path)})
    seconds = time.perf_counter() - t0
    assert r.returncode not in (0, 3), r.stderr[-2000:]
    assert r.stdout == ""
    last = r.stderr.strip().splitlines()[-1]
    assert entry in last and "no entry" in last, r.stderr[-2000:]
    assert seconds < 120
    assert not (tmp_path / "build" / "portbench" / "scenes").exists()


def test_an_unknown_input_is_refused(tmp_path, tiny_cfg):
    (tmp_path / "portbench/configs").mkdir(parents=True)
    shutil.copytree(ROOT / "portbench/traffic", tmp_path / "portbench/traffic")
    (tmp_path / "portbench/configs/x.json").write_text(
        json.dumps(dict(tiny_cfg, input="tape")))
    bench = {"configs": [{"name": "x", "file": "portbench/configs/x.json"}],
             "workloads": [{"name": "x.all7", "config": "x",
                            "traffic": "all7", "chips": 1}]}
    with pytest.raises(SystemExit, match="input 'tape'"):
        run.cell_spec(bench, "x.all7", tmp_path)
