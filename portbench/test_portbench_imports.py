"""Nothing the benchmark runs loads the JAX stack (top-level names
compared whole: the program's ``repro_torch`` begins with ``repro``), and
the reference, its plain tiler of band files with it, loads nothing of the
program."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}

RUN_A_CELL = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from portbench import run
cfg = json.load(open({cfg!r}))
cfg.update(scene_hw=[100, 90], tile=32, max_keypoints_per_tile=16)
traffic = json.load(open({traffic!r}))
traffic.update(pool_scenes=1, check_slots=1, trace_scenes=1)
bench = json.load(open({bench!r}))
e2e, per_layer = run.cell_metrics(bench, "paper-t512.all7")
for kind in ("resident", "band_files"):
    cfg["input"] = kind
    entry = run.program_entry(cfg, traffic["algorithms"])
    for trace in (False, True):
        out, _ = run.measure(cfg, traffic, 7, 0.01, trace, "cpu", entry,
                             e2e, per_layer, scenes_dir={scenes!r})
        assert out["correct"], out
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}]
import torch
from portbench import scenes
from portbench.reference import difet
cfg = json.load(open({cfg!r}))
cfg.update(scene_hw=[100, 90], tile=32, max_keypoints_per_tile=16)
from portbench.reference import bands
g = scenes.generator(3, "cpu")
gray = scenes.synthetic_scene(100, 90, g)
t, h = scenes.tile_scene(gray, 32, 24)
d = scenes.write_bands({scenes!r}, "s", scenes.band_scene(gray).numpy())
bt, bh = (torch.from_numpy(x) for x in bands.tile_scene(d, 32, 24))
for tiles, headers in ((t, h), (bt, bh)):
    difet.extract(tiles, headers, ("harris", "shi_tomasi", "sift", "surf",
                                   "fast", "brief", "orb"), cfg)
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-4000:]
    return {m.split(".")[0] for m in json.loads(r.stdout.splitlines()[-1])}


def test_a_run_of_the_harness_loads_no_jax(tmp_path):
    """Both inputs, resident and band files, untraced and traced."""
    top = _modules(RUN_A_CELL.format(
        src=str(ROOT / "src"), root=str(ROOT), scenes=str(tmp_path / "s"),
        cfg=str(ROOT / "portbench/configs/difet-paper-t512.json"),
        traffic=str(ROOT / "portbench/traffic/all7.json"),
        bench=str(ROOT / "BENCHMARK.json")))
    assert "repro_torch" in top and "portbench" in top
    assert not top & BANNED, top & BANNED


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    """The reference and its plain tiler of band files."""
    top = _modules(REFERENCE_ONLY.format(
        root=str(ROOT), scenes=str(tmp_path),
        cfg=str(ROOT / "portbench/configs/difet-paper-t512.json")))
    assert "portbench" in top and "torch" in top
    assert not top & (BANNED | {"repro_torch"}), top & (BANNED
                                                        | {"repro_torch"})


def test_the_harness_guard_compares_whole_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert run.banned_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & BANNED)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in run.banned_modules()
