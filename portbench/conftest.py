"""Fixtures of the benchmark's CPU tests: a configuration and a traffic
mix cut to a few small tiles, with the cells' own detector settings."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture(autouse=True)
def _few_threads():
    """The benchmark runs its host side on few threads; so do its tests,
    beside the other test workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cfg():
    """The paper configuration on a 150 x 170 scene: 3 x 3 tiles of 64
    (halo 24, 112^2), K 32."""
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "difet-paper-t512.json").read_text())
    cfg.update(scene_hw=[150, 170], tile=64, max_keypoints_per_tile=32)
    return cfg


@pytest.fixture
def tiny_traffic():
    """The seven-algorithm mix over a pool of 2 scenes, both checked."""
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / "all7.json").read_text())
    traffic.update(pool_scenes=2, check_slots=2, trace_scenes=2)
    return traffic
