"""The plain reference against the program's plain route, and the
benchmark's scenes and tiler against the program's tiler, on the CPU."""
import numpy as np
import pytest
import torch

from portbench import scenes
from portbench.reference import difet as reference
from portbench.run import difet_config

ALL7 = ("harris", "shi_tomasi", "sift", "surf", "fast", "brief", "orb")
SEED = 2 ** 31 + 97          # past 32 signed bits, as the driver's seeds


def _scene(cfg, seed=SEED):
    gray = scenes.synthetic_scene(*cfg["scene_hw"],
                                  scenes.generator(seed, "cpu"))
    return scenes.tile_scene(gray, cfg["tile"], cfg["halo"])


@pytest.mark.parametrize("route", ["plain", "kernel_twins"])
def test_reference_equals_program_field_by_field(tiny_cfg, route):
    from repro_torch.core import engine
    tiles, headers = _scene(tiny_cfg)
    want = reference.extract(tiles, headers, ALL7, tiny_cfg, block=4)
    got = engine.extract_features_multi(
        tiles, headers, ALL7, difet_config(tiny_cfg),
        use_kernels=route == "kernel_twins", device="cpu")
    for alg in ALL7:
        assert set(got[alg]) == set(want[alg]), alg
        for key, v in want[alg].items():
            assert got[alg][key].dtype == v.dtype, (alg, key)
            assert torch.equal(got[alg][key], v), (alg, key)
        assert int(want[alg]["total_count"]) > 0, alg


def test_reference_blocks_do_not_change_the_result(tiny_cfg):
    tiles, headers = _scene(tiny_cfg)
    one = reference.extract(tiles, headers, ALL7, tiny_cfg, block=64)
    three = reference.extract(tiles, headers, ALL7, tiny_cfg, block=3)
    for alg in ALL7:
        for key, v in one[alg].items():
            assert torch.equal(three[alg][key], v), (alg, key)


@pytest.mark.parametrize("hw,tile", [((150, 170), 64), ((97, 64), 32),
                                     ((20, 33), 64)])
def test_tiler_equals_the_programs(hw, tile):
    from repro_torch.configs.difet_paper import DifetConfig
    from repro_torch.core.bundle import tile_scene
    gray = scenes.synthetic_scene(*hw, scenes.generator(3, "cpu"))
    tiles, headers = scenes.tile_scene(gray, tile, 24)
    bundle = tile_scene(gray.numpy(), DifetConfig(tile=tile, halo=24))
    np.testing.assert_array_equal(tiles.numpy(), bundle.tiles)
    np.testing.assert_array_equal(headers.numpy(), bundle.headers)


def test_scene_is_fixed_by_its_seed():
    a = scenes.synthetic_scene(300, 260, scenes.generator(SEED, "cpu"))
    b = scenes.synthetic_scene(300, 260, scenes.generator(SEED, "cpu"))
    c = scenes.synthetic_scene(300, 260, scenes.generator(SEED + 1, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and a.min() >= 0 and a.max() <= 1
    # the structure of a LandSat-like band: mid-grey terrain, fields
    assert 0.15 < float(a.mean()) < 0.35 and float(a.std()) > 0.1
