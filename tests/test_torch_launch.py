"""The port's extraction driver and scaling sweep
(``repro_torch.launch.{extract,scale}``) against the JAX package's, end to
end on the CPU: the same stores, bit for bit; a killed driver run that
resumes to the reference's totals; the sweep at the reference's
``--smoke`` size with parity at every worker count and the reference's
counts; and both CLIs defaulting to the card (they raise on a host without
CUDA instead of running on the CPU).
"""
import os

import numpy as np
import pytest
import torch

from repro.configs.difet_paper import DifetConfig as JaxConfig
from repro.launch import extract as jextract
from repro.launch import scale as jscale
from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core import bundle
from repro_torch.launch import extract, scale

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GEOM = dict(tile=64, halo=24, max_keypoints_per_tile=256)
SMOKE = dict(tile=64, halo=16, max_keypoints_per_tile=128)
DRIVER = ["--scenes", "2", "--scene-size", "128", "--tile", "64",
          "--algorithms", "harris,fast"]


def _stored(store):
    """{bundle: (tiles, headers, cfg)} of a store written by either
    package (the same npz layout)."""
    out = {}
    for name in store.list():
        z = np.load(store.root / f"{name}.npz", allow_pickle=False)
        out[name] = (z["tiles"], z["headers"], str(z["cfg"]))
    return out


@pytest.mark.parametrize("stream", [False, True])
def test_build_store_equals_reference(tmp_path, stream):
    """Both modes (in-memory scenes; band files streamed in 3-tile
    batches, the last one padded) give the reference's bundles bit for
    bit, and a second call reopens the store."""
    kw = dict(stream=stream, batch_tiles=3)
    got = extract.build_store(tmp_path / "port", 2, (100, 90),
                              DifetConfig(**GEOM), **kw)
    want = jextract.build_store(tmp_path / "ref", 2, (100, 90),
                                JaxConfig(**GEOM), **kw)
    got_b, want_b = _stored(got), _stored(want)
    assert list(got_b) == list(want_b)
    assert len(got_b) == (3 if stream else 2)
    for name, (tiles, headers, cfg) in got_b.items():
        np.testing.assert_array_equal(tiles, want_b[name][0])
        np.testing.assert_array_equal(headers, want_b[name][1])
        assert tiles.dtype == np.float32 and headers.dtype == np.int32
        assert cfg == want_b[name][2]
    if stream:
        scenes = sorted(p.name for p in (tmp_path / "port" / "scenes")
                        .iterdir())
        assert scenes == ["scene_0000", "scene_0001"]
    again = extract.build_store(tmp_path / "port", 5, (10, 10),
                                DifetConfig(**GEOM), **kw)
    assert again.list() == got.list()


def test_extract_main_resumes_to_the_reference_totals(tmp_path):
    """Killed after one bundle (exit 2), the same command resumes; its
    stored results equal an uninterrupted run's bit for bit, and the
    per-algorithm totals equal the reference driver's on the same
    arguments."""
    killed = DRIVER + ["--device", "cpu", "--store", str(tmp_path / "k")]
    with pytest.raises(SystemExit) as e:
        extract.main(killed + ["--fail-after", "1"])
    assert e.value.code == 2
    resumed = extract.main(killed)
    assert resumed["bundles_done"] == resumed["bundles_total"] == 2
    once = extract.main(DRIVER + ["--device", "cpu", "--store",
                                  str(tmp_path / "o")])
    want = jextract.main(DRIVER + ["--store", str(tmp_path / "ref")])
    for alg in ("harris", "fast"):
        totals = {s["per_algorithm"][alg]["grand_total"]
                  for s in (resumed, once, want)}
        assert len(totals) == 1 and totals.pop() > 0, alg
        assert resumed["per_algorithm"][alg]["counts"] == \
            want["per_algorithm"][alg]["counts"]
    assert resumed["grand_total"] == once["grand_total"] == \
        want["grand_total"]
    stores = [bundle.BundleStore(tmp_path / n) for n in ("k", "o")]
    for name in stores[0].list():
        for alg in ("harris", "fast"):
            a, b = (s.get_result(f"{name}.{alg}") for s in stores)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_extract_main_rejects_unknown_algorithms(tmp_path):
    with pytest.raises(SystemExit) as e:
        extract.main(["--algorithms", "harris,bogus", "--device", "cpu",
                      "--store", str(tmp_path / "s")])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        extract.main(["--device", "cpu"])          # --store is required
    assert e.value.code == 2


def _smoke_readers(tmp_path, module):
    return module.build_scene_set(tmp_path / "scenes", 2, (160, 160))


def test_run_scaling_matches_reference(tmp_path):
    """The reference's --smoke sweep (2 scenes of 160^2, tile 64, halo 16,
    batches of 4, workers 1 and 2, harris and fast) on the CPU: parity at
    every worker count, and the totals and per-batch counts equal the
    reference's."""
    readers = _smoke_readers(tmp_path, scale)
    assert [r.name for r in readers] == ["scene_0000", "scene_0001"]
    jreaders = _smoke_readers(tmp_path, jscale)     # reopens the same set
    cfg, jcfg = DifetConfig(**SMOKE), JaxConfig(**SMOKE)
    rows = scale.run_scaling(readers, cfg, "harris,fast", (1, 2),
                             batch_tiles=4, device="cpu")
    want = jscale.run_scaling(jreaders, jcfg, "harris,fast", (1, 2),
                              batch_tiles=4)
    assert [r["algorithm"] for r in rows] == ["harris", "fast"]
    for row, ref in zip(rows, want):
        assert row["parity"] and ref["parity"]
        assert row["n_batches"] == ref["n_batches"] == 5
        assert row["total_count"] == ref["total_count"] > 0
        assert sorted(row["t"]) == [1, 2]
        assert row["speedup"][1] == row["efficiency"][1] == 1.0
        alg = row["algorithm"]
        fn = jscale.make_batch_extractor((alg,), jcfg)
        res, _ = jscale.run_worker(jreaders, jcfg, 4, fn, 0, 5)
        assert row["batch_counts"] == \
            [int(res[i][alg]["total_count"]) for i in range(5)]
        assert sum(row["batch_counts"]) == row["total_count"]


def test_run_worker_returns_host_results(tmp_path):
    """A worker's slice comes back as numpy arrays keyed by batch index,
    equal to the same slice of the whole run."""
    readers = _smoke_readers(tmp_path, scale)
    cfg = DifetConfig(**SMOKE)
    fn = scale.make_batch_extractor(("harris",), cfg, device="cpu")
    whole, _ = scale.run_worker(readers, cfg, 4, fn, 0, 5, device="cpu")
    part, wall = scale.run_worker(readers, cfg, 4, fn, 2, 4, device="cpu")
    assert sorted(part) == [2, 3] and wall > 0
    assert scale._results_equal(part, {i: whole[i] for i in (2, 3)})
    assert not scale._results_equal(part, {i: whole[i] for i in (1, 2)})
    for v in part[2]["harris"].values():
        assert isinstance(v, np.ndarray)


def test_run_scaling_refuses_too_few_batches(tmp_path):
    readers = _smoke_readers(tmp_path, scale)
    with pytest.raises(ValueError, match="cannot occupy"):
        scale.run_scaling(readers, DifetConfig(**SMOKE), "harris", (1, 8),
                          batch_tiles=4, device="cpu")


def test_scale_main_smoke_returns_its_rows(tmp_path, capsys):
    rows = scale.main(["--smoke", "--device", "cpu", "--store",
                       str(tmp_path / "s"), "--json",
                       str(tmp_path / "rows.json")])
    assert [r["algorithm"] for r in rows] == ["harris", "fast"]
    assert all(r["parity"] and r["total_count"] > 0 for r in rows)
    assert (tmp_path / "rows.json").exists()
    assert "smoke OK" in capsys.readouterr().out


@pytest.mark.parametrize("cli", ["extract", "scale"])
def test_clis_default_to_the_card(tmp_path, cli):
    """Without --device both CLIs run on the card: on a host without CUDA
    they raise rather than fall back to the CPU, before writing a scene."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    store = tmp_path / "s"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if cli == "extract":
            extract.main(DRIVER + ["--store", str(store)])
        else:
            scale.main(["--smoke", "--store", str(store)])
    assert not store.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scale.make_batch_extractor(("harris",), DifetConfig(**SMOKE))
