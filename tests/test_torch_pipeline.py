"""The port's streaming ingest (``repro_torch.data.{landsat,pipeline}``)
against the JAX package's, module by module on the CPU, at
``tests/test_pipeline.py``'s geometry (tile 64, halo 16, K 32).

The numpy parts are held bitwise: reflect indices, streamed tiles and
headers, band readers, the band files written (byte for byte), batches
whole and sliced.  The prefetcher keeps the reference's error and shutdown
contract, and stages onto the CPU when asked to (``device="cpu"``); it
never stages onto the CPU quietly.  Pipelined extraction with the port
equals the reference's jitted pipelined extraction per batch, with
``tests/test_torch_engine.py::assert_result_matches`` as the yardstick.
"""
import functools
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.difet_paper import DifetConfig as JaxConfig
from repro.core import engine as jengine
from repro.data import landsat as jlandsat
from repro.data import pipeline as jpipeline
from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core import bundle, engine
from repro_torch.core.bundle import TileBundle
from repro_torch.data import landsat, pipeline
from repro_torch.data.landsat import (ArraySceneReader, BandSceneReader,
                                      synthetic_scene, synthetic_scene_rgba,
                                      write_scene_bands)
from repro_torch.data.pipeline import (Prefetcher, StreamTiler,
                                       batch_slices, count_batches,
                                       iter_tile_batches, reflect_indices)
from test_torch_engine import assert_result_matches

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GEOM = dict(tile=64, halo=16, max_keypoints_per_tile=32)
CFG = DifetConfig(**GEOM)
JCFG = JaxConfig(**GEOM)


def stream_all(module, reader, cfg, scene_id=0, stripe_rows=None):
    pairs = list(module.iter_scene_tiles(reader, cfg, scene_id, stripe_rows))
    return (np.stack([t for t, _ in pairs]),
            np.asarray([h for _, h in pairs], np.int32))


def assert_batches_equal(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.tiles.dtype == w.tiles.dtype == np.float32
        assert g.headers.dtype == w.headers.dtype == np.int32
        np.testing.assert_array_equal(g.tiles, w.tiles)
        np.testing.assert_array_equal(g.headers, w.headers)


@pytest.mark.parametrize("n,before,after", [
    (7, 3, 5), (64, 16, 16), (5, 0, 7), (1, 2, 2), (3, 4, 4), (100, 16, 44)])
def test_reflect_indices_match_reference_and_np_pad(n, before, after):
    idx = reflect_indices(n, before, after)
    np.testing.assert_array_equal(
        idx, jpipeline.reflect_indices(n, before, after))
    x = np.random.RandomState(0).rand(n).astype(np.float32)
    np.testing.assert_array_equal(
        x[idx], np.pad(x, (before, after), mode="reflect"))


@pytest.mark.parametrize("hw", [(128, 128), (100, 120), (97, 131),
                                (64, 200), (30, 30), (65, 63)])
def test_stream_tiler_bitwise_to_reference_and_tile_scene(hw):
    """Even, odd and sub-tile scenes: the port's streamed tiles and headers
    equal the reference's streamed ones and the port's eager `tile_scene`."""
    gray = synthetic_scene(*hw, seed=3)
    tiles, headers = stream_all(pipeline, ArraySceneReader(gray), CFG, 5)
    jtiles, jheaders = stream_all(jpipeline, jlandsat.ArraySceneReader(gray),
                                  JCFG, 5)
    eager = bundle.tile_scene(gray, CFG, scene_id=5)
    for want_t, want_h in ((jtiles, jheaders), (eager.tiles, eager.headers)):
        np.testing.assert_array_equal(tiles, want_t)
        np.testing.assert_array_equal(headers, want_h)


@pytest.mark.parametrize("rows", [1, 7, 32, 500])
def test_stream_tiler_stripe_size_invariance(rows):
    gray = synthetic_scene(130, 94, seed=1)
    eager = bundle.tile_scene(gray, CFG)
    got = stream_all(pipeline, ArraySceneReader(gray), CFG, stripe_rows=rows)
    want = stream_all(jpipeline, jlandsat.ArraySceneReader(gray), JCFG,
                      stripe_rows=rows)
    for a, b, c in zip(got, want, (eager.tiles, eager.headers)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_stream_tiler_rejects_truncated_and_overrun_scenes():
    tiler = StreamTiler(100, 80, CFG)
    tiler.feed(np.zeros((60, 80), np.float32))
    with pytest.raises(ValueError, match="truncated"):
        tiler.finish()                          # 40 rows never arrived
    with pytest.raises(ValueError, match="overruns"):
        tiler.feed(np.zeros((50, 80), np.float32))
    with pytest.raises(ValueError, match="width"):
        tiler.feed(np.zeros((10, 79), np.float32))
    with pytest.raises(ValueError, match="empty"):
        StreamTiler(0, 80, CFG)


@pytest.mark.parametrize("kind", ["rgba", "gray", "gray_uint8"])
def test_band_reader_matches_reference(tmp_path, kind):
    """The same band files read through both packages' readers, whole and
    in stripes, equal each other and the eager `rgba_to_gray`."""
    rgba = synthetic_scene_rgba(90, 110, seed=2)
    image = {"rgba": rgba, "gray": synthetic_scene(90, 110, seed=2),
             "gray_uint8": rgba[..., 0]}[kind]
    d = write_scene_bands(tmp_path, "s0", image)
    reader, jreader = BandSceneReader(d), jlandsat.BandSceneReader(d)
    assert reader.shape == jreader.shape == (90, 110)
    assert reader.name == jreader.name == "s0"
    whole = reader.read_rows(0, 90)
    assert whole.dtype == np.float32
    np.testing.assert_array_equal(whole, jreader.read_rows(0, 90))
    np.testing.assert_array_equal(whole, bundle.rgba_to_gray(image))
    np.testing.assert_array_equal(
        np.concatenate(list(reader.stripes(17))), whole)
    np.testing.assert_array_equal(
        ArraySceneReader(image).read_rows(5, 40), whole[5:40])
    with pytest.raises(ValueError, match="positive"):
        next(reader.stripes(0))


@pytest.mark.parametrize("kind", ["rgba", "gray"])
def test_write_scene_bands_byte_identical_to_reference(tmp_path, kind):
    image = (synthetic_scene_rgba(40, 56, seed=4) if kind == "rgba"
             else synthetic_scene(40, 56, seed=4))
    d = write_scene_bands(tmp_path / "port", "scene", image)
    jd = jlandsat.write_scene_bands(tmp_path / "ref", "scene", image)
    names = sorted(p.name for p in d.iterdir())
    assert names == sorted(p.name for p in jd.iterdir())
    assert names == (["B2.npy", "B3.npy", "B4.npy", "scene.json"]
                     if kind == "rgba" else ["gray.npy", "scene.json"])
    for name in names:
        assert (d / name).read_bytes() == (jd / name).read_bytes(), name


def test_write_synthetic_scene_set_byte_identical_to_reference(tmp_path):
    dirs = landsat.write_synthetic_scene_set(tmp_path / "port", 2, 48, 40)
    jdirs = jlandsat.write_synthetic_scene_set(tmp_path / "ref", 2, 48, 40)
    assert [d.name for d in dirs] == [d.name for d in jdirs] == \
        ["scene_0000", "scene_0001"]
    for d, jd in zip(dirs, jdirs):
        for p in sorted(jd.iterdir()):
            assert (d / p.name).read_bytes() == p.read_bytes()


def test_band_reader_errors_match_reference(tmp_path):
    """Missing band, a band of another shape, a truncated band file and a
    missing manifest raise in both packages alike."""
    def both_raise(d, exc, match):
        for reader in (BandSceneReader, jlandsat.BandSceneReader):
            with pytest.raises(exc, match=match):
                reader(d)

    d = write_scene_bands(tmp_path, "s1", synthetic_scene_rgba(40, 40))
    (d / "B3.npy").unlink()
    meta = json.loads((d / "scene.json").read_text())
    meta["bands"] = [b for b in meta["bands"] if b != "B3"]
    (d / "scene.json").write_text(json.dumps(meta))
    both_raise(d, ValueError, "band set")
    d2 = write_scene_bands(tmp_path, "s2", synthetic_scene_rgba(40, 40))
    np.save(d2 / "B3.npy", np.zeros((40, 39), np.uint8))
    both_raise(d2, ValueError, "shape")
    d3 = write_scene_bands(tmp_path, "s3", synthetic_scene_rgba(64, 64))
    path = d3 / "B4.npy"
    path.write_bytes(path.read_bytes()[:200])   # cut the data section
    both_raise(d3, IOError, "truncated or corrupt")
    both_raise(tmp_path / "nothing", FileNotFoundError, "scene.json")
    with pytest.raises(ValueError, match="shape"):
        write_scene_bands(tmp_path, "s4", np.zeros((2, 2, 2, 2)))
    with pytest.raises(ValueError, match="shape"):
        ArraySceneReader(np.zeros(5))


def _readers(n=3, hw=(100, 90)):
    scenes = [synthetic_scene(*hw, seed=i) for i in range(n)]
    return ([ArraySceneReader(s, f"s{i}") for i, s in enumerate(scenes)],
            [jlandsat.ArraySceneReader(s, f"s{i}")
             for i, s in enumerate(scenes)], scenes)


@pytest.mark.parametrize("batch_tiles", [1, 4, 7, 64])
def test_iter_tile_batches_equal_reference_and_bundle_scenes(batch_tiles):
    readers, jreaders, scenes = _readers()
    got = list(iter_tile_batches(readers, CFG, batch_tiles))
    assert_batches_equal(got, list(jpipeline.iter_tile_batches(
        jreaders, JCFG, batch_tiles)))
    n = count_batches([r.shape for r in readers], CFG, batch_tiles)
    assert n == len(got) == jpipeline.count_batches(
        [r.shape for r in readers], JCFG, batch_tiles)
    assert all(len(b) == batch_tiles for _, b in got)
    eager = bundle.bundle_scenes(scenes, CFG)
    tiles = np.concatenate([b.tiles for _, b in got])
    headers = np.concatenate([b.headers for _, b in got])
    np.testing.assert_array_equal(tiles[:len(eager)], eager.tiles)
    np.testing.assert_array_equal(headers[:len(eager)], eager.headers)
    padded = eager.pad_to(n * batch_tiles)      # the tail is pad-flagged
    np.testing.assert_array_equal(tiles, padded.tiles)
    np.testing.assert_array_equal(headers, padded.headers)


@pytest.mark.parametrize("shape", [(100, 90), (64, 64), (1, 1), (130, 257)])
def test_scene_tile_count_equals_reference(shape):
    assert pipeline.scene_tile_count(shape, CFG) == \
        jpipeline.scene_tile_count(shape, JCFG) == \
        len(bundle.tile_scene(np.zeros(shape, np.float32), CFG))


@pytest.mark.parametrize("n,w", [(8, 2), (7, 3), (5, 5), (9, 4), (3, 1),
                                 (12, 4)])
def test_batch_slices_equal_reference_and_cover_exactly(n, w):
    slices = batch_slices(n, w)
    assert slices == jpipeline.batch_slices(n, w)
    assert len(slices) == w
    assert [i for lo, hi in slices for i in range(lo, hi)] == list(range(n))


@pytest.mark.parametrize("workers", [2, 3])
def test_sliced_batches_equal_reference_and_full_stream(workers):
    readers, jreaders, _ = _readers()
    full = list(iter_tile_batches(readers, CFG, 4))
    n = count_batches([r.shape for r in readers], CFG, 4)
    got = []
    for lo, hi in batch_slices(n, workers):
        part = list(iter_tile_batches(readers, CFG, 4, start=lo, stop=hi))
        assert_batches_equal(part, list(jpipeline.iter_tile_batches(
            jreaders, JCFG, 4, start=lo, stop=hi)))
        got += part
    assert_batches_equal(got, full)
    with pytest.raises(ValueError, match="bad batch slice"):
        list(iter_tile_batches(readers, CFG, 4, start=3, stop=2))
    with pytest.raises(ValueError, match="positive"):
        list(iter_tile_batches(readers, CFG, 0))


class CountingReader(ArraySceneReader):
    """Counts stripe reads (one counter per instance)."""

    def __init__(self, image, name="scene"):
        super().__init__(image, name)
        self.reads = 0

    def read_rows(self, y0, y1):
        self.reads += 1
        return super().read_rows(y0, y1)


def test_sliced_batches_skip_scenes_outside_the_slice():
    readers = [CountingReader(synthetic_scene(128, 128, seed=i), f"s{i}")
               for i in range(4)]
    n = count_batches([r.shape for r in readers], CFG, 4)
    lo, hi = batch_slices(n, 2)[0]
    list(iter_tile_batches(readers, CFG, 4, start=lo, stop=hi))
    assert readers[0].reads > 0 and readers[-1].reads == 0
    lo, hi = batch_slices(n, 2)[1]
    for r in readers:
        r.reads = 0
    list(iter_tile_batches(readers, CFG, 4, start=lo, stop=hi))
    assert readers[0].reads == 0 and readers[-1].reads > 0


def test_sliced_batches_stop_reading_after_slice():
    """A worker slice ending mid-scene does not stream the rest of it."""
    reader = CountingReader(synthetic_scene(64 * 6, 64, seed=0), "s0")
    assert count_batches([reader.shape], CFG, 2) == 3
    list(iter_tile_batches([reader], CFG, 2, stripe_rows=1, start=0, stop=1))
    reads_first = reader.reads
    reader.reads = 0
    list(iter_tile_batches([reader], CFG, 2, stripe_rows=1))
    assert reads_first < reader.reads / 2


def test_iter_tile_batches_packs_into_the_given_arrays():
    """``alloc`` receives each batch's shapes and the batch is those arrays,
    its values the default packer's."""
    readers, _, _ = _readers(n=1)
    given = []

    def alloc(shape, dtype):
        given.append(np.full(shape, 7, dtype))
        return given[-1]

    got = list(iter_tile_batches(readers, CFG, 4, alloc=alloc))
    assert len(given) == 2 * len(got)
    for k, (_, b) in enumerate(got):
        assert b.tiles is given[2 * k] and b.headers is given[2 * k + 1]
    assert_batches_equal(got, list(iter_tile_batches(readers, CFG, 4)))


def test_prefetcher_yields_everything_in_order():
    with Prefetcher(iter(range(20)), depth=2) as pf:
        assert list(pf) == list(range(20))
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter(()), depth=0)


@pytest.mark.parametrize("at", [0, 2])
def test_prefetcher_propagates_producer_error(at):
    """An error in the first item or mid-stream re-raises at the consumer
    after the items before it."""
    def boom():
        yield from range(at)
        raise IOError("scene truncated mid-stream")

    pf = Prefetcher(boom(), depth=2)
    got = []
    with pytest.raises(IOError, match="truncated mid-stream"):
        for x in pf:
            got.append(x)
    assert got == list(range(at))
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_unblocks_producer():
    """A consumer abandoning iteration does not leave the producer thread
    wedged on a full queue."""
    produced = []

    def infinite():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    pf = Prefetcher(infinite(), depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    assert len(produced) <= 8        # stopped near the queue depth


def test_prefetcher_runs_ahead_of_the_consumer():
    pf = Prefetcher(iter(range(6)), depth=2)
    deadline = time.monotonic() + 10.0
    while pf._q.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf._q.qsize() == 2        # staged ahead, bounded by the depth
    assert list(pf) == list(range(6))
    pf.close()


def test_prefetcher_stages_onto_the_cpu_when_asked():
    """``device_put=True, device="cpu"``: TileBundles inside the yielded
    tuples, and bare arrays, come out as CPU tensors equal to the unstaged
    batches; other items pass through."""
    readers, _, _ = _readers(n=1)
    ref = list(iter_tile_batches(readers, CFG, 4))
    with Prefetcher(iter_tile_batches(readers, CFG, 4), depth=2,
                    device_put=True, device="cpu") as pf:
        got = list(pf)
    assert [i for i, _ in got] == [i for i, _ in ref]
    for (_, b), (_, want) in zip(got, ref):
        assert isinstance(b, TileBundle) and b.cfg == want.cfg
        for t, w in ((b.tiles, want.tiles), (b.headers, want.headers)):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), w)
    arr = np.arange(6, dtype=np.int32)
    with Prefetcher(iter([arr, "name"]), device_put=True,
                    device="cpu") as pf:
        staged, name = list(pf)
    assert isinstance(staged, torch.Tensor) and name == "name"
    np.testing.assert_array_equal(staged.numpy(), arr)


def test_prefetcher_staging_defaults_to_the_card():
    """``device_put=True`` with no device means the card: on a host without
    CUDA it raises instead of staging onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: staging goes to the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Prefetcher(iter(range(3)), device_put=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Prefetcher(iter(range(3)), device_put=True, device="cuda")


ALGS = ("harris", "fast", "sift")


@functools.lru_cache(maxsize=None)
def _jax_extract():
    return jax.jit(lambda t, h: jengine.extract_features_multi(
        t, h, ALGS, JCFG, use_pallas=False))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_pipelined_extraction_matches_reference(tmp_path, use_kernels):
    """Band files -> streamed batches -> prefetcher staging -> extraction,
    for worker slices of 1 and 2 workers: each batch's results equal the
    reference's pipelined extraction of the same batch (jitted, plain
    route)."""
    dirs = [write_scene_bands(tmp_path, f"s{i}",
                              synthetic_scene_rgba(100, 90, seed=i))
            for i in range(2)]
    readers = [BandSceneReader(d) for d in dirs]
    jreaders = [jlandsat.BandSceneReader(d) for d in dirs]
    n_b = count_batches([r.shape for r in readers], CFG, 4)
    fn = _jax_extract()
    with jpipeline.Prefetcher(jpipeline.iter_tile_batches(
            jreaders, JCFG, 4)) as pf:
        want = {idx: jax.device_get(fn(b.tiles, b.headers))
                for idx, b in pf}
    assert sorted(want) == list(range(n_b))
    for w in (1, 2):
        got = {}
        for lo, hi in batch_slices(n_b, w):
            with Prefetcher(iter_tile_batches(readers, CFG, 4, start=lo,
                                              stop=hi),
                            device_put=True, device="cpu") as pf:
                for idx, b in pf:
                    got[idx] = engine.extract_features_multi(
                        b.tiles, b.headers, ALGS, CFG,
                        use_kernels=use_kernels, device="cpu")
        assert got.keys() == want.keys()
        for idx in want:
            for alg in ALGS:
                assert_result_matches(got[idx][alg], want[idx][alg])
    assert sum(int(want[i]["harris"]["total_count"]) for i in want) > 0
