"""The LM substrate's checkpointing and training launcher in the port
(``repro_torch.checkpoint``, ``repro_torch.launch.train``) against the JAX
package's, on the CPU.

The two packages' ``CheckpointManager``s read each other's files bit for
bit (a state of bf16, fp32 and int32 leaves, nested as a train state is);
corruption, ``keep_n`` pruning and async save mirror
``tests/test_job_checkpoint.py``; and ``launch.train.main`` resumed from a
checkpoint continues the uninterrupted loss trajectory (the reference's
rtol 1e-4 / atol 1e-5), with and without microbatches and compression.
"""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def numpy_state(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"emb.w": rng.randn(16, 8).astype(ml_dtypes.bfloat16),
                       "norm": rng.randn(8).astype(np.float32)},
            "opt": {"m": {"emb.w": rng.randn(16, 8).astype(np.float32)},
                    "count": np.int32(7)},
            "step": np.int32(7)}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x):
    """A leaf's bytes and dtype name, from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16"
        return x.numpy().tobytes(), str(x.numpy().dtype)
    a = np.asarray(x)
    return a.tobytes(), a.dtype.name


def assert_same_bits(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            assert_same_bits(got[k], want[k])
        else:
            assert bits(got[k]) == bits(want[k]), k


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_port_file_restores_in_reference(tmp_path, async_):
    state = numpy_state()
    cm = CheckpointManager(tmp_path)
    cm.save(_map(state, to_torch), 7, async_=async_)
    cm.wait()
    manifest = json.loads((tmp_path / "step_0000000007" /
                           "manifest.json").read_text())
    assert manifest["tensors"]["params/emb.w"]["dtype"] == "bfloat16"
    assert manifest["tensors"]["step"]["dtype"] == "int32"
    restored, step = JCheckpointManager(tmp_path).restore(
        _map(state, jnp.asarray))
    assert step == 7
    assert_same_bits(restored, state)


def test_reference_file_restores_in_port(tmp_path):
    state = numpy_state(1)
    JCheckpointManager(tmp_path).save(_map(state, jnp.asarray), 3)
    target = _map(numpy_state(2), to_torch)
    restored, step = CheckpointManager(tmp_path).restore(target)
    assert step == 3
    assert restored["params"]["emb.w"].dtype == torch.bfloat16
    assert_same_bits(restored, state)
    # the port's own round trip, onto the device asked for
    CheckpointManager(tmp_path / "port").save(restored, 4)
    again, _ = CheckpointManager(tmp_path / "port").restore(target,
                                                            device="cpu")
    assert_same_bits(again, state)


def test_checkpoint_corruption_detected(tmp_path):
    cm = CheckpointManager(tmp_path)
    state = {"w": torch.arange(16, dtype=torch.float32)}
    cm.save(state, 1)
    d = tmp_path / "step_0000000001"
    z = np.load(d / "tensors.npz")
    data = {k: z[k].copy() for k in z.files}
    data["w"][0] = 999.0
    np.savez(d / "tensors.npz", **data)
    with pytest.raises(IOError, match="corruption"):
        cm.restore(state)
    restored, _ = cm.restore(state, verify=False)
    assert float(restored["w"][0]) == 999.0


def test_keep_n_prunes_oldest(tmp_path):
    cm = CheckpointManager(tmp_path, keep_n=2)
    for step in (1, 2, 3, 4):
        cm.save({"w": torch.full((3,), float(step))}, step, async_=True)
    cm.wait()
    assert cm.list_steps() == [3, 4] and cm.latest_step() == 4
    assert not list(tmp_path.glob(".tmp_step_*"))
    restored, step = cm.restore({"w": torch.zeros(3)})
    assert step == 4 and torch.equal(restored["w"], torch.full((3,), 4.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"w": torch.zeros(3)})


def test_async_save_copies_before_training_goes_on(tmp_path):
    """The host copy is taken at ``save``: an in-place update made right
    after it does not reach the file."""
    cm = CheckpointManager(tmp_path)
    w = torch.ones(1 << 16)
    cm.save({"w": w}, 1, async_=True)
    w.add_(1.0)
    cm.wait()
    restored, _ = cm.restore({"w": torch.zeros(1 << 16)})
    assert torch.equal(restored["w"], torch.ones(1 << 16))


@pytest.mark.parametrize("extra", [[], ["--microbatches", "2",
                                        "--grad-compression"]],
                         ids=["plain", "microbatches+compression"])
def test_train_resume_matches_uninterrupted(tmp_path, extra):
    """Checkpoint/restart reproduces the uninterrupted loss trajectory
    (deterministic data + state capture), as the reference's test."""
    from repro_torch.launch.train import main as train_main
    base = ["--device", "cpu", "--arch", "smollm-135m", "--reduced",
            "--batch", "2", "--seq", "32", "--log-every", "100"] + extra
    full = train_main(base + ["--steps", "8"])
    part = train_main(base + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "ck"), "--ckpt-every", "4"])
    resumed = train_main(base + ["--steps", "8", "--ckpt-dir",
                                 str(tmp_path / "ck"), "--resume"])
    assert len(part) == 4 and len(resumed) == 4
    np.testing.assert_allclose(full[:4], part, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(full[4:], resumed, rtol=1e-4, atol=1e-5)
    assert all(np.isfinite(full))
