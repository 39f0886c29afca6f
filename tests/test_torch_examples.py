"""The port's examples (``examples/torch_*.py``) run on the CPU
(``--device cpu``) at their smallest sizes, each in a process of its own:
every step prints its line and the script exits 0."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "torch_quickstart.py": (["--size", "128", "160", "--tile", "64"],
                            "strongest Harris corner at"),
    "torch_distributed_extract.py": (["--size", "160"],
                                     "elastic rebalance over 3 workers"),
    "torch_serve_lm.py": (["--steps", "4"], "zamba2-2.7b    generated (4, 4)"),
    "torch_train_lm.py": (["--steps", "6", "--batch", "2", "--seq", "32",
                           "--ckpt-every", "3"], "(improved)"),
}


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_the_cpu(tmp_path, script):
    args, last = CASES[script]
    if script == "torch_train_lm.py":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    done = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu"]
        + args, cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    assert last in done.stdout, done.stdout
    if script == "torch_quickstart.py":
        for alg in ("harris", "shi_tomasi", "sift", "surf", "fast", "brief",
                    "orb"):
            assert f"  {alg} " in done.stdout, alg
