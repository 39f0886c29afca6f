"""End-to-end training on the PyTorch port: a reduced SmolLM for a few
hundred steps with checkpoints (``repro_torch.launch.train``); the loss
must visibly decrease.  The steps of ``examples/train_lm.py``, on the CUDA
card by default or on the CPU with ``--device cpu``; drop ``--reduced`` for
the full-width model.  Arguments after the script pass through to the
launcher (``--steps 50``, ``--device cpu``, ...).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
"""
import sys
import tempfile
from pathlib import Path

from repro_torch.launch.train import main

if __name__ == "__main__":
    ckpt = Path(tempfile.gettempdir()) / "repro_torch_ckpt"
    args = ["--arch", "smollm-135m", "--reduced", "--steps", "300",
            "--batch", "8", "--seq", "128", "--ckpt-dir", str(ckpt),
            "--ckpt-every", "100"]
    # pass-through overrides, e.g. --steps 50: a later flag wins
    extra = sys.argv[1:]
    for flag in ("--steps", "--batch", "--seq", "--ckpt-dir",
                 "--ckpt-every"):
        if flag in extra:
            i = args.index(flag)
            del args[i:i + 2]
    main(args + extra)
