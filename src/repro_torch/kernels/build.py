"""Build the CUDA kernels of ``kernels/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for Hopper
(``sm_90a``), into its own shared library with a plain C interface under
``build/repro_torch_kernels/`` at the root of the checkout.  The library
name carries a hash of the sources and flags, so an edited source is never
served by a stale build.  ``build_all`` starts one ``nvcc`` per source at
once and waits for all of them.

A C entry point takes device pointers, sizes, scalars and PyTorch's
current stream, launches its kernel without synchronising, and returns
``cudaGetLastError()``; ``CudaKernel.launch`` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("harris", "fastscore", "blur", "scalespace")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")
MAX_RADIUS = 16          # csrc/common.cuh MAX_TAPS = 2 * 16 + 1


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its sources and flags."""
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}.{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def build_all(names=SOURCES) -> dict:
    """Compile every library of ``names`` not built yet, all at once.
    Returns {name: compiler output} (ptxas register and shared-memory
    report) for the ones it built; raises on the first failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {n: _start(n) for n in names if not library_path(n).exists()}
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        tmp.replace(out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))


class CudaKernel:
    """One C entry point of one library, with a count of its launches.

    ``launches`` goes up by one each time ``launch`` has put the kernel on
    the stream, and nowhere else."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0

    @functools.cached_property
    def _fn(self):
        lib = load(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.difet_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        return fn, err

    def launch(self, device: torch.device, *args) -> None:
        fn, err = self._fn
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} "
                               f"({err(rc).decode()})")
        self.launches += 1


def check_image(x: torch.Tensor, name: str) -> None:
    """What every kernel wrapper takes: fp32, [N, H, W], contiguous, on the
    CPU (plain twin) or a CUDA device (kernel)."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"{name}: needs [N, H, W], got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs on cpu or cuda, not {x.device}")

