"""Checkpointing with async save, an integrity manifest and pruning (port
of ``repro.checkpoint.checkpoint``), in the reference's on-disk layout:

    <root>/step_%010d/tensors.npz     one array per leaf, keyed by its
                                      '/'-joined path in the state tree
    <root>/step_%010d/manifest.json   step, time, per-tensor shape, dtype
                                      and crc32 of the array's bytes

A save writes a tmp directory and renames it into place, so a half-written
checkpoint is never visible; the oldest beyond ``keep_n`` are pruned.
On a mesh the files hold the logical tensors: every rank gathers each
DTensor leaf (``full_tensor``), rank 0 alone writes, and a restore with
``shardings`` places what it reads onto the current mesh, whatever mesh
wrote it (an elastic restore).
numpy has no bfloat16 here, so a bf16 leaf is stored as the 2-byte void
view that the reference's files hold for it (its crc over those bytes, its
manifest dtype "bfloat16"): either package reads the other's files.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_BF16_VIEW = np.dtype("V2")


def flatten_state(tree, prefix=""):
    """[(path, leaf)] of a nested dict of tensors, in the tree's order;
    a path joins the keys with '/' (the checkpoint's keys)."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += flatten_state(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _unflatten(tree, leaves, prefix=""):
    return {k: (_unflatten(v, leaves, f"{prefix}{k}/") if isinstance(v, dict)
                else leaves[f"{prefix}{k}"]) for k, v in tree.items()}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a blocking copy, never a view of a CPU
    tensor that training goes on writing); of a DTensor, its logical
    value (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_VIEW)
    return t.numpy()


def _dtype_name(a: np.ndarray, t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype)


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        if arr.dtype.kind != "V" or arr.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_name)))


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the only
    process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _leaf(tree, key: str):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def _place(t: torch.Tensor, mesh, placements):
    """A logical tensor (the same on every rank) as a DTensor of
    ``placements`` on ``mesh``, on the mesh's device."""
    from torch.distributed.tensor import distribute_tensor
    kind = mesh.device_mesh.device_type
    dev = (torch.device(kind, torch.cuda.current_device()) if kind == "cuda"
           else torch.device(kind))
    return distribute_tensor(t.to(dev), mesh.device_mesh, placements)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xffffffff


class CheckpointManager:
    def __init__(self, root, keep_n: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None

    # ---------------- save ---------------------------------------------------
    def save(self, state, step: int, async_: bool = False):
        """Every rank of a mesh calls it; rank 0 writes."""
        # copied to the host now, so that training can go on under async
        host, dtypes = {}, {}
        for k, t in flatten_state(state):
            host[k] = _to_host(t)
            dtypes[k] = _dtype_name(host[k], t)
        if not _writer():
            return
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(host, dtypes, step), daemon=True)
            self._thread.start()
        else:
            self._write(host, dtypes, step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host, dtypes, step: int):
        tmp = self.root / f".tmp_step_{step}"
        final = self.root / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "tensors": {}}
        np.savez(tmp / "tensors.npz", **host)
        for k, v in host.items():
            manifest["tensors"][k] = {"shape": list(v.shape),
                                      "dtype": dtypes[k], "crc32": _crc(v)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.replace(final)                      # atomic publish
        self._prune()

    def _prune(self):
        steps = self.list_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self.root / f"step_{s:010d}", ignore_errors=True)

    # ---------------- restore ------------------------------------------------
    def list_steps(self):
        return sorted(int(p.name.split("_")[1])
                      for p in self.root.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, target, step: Optional[int] = None, device=None,
                verify: bool = True, shardings=None, mesh=None):
        """Restore into the structure of ``target`` (a nested dict of
        tensors): new tensors of each target leaf's dtype, on ``device`` if
        given, else on the target leaf's device.  ``shardings``: a matching
        tree of DTensor placements on the `LMMesh` ``mesh`` (an elastic
        restore onto the current mesh: each leaf becomes a DTensor).
        Returns (state, step)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = {}
        with np.load(d / "tensors.npz") as z:
            if verify:
                for k, meta in manifest["tensors"].items():
                    if _crc(z[k]) != meta["crc32"]:
                        raise IOError(f"checkpoint corruption in tensor "
                                      f"{k!r}")
            for key, ref in flatten_state(target):
                t = _from_host(z[key], manifest["tensors"][key]["dtype"])
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: ckpt {tuple(t.shape)} "
                        f"vs target {tuple(ref.shape)}")
                if shardings is not None:
                    leaves[key] = _place(t.to(dtype=ref.dtype), mesh,
                                         _leaf(shardings, key))
                else:
                    leaves[key] = t.to(device=device or ref.device,
                                       dtype=ref.dtype)
        return _unflatten(target, leaves), step
