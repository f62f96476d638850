"""Checkpointing (``repro.training.checkpoint``), byte-compatible with the
reference's ``CheckpointManager``.

A checkpoint of a tree (here ``(params, opt_state)``) is a directory
``step_<10 digits>`` holding one ``.npy`` per leaf and ``manifest.json``
with each leaf's file, shape and dtype.  Keys are the ``/``-joined paths
of the tree (dict keys in sorted order, list and tuple indices), e.g.
``0/stages/0/attn/wq`` or ``1/embed/m``; files are the keys with ``/``
as ``__``.  bfloat16 leaves are written as raw two-byte ``<V2`` records
with manifest dtype ``"bfloat16"``, as numpy writes the reference's
ml_dtypes arrays, and read back through a ``uint16`` view, so neither
package needs the other's dtype library.  Writes go to ``<dir>.tmp`` and
are renamed into place; ``save_async`` snapshots to host memory and
writes on a background thread; the ``keep`` newest steps are retained.
``restore(shardings=...)`` (placement on a mesh) is not ported.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.convert import to_numpy


def _leaf_paths(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(key, leaf) in the reference's order: dict keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaf_paths(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaf_paths(v, prefix + (str(i),)))
        return out
    return [("/".join(prefix), tree)]


def _sanitize(key: str) -> str:
    return key.replace("/", "__")


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # the header numpy writes for an ml_dtypes bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _to_tensor(arr: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if dtype != "bfloat16":
            raise ValueError(f"unsupported raw dtype {dtype!r} in checkpoint")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -------------------------------------------------------------
    @staticmethod
    def _snapshot(tree: Any) -> list[tuple[str, np.ndarray, str]]:
        """(key, host array, manifest dtype) per tensor leaf; bf16 as
        uint16 bits."""
        out = []
        for key, leaf in _leaf_paths(tree):
            dtype = ("bfloat16" if leaf.dtype == torch.bfloat16
                     else str(leaf.dtype).removeprefix("torch."))
            arr = to_numpy(leaf)
            if leaf.device.type == "cpu":  # a view of the live tensor
                arr = arr.copy()
            out.append((key, arr, dtype))
        return out

    def save(self, step: int, tree: Any, extra: dict | None = None) -> Path:
        return self._write(step, self._snapshot(tree), extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: dict | None = None) -> None:
        self.wait()  # one in-flight save at a time
        host = self._snapshot(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list, extra: dict) -> Path:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "arrays": {}}
        for key, arr, dtype in host:
            fname = _sanitize(key) + ".npy"
            _save_npy(tmp / fname, arr, dtype)
            manifest["arrays"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: int | None = None,
                shardings: Any | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``tree_like``: each leaf comes
        back on the like leaf's device in its dtype.  Returns (tree,
        extra)."""
        if shardings is not None:
            raise NotImplementedError("restore(shardings=...) is not ported: "
                                      "the port runs on one device")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        arrays = manifest["arrays"]
        loaded = {}
        for key, like in _leaf_paths(tree_like):
            if key not in arrays:
                raise KeyError(f"checkpoint missing array {key!r}")
            arr = np.load(d / arrays[key]["file"])
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != expected "
                    f"{tuple(like.shape)}")
            loaded[key] = _to_tensor(arr, arrays[key]["dtype"], like)

        def rebuild(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: rebuild(v, prefix + (str(k),))
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(rebuild(v, prefix + (str(i),))
                                  for i, v in enumerate(tree))
            return loaded["/".join(prefix)]

        return rebuild(tree_like), manifest["extra"]
