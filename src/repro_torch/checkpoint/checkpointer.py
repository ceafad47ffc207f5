"""Atomic, async checkpoints of nested dicts of tensors: the port of
``repro.checkpoint.checkpointer``.

Layout:   <dir>/step_<n>.tmp/  ->  (atomic rename)  ->  <dir>/step_<n>/
            manifest.json        each leaf's key path, shape and dtype,
                                 and the caller's ``extra``
            leaf_<i>.npy         one file per leaf (the whole tensor)

A tree is nested dicts whose leaves are tensors, numpy arrays or numbers;
the manifest names each leaf by its key path (``["params",
"blocks.0.attn.wq"]``) where the reference pickles a JAX treedef.
bfloat16 leaves (numpy has none) are stored as their raw 16 bits and
viewed back, so they round-trip bitwise.  :meth:`Checkpointer.restore`
puts every leaf on the device the caller names (default the CPU).  Writes
can run on a background thread (``async_save``, from a host snapshot
taken first); ``wait()`` joins and re-raises a failed write.  ``keep``
bounds the steps kept, and ``.tmp`` directories (a writer that died) are
ignored.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike

_RAW = {torch.bfloat16: (torch.int16, "bfloat16")}
_VIEWS = {"bfloat16": torch.bfloat16}


def _leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) of every leaf, dict keys in insertion order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    return [(path, tree)]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to write, dtype name to restore)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _RAW:
            raw, name = _RAW[t.dtype]
            return t.view(raw).numpy(), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _nest(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = _leaves(tree)
        manifest = {"step": step, "n_leaves": len(flat), "leaves": [],
                    "extra": extra or {}, "time": time.time()}
        for i, (path, leaf) in enumerate(flat):
            arr, dtype = _to_host(leaf)
            np.save(tmp / f"leaf_{i}.npy", arr)
            manifest["leaves"].append({"index": i, "path": list(path),
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                       # atomic publish
        self._gc()
        return final

    def async_save(self, step: int, tree: Any,
                   extra: Optional[dict] = None):
        # snapshot to host first: the caller may go on writing the tensors
        host = {}
        for path, leaf in _leaves(tree):
            _nest(host, path, leaf.detach().to("cpu", copy=True)
                  if isinstance(leaf, torch.Tensor) else np.array(leaf))
        self.wait()

        def work():
            try:
                self.save(step, host, extra)
            except BaseException as e:   # surfaced at next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                 if not p.name.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None,
                device: DeviceLike = "cpu") -> tuple:
        """(tree of tensors on ``device``, extra) of ``step`` (default the
        latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        tree: dict = {}
        for leaf in manifest["leaves"]:
            t = torch.from_numpy(np.load(path / f"leaf_{leaf['index']}.npy"))
            if leaf["dtype"] in _VIEWS:
                t = t.view(_VIEWS[leaf["dtype"]])
            _nest(tree, tuple(leaf["path"]), t.to(device))
        return tree, manifest["extra"]

    # --------------------------------------------------------------- gc
    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
