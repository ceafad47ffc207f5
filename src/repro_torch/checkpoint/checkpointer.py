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
puts every leaf on the device the caller names (default the CPU), or, with
``shardings`` (a tree of ``dist.sharding.NamedSharding``, or None leaves),
each leaf as a DTensor with the asked placements on the sharding's mesh:
the checkpoint holds whole tensors, so restoring onto another mesh is a
placement decision (``runtime.elastic.reshard_restore``).  A DTensor leaf
is saved whole (``full_tensor``, a collective: every rank of its mesh
calls ``save``); in a process group of more than one rank only rank 0
writes, and every rank waits for the write before ``save`` returns.  Writes
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike

_RAW = {torch.bfloat16: (torch.int16, "bfloat16")}
_VIEWS = {"bfloat16": torch.bfloat16}


def _leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) of every leaf, dict keys in insertion order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    return [(path, tree)]


def _whole(leaf):
    """A DTensor leaf gathered whole (a collective), any other as it is."""
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


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


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


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
        flat = [(path, _whole(leaf)) for path, leaf in _leaves(tree)]
        final = self.dir / f"step_{step}"
        if _writer():
            self._write(step, flat, extra)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        return final

    def _write(self, step: int, flat, extra: Optional[dict]):
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
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

    def async_save(self, step: int, tree: Any,
                   extra: Optional[dict] = None):
        # snapshot to host first: the caller may go on writing the tensors
        host = []
        for path, leaf in _leaves(tree):
            leaf = _whole(leaf)
            host.append((path, leaf.detach().to("cpu", copy=True)
                         if isinstance(leaf, torch.Tensor)
                         else np.array(leaf)))
        self.wait()
        if not _writer():
            return

        def work():
            try:
                self._write(step, host, extra)
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
                device: DeviceLike = "cpu", shardings: Any = None) -> tuple:
        """(tree of tensors on ``device``, extra) of ``step`` (default the
        latest); with ``shardings``, a tree matching the saved one whose
        leaves are ``NamedSharding`` (the leaf comes back as that
        sharding's DTensor on its mesh's device) or None (a plain tensor on
        ``device``)."""
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
            key = tuple(leaf["path"])
            sh = _at(shardings, key) if shardings is not None else None
            _nest(tree, key, t.to(device) if sh is None
                  else sh.distribute(t))
        return tree, manifest["extra"]

    # --------------------------------------------------------------- gc
    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
