"""Fault-tolerant checkpointing.

Port of ``repro/runtime/checkpoint.py``, with its on-disk format:
  * host-side full arrays keyed by tree path, with the reference's key
    strings (``a:<field>`` for a NamedTuple field, ``k:<key>`` for a dict
    key, ``i:<n>`` for a list index, joined by ``/``), so a checkpoint
    either package writes of a ``TrainState`` restores in the other;
  * ATOMIC: written to a temp dir, fsynced, renamed; a crashed writer
    never corrupts the latest checkpoint;
  * ASYNC: a background thread drains a queue, so the training loop only
    pays for the device->host copy; or STREAMED (``save_leaves``): each
    leaf copied and written as it comes, as a mesh's gathered checkpoint
    is;
  * keep-last-k, with a JSON manifest of step, time, extra data, the keys
    and each array's true dtype (bf16 is stored as its raw uint16 bits).

``restore(shardings=)`` keeps each rank's shard of every leaf: the
shardings are a tree of ``launch.sharding.NamedSharding`` (from
``params_shardings``, ``cache_shardings`` ...), each leaf loaded whole and
cut by its sharding's ``local``.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import zipfile

import numpy as np
import torch


def _map_with_path(fn, tree, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``: the key is the
    leaf's path in the reference's strings, over NamedTuples, dicts, lists
    and tuples (None is an empty subtree, as in a pytree)."""
    join = (lambda k: f"{path}/{k}") if path else (lambda k: k)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, join(f"a:{name}"))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(f"k:{k}"))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, join(f"i:{i}"))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _flatten(tree) -> dict:
    """{key path: leaf}."""
    out = {}
    _map_with_path(out.__setitem__, tree)
    return out


def _to_numpy(leaf) -> np.ndarray:
    """A host copy; bf16 as raw uint16 bits (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().copy()
        return t.numpy().copy()
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._err = None
        self._thread = None
        if async_save:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, *, extra: dict | None = None,
             blocking: bool = False):
        """Snapshot to host memory now; write in the background."""
        items = [(k, _to_numpy(v), _dtype_name(v))
                 for k, v in _flatten(tree).items()]
        payload = (step, items, extra or {})
        if self._thread is None or blocking:
            self._write(*payload)
        else:
            self._q.put(payload)

    def save_leaves(self, step: int, leaves, *, extra: dict | None = None):
        """Write a checkpoint from ``leaves``, an iterable of ``(key,
        leaf)`` in the tree's order (``launch.sharding.gathered_leaves``),
        each copied to the host and written as it comes, so that no whole
        tree is ever in memory.  Blocks, after the queued saves."""
        self.wait()
        self._write(step, ((k, _to_numpy(v), _dtype_name(v))
                           for k, v in leaves), extra or {})

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                self._write(*item)
            except Exception as e:  # surfaced on next wait()
                self._err = e
            finally:
                self._q.task_done()

    def wait(self):
        """Block until queued saves land (call before shutdown)."""
        if self._thread is not None:
            self._q.join()
        if self._err:
            raise self._err

    def _write(self, step: int, items, extra: dict):
        """``items``: (key, host array, dtype name), written one at a time
        into ``arrays.npz`` (``np.savez``'s layout)."""
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        dtypes = {}
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                             zipfile.ZIP_STORED, allowZip64=True) as zf:
            for key, arr, dtype in items:
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(arr),
                                              allow_pickle=False)
                dtypes[key] = dtype
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "keys": sorted(dtypes), "dtypes": dtypes}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, step: int | None = None, shardings=None):
        """Restore into the structure of ``like_tree`` (its tensors give
        each leaf's dtype and device).  Returns ``(tree, manifest)``.

        ``shardings``: a tree of the same structure whose leaves have a
        ``local(tensor)`` method (``launch.sharding.NamedSharding``); each
        leaf is loaded whole and this rank keeps ``local`` of it, so
        ``restore(params, shardings=params_shardings(mesh, cfg, params))``
        gives what ``place_params`` gives."""
        keep = {} if shardings is None else _flatten(shardings)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as data:
            stored = {k: data[k] for k in data.files}

        def load(key, leaf):
            arr = stored[key]
            if dtypes.get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.uint16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            if key in keep:
                t = keep[key].local(t)
            if isinstance(leaf, torch.Tensor):
                return t.to(device=leaf.device, dtype=leaf.dtype)
            return t

        return _map_with_path(load, like_tree), manifest

    def restore_or_none(self, like_tree, shardings=None):
        try:
            return self.restore(like_tree, shardings=shardings)
        except FileNotFoundError:
            return None, None
