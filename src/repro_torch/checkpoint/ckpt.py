"""Checkpoints of trees of tensors, written on a background thread if
asked (port of ``repro.checkpoint.ckpt``).

Layout, the same as ``repro``'s, so either package restores what the other
wrote: one directory per step, ``<path>/step_XXXXXXXX/``, holding

* ``manifest.json`` — ``step``, per-leaf ``shape`` and ``dtype``, the
  caller's ``extra`` and the write ``time``;
* ``arrays.npz`` — every leaf's values, named by its path in the tree:
  dict keys (in sorted order) and list or tuple indices joined by ``/``
  (``slabs/0``, ``streams/first_price/s_hat``), as ``jax.tree_util``
  names them. ``None`` is an empty subtree and has no leaf.

A step is written into ``.tmp_step_XXXXXXXX`` and renamed into place, so a
crash never leaves a partial ``step_*``.

A leaf is written as its *logical* value: a
:class:`~repro_torch.launch.mesh.ShardedLog` is put together from its
shards first. So a checkpoint does not remember the mesh it came from, and
:func:`restore_checkpoint`'s ``shardings=`` places each leaf onto any mesh
(``event_sharding(mesh)`` splits its rows over the mesh's event ranks,
``replicated(mesh)`` puts it whole on the lead device): saved from 4 shards,
restored onto 2 — the elastic restore.
"""
from __future__ import annotations

import dataclasses
import json
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, pick_device
from repro_torch.launch.mesh import ShardedLog

Tree = Any


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order: dict keys
    sorted, sequences by index, ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _flatten(tree[key], prefix + (str(key),))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, sub in enumerate(tree)
                for pair in _flatten(sub, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like: Tree, leaves) -> Tree:
    """A tree of ``like``'s structure holding the next values of the
    iterator ``leaves``, in :func:`_flatten`'s order."""
    if like is None:
        return None
    if isinstance(like, dict):
        filled = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: filled[key] for key in like}
    if isinstance(like, (list, tuple)):
        subs = [_unflatten(sub, leaves) for sub in like]
        # a NamedTuple (a TrainState) takes its fields as arguments
        return type(like)(*subs) if hasattr(like, "_fields") \
            else type(like)(subs)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, ShardedLog):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str | Path, step: int, tree: Tree,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``tree`` (dicts, lists and tuples of tensors or arrays) as
    step ``step`` under ``path``. Returns the checkpoint directory."""
    root = Path(path)
    ckpt_dir = root / f"step_{step:08d}"
    tmp_dir = root / f".tmp_step_{step:08d}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "leaves": {}, "extra": extra or {},
                "time": time.time()}
    for key, leaf in _flatten(tree):
        arr = _host(leaf)
        arrays[key] = arr
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    np.savez(tmp_dir / "arrays.npz", **arrays)
    (tmp_dir / "manifest.json").write_text(json.dumps(manifest))
    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    tmp_dir.rename(ckpt_dir)
    return ckpt_dir


def latest_step(path: str | Path) -> Optional[int]:
    """The largest step written under ``path``; ``None`` if there is none."""
    root = Path(path)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")]
    return max(steps) if steps else None


def restore_checkpoint(path: str | Path, like: Tree,
                       step: Optional[int] = None, *,
                       device: DeviceLike = None,
                       shardings: Optional[Tree] = None
                       ) -> Tuple[Tree, Dict]:
    """Restore step ``step`` (the latest by default) into the structure of
    ``like`` (its leaves' values are ignored), each leaf a tensor on
    ``device`` (the card by default). Returns ``(tree, manifest)``.

    ``shardings`` places leaves on a mesh instead: a tree of ``like``'s
    structure whose entries are shardings
    (:func:`repro_torch.launch.mesh.event_sharding`, giving a
    :class:`~repro_torch.launch.mesh.ShardedLog`, or
    :func:`~repro_torch.launch.mesh.replicated`) or ``None`` (the leaf on
    ``device``); a sharding where ``like`` has a subtree applies to every
    leaf under it. Any mesh restores any checkpoint, whatever mesh wrote
    it."""
    root = Path(path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    ckpt_dir = root / f"step_{step:08d}"
    manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    flat = _flatten(like)
    if not flat:
        return _unflatten(like, iter(())), manifest
    places = _placements(like, shardings)
    dev = None if all(p is not None for p in places) else pick_device(device)
    leaves = []
    with np.load(ckpt_dir / "arrays.npz") as data:
        for (key, _), place in zip(flat, places):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = torch.from_numpy(np.array(data[key]))
            leaves.append(arr.to(dev) if place is None else place.place(arr))
    return _unflatten(like, iter(leaves)), manifest


def _placements(like: Tree, shardings: Optional[Tree]) -> list:
    """The sharding of each leaf of ``like`` (in :func:`_flatten`'s
    order): the entry of ``shardings`` at the leaf's path, or the nearest
    one above it; ``None`` where there is none."""
    if like is None:
        return []
    if shardings is None or hasattr(shardings, "place"):
        return [shardings] * len(_flatten(like))
    if isinstance(like, dict):
        return [p for key in sorted(like)
                for p in _placements(like[key], shardings.get(key))]
    if isinstance(like, (list, tuple)):
        return [p for i, sub in enumerate(like)
                for p in _placements(sub, shardings[i])]
    raise ValueError(f"shardings do not match the tree: {shardings!r} "
                     "where the tree has a leaf")


@dataclasses.dataclass
class AsyncCheckpointer:
    """A background-thread checkpoint writer with at most one save queued,
    keeping the newest ``keep`` steps. :meth:`save` copies the tree to host
    memory (blocking) and returns; the thread writes it. A failed write is
    raised by the next :meth:`save` or :meth:`wait`."""

    path: str | Path
    keep: int = 3

    def __post_init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._pending = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save_checkpoint(self.path, step, host_tree, extra)
                self._gc()
            except BaseException as e:   # raised by the next save()/wait()
                self._err = e
            finally:
                with self._lock:
                    self._pending -= 1

    def _gc(self):
        steps = sorted(Path(self.path).glob("step_*"))
        for old in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(old, ignore_errors=True)

    def save(self, step: int, tree: Tree,
             extra: Optional[Dict[str, Any]] = None):
        """Copy ``tree`` to host memory here; write it on the thread."""
        if self._err:
            err, self._err = self._err, None
            raise err
        host_tree = [(key, _host(leaf)) for key, leaf in _flatten(tree)]
        host_tree = _unflatten(tree, iter(arr for _, arr in host_tree))
        with self._lock:
            self._pending += 1
        self._q.put((step, host_tree, extra))

    def wait(self, timeout: float = 60.0):
        """Block until every queued save is written."""
        t0 = time.time()
        while True:
            with self._lock:
                if self._pending == 0:
                    break
            if time.time() - t0 > timeout:
                raise TimeoutError("checkpoint writer stuck")
            time.sleep(0.01)
        if self._err:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)
