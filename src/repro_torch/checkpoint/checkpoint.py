"""Checkpoints with async writes, keep-k GC and crash-consistent commits
(twin of ``repro.checkpoint.checkpoint``, on the same on-disk layout, so
either package restores what the other wrote).

Layout (one directory per step)::

    <dir>/step_000000123/
        manifest.json        # step, extras, each leaf's shape and true dtype
        arrays.npz           # the flattened leaves
        COMMITTED            # written last: readers ignore dirs without it

Leaves are named as the reference's ``jax.tree_util`` walk names them: dict
keys in sorted order, a ``NamedTuple`` field as ``.name``, a sequence item
by index, joined with ``/`` (``params/embed/table``, ``opt/.step``,
``opt/.m/blocks/pos0/...``, ``ef/.residual/...``).  bf16 leaves are stored
as their ``uint16`` bits and the manifest keeps the true dtype.
``save_async`` copies every leaf to the host before it returns and writes
the files on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.apply import _named_leaves, map_named

__all__ = ["save", "save_async", "restore", "latest_step", "gc_keep"]

_COMMIT = "COMMITTED"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


def _host(leaf):
    """A tensor or array as (a numpy copy on the host, true dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _flatten(tree: Any) -> dict:
    """name -> (host array, true dtype) of every leaf, in the reference's
    order."""
    return {name: _host(leaf) for name, leaf in _named_leaves(tree)}


def _write(directory: str, step: int, leaves: dict, extras: Optional[dict]) -> str:
    d = _step_dir(directory, step)
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **{k: v[0] for k, v in leaves.items()})
    manifest = {
        "step": step,
        "extras": extras or {},
        "leaves": {k: {"shape": list(v[0].shape), "dtype": v[1]}
                   for k, v in leaves.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.replace(tmp, d)
    return d


def save(directory: str, step: int, tree: Any, extras: Optional[dict] = None) -> str:
    """Write ``tree`` as step ``step``'s directory, committed last."""
    return _write(directory, step, _flatten(tree), extras)


class _Writer(threading.Thread):
    """The background write; ``join`` re-raises its error, so a failed write
    is not lost with the thread."""

    def __init__(self, *args):
        super().__init__(daemon=True)
        self._args, self._error = args, None

    def run(self) -> None:
        try:
            _write(*self._args)
        except Exception as e:   # handed to the joining thread
            self._error = e

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self._error is not None:
            raise self._error


def save_async(directory: str, step: int, tree: Any,
               extras: Optional[dict] = None) -> threading.Thread:
    """Device -> host copy now; the disk write on a background thread, whose
    ``join`` re-raises an error of the write."""
    t = _Writer(directory, step, _flatten(tree), extras)
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_") and not name.endswith(".tmp")
             and os.path.exists(os.path.join(directory, name, _COMMIT))]
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, true_dtype: str) -> torch.Tensor:
    if true_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, template: Any, step: Optional[int] = None):
    """Restore into ``template``'s structure: each leaf's shape is checked
    (``ValueError`` on a mismatch), cast to the template leaf's dtype and
    placed on its device.  Returns ``(tree, step, extras)``; raises
    ``FileNotFoundError`` when nothing is committed (a cold start for
    ``runtime.fault_tolerance``)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = _step_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        def leaf(name, like):
            t = _from_host(data[name], manifest["leaves"][name]["dtype"])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{name}: checkpoint {tuple(t.shape)} vs "
                                 f"template {tuple(like.shape)}")
            return t.to(device=like.device, dtype=like.dtype)
        tree = map_named(leaf, template)
    return tree, manifest["step"], manifest["extras"]


def gc_keep(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints, and every
    uncommitted or temporary directory."""
    if not os.path.isdir(directory):
        return
    committed = []
    for name in sorted(os.listdir(directory)):
        full = os.path.join(directory, name)
        if name.endswith(".tmp"):
            shutil.rmtree(full, ignore_errors=True)
        elif name.startswith("step_"):
            if os.path.exists(os.path.join(full, _COMMIT)):
                committed.append(full)
            else:
                shutil.rmtree(full, ignore_errors=True)
    for full in committed[:-keep] if keep else committed:
        shutil.rmtree(full, ignore_errors=True)
