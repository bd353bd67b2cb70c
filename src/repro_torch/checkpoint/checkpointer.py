"""Checkpointing with atomic commits, retention and async save, in the JAX
package's on-disk format (``checkpoint/checkpointer.py``), so a checkpoint
written by either package restores in the other.

Format: one directory per step containing

    manifest.json          tree structure, shapes, dtypes, step metadata
    <leaf-path>.npy        one file per leaf (the full tensor)

Leaf paths are the reference's: dict keys sorted, ``_i`` for the i-th
item of a tuple or list, joined by ``/`` (``__`` in file names).
bfloat16, which numpy cannot hold, is stored as its raw ``uint16`` bits
with ``"bfloat16"`` recorded in the manifest (the bits come from
``tensor.view(torch.int16)``; no ``ml_dtypes``).  The reference's float8
leaves are not read (nothing here writes them).  Writes go to
``<dir>.tmp`` and are committed with an atomic rename, so a crash
mid-save never corrupts the latest checkpoint.  Saves can run on a background thread
(``async_save=True``); ``wait()`` joins.  A save first copies every leaf
to the host, so the caller may update its tensors in place at once.

``restore`` places the leaves on one device, ``cuda`` unless the caller
names another, where the reference takes shardings; resharding across
cards waits for the mesh layer.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..devices import resolve_device

LOG = logging.getLogger("repro_torch.resilience")

# bfloat16, which numpy cannot hold, is stored as its raw bits, a uint16
# view (the reference's), and read back through an int16 view
BF16 = "bfloat16"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (f"_{i}",))
    elif tree is None:
        yield prefix + ("_none",), None
    else:
        yield prefix, tree


def _unflatten_into(skeleton, leaves: dict):
    def rec(node, prefix):
        if isinstance(node, dict):
            return {k: rec(v, prefix + (str(k),))
                    for k, v in sorted(node.items())}
        if isinstance(node, (tuple, list)):
            out = [rec(v, prefix + (f"_{i}",)) for i, v in enumerate(node)]
            return type(node)(out)
        if node is None:
            return None
        return leaves["/".join(prefix)]
    return rec(skeleton, ())


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A copy of ``leaf`` on the host as numpy, and its logical dtype."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16).copy(), BF16
    arr = t.cpu().numpy().copy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, logical: str,
               device: torch.device) -> torch.Tensor:
    if logical == BF16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif str(arr.dtype) == logical:
        t = torch.from_numpy(np.array(arr))  # a copy; 0-d stays 0-d
    else:
        raise ValueError(f"checkpoint: a leaf stored as {arr.dtype} for "
                         f"{logical} is not a format this package reads")
    return t.to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None,
             async_save: bool = False) -> None:
        # copy to the host *before* backgrounding (snapshot semantics)
        leaves = []
        for path, leaf in _flatten(tree):
            if leaf is None:
                continue
            leaves.append(("/".join(path), *_to_host(leaf)))
        if async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves, extra or {})

    def _write(self, step: int, leaves, extra: dict) -> None:
        try:
            final = os.path.join(self.directory, f"step_{step:09d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "time": time.time(), "extra": extra,
                        "leaves": {}}
            for name, arr, logical in leaves:
                fn = name.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"][name] = {
                    "file": fn, "shape": list(arr.shape),
                    "dtype": logical}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)        # atomic commit
            self._gc()
        except BaseException as e:  # surfaced by wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        """Committed steps with a READABLE manifest.  A step directory
        whose manifest is missing or unparsable is skipped with a warning,
        so ``latest_step``/``restore`` land on the newest intact
        checkpoint instead of failing."""
        out = []
        for d in os.listdir(self.directory):
            if not d.startswith("step_") or d.endswith(".tmp"):
                continue
            try:
                step = int(d.split("_")[1])
                with open(os.path.join(self.directory, d,
                                       "manifest.json")) as f:
                    json.load(f)
            except (OSError, ValueError):
                LOG.warning("checkpoint %s has no readable manifest — "
                            "skipping it",
                            os.path.join(self.directory, d))
                continue
            out.append(step)
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, skeleton: Any, step: int | None = None,
                device: str | torch.device | None = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``skeleton``, every leaf a tensor
        on ``device`` (``cuda`` unless the caller names another) with the
        dtype it was saved in.  Returns (tree, manifest)."""
        dev = resolve_device(device)
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {name: _from_host(np.load(os.path.join(d, meta["file"])),
                                   meta["dtype"], dev)
                  for name, meta in manifest["leaves"].items()}
        return _unflatten_into(skeleton, leaves), manifest
