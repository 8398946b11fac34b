"""Atomic, keep-N, optionally-async checkpointing, the port of the
reference's ``repro.checkpoint.manager``, in its on-disk format.

Format: one directory per step, one ``.npy`` per tree leaf (named by its
key, :mod:`repro_torch.tree`'s path with ``/`` -> ``__``), plus a
``manifest.json`` recording keys, shapes, dtypes and user metadata;
bfloat16 leaves are stored as their uint16 bits under their real dtype's
name.  A checkpoint written by either package loads in the other.
Writes go to ``<dir>.tmp`` and are renamed into place only when
complete, so a killed run never leaves a half checkpoint that restore
would pick up.

Restore is structure-driven: the caller passes a target tree (tensors,
or ``meta`` tensors such as a train step's ``StepSpecs``) and each leaf
is filled by key, cast to the target's dtype and put on its device (a
``meta`` target's on ``device``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import flatten_with_path, unflatten

PREFIX = "ckpt_"


def _host(t) -> np.ndarray:
    """A leaf as a numpy array of its own bits (bfloat16 as uint16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def _snapshot(t):
    """A host copy of a leaf, in memory of its own: a later in-place
    update of ``t`` does not reach it."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True)
    return np.array(t)


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return str(np.asarray(t).dtype)


def save_pytree(tree, directory: str, *, metadata: Optional[dict] = None):
    """Atomic write of ``tree`` (tensors or numpy arrays) to
    ``directory``."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"leaves": {}, "metadata": metadata or {}}
    for key, leaf in flatten_with_path(tree):
        arr = _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)


def _tensor(arr: np.ndarray, dtype_name: str, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """The file's array (of its recorded dtype) as a tensor on ``device``
    of ``dtype``, in memory of its own: torch's allocation, never the
    array's."""
    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
        if dtype_name == "bfloat16" else torch.from_numpy(arr)
    out = t.to(device, dtype)
    return out.clone() if out is t else out


def load_pytree(target, directory: str, *, device=None):
    """Fill ``target``'s structure from ``directory``.  A leaf goes to the
    target leaf's device, or to ``device`` (CUDA unless the caller asks
    for the CPU) where the target is a ``meta`` tensor, cast to the
    target's dtype; a shape that differs from the target's raises."""
    manifest = load_manifest(directory)
    out = []
    dev = None
    for key, leaf in flatten_with_path(target):
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint {directory} missing leaf {key!r}")
        entry = manifest["leaves"][key]
        arr = np.load(os.path.join(directory, entry["file"]))
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != {want}")
        where = leaf.device
        if where.type == "meta":
            dev = dev or resolve_device(device)
            where = dev
        out.append(_tensor(arr, entry["dtype"], where, leaf.dtype))
    return unflatten(target, out)


class CheckpointManager:
    """keep-N rotation + latest-step discovery + async save."""

    def __init__(self, root: str, *, keep_n: int = 3,
                 async_save: bool = False):
        self.root = root
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    # -- discovery ---------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = re.fullmatch(PREFIX + r"(\d+)", name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"{PREFIX}{step}")

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, *, metadata: Optional[dict] = None,
             block: bool = False):
        """Every leaf is copied to host memory before this returns (a
        consistent snapshot: a donated train step may update the same
        tensors next); the file writes go to a background thread when
        ``async_save``."""
        flat = flatten_with_path(tree)
        host = unflatten(tree, [_snapshot(t) for _, t in flat])
        meta = dict(metadata or {})
        meta["step"] = step
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_in_background, args=(step, host, meta),
                daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host, meta)

    def _save_and_gc(self, step, host, meta):
        save_pytree(host, self.path(step), metadata=meta)
        for old in self.steps()[: -self.keep_n]:
            shutil.rmtree(self.path(old), ignore_errors=True)

    def _save_in_background(self, step, host, meta):
        try:
            self._save_and_gc(step, host, meta)
        except Exception as e:          # raised again by wait()
            self._error = e

    def wait(self):
        """Joins the background write; raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ---------------------------------------------------------------
    def restore(self, target, *, step: Optional[int] = None, device=None):
        """Returns (tree, metadata) or (None, None) when no checkpoint."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = self.path(step)
        return (load_pytree(target, d, device=device),
                load_manifest(d)["metadata"])


__all__ = ["CheckpointManager", "save_pytree", "load_pytree",
           "load_manifest", "PREFIX"]
