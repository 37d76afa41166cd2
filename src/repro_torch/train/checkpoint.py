"""Checkpointing: atomic, async-capable, restorable onto any device.

Port of ``repro.train.checkpoint``, in JAX's layout:

  <dir>/step_<N>/
    manifest.json       -- step, leaf paths, shapes, dtypes
    shard_0.npz         -- flat leaf arrays (one host)
  <dir>/LATEST          -- atomic pointer file

A tree is nested dicts and lists whose leaves are tensors, numpy arrays or
Python numbers; a leaf's key is its path joined by "/" (dict keys sorted,
list indices), as JAX's ``tree_flatten_with_path`` names them, so either
package restores the other's checkpoints.  bfloat16 tensors are stored as
float32 (numpy has no bfloat16; the values are exact) and cast back to the
template's dtype on restore; JAX's bfloat16 arrays (2-byte values numpy
reads as raw bytes) are read as bfloat16.

* Atomicity: writes go to step_<N>.tmp/ then os.rename -> step_<N>, then
  LATEST is updated via write-to-tmp + rename (POSIX atomic); ``keep``
  bounds the steps kept, the oldest removed.
* Async: save() copies the tree to the host at once and can write it in a
  background thread (``wait()`` joins it).  Every save waits for the
  write before it, so an async save of step N and the final save of the
  same step do not race.
* Restore: into the structure of a template, each tensor onto ``device``
  (default the template leaf's own device) in the template's dtype: the
  one-card form of JAX's elastic remesh, which places the unsharded
  arrays with new specs.  A shape that differs from the template's is
  refused.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _flatten(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, x in enumerate(tree):
            out.update(_flatten(x, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(template, flat: dict, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], flat, f"{prefix}{k}/")
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, flat, f"{prefix}{i}/")
                              for i, x in enumerate(template))
    return flat[prefix[:-1]]


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save ----

    def save(self, step: int, tree, async_: bool = False) -> None:
        flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self.wait()  # one write at a time (JAX's sync save does not wait)
        if async_:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict) -> None:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        ptr_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(str(step))
        os.rename(ptr_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore ----

    def all_steps(self) -> list[int]:
        return [int(name.split("_")[1]) for name in os.listdir(self.dir)
                if name.startswith("step_") and not name.endswith(".tmp")]

    def latest_step(self) -> int | None:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip())

    def restore(self, template, step: int | None = None, device=None):
        """(tree in the structure of ``template``, step), or (None, None)
        when there is no checkpoint.  Tensor leaves go to ``device`` (or
        the template leaf's device) in the template leaf's dtype; numbers
        come back as the template's Python type."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step}")
        flat = {}
        with np.load(os.path.join(path, "shard_0.npz")) as data:
            for key, tmpl in _flatten(template).items():
                arr = data[key]
                shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else ()
                if tuple(arr.shape) != shape:
                    raise ValueError(f"{key}: checkpoint {arr.shape} != "
                                     f"template {shape}")
                if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                    # JAX's bfloat16 (ml_dtypes), read as raw 2-byte
                    # values: widened to float32, exactly
                    arr = torch.from_numpy(arr.view(np.int16).copy()).view(
                        torch.bfloat16).float().numpy()
                if isinstance(tmpl, torch.Tensor):
                    flat[key] = torch.from_numpy(arr).to(
                        device=device or tmpl.device, dtype=tmpl.dtype)
                elif isinstance(tmpl, np.ndarray):
                    flat[key] = arr.astype(tmpl.dtype)
                else:
                    flat[key] = type(tmpl)(arr.item())
        return _unflatten(template, flat), step
