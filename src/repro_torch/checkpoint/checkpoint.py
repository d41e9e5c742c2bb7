"""Checkpointing: save/restore with atomic publish and async writes.

The counterpart of ``repro.checkpoint.checkpoint``, with its on-disk
layout, so that a directory either package writes is restored by the
other:  <dir>/step_<n>.tmp/...  ->  rename  ->  <dir>/step_<n>/
  index.json          tree structure, shapes, dtypes
  <flat-key>.npy      one file per leaf (bfloat16 stored exactly as fp32)
  COMMITTED           marker written last; restore ignores uncommitted dirs

Flat keys are the reference's: sorted dict keys and tuple indices joined
by "/", ``<key>@none`` for a None leaf (the state's ``master`` when there
is no master copy).

Async: ``CheckpointManager.save_async`` copies the tree to host memory on
the caller's thread (device to host), then writes it on a background
thread so that the train step resumes at once. ``restore`` puts each leaf
on the device of the matching leaf of ``like``, in the dtype it was saved
in.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_MARKER = "COMMITTED"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix.rstrip("/") + "@none"] = None
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_like(like: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten_like(like[k], flat, f"{prefix}{k}/")
                for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten_like(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(like)]
        return type(like)(*vals) if hasattr(like, "_fields") else \
            type(like)(vals)
    if like is None:
        return None
    return flat[prefix.rstrip("/")]


def _host(val: Any) -> Any:
    """A leaf as a host array of its own: a tensor's bfloat16 stays a
    (CPU) tensor, since numpy has no bfloat16 of its own. A CPU tensor is
    copied too, since the optimizer updates its leaves in place while an
    async save is still writing."""
    if isinstance(val, torch.Tensor):
        t = val.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return val


def _stored(val: Any):
    """(numpy array to write, the dtype name to record)."""
    if isinstance(val, torch.Tensor):          # a bfloat16 host tensor
        if val.dtype != torch.bfloat16:
            return val.numpy(), str(val.numpy().dtype)
        return val.float().numpy(), "bfloat16"
    arr = np.asarray(val)
    if arr.dtype.name == "bfloat16":           # the reference's arrays
        return arr.astype(np.float32), "bfloat16"
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic save. Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = {}
    for key, val in _flatten(tree).items():
        if key.endswith("@none"):
            index[key] = {"none": True}
            continue
        arr, dtype = _stored(_host(val))
        fname = key.replace("/", ".") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        index[key] = {"file": fname, "shape": list(arr.shape),
                      "dtype": dtype}
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump({"step": step, "leaves": index}, f)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MARKER)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, step: int, like: Any) -> Any:
    """Load a checkpoint into the structure of ``like`` (tensors, e.g. on
    the ``meta`` device): each leaf lands on its ``like`` leaf's device,
    in the dtype it was saved in."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, _MARKER)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)["leaves"]
    targets = _flatten(like)
    flat = {}
    for key, meta in index.items():
        if meta.get("none"):
            continue
        t = torch.from_numpy(np.load(os.path.join(path, meta["file"])))
        if meta.get("dtype") == "bfloat16":
            t = t.to(torch.bfloat16)
        target = targets.get(key)
        flat[key] = (t.to(target.device) if isinstance(target, torch.Tensor)
                     else t)
    return _unflatten_like(like, flat)


class CheckpointManager:
    """Async checkpointing with bounded retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: List[int] = []

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        host_tree = _unflatten_like(
            tree, {k: _host(v) for k, v in _flatten(tree).items()})

        def work():
            save(self.directory, step, host_tree)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        self.saved_steps.append(step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
