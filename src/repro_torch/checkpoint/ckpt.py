"""Checkpointing: sharded npz + manifest, async save thread, atomic commit.

Layout per step:
    <dir>/step_<n>/shard_<host>.npz     flat {path -> np.ndarray}
    <dir>/step_<n>/manifest.json        tree structure + dtypes + data state
    <dir>/step_<n>/COMMITTED            written last (atomic visibility)

The JAX package's ``repro.checkpoint.ckpt`` with the same layout, so a
checkpoint written by either package restores in the other. npz cannot
hold bf16, so a bf16 tensor is stored as its raw ``uint16`` bits with
``"bfloat16"`` as its dtype in the manifest (the JAX package's convention)
and read back with ``view(torch.bfloat16)``. ``restore`` returns tensors
on the device asked for; restoring onto another mesh waits for the mesh
slice (``ROADMAP.md``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# npz's own integer and float kinds; anything else is stored as raw bits
_RAW_BITS = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict) and node and all(
                k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def to_numpy(x) -> tuple:
    """(array, logical dtype name) of a tensor or array, copied to the
    host: a bf16 tensor as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(x)
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, state: dict, *, host: int = 0,
         extra: Optional[dict] = None, keep: int = 3) -> str:
    """Synchronous sharded save with atomic COMMITTED marker."""
    return _save_flat(ckpt_dir, step, _host_copy(state), host=host,
                      extra=extra, keep=keep)


def _host_copy(state) -> dict:
    """{path: (host array, logical dtype)} of a state tree."""
    return {k: to_numpy(v) for k, v in _flatten(state).items()}


def _save_flat(ckpt_dir: str, step: int, flat: dict, *, host: int,
               extra: Optional[dict], keep: int) -> str:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    stored = {}
    for k, (a, logical) in flat.items():
        stored[k] = a if a.dtype.kind in "biufc" and str(a.dtype) == logical \
            else a.view(_RAW_BITS[a.dtype.itemsize])
    np.savez(os.path.join(tmp, f"shard_{host}.npz"), **stored)
    manifest = {
        "step": step,
        "paths": {k: {"dtype": logical, "shape": list(a.shape)}
                  for k, (a, logical) in flat.items()},
        "extra": extra or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    _gc(ckpt_dir, keep)
    return d


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(p for p in os.listdir(ckpt_dir) if p.startswith("step_")
                   and os.path.exists(os.path.join(ckpt_dir, p, "COMMITTED")))
    for p in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, p), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(p.split("_")[1]) for p in os.listdir(ckpt_dir)
             if p.startswith("step_")
             and os.path.exists(os.path.join(ckpt_dir, p, "COMMITTED"))]
    return max(steps) if steps else None


def _tensor(a: np.ndarray, logical: str) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy, 0-d kept
    if logical == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if logical != str(a.dtype):
        raise TypeError(f"checkpoint entry stored as {a.dtype}, manifest "
                        f"says {logical}")
    return torch.from_numpy(a)


def restore(ckpt_dir: str, step: Optional[int] = None, *, host: int = 0,
            device: DeviceLike = None) -> tuple:
    """Returns (state tree of tensors on ``device``, extra). ``device`` is
    ``cuda:0`` by default (raising without a card), ``"cpu"`` on
    request."""
    dev = resolve_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, f"shard_{host}.npz")) as z:
        flat = {}
        for k in z.files:
            a = z[k]
            want = manifest["paths"].get(k, {}).get("dtype", str(a.dtype))
            flat[k] = _tensor(a, want).to(dev)
    return _unflatten(flat), manifest.get("extra", {})


class AsyncCheckpointer:
    """Non-blocking saves on a worker thread; at most one in flight —
    a newer snapshot supersedes a queued older one. ``submit`` copies the
    state to the host before it returns, so the in-place updates of the
    next steps do not reach the snapshot."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._pending = None
        self._lock = threading.Lock()
        self._kick = threading.Event()
        self._stop = False
        self.saved_steps: list = []
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def submit(self, step: int, state, extra: Optional[dict] = None):
        host_state = _host_copy(state)   # snapshot off the device
        with self._lock:
            self._pending = (step, host_state, extra)
        self._kick.set()

    def _worker(self):
        while True:
            self._kick.wait()
            self._kick.clear()
            if self._stop:
                return
            with self._lock:
                item, self._pending = self._pending, None
            if item is None:
                continue
            step, flat, extra = item
            _save_flat(self.dir, step, flat, host=0, extra=extra,
                       keep=self.keep)
            self.saved_steps.append(step)

    def wait_idle(self, timeout: float = 60.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            with self._lock:
                if self._pending is None and not self._kick.is_set():
                    return
            time.sleep(0.01)

    def close(self):
        self.wait_idle()
        self._stop = True
        self._kick.set()
        self._t.join(timeout=5.0)


__all__ = ["save", "restore", "latest_step", "to_numpy", "AsyncCheckpointer"]
