"""Sharded, atomic, async checkpointing (the port of
``src/repro/ft/checkpoint.py``, whose directory layout and manifest it
keeps, so either package reads the other's checkpoints).

Layout (one directory per step):
    <dir>/step_000123/
        manifest.json          # step, leaf keys, dtypes, n_processes, meta
        shard_00000.npz        # this process's param/opt leaves a0, a1, ...
        data_state.json        # pipeline cursor
    <dir>/LATEST               # atomic pointer file

Leaves are the tree's tensors in sorted-key order (``repro_torch.tree``),
their keys the "/"-joined paths.  A bf16 tensor goes to disk through its
bits, as a uint16 array with dtype "bfloat16" in the manifest (what
``convert.py`` reads back).

Atomicity: write into ``step_N.tmp/``, then ``os.replace`` the directory
name and rewrite LATEST.  A crash mid-save leaves only a .tmp directory
that restore ignores.  Async: ``save_async`` copies the tensors to host
memory at once (the train step updates params and optimizer state in
place, so the snapshot must not alias them) and writes them in a daemon
thread, so the train loop never blocks on storage.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..tree import leaves, leaves_with_paths, tree_map, unflatten


def _snapshot(tree):
    """The tree's tensors copied to host memory."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _encode(t: torch.Tensor):
    """npz-safe encoding; bfloat16 round-trips via a uint16 view."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _decode(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    a = np.array(a)                     # a contiguous copy, 0-d kept
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(directory: str, step: int, tree: Any,
                    data_state: Optional[dict] = None,
                    process_index: int = 0, meta: Optional[dict] = None):
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.isdir(final):
        return final            # this step is already durably saved
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = leaves_with_paths(tree)
    keys = ["/".join(str(k) for k in path) for path, _ in flat]
    enc = [_encode(v) for _, v in flat]
    arrays = {f"a{i}": a for i, (a, _) in enumerate(enc)}
    np.savez(os.path.join(tmp, f"shard_{process_index:05d}.npz"), **arrays)
    manifest = {"step": step, "keys": keys, "n_processes": 1,
                "dtypes": [d for _, d in enc], "meta": meta or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if data_state is not None:
        with open(os.path.join(tmp, "data_state.json"), "w") as f:
            json.dump(data_state, f)
    os.replace(tmp, final)                      # atomic publish
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def restore_latest(directory: str, example_tree: Any,
                   process_index: int = 0):
    """Returns (step, tree, data_state) or None when no checkpoint.  Each
    restored tensor lands on the device of the example tree's leaf in its
    place (a leaf that is no tensor: the CPU)."""
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    if not os.path.isdir(path):                  # stale pointer
        steps = sorted(d for d in os.listdir(directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        if not steps:
            return None
        path = os.path.join(directory, steps[-1])
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shard = np.load(os.path.join(path, f"shard_{process_index:05d}.npz"))
    dtypes = manifest.get("dtypes") or [None] * len(manifest["keys"])
    like = leaves(example_tree)
    if len(like) != len(manifest["keys"]):
        raise ValueError(f"checkpoint {path} holds {len(manifest['keys'])} "
                         f"leaves, the example tree {len(like)}")
    vals = [_decode(shard[f"a{i}"], dtypes[i]).to(
                getattr(like[i], "device", "cpu"))
            for i in range(len(manifest["keys"]))]
    tree = unflatten(example_tree, vals)
    data_state = None
    ds = os.path.join(path, "data_state.json")
    if os.path.exists(ds):
        with open(ds) as f:
            data_state = json.load(f)
    return manifest["step"], tree, data_state


class CheckpointManager:
    """Async save + retention.  ``save_async`` returns once the tensors
    are on the host."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Any,
                   data_state: Optional[dict] = None, meta=None):
        self.wait()
        host = _snapshot(tree)

        def work():
            save_checkpoint(self.directory, step, host, data_state,
                            meta=meta)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step, tree, data_state=None, meta=None):
        self.wait()   # an in-flight async save may target the same step
        save_checkpoint(self.directory, step, tree, data_state, meta=meta)
        self._gc()

    def restore(self, example_tree):
        self.wait()
        return restore_latest(self.directory, example_tree)

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)
