"""Checkpoints: step-atomic, resumable, device-agnostic; the port of
``repro.train.checkpoint``, with its on-disk layout.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json`` (``step``,
``time``, ``dtypes`` and the caller's metadata), written to
``step_<N>.tmp`` and renamed, so a crashed save is never mistaken for a
complete one.  Keys are the tree's paths joined by ``/`` (dict keys, list
indices), as the reference's.  bf16 leaves are stored as a ``uint16`` view
and read back as ``torch.bfloat16`` without ``ml_dtypes``.  Tensors are
copied to the host when :meth:`CheckpointManager.save` is called; an
asynchronous save writes them on a thread while training goes on, and
:meth:`~CheckpointManager.wait` re-raises what that thread raised.

A state holding DTensors (training on a mesh) is saved as the full global
arrays, as the reference stores them: each leaf is gathered in turn (a
collective, so every rank calls ``save`` and ``wait`` at the same points),
rank 0 keeps the host copy and commits the step directory, and the other
ranks wait for it at a barrier in ``wait``.  Such a checkpoint restores
onto any mesh, or onto none.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.models.layers import tree_paths
from repro_torch.models.sharding import distribute, is_dtensor, place

_NP_NAMES = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.bfloat16: "bfloat16",
             torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
             torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}


def _host(x):
    """A leaf as a host array of its own (never a view of live storage); a
    DTensor gathered whole."""
    if is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), _NP_NAMES[x.dtype]
    x = np.array(x)
    return x, str(x.dtype)


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy(order="C"))


def _unflatten_into(tree_like, leaf, device, prefix: str = "",
                    shardings=None):
    """``tree_like``'s structure with each leaf read by ``leaf(path)``."""
    if isinstance(tree_like, dict):
        return {k: _unflatten_into(v, leaf, device, f"{prefix}{k}/",
                                   _child(shardings, k))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return [_unflatten_into(v, leaf, device, f"{prefix}{i}/",
                                _child(shardings, i))
                for i, v in enumerate(tree_like)]
    t = leaf(prefix[:-1])
    if shardings is not None:           # straight onto its placement
        dtype = tree_like.dtype if isinstance(tree_like, torch.Tensor) \
            else t.dtype
        return distribute(t.to(device=shardings.mesh.device_type, dtype=dtype),
                          shardings)
    if is_dtensor(tree_like):           # onto the like-leaf's placement
        mesh = tree_like.device_mesh
        return place(t.to(device=mesh.device_type, dtype=tree_like.dtype),
                     mesh, tree_like.placements)
    if isinstance(tree_like, torch.Tensor):
        dev = tree_like.device if device is None else device
        return t.to(device=dev, dtype=tree_like.dtype)
    return t


def _child(shardings, key):
    """The subtree of ``shardings`` under ``key`` (None: no placement)."""
    if shardings is None or not isinstance(shardings, (dict, list, tuple)):
        return shardings
    return shardings[key]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False      # a sharded save the other ranks wait for

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, metadata: Optional[dict] = None,
             blocking: bool = True):
        """Write ``state`` (a tree of tensors) as step ``step``: once the
        previous save has finished, copied to the host and written, now or
        (``blocking=False``) on a thread.  A state with DTensor leaves is
        gathered leaf by leaf and written by rank 0 alone."""
        self.wait()          # one host copy at a time
        leaves = tree_paths(state)
        sharded = any(is_dtensor(v) for v in leaves.values())
        writer = not sharded or dist.get_rank() == 0
        host = {}
        for k, v in leaves.items():
            h = _host(v)     # every rank takes part in a DTensor's gather
            if writer:
                host[k] = h
        self._barrier = sharded
        if writer and blocking:
            self._write(step, host, metadata or {})
        elif writer:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, metadata or {}))
            self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Wait for an asynchronous save (after a sharded one, every rank
        waits for rank 0's); raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_async(self, step, host, metadata):
        try:
            self._write(step, host, metadata)
        except Exception as e:   # handed to wait(), which re-raises it
            self._error = e

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               metadata: dict):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in host.items()})
        manifest = {"step": step, "time": time.time(),
                    "dtypes": {k: d for k, (_, d) in host.items()}, **metadata}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for n in os.listdir(self.directory):
            if n.startswith("step_") and not n.endswith(".tmp"):
                out.append(int(n.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None,
                device=None, shardings=None) -> Tuple[Any, dict]:
        """A new state of ``state_like``'s structure and dtypes from step
        ``step`` (default the latest), every tensor on ``device`` (default:
        the like-leaf's device; ``device="cpu"`` restores a card-written
        checkpoint on the host).  ``shardings``: a tree of
        ``repro_torch.models.sharding.NamedSharding`` leaves (None for an
        unplaced leaf) matching ``state_like``, or one for every leaf; each
        leaf then lands straight on its placement as a DTensor, every rank
        reading the same file and keeping its shard (how a checkpoint
        written on mesh A, or without one, lands on mesh B).  Without
        ``shardings`` a DTensor like-leaf's value lands on its placement.
        Leaves are read one at a time.  Returns (state, manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        dev = None if device is None else resolve_device(device)
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as raw:
            return _unflatten_into(
                state_like, lambda k: _tensor(raw[k], manifest["dtypes"][k]),
                dev, shardings=shardings), manifest
