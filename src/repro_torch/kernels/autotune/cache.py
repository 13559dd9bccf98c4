"""On-disk persistence of tuned launch configs.

A copy of the JAX package's ``repro/kernels/autotune/cache.py`` with the
port's own default directory, ``~/.cache/repro_torch/autotune``, and file
names (``torch_<device>.json``), so the two packages never share a file, not
even when ``REPRO_AUTOTUNE_CACHE`` points both at one directory.

One small JSON file per device kind, keyed by the tuner's chain key
(``tuner.chain_key``).  The file carries its schema version and the device
kind it was tuned on; a mismatch on either invalidates the whole file.
Writes are atomic (a temporary file, then a rename), so concurrent processes
never read a torn file.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
from typing import Dict, Optional

CACHE_VERSION = 1


def default_cache_dir() -> str:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE", "")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune")


def _slug(device_kind: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in device_kind.lower())


class TuningCache:
    """Load and store tuned configs (plain dicts) for one device kind.

    Thread-safe: the lazy first load and every change hold one lock, and
    ``load`` returns a copy rather than the live dict.
    """

    def __init__(self, device_kind: str, path: Optional[str] = None):
        self.device_kind = device_kind
        self.path = path or os.path.join(default_cache_dir(),
                                         f"torch_{_slug(device_kind)}.json")
        self._lock = threading.Lock()
        self._entries: Optional[Dict[str, dict]] = None  # guarded-by: _lock

    def load(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._load_locked())

    def _load_locked(self) -> Dict[str, dict]:  # requires-lock: _lock
        if self._entries is not None:
            return self._entries
        self._entries = {}
        # a missing or corrupt file is an empty cache
        with contextlib.suppress(OSError, ValueError):
            with open(self.path) as f:
                blob = json.load(f)
            if (blob.get("version") == CACHE_VERSION
                    and blob.get("device_kind") == self.device_kind
                    and isinstance(blob.get("entries"), dict)):
                self._entries = dict(blob["entries"])
        return self._entries

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            return self._load_locked().get(key)

    def put(self, key: str, config: dict) -> None:
        with self._lock:
            entries = self._load_locked()
            entries[key] = config
            self._write(dict(entries))

    def _write(self, entries: Dict[str, dict]) -> None:
        blob = {"version": CACHE_VERSION, "device_kind": self.device_kind,
                "entries": entries}
        d = os.path.dirname(self.path)
        # a read-only file system keeps the in-memory view
        with contextlib.suppress(OSError):
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)

    def clear(self) -> None:
        with self._lock:
            self._entries = {}
        with contextlib.suppress(OSError):
            os.unlink(self.path)
