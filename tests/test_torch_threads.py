"""The port's module-level caches under two threads.

A release server reaches them from its worker thread, from the thread that
registers tenants and from its HTTP thread: the kernel library loader
(``kernels/_build.py``), the autotuner's registry (``kernels/autotune/
tuner.py``) and the factors kept on the device (``kernels/kron_matvec/
_layout.py``).  Each test drives two or more threads at one of them.  No
nvcc is needed: the build's compiler and loader are replaced by stand-ins.
"""
import os
import sys
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autotune import registry_snapshot, tuner
from repro_torch.kernels.kron_matvec import _layout


def _run(n, fn):
    """Start ``n`` threads of ``fn(i)`` behind one barrier; returns the
    exceptions they raised."""
    barrier, errors = threading.Barrier(n), []

    def body(i):
        barrier.wait()
        try:
            fn(i)
        except Exception as exc:        # noqa: BLE001 — surfaced by caller
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_load_builds_and_loads_a_kernel_once_from_two_threads(monkeypatch):
    """Two first calls of ``load`` at once build the library once and share
    one handle."""
    built, handles = [], []
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_stale", lambda name: not built)

    def fake_build(names, force=False):
        time.sleep(0.05)                # widen the window a race would use
        built.append(tuple(names))
        return {}

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    errors = _run(2, lambda i: handles.append(_build.load("fused_chain")))
    assert not errors
    assert built == [("fused_chain",)]
    assert len(handles) == 2 and handles[0] is handles[1]


def test_build_names_its_temporary_file_per_thread(tmp_path, monkeypatch):
    """Two threads building one kernel write two temporary files (process
    and thread id in the name), and the library is whole after both."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    outs = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            outs.append((out, threading.get_ident()))
            with open(out, "w") as fh:
                fh.write("lib")
            self.returncode = 0

        def communicate(self):
            return "ptxas info: 0 registers", None

    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    errors = _run(2, lambda i: _build.build(["k"], force=True))
    assert not errors
    assert len({o for o, _ in outs}) == 2
    for out, ident in outs:
        assert f".{os.getpid()}.{ident}.tmp" in out
        assert not os.path.exists(out)          # renamed into place
    assert (tmp_path / "build" / "libk.so").read_text() == "lib"


def test_registry_snapshot_while_a_worker_inserts_keys(monkeypatch):
    """``registry_snapshot`` (a /stats scrape) while another thread
    registers thousands of new chain keys never fails, and sees only whole
    entries."""
    monkeypatch.setattr(tuner, "_REGISTRY", {})
    cfg = tuner.TunedConfig(rows=4, smem_budget=1024)
    for k in range(1000):
        tuner._register(f"seed|b={k}", cfg)
    snaps = []

    def work(i):
        if i == 0:
            for k in range(8000):
                tuner._register(f"cpu|d=5,5|b={k}", cfg)
        else:
            for _ in range(10):
                snaps.append(registry_snapshot("cpu"))

    errors = _run(2, work)
    assert not errors, errors[:1]
    assert len(tuner._REGISTRY) == 9000
    assert all(e == cfg.as_dict() for s in snaps
               for e in s["entries"].values())
    tuner.reset_registry()
    assert registry_snapshot("cpu")["entries"] == {}


def test_device_factor_cache_from_several_threads(monkeypatch):
    """Four threads asking for the same factors at once, past the cache's
    byte limit: each content is counted once, so the byte count stays equal
    to the keys held and within the limit, and every tensor equals its
    array.  (Unlocked, two threads that miss on one content both insert it
    and count its bytes twice.)"""
    monkeypatch.setattr(_layout, "_DEVICE_FACTORS", OrderedDict())
    monkeypatch.setattr(_layout, "_device_factor_bytes", 0)
    monkeypatch.setattr(_layout, "_DEVICE_FACTORS_MAX_BYTES", 64 * 256)
    cpu = torch.device("cpu")

    def work(i):
        for k in range(3000):
            a = np.full(64, k, dtype=np.float32)
            t = _layout.device_factor(a, torch.float32, cpu)
            assert torch.equal(t, torch.from_numpy(a))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # interleave the threads finely
    try:
        errors = _run(4, work)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors[:1]
    held = sum(len(key[-1]) for key in _layout._DEVICE_FACTORS)
    assert _layout._device_factor_bytes == held <= 64 * 256
    _layout.clear_device_factors()
    assert _layout._device_factor_bytes == 0 and not _layout._DEVICE_FACTORS
