"""`tests/torch_reference_native.py`: the guard that makes the JAX
package's native CSV route ready in a test process before the port is
held against it. A lost build race (`_build_failed` set, or a corrupt
library on disk) is undone, so `native_available()` holds again."""

import os
import shutil

import torch_reference_native as guard
from avenir_tpu.native import ingest as reference


def test_guard_made_the_native_route_ready_at_import():
    assert guard.STATUS.available, guard.STATUS.reason
    assert reference.native_available()
    assert os.path.exists(guard.LOCK_PATH)


def test_guard_undoes_a_failed_build_flag(monkeypatch):
    monkeypatch.setattr(reference, "_build_failed", True)
    monkeypatch.setattr(reference, "_lib", None)
    assert not reference.native_available()
    status = guard.ensure()
    assert status.available and status.reason is None
    assert not status.built             # the library on disk was sound
    assert reference.native_available()
    assert not reference._build_failed


def test_guard_rebuilds_a_corrupt_library(tmp_path, monkeypatch):
    src = tmp_path / "csv_ingest.cpp"
    lib = tmp_path / "libcsv_ingest.so"
    shutil.copyfile(reference._SRC, src)
    lib.write_bytes(b"\x7fELF not a shared object")   # newer than src
    monkeypatch.setattr(reference, "_SRC", str(src))
    monkeypatch.setattr(reference, "_LIB", str(lib))
    monkeypatch.setattr(reference, "_build_failed", True)
    monkeypatch.setattr(reference, "_lib", None)
    status = guard.ensure()
    assert status.available and status.built
    assert reference.native_available() and not reference._build_failed
    assert reference._lib.csv_count_rows(b"a,b\nc,d\n", 8) == 2
    assert sorted(os.listdir(tmp_path)) == ["csv_ingest.cpp",
                                            "libcsv_ingest.so"]
