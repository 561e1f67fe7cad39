"""`ops._build.load` from several threads at once, with the compiler faked.

The job server's executor threads and the score plane's dispatcher may
reach a kernel for the first time together. `load` holds a module lock
around build-and-bind, so nvcc runs once for each library however many
threads ask, and every thread gets the one bound library. Here `_nvcc` is
a script that logs its call and writes the `-o` file, and `ctypes.CDLL`
and `bind` are stubs: nothing is compiled or loaded.
"""

import os
import stat
import sys
import threading

import pytest

from avenir_tpu_torch.ops import _build

_BIND = _build.bind

_FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
time.sleep(0.2)
with open({log!r}, "a") as fh:
    fh.write(out + "\\n")
with open(out, "wb") as fh:
    fh.write(b"lib")
"""


@pytest.fixture
def faked(tmp_path, monkeypatch):
    """(log path, loaded-object record) with the compiler and the loader
    replaced and the build root under `tmp_path`."""
    log = str(tmp_path / "nvcc.log")
    script = tmp_path / "nvcc"
    script.write_text(_FAKE_NVCC.format(python=sys.executable, log=log))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    opened = []

    def cdll(path):
        opened.append(path)
        return object()

    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "bind", lambda lib, name: lib)
    return log, opened


@pytest.mark.parametrize("names", [["knn_topk"] * 8,
                                   ["knn_topk", "subseq_support"] * 4])
def test_eight_threads_compile_each_library_once(faked, names):
    log, opened = faked
    gate = threading.Barrier(len(names))
    got, errors = [None] * len(names), []

    def run(i):
        try:
            gate.wait(10)
            got[i] = _build.load(names[i])
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(names))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    with open(log) as fh:
        outs = fh.read().split()
    # one build_all: one nvcc for each library, none twice
    built = sorted(os.path.basename(p).split(".")[1][3:] for p in outs)
    assert built == sorted(_build.LIBRARIES)
    # the temporary name carries the process and the building thread
    for p in outs:
        parts = os.path.basename(p).split(".")
        assert parts[2] == str(os.getpid()) and parts[3].isdigit()
    # one CDLL a library, and every thread holds that one object
    assert len(opened) == len(set(names))
    for name in set(names):
        assert {id(g) for g, n in zip(got, names) if n == name} == {
            id(_build._loaded[name])}
    # a later load is served from the cache: no compiler, no CDLL
    _build.load(names[0])
    with open(log) as fh:
        assert len(fh.read().split()) == len(_build.LIBRARIES)
    assert len(opened) == len(set(names))


class _Entries:
    """A loaded library whose every C entry is a plain object."""

    def __getattr__(self, entry):
        return type(entry, (), {})()


def test_builds_and_binds_are_counted_where_they_happen(faked, monkeypatch):
    """`_build.counts` adds one an nvcc run and one a bind, whoever asks:
    `load` builds every library once and binds each once, and a bind made
    past `load`'s cache still counts."""
    log, _opened = faked
    monkeypatch.setattr(_build, "bind", _BIND)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _Entries())
    monkeypatch.setattr(_build, "counts", {"builds": 0, "binds": 0})
    for _ in range(3):
        _build.load("knn_topk")
    assert _build.counts == {"builds": len(_build.LIBRARIES), "binds": 1}
    _build.load("subseq_support")
    assert _build.counts == {"builds": len(_build.LIBRARIES), "binds": 2}
    _build.bind(_Entries(), "subseq_support")
    assert _build.counts["binds"] == 3
    with open(log) as fh:
        assert len(fh.read().split()) == len(_build.LIBRARIES)
