"""The port's compile caching (``tpudp_torch/utils/compile_cache.py``)
against the JAX package's, and the build key of ``ops/_build.py`` and
``native`` with stub compilers.

``ProgramCache`` gives JAX's build order, counters and length on the
same seeded sequence of gets.  ``enable_persistent_cache`` honours
``TPUDP_COMPILE_CACHE`` (a path, unset, ``0``), returns None without a
card unless forced and falls back with a warning from a directory it
cannot write.  The build key: an ``nvcc`` and a ``g++`` on ``PATH`` that
write their output file and log their calls (nothing is compiled or
loaded) show that a second build into one directory runs no compiler,
that another ``--version``, flag or edited header names another library,
and that a failing compiler leaves no partial file.
"""

import os
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpudp.utils.compile_cache import ProgramCache as JaxProgramCache
from tpudp_torch import native
from tpudp_torch.ops import _build
from tpudp_torch.utils import compile_cache
from tpudp_torch.utils.compile_cache import (ProgramCache,
                                             enable_persistent_cache)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    """No directory chosen and no compiler version read yet; the counts
    of this test alone."""
    monkeypatch.setattr(compile_cache, "_chosen", None)
    monkeypatch.setattr(compile_cache, "counts",
                        {"built": compile_cache.collections.Counter(),
                         "found": compile_cache.collections.Counter()})
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    compile_cache.compiler_version.cache_clear()
    yield
    compile_cache.compiler_version.cache_clear()


# -- ProgramCache, held against JAX's ------------------------------------

class Params:
    """A weight tree stand-in: equal configs, distinct identities."""

    def __init__(self, tag):
        self.tag = tag


def _run_gets(cache_cls, max_entries, seed):
    built = []
    cache = cache_cls(lambda cfg, p: built.append((cfg, p.tag)) or
                      (cfg, p.tag), max_entries=max_entries)
    weights = {tag: Params(tag) for tag in "abcd"}
    twin = Params("a")  # a's config and tag, another identity
    keys = [("small", "a"), ("small", "b"), ("medium", "c"), ("small", "d"),
            ("medium", "a"), ("small", "twin")]
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.integers(0, len(keys), size=40):
        cfg, tag = keys[i]
        params = twin if tag == "twin" else weights[tag]
        out.append(cache.get(cfg, params))
    return built, out, cache.builds, cache.hits, len(cache)


@pytest.mark.parametrize("max_entries", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_program_cache_matches_jax(max_entries, seed):
    got = _run_gets(ProgramCache, max_entries, seed)
    want = _run_gets(JaxProgramCache, max_entries, seed)
    assert got == want
    assert got[2] + got[3] == 40 and got[4] <= max_entries


def test_program_cache_identity_not_equality():
    """An equal config over another params object builds anew, in both."""
    for cls in (ProgramCache, JaxProgramCache):
        cache = cls(lambda cfg, p: object())
        a, b = Params("a"), Params("a")
        first = cache.get("cfg", a)
        assert cache.get("cfg", a) is first
        assert cache.get("cfg", b) is not first
        assert (cache.builds, cache.hits, len(cache)) == (2, 1, 2)
        cache.clear()
        assert len(cache) == 0


def test_program_cache_rejects_no_entries():
    for cls in (ProgramCache, JaxProgramCache):
        with pytest.raises(ValueError, match="max_entries"):
            cls(lambda cfg, p: None, max_entries=0)


# -- enable_persistent_cache ----------------------------------------------

def test_env_path_relocates(monkeypatch, tmp_path):
    d = tmp_path / "cache"
    monkeypatch.setenv(compile_cache.ENV, str(d))
    assert enable_persistent_cache(force=True) == str(d)
    assert d.is_dir() and compile_cache.build_dir() == d
    # An explicit path wins over the variable; a repeated call keeps it.
    other = tmp_path / "other"
    assert enable_persistent_cache(str(other), force=True) == str(other)
    assert enable_persistent_cache(str(other), force=True) == str(other)


def test_unset_keeps_the_checkout_default():
    assert enable_persistent_cache(force=True) == str(
        compile_cache.DEFAULT_DIR)
    assert compile_cache.DEFAULT_DIR.name == "_build"
    assert compile_cache.DEFAULT_DIR.parent.name == "tpudp_torch"


def test_builds_follow_the_variable_without_a_call(monkeypatch, tmp_path):
    """A child or spawned rank inherits the setting: build_dir() reads
    the variable where this process made no call."""
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "inherited"))
    assert compile_cache.build_dir() == tmp_path / "inherited"


def test_zero_is_a_temporary_directory_removed_at_exit(tmp_path):
    code = ("import os\n"
            "from tpudp_torch.utils import compile_cache as c\n"
            "d = c.enable_persistent_cache(force=True)\n"
            "assert os.path.isdir(d) and d != str(c.DEFAULT_DIR)\n"
            "assert c.enable_persistent_cache(force=True) == d\n"
            "open(os.path.join(d, 'libx.so'), 'w').close()\n"
            "print(d)\n")
    env = dict(os.environ, TPUDP_COMPILE_CACHE="0", TMPDIR=str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    d = out.stdout.strip()
    assert d.startswith(str(tmp_path)) and not os.path.exists(d)


def test_none_without_a_card_unless_forced(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert enable_persistent_cache(str(tmp_path / "c")) is None
    assert not (tmp_path / "c").exists()
    assert enable_persistent_cache(str(tmp_path / "c"), force=True) == str(
        tmp_path / "c")


def test_unwritable_directory_warns_and_falls_back(tmp_path, capsys):
    # A regular file as the parent: no directory can be made, for root
    # too.
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    assert enable_persistent_cache(str(blocker / "cache"), force=True) == \
        str(compile_cache.DEFAULT_DIR)
    err = capsys.readouterr().err
    assert "[compile_cache] warning" in err and str(blocker) in err


# -- the build key, with stub compilers -----------------------------------

STUB = """#!/bin/sh
dir=$(dirname "$0")
if [ "$1" = "--version" ]; then cat "$dir/version"; exit 0; fi
echo "$@" >> "$dir/calls.log"
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "built by a stub" > "$out"
if [ -f "$dir/fail" ]; then echo "stub: error: no" >&2; exit 1; fi
"""


class Stub:
    """``nvcc`` and ``g++`` on ``PATH``, logging their compile calls."""

    def __init__(self, bindir):
        self.dir = bindir
        bindir.mkdir()
        for name in ("nvcc", "g++"):
            path = bindir / name
            path.write_text(STUB)
            path.chmod(path.stat().st_mode | stat.S_IXUSR)
        self.version("stub compiler 1.0")

    def version(self, text):
        (self.dir / "version").write_text(text + "\n")
        compile_cache.compiler_version.cache_clear()

    def fail(self, on=True):
        (self.dir / "fail").unlink(missing_ok=True)
        if on:
            (self.dir / "fail").write_text("")

    def calls(self):
        log = self.dir / "calls.log"
        return log.read_text().splitlines() if log.exists() else []


@pytest.fixture()
def stub(tmp_path, monkeypatch):
    s = Stub(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{s.dir}{os.pathsep}{os.environ['PATH']}")
    assert shutil.which("nvcc") == str(s.dir / "nvcc")
    monkeypatch.setattr(_build, "_loaded", {})
    enable_persistent_cache(str(tmp_path / "cache"), force=True)
    return s


SOURCES = sorted(set(map(_build.source, _build.SIGNATURES)))


def test_second_build_runs_no_compiler(stub, tmp_path):
    _build.build()
    assert len(stub.calls()) == len(SOURCES) == 6
    libs = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert libs == sorted(_build.library_path(s).name for s in SOURCES)
    assert sum(compile_cache.counts["built"].values()) == 6
    _build.build()
    _build.build(("paged_decode_int8",))
    assert len(stub.calls()) == 6
    assert sum(compile_cache.counts["found"].values()) == 7
    lib = native.Library(cxx="g++")
    first = lib.ensure_built()
    assert first.parent == tmp_path / "cache"
    assert lib.ensure_built() == first
    assert len(stub.calls()) == 7
    assert compile_cache.counts["built"][first.name] == 1
    assert compile_cache.counts["found"][first.name] == 1


def test_compiler_version_flags_and_headers_key_the_name(stub, tmp_path,
                                                         monkeypatch):
    names = {s: _build.library_path(s).name for s in SOURCES}
    aug = native.Library(cxx="g++").path().name
    stub.version("stub compiler 1.1")
    assert all(_build.library_path(s).name != names[s] for s in SOURCES)
    assert native.Library(cxx="g++").path().name != aug
    stub.version("stub compiler 1.0")
    assert {s: _build.library_path(s).name for s in SOURCES} == names
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert all(_build.library_path(s).name != names[s] for s in SOURCES)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-1])
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert {s: _build.library_path(s).name for s in SOURCES} == names
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "// edited\n")
    assert all(_build.library_path(s).name != names[s] for s in SOURCES)


def test_failing_compiler_leaves_no_partial_file(stub, tmp_path):
    stub.fail()
    with pytest.raises(_build.BuildError, match="stub: error"):
        _build.build(("paged_tree",))
    with pytest.raises(RuntimeError, match="stub: error"):
        native.Library(cxx="g++").ensure_built()
    assert list((tmp_path / "cache").iterdir()) == []
    assert not compile_cache.counts["built"]
    stub.fail(False)
    _build.build(("paged_tree",))
    assert [p.name for p in (tmp_path / "cache").iterdir()] == [
        _build.library_path("paged_tree").name]


def test_missing_compiler_is_a_build_error(stub, monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build(("paged_decode",))
