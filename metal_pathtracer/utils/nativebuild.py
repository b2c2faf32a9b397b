"""Build the native helpers on demand.

The .so binaries are not committed (prebuilt -march=native binaries are
non-portable and unverifiable); they are compiled from native/*.cpp and
native/*.c on first use, on the machine that runs them. A stamp beside the
libraries records a hash of those sources (and of build.sh), and a library
whose stamp does not match is rebuilt, so what runs is always built from
the committed sources. Pure-python fallbacks exist for every native
component (numpy SAH builder; the oracle backend degrades to the jax-CPU
backend with a warning).
"""

from __future__ import annotations

import fcntl
import glob
import hashlib
import os
import subprocess
import threading

_NATIVE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "native"))
_STAMP = "build.stamp"
_lock = threading.Lock()
_attempted = False


def native_dir() -> str:
    return _NATIVE_DIR


def lib_path(name: str) -> str:
    return os.path.join(_NATIVE_DIR, name)


def source_hash(native: str = _NATIVE_DIR) -> str:
    """sha256 over the native sources and the build script."""
    h = hashlib.sha256()
    paths = sorted(glob.glob(os.path.join(native, "*.cpp"))
                   + glob.glob(os.path.join(native, "*.c"))
                   + glob.glob(os.path.join(native, "*", "*.c"))
                   + glob.glob(os.path.join(native, "*", "*.h"))
                   + [os.path.join(native, "build.sh")])
    for p in paths:
        if os.path.exists(p):
            h.update(os.path.relpath(p, native).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def _stamp_matches() -> bool:
    try:
        with open(os.path.join(_NATIVE_DIR, _STAMP)) as fh:
            return fh.read().strip() == source_hash()
    except OSError:
        return False


def ensure_built(name: str) -> str | None:
    """Return the path to native/<name>, (re)building via build.sh when it
    is missing or older than the sources.

    A build is attempted at most once per process; returns None when the
    library is absent and cannot be built (no compiler / build failure).
    """
    global _attempted
    path = lib_path(name)
    if os.path.exists(path) and _stamp_matches():
        return path
    # one build at a time across threads and processes (test workers)
    with _lock, open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path) and _stamp_matches():
            return path
        if _attempted:
            return None
        _attempted = True
        digest = source_hash()
        try:
            subprocess.run(["bash", os.path.join(_NATIVE_DIR, "build.sh")],
                           cwd=_NATIVE_DIR, check=True, capture_output=True,
                           timeout=600)
        except Exception:
            return None
        with open(os.path.join(_NATIVE_DIR, _STAMP), "w") as fh:
            fh.write(digest + "\n")
    return path if os.path.exists(path) else None
