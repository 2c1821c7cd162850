"""Native (C++) host components, loaded via ctypes.

The compute path is JAX/XLA; the host runtime around it (the startup-hot
geometry preparation) is native C++ here, compiled on demand with the
system toolchain. Everything has a pure-Python fallback — set
``PT_TPU_NO_NATIVE=1`` to force it.

The library is built only from the committed ``.cpp`` sources, on the
machine that loads it: it lives under ``_build/<key>/`` (gitignored), where
``key`` hashes the sources, the compiler command and the host
(``platform.system()``/``platform.machine()``). A build for other sources or
another host therefore has another path and is never loaded. The flags name
no ``-march``, so a build runs on any CPU of its architecture.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["bvh_builder.cpp", "obj_parser.cpp"]
_CXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
_BUILD_ROOT = os.path.join(_DIR, "_build")

_lock = threading.Lock()
_lib = None
_tried = False


def build_key() -> str:
    """Hash of the sources, compiler command and host the library is for."""
    h = hashlib.sha256()
    for part in (*_CXX, platform.system(), platform.machine()):
        h.update(part.encode() + b"\0")
    for name in _SOURCES:
        h.update(name.encode() + b"\0")
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path(key: str | None = None) -> str:
    """Where the library for ``key`` (default: this host's) is built."""
    return os.path.join(_BUILD_ROOT, key or build_key(), "libptnative.so")


def _compile(path: str) -> bool:
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    # Build to a private name, then rename: concurrent builders (test
    # workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [*_CXX, "-o", tmp, *(os.path.join(_DIR, s) for s in _SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except Exception as e:  # toolchain missing/failed -> Python fallback
        print(f"[pathtracer_tpu.native] build failed, using Python fallback: {e}",
              file=sys.stderr)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """The loaded native library, or None (fallbacks engage)."""
    global _lib, _tried
    if os.environ.get("PT_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) and not _compile(path):
            return None
        try:
            _lib = ctypes.CDLL(path)
        except OSError as e:
            print(f"[pathtracer_tpu.native] load failed: {e}", file=sys.stderr)
            _lib = None
        return _lib
