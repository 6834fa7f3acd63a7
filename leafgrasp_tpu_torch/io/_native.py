"""Loader of the repo's native C++ libraries (``native/*.cpp``) for the
port's frame bus and frame log.

The sources live in the repo's ``native/`` directory, which this
package only reads: a library is compiled from ``native/<name>.cpp``
into ``build/native/`` (named by a hash of the source, so an edited
source rebuilds) and loaded from there. Nothing is ever written into
``native/``. Without a C++ compiler the load fails and the callers use
their pure-Python implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

__all__ = ["load_native", "NATIVE_DIR", "BUILD_DIR"]

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
_CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def _build(name: str) -> Path:
    src = NATIVE_DIR / f"{name}.cpp"
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(src)], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return out


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """The loaded ``lib<name>`` (built on first use), or None when it
    cannot be built or loaded (no compiler, no source, a failed load)."""
    with _LOCK:
        if name not in _LIBS:
            try:
                _LIBS[name] = ctypes.CDLL(str(_build(name)))
            except (OSError, RuntimeError, subprocess.CalledProcessError):
                _LIBS[name] = None
        return _LIBS[name]
