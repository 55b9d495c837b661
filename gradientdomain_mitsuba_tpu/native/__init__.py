"""Native (C++) runtime components, bound via ctypes.

The compute path is XLA/Pallas device code; these host-side components
replace the reference's performance-critical C++ where Python would
bottleneck scene preparation (SURVEY.md §3.8):

  bvh_builder.cpp — binned-SAH BVH construction (skdtree.cpp analog)

Libraries build lazily with g++ on first use and are cached next to the
sources (``_<name>.so``, ignored by git).  Every native component has a
pure-Python fallback, so the framework works without a toolchain; a
failed build prints one warning to stderr before falling back.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS = {}


def _build_lib(name: str):
    src = os.path.join(_HERE, name + ".cpp")
    out = os.path.join(_HERE, "_" + name + ".so")
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        cmd = ["g++", "-O3", "-shared", "-fPIC",
               "-std=c++17", src, "-o", out + ".tmp"]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(out + ".tmp", out)
    return ctypes.CDLL(out)


def get_lib(name: str):
    """Load (building if needed) a native library; None on failure."""
    with _LOCK:
        if name not in _LIBS:
            try:
                _LIBS[name] = _build_lib(name)
            except Exception as e:
                detail = getattr(e, "stderr", b"") or b""
                if isinstance(detail, bytes):
                    detail = detail.decode(errors="replace")
                print(f"warning: native {name} unavailable ({e!r}"
                      f"{': ' + detail.strip() if detail else ''}); "
                      "using the pure-Python fallback", file=sys.stderr)
                _LIBS[name] = None
        return _LIBS[name]
