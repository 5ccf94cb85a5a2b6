"""Builds the port's native libraries at first use, into ``build/``.

A library's file name carries a hash of its compile command (compiler,
flags) and of its sources' and included headers' bytes, so a change to any of them builds a new
library instead of reusing a stale one. The compiler writes to a private
temporary name that is then renamed into place, so processes that build at
the same time never load a half-written file. A failed build raises with the
compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(REPO_DIR, "build")


def library_path(name: str, sources, compile_cmd, headers=()) -> str:
    """``build/<stem>.<hash><ext>`` for ``name`` = ``<stem><ext>``."""
    h = hashlib.sha256("\0".join(compile_cmd).encode())
    for src in list(sources) + list(headers):
        if not os.path.exists(src):
            raise FileNotFoundError(f"kernel source missing: {src}")
        with open(src, "rb") as f:
            h.update(b"\0" + f.read())
    stem, ext = os.path.splitext(name)
    return os.path.join(BUILD_DIR, f"{stem}.{h.hexdigest()[:16]}{ext}")


def build_and_load(name: str, sources, compile_cmd,
                   headers=()) -> ctypes.CDLL:
    """Compile ``sources`` with ``compile_cmd + [-o, out] + sources`` unless
    a library built by the same command from the same sources and
    ``headers`` (included by the sources, not compiled alone) exists, then
    ``dlopen`` it."""
    out = library_path(name, sources, compile_cmd, headers)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = list(compile_cmd) + ["-o", tmp] + list(sources)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(cmd)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)
