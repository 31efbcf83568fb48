"""Native IO runtime: the CPython extension ``gfs_io`` (``gfs_io.c`` in this
package, a copy of the JAX package's), built with ``cc`` on first use.

``load()`` compiles ``gfs_io.c`` once per source digest into
``gpufluidsimulation_tpu_torch/_build/`` and imports the library as
``gpufluidsimulation_tpu_torch.native.gfs_io`` (its last name component
stays ``gfs_io``: the library's entry point is ``PyInit_gfs_io``). There
is no fallback: a failed build raises with the compiler's message.
Nothing is built at import time.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "gfs_io.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
MODULE = __name__ + ".gfs_io"
CFLAGS = ("-O3", "-shared", "-fPIC")

_MODULE = None


def _command(out) -> list:
    inc = sysconfig.get_paths()["include"]
    return ["cc", *CFLAGS, f"-I{inc}", str(SOURCE), "-o", str(out),
            "-lpthread"]


def lib_path() -> Path:
    """The library for this source, these flags and this interpreter."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(_command("")).encode())
    h.update(suffix.encode())
    return BUILD_DIR / f"gfs_io-{h.hexdigest()[:12]}{suffix}"


def build() -> Path:
    """Compile the library unless it exists; raise on a failed build."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(_command(tmp), capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {SOURCE} failed (exit {proc.returncode}):\n"
                + proc.stdout + proc.stderr)
        os.replace(tmp, out)        # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load():
    """The ``gfs_io`` extension module, built first if need be."""
    global _MODULE
    if _MODULE is None:
        path = str(build())
        loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
        spec = importlib.util.spec_from_file_location(MODULE, path,
                                                      loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        sys.modules[MODULE] = mod
        _MODULE = mod
    return _MODULE


def loaded():
    """The extension if ``load()`` has run in this process, else None."""
    return _MODULE
