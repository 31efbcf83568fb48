"""nvcc build and ctypes loader for the hand-written kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o _build/<name>-<digest>.so csrc/<name>.cu

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions compute them, so the card's kernels can be held
against their plain versions to a few ulp; fast math is never enabled.
The library name carries a digest of the sources and flags, so an edited
kernel is rebuilt and a stale library is never loaded. ``build`` starts
one nvcc per source at once and waits for all of them.

Kernels take pointers and the stream as ``c_void_p`` and return
``cudaGetLastError()`` after the launch; ``check`` raises on nonzero.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("trilerp_sample", "minmax_sample", "rk3_substep", "dmc_substep",
           "jacobi_diffuse", "rbgs_smooth", "masked_rbgs_smooth",
           "volume_prefilter", "vol9_fixup", "pullback_sample",
           "bilerp_sample", "p2g_splat")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
# the C functions by (library, symbol), their argument types declared once
_FUNCS: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha1()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names=SOURCES, verbose: bool = False) -> dict[str, str]:
    """Compile every missing library in `names`, all nvcc processes at
    once. Returns nvcc's output per name (register/spill report when
    `verbose`). Raises with nvcc's errors if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists() and not verbose:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes):
    """The C function `symbol` of library `name` (built if missing) with
    its argument types declared; it returns a cudaError_t as int. The
    library is loaded and the function bound and declared on the first
    call only; later calls return it from a cache."""
    fn = _FUNCS.get((name, symbol))
    if fn is not None:
        return fn
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _FUNCS[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> int:
    """The current stream of t's card, as the int a c_void_p argument
    takes (PyTorch's raw-stream query: building a torch.cuda.Stream costs
    the host microseconds a launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


_SAME_CARD = contextlib.nullcontext()


def current(t):
    """A context that makes t's card the current one, and does nothing
    where it already is (entering torch.cuda.device costs the host
    microseconds a launch)."""
    import torch

    if t.get_device() == torch.cuda.current_device():
        return _SAME_CARD
    return torch.cuda.device(t.device)


def on_card(t, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.is_cuda:
        return True
    raise ValueError(f"{name}: unsupported device {t.device}")


def require(t, name: str, shape=None, ndim=None, dtype=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (float32
    when None) and `shape`."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
