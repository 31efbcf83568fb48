#!/usr/bin/env python3
"""Time design variants of the port's redesigned kernels on one GPU.

    python3 scripts/kernel_variants.py            # 256^3 shapes
    python3 scripts/kernel_variants.py --n 64     # a quick check

Each variant is the kernel's source in ``gpufluidsimulation_tpu_torch/csrc``
with a few textual edits (block shape, rows per thread, the division, the
offset arithmetic). This is the one place where such alternatives are
built: the port ships only the chosen design. Every variant is built with
nvcc for sm_90a with the port's flags and ``-Xptxas -v`` (registers and
spills are printed), run on the inputs of ``chip_smoke.py``'s kernel
phase, held against the plain PyTorch version (its max abs error is
printed; the shipped design must show 0) and timed with CUDA events.
``jacobi_diffuse`` variants are timed per 20-sweep solve at 1, 2, 4 and 8
sweeps a launch (the shipped source builds 2 and 1; every variant here
adds 4 and 8), on a smooth field, an all-zero field and one zero on half
its k range. Builds go to the port's build directory
(``gpufluidsimulation_tpu_torch/_build/variants/``).
Needs a GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "gpufluidsimulation_tpu_torch" / "csrc"

_TRILERP_BLOCK = "constexpr int kBlockK = 32, kBlockJ = 2, kBlockI = 2;"
_TRILERP_KERNEL = ("template <bool kDual>\n__global__ void "
                   "trilerp_sample_kernel(")
TRILERP = {
    "shipped (32x2x2 block)": [],
    "32x1x1 block": [(_TRILERP_BLOCK, "constexpr int kBlockK = 32, "
                      "kBlockJ = 1, kBlockI = 1;")],
    "32x4x1 block": [(_TRILERP_BLOCK, "constexpr int kBlockK = 32, "
                      "kBlockJ = 4, kBlockI = 1;")],
    "32x4x2 block (256 threads)": [(_TRILERP_BLOCK, "constexpr int kBlockK "
                                    "= 32, kBlockJ = 4, kBlockI = 2;")],
    "offsets added to the pointer one by one": [
        ("__ldg(f + (ax.node[a] + ay.node[b] + az.node[c]))",
         "__ldg(f + ax.node[a] + ay.node[b] + az.node[c])")],
    "at most 64 registers": [
        (_TRILERP_KERNEL, "template <bool kDual>\n__global__ void "
         "__launch_bounds__(128, 8) trilerp_sample_kernel(")],
}

# every Jacobi variant also builds 4 and 8 sweeps a launch, beside the
# shipped kSweeps and 1, so that a 20-sweep solve can be timed at each
_JACOBI_ONE = ("  if (sweeps == 1) return launch<1>(xp, bp, nx, ny, nz, coef, "
               "denom, op, s);\n")
_JACOBI_MORE = "".join(
    _JACOBI_ONE.replace("== 1", f"== {s}").replace("<1>", f"<{s}>")
    for s in (1, 4, 8))

JACOBI = {
    "shipped (32x32 region, 2 rows a thread)": [],
    "1 row a thread (32 warps)": [("constexpr int kWarpsJ = 16;",
                                   "constexpr int kWarpsJ = 32;")],
    "4 rows a thread (8 warps)": [("constexpr int kWarpsJ = 16;",
                                   "constexpr int kWarpsJ = 8;")],
    "nvcc's full division (a / denom)": [
        ("divide(bq[t - 1][q] + coef * nb, denom, rcp)",
         "(bq[t - 1][q] + coef * nb) / denom")],
}


def build(out_dir, tag, source, edits):
    """nvcc the edited source; returns the library and the ptxas lines."""
    from gpufluidsimulation_tpu_torch.ops import _build

    text = (CSRC / f"{source}.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{tag}: edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    cu = out_dir / f"{tag}.cu"
    cu.write_text(text)
    lib = out_dir / f"{tag}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
           str(CSRC), "-o", str(lib), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"{tag}: nvcc failed\n{res.stdout}{res.stderr}")
    ptxas = [line.strip().replace("ptxas info    : ", "")
             for line in (res.stdout + res.stderr).splitlines()
             if "registers" in line or "spill" in line]
    return ctypes.CDLL(str(lib)), ptxas


def trilerp_variants(n, out_dir):
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    h = g.h

    def positions(kind):
        px, py, pz = g.node_coords(kind, device=dev)
        return [(p + cs.smooth(px.shape, rng, 2.0 * h, dev)).contiguous()
                for p in (px, py, pz)]

    fu = cs.smooth(g.shape_u, rng, 0.06, dev)[None].contiguous()
    fc = torch.stack([cs.smooth(g.shape_c, rng, 1.0, dev),
                      cs.smooth(g.shape_c, rng, 50.0, dev)]).contiguous()
    pu, pc = positions("u"), positions("c")
    cases = [("C=1 dual", fu, pu, g.OFF_U, True),
             ("C=2 dual", fc, pc, g.OFF_C, True),
             ("C=1 plain", fu, pu, g.OFF_U, False)]
    wants = [interp_fast.trilerp_sample_plain(f, *p, h, (o,) * len(f), d)
             for _, f, p, o, d in cases]
    F, I, P, LL = ctypes.c_float, ctypes.c_int, ctypes.c_void_p, \
        ctypes.c_longlong
    for i, (name, edits) in enumerate(TRILERP.items()):
        lib, ptxas = build(out_dir, f"trilerp_{i}", "trilerp_sample", edits)
        fn = lib.gfs_trilerp_sample
        fn.argtypes = [P, I, I, I, I, P, P, P, LL, I, I, F,
                       ctypes.POINTER(F), I, P, P]
        fn.restype = I
        cs.log(f"[trilerp_sample] {name}: " + "; ".join(ptxas))
        for (label, f, p, off, dual), want in zip(cases, wants):
            C = f.shape[0]
            out = torch.empty((C,) + tuple(p[0].shape), device=dev)
            offs = (F * (3 * C))(*[float(x) for x in off * C])

            def run():
                err = fn(_build.ptr(f), C, *f.shape[1:],
                         *[_build.ptr(q) for q in p], p[0].numel(),
                         p[0].shape[-2], p[0].shape[-1], float(h), offs,
                         int(dual), _build.ptr(out), _build.stream(f))
                _build.check(err, name)

            run()
            err = float((out - want).abs().max())
            ms = cs.cuda_time(run, 30)
            cs.log(f"[trilerp_sample] {name}: {label} {ms:.4f} ms, "
                   f"max_abs_err {err:.3e}")


def jacobi_variants(n, out_dir):
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build
    from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    coef = 1e-6 * (8.0 / n) / (g.h * g.h)        # the main path's
    coef_f, denom_f = sk._coefs(coef)
    smooth = cs.smooth(g.shape_u, rng, 0.06, dev)
    half = smooth.clone()
    half[:, :, : half.shape[2] // 2] = 0.0
    fields = [("smooth", smooth), ("zero", torch.zeros_like(smooth)),
              ("half zero", half)]
    wants = [sk.jacobi_diffuse_plain(x, x, 20, coef) for _, x in fields]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for i, (name, edits) in enumerate(JACOBI.items()):
        lib, ptxas = build(out_dir, f"jacobi_{i}", "jacobi_diffuse",
                           [*edits, (_JACOBI_ONE, _JACOBI_MORE)])
        fn = lib.gfs_jacobi_diffuse
        fn.argtypes = [P, P, I, I, I, F, F, I, P, P]
        fn.restype = I
        regs = [line.split(",")[0] for line in ptxas if "registers" in line]
        cs.log(f"[jacobi_diffuse] {name}: {regs} (sweeps a launch in the "
               "order ptxas builds them)")
        for (label, x), want in zip(fields, wants):
            times = []
            for per in (1, 2, 4, 8):
                bufs = [torch.empty_like(x), torch.empty_like(x)]

                def run():
                    src = x
                    for k, s in enumerate(sk.sweep_chunks(20, per)):
                        err = fn(_build.ptr(src), _build.ptr(x), *x.shape,
                                 coef_f, denom_f, s,
                                 _build.ptr(bufs[k % 2]), _build.stream(x))
                        _build.check(err, name)
                        src = bufs[k % 2]
                    return src

                err = float((run() - want).abs().max())
                times.append(f"{per} a launch {cs.cuda_time(run, 10):.4f} "
                             f"ms (max_abs_err {err:.3e})")
            cs.log(f"[jacobi_diffuse] {name}: {label} field, 20-sweep "
                   "solve: " + ", ".join(times))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--out", default=str(ROOT / "gpufluidsimulation_tpu_torch"
                                        / "_build" / "variants"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no GPU", file=sys.stderr)
        return 2
    out_dir = Path(args.out)
    os.makedirs(out_dir, exist_ok=True)
    cs.log(cs.nvidia_smi_line())
    trilerp_variants(args.n, out_dir)
    jacobi_variants(args.n, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
