#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full run: 256^3 main path, 8 steps
    python3 chip_smoke.py --n 64     # smaller main path (faster check)
    python3 chip_smoke.py --profile out/profile.txt
                                     # also write a per-kernel time table
                                     # of 2 main-path steps to that file

Phases, each of which fails loudly (non-zero exit, no result line):
 1. print the card's name and power limit; build the four CUDA kernels
    from gpufluidsimulation_tpu_torch/csrc with nvcc, all at once;
 2. at the main path's 256^3 shapes, hold each kernel against its plain
    PyTorch version on the same inputs and time both with CUDA events;
 3. slice parity: 3 steps of the port at 32^3 on the card (kernels)
    against the port on the CPU (plain versions) from one numpy state;
 4. the main path: the 3D BiMocq vortex-collision step as bench.py builds
    it (n^3, dt = 8/n, two recentred emitters), 1 warm-up step and
    `--steps` timed steps, every kernel's launch count reset before and
    read after, rho_max in (0, 10] and every field finite.
Then it prints one JSON line with every kernel's numbers and, last, the
device line. It never imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps, warmup=2):
    """Mean milliseconds of fn() over `reps` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# float32 operations per output element, counted from the kernels' source:
# one clamped trilerp = 3 floor + 3 frac + 7 lerps x 4 (1-f, 2 mul, add)
TRILERP_OPS = 34
# dual: 9 trilerps, 24 corner-coordinate adds, 7 corner adds, 4 blend ops
DUAL_OPS = 9 * TRILERP_OPS + 24 + 7 + 4


def smooth(shape, rng, amp, device):
    """amp * a sum of two random-phase sine modes on the index lattice."""
    import torch

    idx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(2):
        k = rng.uniform(0.5, 3.0, 3) * 2 * np.pi / np.array(shape)
        ph = rng.uniform(0, 2 * np.pi)
        f += np.sin(sum(kk * ii for kk, ii in zip(k, idx)) + ph)
    return torch.from_numpy((amp * f / 2).astype(np.float32)).to(device)


def kernel_phase(n, seed):
    """Phase 2: every kernel against its plain version at n^3 shapes."""
    import torch
    import torch.nn.functional as F

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import interp_fast, stencil_kernels

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    g = Grid3D(n, n, n, 0.2 / n)
    h = g.h
    u = smooth(g.shape_u, rng, 0.06, dev)
    v = smooth(g.shape_v, rng, 0.06, dev)
    w = smooth(g.shape_w, rng, 0.06, dev)
    maxvel = max(float(t.abs().max()) for t in (u, v, w))
    sh = float(np.float32(np.float32(h) / np.float32(maxvel)) / np.float32(h))
    results = {}

    def compare(name, got, want, tol):
        err = float((got - want).abs().max())
        log(f"[kernels] {name}: max_abs_err={err:.3e} tol={tol:.1e}")
        if not np.isfinite(err) or err > tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version: {err} > {tol}")
        return err

    # trilerp_sample: the u pull-back (C=1, dual) at the u lattice, and
    # the rho+T pull-back (C=2, dual) at the cell lattice
    def positions(kind):
        px, py, pz = g.node_coords(kind, device=dev)
        shape = px.shape
        return [(p + smooth(shape, rng, 2.0 * h, dev)).contiguous()
                for p in (px, py, pz)]

    pu = positions("u")
    fu = smooth(g.shape_u, rng, 0.06, dev)[None].contiguous()
    pc = positions("c")
    fc = torch.stack([smooth(g.shape_c, rng, 1.0, dev),
                      smooth(g.shape_c, rng, 50.0, dev)]).contiguous()
    variants = []
    for label, fields, pos, off, dual in (
            ("C=1 dual u", fu, pu, g.OFF_U, True),
            ("C=2 dual c", fc, pc, g.OFF_C, True),
            ("C=1 plain u", fu, pu, g.OFF_U, False)):
        C = fields.shape[0]
        offs = (off,) * C
        got = interp_fast.trilerp_sample(fields, *pos, h, offs, dual=dual)
        want = interp_fast.trilerp_sample_plain(fields, *pos, h, offs, dual)
        # fp32, identical operation order: a few ulp of the largest value
        tol = 1e-6 * max(1.0, float(want.abs().max()))
        err = compare(f"trilerp_sample {label}", got, want, tol)
        k_ms = cuda_time(lambda: interp_fast.trilerp_sample(
            fields, *pos, h, offs, dual=dual), 20)
        p_ms = cuda_time(lambda: interp_fast.trilerp_sample_plain(
            fields, *pos, h, offs, dual), 3, warmup=1)
        n_out = pos[0].numel()
        nbytes = 4 * (fields.numel() + 3 * n_out + C * n_out)
        nops = n_out * (6 + C * (DUAL_OPS if dual else TRILERP_OPS))
        b_ms, b_by = bound_ms(nbytes, nops)
        lib_ms = None
        if C == 1 and not dual:
            # yardstick only: grid_sample computes the same clamped
            # trilinear (border padding, align_corners) on these inputs
            f5 = fields[None]
            dims = fields.shape[1:]
            grid5 = torch.stack([
                (pos[2] / h - off[2]) * (2.0 / (dims[2] - 1)) - 1.0,
                (pos[1] / h - off[1]) * (2.0 / (dims[1] - 1)) - 1.0,
                (pos[0] / h - off[0]) * (2.0 / (dims[0] - 1)) - 1.0,
            ], dim=-1)[None]
            ref = F.grid_sample(f5, grid5, mode="bilinear",
                                padding_mode="border", align_corners=True)
            lib_err = float((ref[0] - got).abs().max())
            log(f"[kernels] grid_sample vs kernel: max_abs_err={lib_err:.3e}")
            lib_ms = cuda_time(lambda: F.grid_sample(
                f5, grid5, mode="bilinear", padding_mode="border",
                align_corners=True), 20)
        variants.append(dict(variant=label, max_abs_err=err, tol=tol,
                             ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms))
        log(f"[kernels] trilerp_sample {label}: {k_ms:.4f} ms (plain "
            f"{p_ms:.3f}, bound {b_ms:.4f} by {b_by}, library {lib_ms})")
    main = variants[0]
    results["trilerp_sample"] = dict(
        main, variants=variants,
        replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:915 (_kernel, "
                  "pallas_call :995) and :1306 (_kernel_multi, pallas_call "
                  ":1421)"))

    # rk3_substep: one forward-map substep from a displaced lattice
    ni, nj, nk = g.shape_c
    pos = torch.stack([torch.div(p, h) for p in positions("c")]).contiguous()
    clamp = (1.0, ni - 1.0, 1.0, nj - 1.0, 1.0, nk - 1.0)
    got = interp_fast.rk3_substep(u, v, w, pos, sh, clamp)
    want = interp_fast.rk3_substep_plain(u, v, w, pos, sh, clamp)
    tol = 1e-6 * max(1.0, float(want.abs().max()))   # grid coords to n
    err = compare("rk3_substep", got, want, tol)
    k_ms = cuda_time(lambda: interp_fast.rk3_substep(u, v, w, pos, sh,
                                                      clamp), 20)
    p_ms = cuda_time(lambda: interp_fast.rk3_substep_plain(u, v, w, pos, sh,
                                                           clamp), 3, 1)
    N = pos[0].numel()
    b_ms, b_by = bound_ms(4 * (6 * N + u.numel() + v.numel() + w.numel()),
                          N * (9 * (TRILERP_OPS + 1) + 12 + 18 + 6))
    results["rk3_substep"] = dict(
        max_abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:1664 "
                  "(_kernel_rk3/_kernel_rk3_twotier :1745, pallas_call "
                  ":1855) and :1870 (_kernel_rk3_ident, pallas_call :2001)"))
    log(f"[kernels] rk3_substep: {k_ms:.4f} ms (plain {p_ms:.3f}, bound "
        f"{b_ms:.4f} by {b_by})")

    # dmc_substep: one backward-map substep of a displaced map
    maps = torch.stack(positions("c")).contiguous()
    thresh = interp_fast.dmc_threshold(h)
    got = interp_fast.dmc_substep(u, v, w, maps, sh, thresh)
    want = interp_fast.dmc_substep_plain(u, v, w, maps, sh, thresh)
    tol = 1e-6 * max(1.0, float(want.abs().max()))   # world coords to 0.2
    err = compare("dmc_substep", got, want, tol)
    k_ms = cuda_time(lambda: interp_fast.dmc_substep(u, v, w, maps, sh,
                                                      thresh), 20)
    p_ms = cuda_time(lambda: interp_fast.dmc_substep_plain(
        u, v, w, maps, sh, thresh), 3, 1)
    N = maps[0].numel()
    b_ms, b_by = bound_ms(4 * (6 * N + u.numel() + v.numel() + w.numel()),
                          N * (12 + 3 * 10 + 3 + 3 * TRILERP_OPS))
    results["dmc_substep"] = dict(
        max_abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:3143 "
                  "(_kernel_dmc, pallas_call :3319)"))
    log(f"[kernels] dmc_substep: {k_ms:.4f} ms (plain {p_ms:.3f}, bound "
        f"{b_ms:.4f} by {b_by})")

    # jacobi_diffuse: the 20 sweeps of one velocity component's solve
    coef = 1e-6 * (8.0 / n) / (h * h)
    x = smooth(g.shape_u, rng, 0.06, dev)
    got = stencil_kernels.jacobi_diffuse(x, x, 20, coef)
    want = stencil_kernels.jacobi_diffuse_plain(x, x, 20, coef)
    tol = 1e-6 * max(1.0, float(want.abs().max()))
    err = compare("jacobi_diffuse (20 sweeps)", got, want, tol)
    k_ms = cuda_time(lambda: stencil_kernels.jacobi_diffuse(x, x, 1, coef), 40)
    p_ms = cuda_time(lambda: stencil_kernels.jacobi_diffuse_plain(
        x, x, 1, coef), 5, 1)
    b_ms, b_by = bound_ms(4 * 3 * x.numel(), x.numel() * 8)
    results["jacobi_diffuse"] = dict(
        max_abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        replaces=("gpufluidsimulation_tpu/ops/pallas_kernels.py:200 "
                  "(_jacobi_diffuse_kernel, pallas_call :264)"))
    log(f"[kernels] jacobi_diffuse (one sweep): {k_ms:.4f} ms (plain "
        f"{p_ms:.3f}, bound {b_ms:.4f} by {b_by})")
    return results


def bench_config(n, steps_dt=None):
    """The main-path configuration as bench.py builds it."""
    from gpufluidsimulation_tpu_torch.scenes.scenes3d import (
        vortex_collision_config)
    from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Emitter3D

    return vortex_collision_config(
        ni=n, nj=n, nk=n, scheme=Scheme.BIMOCQ, dt=8.0 / n,
        emitters=(
            Emitter3D(center=(0.04, 0.10, 0.10), radius=0.015, sign=1.0),
            Emitter3D(center=(0.16, 0.101, 0.10), radius=0.015, sign=-1.0),
        ),
        proj_tol=1e-4, proj_max_iters=30,
    )


FIELDS = ("u", "v", "w", "rho", "T", "u_init", "v_init", "w_init")


def parity_phase(n=32, steps=3):
    """Phase 3: the port on the card against the port on the CPU."""
    from gpufluidsimulation_tpu_torch import convert
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D

    cfg = bench_config(n)
    gpu = Smoke3D(cfg)
    cpu = Smoke3D(cfg, device="cpu")
    start = convert.state_to_numpy(cpu.init_state())
    sg = convert.state_from_numpy(start, cfg, gpu.device)
    sc = convert.state_from_numpy(start, cfg, "cpu")
    worst = {}
    for k in range(steps):
        sg = gpu.step(sg)
        sc = cpu.step(sc)
        if sg.substeps != sc.substeps:
            raise AssertionError(f"parity step {k}: substeps {sg.substeps} "
                                 f"(card) != {sc.substeps} (cpu)")
    a, b = convert.state_to_numpy(sg), convert.state_to_numpy(sc)
    for key in FIELDS:
        err = float(np.abs(a[key].astype(np.float64) - b[key]).max())
        scale = max(1.0, float(np.abs(b[key]).max()))
        worst[key] = err
        # fp32 with another summation order (cuBLAS vs CPU BLAS in the
        # spectral transforms): the 2e-3 fidelity bound of
        # tests/test_fidelity3d.py, relative to the field's scale
        if not np.isfinite(err) or err > 2e-3 * scale:
            raise AssertionError(f"parity {key}: card vs cpu {err}")
    log(f"[parity] {n}^3, {steps} steps, card vs cpu max abs err: "
        + json.dumps(worst))
    return worst


def main_phase(n, steps, profile):
    """Phase 4: the main path through the entry points, launches counted."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import interp_fast, stencil_kernels
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D

    kernels = {"trilerp_sample": interp_fast.trilerp_sample,
               "rk3_substep": interp_fast.rk3_substep,
               "dmc_substep": interp_fast.dmc_substep,
               "jacobi_diffuse": stencil_kernels.jacobi_diffuse}
    solver = Smoke3D(bench_config(n))
    state = solver.init_state()
    t0 = time.time()
    state = solver.step(state)      # warm-up (emission, first launches)
    torch.cuda.synchronize()
    warm_s = time.time() - t0

    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    subs = []
    t0 = time.time()
    start.record()
    for _ in range(steps):
        state = solver.step(state)
        subs.append(state.substeps)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.time() - t0) / steps * 1e3
    dev_ms = start.elapsed_time(end) / steps
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    missing = [k for k, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    rho_max = float(state.rho.max())
    if not 0.0 < rho_max <= 10.0:
        raise AssertionError(f"implausible rho_max={rho_max}")
    for key in FIELDS:
        if not bool(torch.isfinite(getattr(state, key)).all()):
            raise AssertionError(f"non-finite {key}")
    res = dict(n=n, steps=steps, ms_per_step=dev_ms, host_ms_per_step=host_ms,
               mcells_per_s=n ** 3 / 1e6 / (dev_ms / 1e3),
               warmup_s=warm_s, substeps=subs, rho_max=rho_max,
               cfl=state.cfl, proj_iters=state.proj_iters,
               proj_res=float(state.proj_res), launches=launches,
               peak_mem_gib=peak / 2 ** 30)
    log("[main] " + json.dumps(res))
    if profile:
        profile_steps(solver, state, profile)
    return launches


def profile_steps(solver, state, path, steps=2):
    """Device time by kernel name over `steps` main-path steps, written
    to `path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state = solver.step(state)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    log("[profile] " + "\n".join(table.splitlines()[:30]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256, help="main-path grid n^3")
    ap.add_argument("--steps", type=int, default=8, help="timed steps")
    ap.add_argument("--kernel-n", type=int, default=256,
                    help="grid of the kernel-vs-plain phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="PATH",
                    help="write a torch.profiler table of 2 steps to PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        from gpufluidsimulation_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    log(smi)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.time()
    logs = _build.build(verbose=True)
    log(f"[build] {len(logs)} libraries in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    results = kernel_phase(args.kernel_n, args.seed)
    parity_phase()
    launches = main_phase(args.n, args.steps, args.profile)

    sources = {"trilerp_sample": "gpufluidsimulation_tpu_torch/csrc/trilerp_sample.cu",
               "rk3_substep": "gpufluidsimulation_tpu_torch/csrc/rk3_substep.cu",
               "dmc_substep": "gpufluidsimulation_tpu_torch/csrc/dmc_substep.cu",
               "jacobi_diffuse": "gpufluidsimulation_tpu_torch/csrc/jacobi_diffuse.cu"}
    line = []
    for name, r in results.items():
        entry = dict(name=name, route="cuda", source=sources[name],
                     replaces=r["replaces"], launches=launches[name],
                     max_abs_err=r["max_abs_err"], max_err=r["max_abs_err"],
                     tol=r["tol"], ms=r["ms"], kernel_ms=r["ms"],
                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                     bound_by=r["bound_by"], library_ms=r["library_ms"])
        if "variants" in r:
            entry["variants"] = r["variants"]
        line.append(entry)
    log(json.dumps({"kernels": line}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
