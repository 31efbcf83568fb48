#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full run: 256^3 paths
    python3 chip_smoke.py --n 64 --kernel-n 64 --obstacle-n 64 --scheme-n 64
                                     # every phase at a small size
    python3 chip_smoke.py --profile out/profile.txt
                                     # also write per-kernel time tables of
                                     # 2 steps of the main, obstacle,
                                     # MG-PCG and phase-7 paths to that
                                     # file, with the backward-map march's
                                     # and the smoothers' device time

Phases, each of which fails loudly (non-zero exit, no result line):
 1. print the card's name and power limit; build the twelve CUDA
    kernels from gpufluidsimulation_tpu_torch/csrc with nvcc, all at once,
    and print each kernel's registers and spills (the ten 3D kernels are
    redesigned for Hopper, and none of them may spill);
 2. at the paths' 256^3 shapes (and 100x200x200 for the Jacobi solve),
    hold each kernel against its plain PyTorch version on the same inputs
    and time both with CUDA events, every kernel bit for bit: the
    smoothers on 256^3, 100x200x200, 37x29x45
    and every level of their V-cycle hierarchies in every mode (iters
    1-4, reverse, x=None; the masked one with the obstacle scene's
    coarsened flags), their 2-sweep call timed on each level the V-cycle
    smooths with them, the sampler also at positions outside the
    domain and on the quarter-cell lattice, the Jacobi solve at iters
    around its sweeps a launch and its division over the accepted range
    of denominators, rk3_substep, dmc_substep, volume_prefilter and
    vol9_fixup also on 100x200x200 and 37x29x45, rk3_substep from
    positions outside the domain and on the half-cell lattice and in its
    lattice mode for the kinds c, u, v and w, dmc_substep in both modes
    through its guard, zero velocities and map positions past the
    lattice, vol9_fixup at tol 0 and the default tol with mapped
    positions clamped on every face; minmax_sample on 256^3, 100x200x200
    and 37x29x45 at C=1 and 2, equal and differing offsets, from
    displaced, outside and quarter-cell positions, its sample mode also
    against trilerp_sample_plain, timed beside the two launches the
    sample mode replaces; pullback_sample on the same grids for the kind
    sets (u, v, w), (c, c), (u, c, c) and (u, v, w, c) at clamps (1, 1)
    and (0, 0), the clip both hit and missed;
2b. the slab modes of trilerp_sample, rk3_substep and dmc_substep (the
    sharded path), their lattice modes too, against their plain versions
    bit for bit with equal overflow counts, on 256^3 (slabs of 64 planes
    at origins 0, 64 and 192, halo 8) and 37x29x45 (slabs of 15, halo 4),
    from positions up to the halo (no count; the slab launch equals the
    whole-grid launch bit for bit) and past it (the count must not be
    0); each timed on a 64-plane slab;
 3. parity on the card (kernels) against the port on the CPU (plain
    versions): 3 steps at 32^3 from one numpy state of the vortex step,
    the moving-obstacle step, MAC_REFLECTION on the vortex scene,
    MACCORMACK on the obstacle scene, BiMocq with adaptive reinit and
    blend 0.5 in the dual, exact, vol9 and prefilter volume forms; the
    fused multi-kind pull-back (bimocq_advect_multi_3d) of the velocity
    triplet and of rho+T; one MG-PCG solve; the obstacle scene with its
    sphere replaced by a voxel level set (mesh_to_sdf of an octasphere);
    a moving voxel emitter with trans and emit_velocity; the MG-PCG vortex
    path with EngineMode(rbgs=False) (the Jacobi-smoothed V-cycle);
 4. the main path: the 3D BiMocq vortex-collision step as bench.py builds
    it (n^3, dt = 8/n, two recentred emitters), 1 warm-up step and
    `--steps` timed steps, every kernel's launch count reset before and
    read after (12 trilerp_sample, 3 x ceil(20/s) jacobi_diffuse, 3
    rk3_substep and 3 dmc_substep, 1 of each in the lattice mode, and 3
    volume_prefilter launches a step, no plain DMC displacement on the
    card), rho_max in (0, 10] and every field finite;
4b. the sharded main path: the same solver's step through
    parallel.sharding.sharded_step on a mesh of 4 slabs on the one card
    (halo 8): 2 steps held bit for bit against the main phase's
    single-device step, then 1 warm-up and 3 timed steps
    with the launch counts and the slab-mode counts read (D times the
    marches' launches, 3 D + 3 trilerp_sample launches a stage set), its
    ms/step beside the single-device one, launches and peak memory;
 5. the obstacle path: the moving-obstacle scene (buoyant plume, sweeping
    sphere, masked MG-PCG) at n^3 with dt = 1.6/n, warmed up until the
    plume passes CFL 1 (so that both map marches substep), then timed
    steps with the launch counts reset before and read after, and every
    masked_rbgs_smooth call held to ceil(2 iters / levels a launch)
    launches (one for the V-cycle's 2-sweep calls);
 6. the vortex path with the MG-PCG projection (spectral solve off), its
    rbgs_smooth calls held the same way; then the same path with
    EngineMode(rbgs=False), `--scheme-steps` timed steps with no
    rbgs_smooth launch, its ms/step and proj_iters beside the red-black
    path's;
 7. five more vortex paths built like the main path: `reflection`
    (MAC_REFLECTION, the scene's own default scheme), `maccormack`,
    `bimocq_adaptive` (adaptive reinit, blend 1), `bimocq_vol9` (the
    same in the vol9 volume form, with the share of flagged block
    channels) and `bimocq_prefilter` (the main path in the prefilter
    volume form), 1 warm-up and `--scheme-steps` timed steps each; on
    reflection and maccormack the trace clamp must make one minmax_sample
    launch a step, in its sample mode, and no fallback trilerp_sample
    launch;
 8. `pullback_multi`: the parked fused multi-kind pull-back at the
    `--scheme-n` width, on a stepped state whose maps and prev tier are
    live, launches counted, against and timed beside the per-kind
    prefilter path;
 9. the CLI (``gpufluidsimulation_tpu_torch.cli.main``, in-process,
    --out in a temporary directory): sim3d 0 at --cli-res (100: 100 x
    200 x 200), 4 frames with a checkpoint every 2; --resume from the
    checkpoint of frame 1, whose frames 3-4 must read back bit-identical
    to the first run's; sim3d 3 (reflection), 2 frames; sim3d 0
    --example 1 (the obstacle scene) at --cli-obstacle-res (64), 3
    frames. Each run's launch counts are set to 0 before and read after
    it, and it must launch each kernel of its path; every frame file
    reads back as its state's rho; each frame's step ms (the CLI's
    FrameTimer), write_volume ms and checkpoint ms are logged, and the
    output's split (device-to-host copy, pack_vdb, hand-off, disk write;
    each volume format; a checkpoint's copies against its compression);
10. the 2D kernel bilerp_sample in its sample, mac and cp modes against
    its plain versions, bit for bit, on 256^2, 256x1280 and 37x29 (C=1,
    C=2 on the 5-point stencil's (5, ni, nj) batch, C=2 on two lattices,
    the mac mode, calculateCp of u, v, rho and T; each also from
    positions 3 cells outside the domain), timed at 256^2 (also with the
    50 MB L2 flushed before each launch) beside its plain version, its
    bound and grid_sample; the P2G kernel p2g_splat in
    its FLIP, APIC and PolyPIC modes on 256^2 with 1,048,576 particles
    (12,000 of them piled on one clamp-ring node; none piled; 5,000 piled
    at an interior node, runs of ten chunks) and on RT's 256x1280 with
    5,242,880: bit for bit against its plain version on the CPU, within
    1e-5 of each output's scale against its plain version on the card
    (atomics), two launches bit for bit, timed beside the plain version,
    its bound and index_add_ of the same tap payloads, one call traced
    by torch.profiler;
11. 2D parity: SEMILAG, MACCORMACK, BFECC, MAC_REFLECTION and BIMOCQ
    (blend 0.5, remap gaps 2 and 1) at 32x48, BIMOCQ in the level-set
    mode and FLIP, APIC and POLYPIC, 3 steps on the card against the port
    on the CPU, within 2e-3 of each field's and particle column's scale,
    every counter equal;
12. the 2D paths: BiMocq on example 0 (the Taylor vortex, 256^2, dt
    0.025; README: sim2d 7 0) and example 2 (Rayleigh-Taylor, 256x1280,
    pure Neumann); FLIP, APIC and POLYPIC on example 0 (1,048,576
    particles) and FLIP on example 2 (5,242,880); `--steps-2d` timed
    steps each with the launch counts reset before and read after (a
    particle path must launch p2g_splat every step, the cp mode on APIC
    and POLYPIC, and call no plain splat), the host syncs of a step
    (torch.cuda.set_sync_debug_mode) and the card's idle share
    (torch.profiler);
13. the CLI's sim2d in-process: 7 0 (3 frames), 3 2 (2 frames), 7 3
    (the Zalesak level set, CFL-driven substeps, 1 frame), 4 0 (FLIP, 2
    frames) and 6 2 (PolyPIC, 1 frame), each run's launches counted
    alone, every BMP a 24-bit image of the grid's size, the level-set
    file finite and equal to the frame's rho;
14. the bf16 mode (EngineMode.interp_bf16), run after phase 9: each of
    the four kernels with a bf16 mode (trilerp_sample C=1 and C=2 dual,
    plain, C=3 on the MAC pack, also with NaNs sown; minmax_sample in both
    modes; rk3_substep displaced and in its lattice mode for every kind;
    dmc_substep from a displaced map) bit for bit against its plain
    version at the n^3 shapes, each timed by CUDA graph beside its
    float32 form; parity card vs CPU of the bf16 main path and MacCormack
    at 32^3 (3 steps, 2e-3 of scale); the bf16 main path at n^3 with its
    bf16-mode launches and conversions to bfloat16 a step counted, and
    the drift of rho and u from the float32 main path after 8 steps; the
    bf16 MacCormack path at n^3 (one bf16 minmax_sample launch a step).
Then it prints one JSON line with every kernel's numbers (the three with a
slab mode carry its numbers under "slab", the four with a bf16 mode under
"bf16") and, last, the device line. It never imports JAX or the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import io
import json
import os
import re
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


def device_ms(fn, reps, key):
    """Mean device milliseconds per fn() call of the kernels whose name
    holds `key`, from torch.profiler over `reps` calls: the kernel's own
    time where a call is too short for CUDA events around the calls to see
    past the host's launch overhead: the sum over the kernel events, each
    launch's own duration on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA and key in e.name]
    if not kernels or len(kernels) % reps:
        log(f"[profiler] {key}: {len(kernels)} kernel events for {reps} "
            "calls: the trace lost some, so this time undercounts")
    return sum(kernels) / 1e3 / reps


def launch_graph(fn, calls):
    """A CUDA graph of `calls` back-to-back calls of fn, warmed up (fn's
    work must be capturable: launches on the current stream, no host
    sync)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def host_us(fn, calls=1000):
    """Microseconds of host time a call of fn: the wall time of `calls`
    calls made without a sync (the card keeps up with launches that
    short), over `calls`."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def graph_ms(fn, calls=20, replays=10):
    """Mean device milliseconds a call of fn, from a CUDA graph of `calls`
    calls replayed `replays` times between CUDA events: the card's time
    with the host's launch work out of the way, and without the
    profiler."""
    return cuda_time(launch_graph(fn, calls).replay, replays,
                     warmup=1) / calls


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# float32 operations per output element, counted from the kernels' source:
# one clamped trilerp = one weight set (3 floor + 3 frac) + 7 lerps x 4
# (1-f, 2 mul, add); channels sampled at one position share the weights
TRILERP_WEIGHTS = 6
LERP_OPS = 4
TRILERP_OPS = TRILERP_WEIGHTS + 7 * LERP_OPS


def dual_ops(pos, h, offs):
    """float32 operations the dual volume form needs on these positions
    once weights and lerps are shared: per output the 3 divisions by h;
    per distinct channel offset 3 subtractions and, per axis, the two
    corner coordinates g -+ 1/4 and 3 x (floor, fraction, 1 - f); per
    channel the distinct lerps, 3 operations each (2 products, a sum):
    x lerps on the node pairs that the 8 corners and the centre touch,
    2|J||K| + 4, with |J| and |K| (2 or 3) the y and z nodes that
    g -+ 1/4 span at this position, y lerps 4|K| + 2, the 9 z lerps; then
    the 7 corner sums and the 4 operations of the blend."""
    import torch

    x = [p / torch.full((), h, dtype=p.dtype, device=p.device) for p in pos]
    n_out = pos[0].numel()
    total = 3 * n_out
    for off in dict.fromkeys(offs):
        total += 36 * n_out

        def span(g):
            return 2 + (torch.floor(g + 0.25) != torch.floor(g - 0.25)).to(
                torch.int64)

        J, K = span(x[1] - off[1]), span(x[2] - off[2])
        lerps = int((2 * J * K + 4 + 4 * K + 2 + 9).sum())
        total += offs.count(off) * (3 * lerps + 11 * n_out)
    return total


def smooth(shape, rng, amp, device):
    """amp * a sum of two random-phase sine modes on the index lattice."""
    import torch

    idx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(2):
        k = rng.uniform(0.5, 3.0, len(shape)) * 2 * np.pi / np.array(shape)
        ph = rng.uniform(0, 2 * np.pi)
        f += np.sin(sum(kk * ii for kk, ii in zip(k, idx)) + ph)
    return torch.from_numpy((amp * f / 2).astype(np.float32)).to(device)


def kernel_phase(n, seed):
    """Phase 2: every kernel against its plain version at n^3 shapes."""
    import torch
    import torch.nn.functional as F

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    g = Grid3D(n, n, n, 0.2 / n)
    h = g.h
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
    def edge_positions(kind, how):
        """`kind`'s lattice stretched to reach 3 cells outside the field
        on every axis ("outside"), or (with h = 1/4, so that p / h is
        exact) grid coordinates g on the quarter-cell lattice within 2
        cells of each node, both g - 1/4 and g integral ("quarter")."""
        if how == "outside":
            return [(p * ((m + 6.0) / m) - 3.0 * h).contiguous()
                    for p, m in zip(g.node_coords(kind, device=dev),
                                    g.shape_of(kind))], h
        off = g.off_of(kind)
        lat = torch.meshgrid(*[torch.arange(m, dtype=torch.float32,
                                            device=dev)
                               for m in g.shape_of(kind)], indexing="ij")
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        return [(0.25 * (q + torch.randint(-8, 9, q.shape, device=dev,
                                           generator=gen) / 4.0 + o))
                .contiguous() for q, o in zip(lat, off)], 0.25

    # the same functions at the domain's edges and on the floor lattice,
    # compared only: positions up to 3 cells outside the field, and on
    # quarter-cell values where the 3-node neighbourhood splits
    edges = []
    for label, fields, kind, dual in (("C=1 dual u", fu, "u", True),
                                      ("C=2 dual c", fc, "c", True),
                                      ("C=1 plain u", fu, "u", False)):
        offs = (g.off_of(kind),) * fields.shape[0]
        for how in ("outside", "quarter"):
            pos, hh = edge_positions(kind, how)
            got = interp_fast.trilerp_sample(fields, *pos, hh, offs, dual=dual)
            want = interp_fast.trilerp_sample_plain(fields, *pos, hh, offs,
                                                    dual)
            edges.append(dict(variant=f"{label} {how}", max_abs_err=compare(
                f"trilerp_sample {label} {how}", got, want, 0.0), tol=0.0))
    variants = []
    for label, fields, pos, off, dual in (
            ("C=1 dual u", fu, pu, g.OFF_U, True),
            ("C=2 dual c", fc, pc, g.OFF_C, True),
            ("C=1 plain u", fu, pu, g.OFF_U, False)):
        C = fields.shape[0]
        offs = (off,) * C
        got = interp_fast.trilerp_sample(fields, *pos, h, offs, dual=dual)
        want = interp_fast.trilerp_sample_plain(fields, *pos, h, offs, dual)
        # same operations in the same order: bit for bit
        tol = 0.0
        err = compare(f"trilerp_sample {label}", got, want, tol)
        k_ms = cuda_time(lambda: interp_fast.trilerp_sample(
            fields, *pos, h, offs, dual=dual), 20)
        p_ms = cuda_time(lambda: interp_fast.trilerp_sample_plain(
            fields, *pos, h, offs, dual), 3, warmup=1)
        n_out = pos[0].numel()
        nbytes = 4 * (fields.numel() + 3 * n_out + C * n_out)
        nops = (dual_ops(pos, h, offs) if dual
                else n_out * (6 + C * TRILERP_OPS))
        b_ms, b_by = bound_ms(nbytes, nops)
        ops_ms = nops / FP32_OPS_PER_S * 1e3
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
                             bound_by=b_by, ops_bound_ms=ops_ms,
                             library_ms=lib_ms))
        log(f"[kernels] trilerp_sample {label}: {k_ms:.4f} ms (plain "
            f"{p_ms:.3f}, bound {b_ms:.4f} by {b_by}, operations alone "
            f"{ops_ms:.4f}, library {lib_ms})")
    main = variants[0]
    results["trilerp_sample"] = dict(
        main, variants=variants + edges,
        replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:915 (_kernel, "
                  "pallas_call :995) and :1306 (_kernel_multi, pallas_call "
                  ":1421)"))

    results["minmax_sample"] = minmax_phase(g, fc, rng, dev, compare)

    # rk3_substep: bit for bit on three grids, from displaced positions,
    # from positions outside the clamp box and the domain, and from each
    # kind's lattice (the lattice mode, against the plain version on the
    # materialized lattice); timed at n^3 from displaced positions and from
    # the cell lattice
    results["rk3_substep"] = rk3_phase(g, rng, dev, compare)

    # dmc_substep: bit for bit on three grids, displaced and lattice mode,
    # through the guard, zero velocities and clamped map positions; timed
    # at n^3 in both modes
    results["dmc_substep"] = dmc_phase(g, rng, dev, compare)

    results["jacobi_diffuse"] = jacobi_phase(g, rng, dev, compare)
    results.update(smoother_phase(n, rng, dev))
    results.update(volume_phase(g, rng, dev, compare, positions))
    results.update(pullback_phase(g, rng, dev, compare))
    return results


def minmax_phase(g, fc, rng, dev, compare):
    """Phase 2, minmax_sample: bit for bit against its plain version on the
    n^3 grid, the reference scene's 100x200x200 and a ragged 37x29x45, at
    C=1 and C=2 with equal offsets (the trace clamp's only case: rho+T at
    the cell lattice) and with differing ones, from cell-lattice positions
    displaced by up to 2.5 cells (some outside the domain), stretched to
    reach 3 cells outside every face, and on the quarter-cell lattice
    within 3 cells of each node (h = 1/4, so that g and its floor are
    exact lattice planes); the sample mode also against
    trilerp_sample_plain. Timed on the n^3 grid at C=2 from the displaced
    positions: the min/max alone, the sample mode, and the two launches
    that the sample mode replaces (the min/max, then trilerp_sample's
    plain C=2 sample at the same positions). The bounds: positions read
    once, each field read once, 2 (3 with the sample) outputs a channel
    written once; per output the 3 divisions and per channel 3
    subtractions, 3 floors and 14 min/max, with the sample 7 lerps more."""
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    mm, mm_plain = interp_fast.minmax_sample, interp_fast.minmax_sample_plain
    errs, variants = [], []
    for shape in (g.shape_c,) + EDGE_SHAPES:
        gg = g if shape == g.shape_c else Grid3D(*shape, 0.2 / shape[0])
        tag = "x".join(map(str, shape))
        fields = fc if gg is g else torch.stack(
            [smooth(shape, rng, 1.0, dev), smooth(shape, rng, 50.0, dev)])
        lat = torch.meshgrid(*[torch.arange(m, dtype=torch.float32,
                                            device=dev) for m in shape],
                             indexing="ij")
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        starts = {
            "displaced": ([p + smooth(shape, rng, 2.5 * gg.h, dev)
                           for p in gg.node_coords("c", device=dev)], gg.h),
            "outside": ([p * ((m + 5.0) / (m - 1.0)) - 3.0 * gg.h
                         for p, m in zip(gg.node_coords("c", device=dev),
                                         shape)], gg.h),
            "quarter": ([0.25 * (q + torch.randint(
                -12, 13, q.shape, device=dev, generator=gen) / 4.0)
                for q in lat], 0.25)}
        for label, (pos, h) in starts.items():
            pos = [p.contiguous() for p in pos]
            for offs in ((g.OFF_C,), (g.OFF_U,), (g.OFF_C,) * 2,
                         (g.OFF_C, g.OFF_W)):
                C = len(offs)
                f = fields[:C]
                name = f"minmax_sample {tag} {label} C={C} offs {offs}"
                got = mm(f, *pos, h, offs, sample=True)
                want = mm_plain(f, *pos, h, offs, sample=True)
                for q, what in enumerate(("mn", "mx", "sample")):
                    errs.append(compare(f"{name} {what}", got[q], want[q],
                                        0.0))
                errs.append(compare(f"{name} sample vs trilerp_sample_plain",
                                    got[2], interp_fast.trilerp_sample_plain(
                                        f, *pos, h, offs), 0.0))
                pair = mm(f, *pos, h, offs)
                errs.append(compare(f"{name} min/max alone", torch.stack(
                    pair), torch.stack(want[:2]), 0.0))
        if gg is not g:
            continue
        pos = [p.contiguous() for p in starts["displaced"][0]]
        h = g.h
        outside = float(((pos[0] < 0) | (pos[0] > (g.ni - 1) * h)).float()
                        .mean())
        offs = (g.OFF_C,) * 2
        N, C = pos[0].numel(), 2

        def two_launches():
            mm(fc, *pos, h, offs)
            interp_fast.trilerp_sample(fc, *pos, h, offs)

        for label, run, plain, outs, lerps in (
                ("C=2 rho+T min/max", lambda: mm(fc, *pos, h, offs),
                 lambda: mm_plain(fc, *pos, h, offs), 2, 0),
                ("C=2 rho+T sample mode", lambda: mm(fc, *pos, h, offs,
                                                     sample=True),
                 lambda: mm_plain(fc, *pos, h, offs, sample=True), 3, 7),
                ("C=2 rho+T min/max and trilerp_sample (two launches)",
                 two_launches, None, 3, 7)):
            k_ms = cuda_time(run, 20)
            p_ms = None if plain is None else cuda_time(plain, 3, 1)
            b_ms, b_by = bound_ms(4 * (3 * N + C * N + outs * C * N),
                                  N * (3 + C * (20 + lerps * LERP_OPS)))
            variants.append(dict(variant=label, tol=0.0, ms=k_ms,
                                 plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None, outside_share=outside))
            log(f"[kernels] minmax_sample {label}: {k_ms:.4f} ms (plain "
                f"{p_ms}, bound {b_ms:.4f} by {b_by}); {100 * outside:.2f}% "
                "of the positions outside the domain in x")
        trilerp_ms = cuda_time(lambda: interp_fast.trilerp_sample(
            fc, *pos, h, offs), 20)
        variants[-1]["trilerp_sample_ms"] = trilerp_ms
        log(f"[kernels] trilerp_sample C=2 plain at the same positions: "
            f"{trilerp_ms:.4f} ms")
    for v_ in variants:
        v_["max_abs_err"] = max(errs)
    return dict(variants[0], variants=variants, sample_mode=variants[1],
                replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:1177 "
                          "(_kernel_minmax, pallas_call :1282; entry "
                          "minmax3_fast :1212)"))


# float32 operations of one rk3_substep node, counted from the kernel's
# source: per stage the 3 adds g + 1/2, 6 floor/weight sets (floor,
# fraction, 1 - f) and 3 components x 7 lerps x 3 (2 products, a sum);
# the two stage positions (2 x 6), the result (3 x 6) and the clamp (6)
RK3_OPS = 3 * (3 + 6 * 3 + 3 * 7 * 3) + 2 * 6 + 3 * 6 + 6
# grids beside the n^3 one on which rk3_substep and volume_prefilter are
# held bit for bit: the reference scene's grid and a ragged one
EDGE_SHAPES = ((100, 200, 200), (37, 29, 45))


def rk3_phase(g, rng, dev, compare):
    """Phase 2, rk3_substep: bit for bit against its plain version on the
    n^3 grid, the reference scene's 100x200x200 and a ragged 37x29x45,
    from positions displaced by up to 2 cells, from positions stretched
    to reach 3 cells outside the domain (beyond the clamp box), from
    positions on the half-cell lattice (cell centres and faces, where
    floor(g) and floor(g + 1/2) differ), and in the lattice mode for the
    kinds c, u, v and w (against the plain version on
    advect._cropped_positions). Timed on the n^3 grid from displaced
    positions and from the cell lattice, beside the displaced kernel
    reading the materialized lattice. The bounds: the faces read once,
    3 position floats read (none from the lattice) and 3 written a node,
    or RK3_OPS a node."""
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import advect, interp_fast

    rk3 = interp_fast.rk3_substep
    variants, errs = [], []
    for shape in (g.shape_c,) + EDGE_SHAPES:
        gg = Grid3D(*shape, 0.2 / shape[0])
        tag = "x".join(map(str, shape))
        u, v, w = (smooth(s, rng, 0.06, dev)
                   for s in (gg.shape_u, gg.shape_v, gg.shape_w))
        # the substep over h at which the fastest face moves one cell
        top = max(float(t.abs().max()) for t in (u, v, w))
        sh = float(np.float32(np.float32(gg.h) / np.float32(top))
                   / np.float32(gg.h))
        clamp = advect._clamp_grid(gg)
        lat, _ = advect._cropped_positions(gg, "c", dev)
        lat = lat.contiguous()
        n_ = np.array(shape, dtype=np.float32).reshape(3, 1, 1, 1)
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        starts = {
            "displaced": lat + torch.stack([smooth(shape, rng, 2.0, dev)
                                            for _ in range(3)]),
            "outside": (lat + 0.5) * torch.from_numpy((n_ + 6.0) / n_).to(
                dev) - 3.5,
            "half-cell lattice": lat + torch.randint(
                -6, 7, lat.shape, device=dev, generator=gen) / 2.0,
        }
        for label, pos in starts.items():
            pos = pos.contiguous()
            for sign in (1.0, -1.0):
                name = f"rk3_substep {tag} {label} sh={sign * sh:+.4f}"
                errs.append(compare(name, rk3(u, v, w, pos, sign * sh, clamp),
                                    interp_fast.rk3_substep_plain(
                                        u, v, w, pos, sign * sh, clamp), 0.0))
        for kind in ("c", "u", "v", "w"):
            s_k = sh if kind == "c" else -sh     # forward map, backtraces
            pos, _ = advect._cropped_positions(gg, kind, dev)
            name = f"rk3_substep_lattice {tag} {kind} sh={s_k:+.4f}"
            errs.append(compare(
                name, interp_fast.rk3_substep_lattice(u, v, w, gg.dim_of(kind),
                                                      s_k, clamp),
                interp_fast.rk3_substep_plain(u, v, w, pos.contiguous(), s_k,
                                              clamp), 0.0))
        if shape != g.shape_c:
            continue
        N = lat[0].numel()
        faces = 4 * (u.numel() + v.numel() + w.numel())
        pos = starts["displaced"].contiguous()
        dim_c = gg.dim_of("c")
        for label, run, plain, nbytes in (
                ("displaced positions",
                 lambda: rk3(u, v, w, pos, sh, clamp),
                 lambda: interp_fast.rk3_substep_plain(u, v, w, pos, sh,
                                                       clamp),
                 faces + 4 * 6 * N),
                ("lattice mode (identity peel), cell kind",
                 lambda: interp_fast.rk3_substep_lattice(u, v, w, dim_c, sh,
                                                         clamp),
                 lambda: interp_fast.rk3_substep_plain(
                     u, v, w, interp_fast.lattice_positions(shape, dim_c,
                                                            dev), sh, clamp),
                 faces + 4 * 3 * N)):
            k_ms = cuda_time(run, 20)
            p_ms = cuda_time(plain, 3, 1)
            b_ms, b_by = bound_ms(nbytes, N * RK3_OPS)
            variants.append(dict(variant=label, tol=0.0, ms=k_ms,
                                 plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None))
            log(f"[kernels] rk3_substep {label}: {k_ms:.4f} ms (plain "
                f"{p_ms:.3f}, bound {b_ms:.4f} by {b_by})")
        read_ms = cuda_time(lambda: rk3(u, v, w, lat, sh, clamp), 20)
        variants[-1]["materialized_lattice_ms"] = read_ms
        log(f"[kernels] rk3_substep reading the materialized lattice: "
            f"{read_ms:.4f} ms")
    for v_ in variants:
        v_["max_abs_err"] = max(errs)
    return dict(variants[0], variants=variants, lattice=variants[1],
                replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:1664 "
                          "(_kernel_rk3/_kernel_rk3_twotier :1745, "
                          "pallas_call :1855) and :1870 (_kernel_rk3_ident, "
                          "pallas_call :2001)"))


# float32 operations of one dmc_substep cell in the band, counted from
# the kernel's source: the 6 face averages (2 each); per axis the
# exponential step (sign, du, q (2), |du|, the guard's select, exp, 1 - e,
# the product and the division: 10) and the map coordinate (1); one weight
# set (3 floors, 3 fractions, 3 x 1 - f); 3 channels x 7 lerps x 3
DMC_OPS = 6 * 2 + 3 * (10 + 1) + 9 + 3 * 7 * 3
# the lattice mode: the face averages and steps, then per axis p, disp*h,
# the subtraction and the clamp (2)
DMC_LATTICE_OPS = 6 * 2 + 3 * 10 + 3 * 5


def dmc_faces(gg, rng, dev):
    """Three MAC triplets of grid `gg`: smooth faces of size 0.06; the same
    with a zero slab over the lowest third of k (velocity 0 there, where
    the kernel's sign test is false); and smooth faces quantized to 0.01
    with jitter of 0, 0.5, 0.99, 1.01 or 2 times the guard 1e-4 h of
    either sign, so that |du| is 0, just under and just over the guard."""
    import torch

    base = [smooth(s, rng, 0.06, dev)
            for s in (gg.shape_u, gg.shape_v, gg.shape_w)]
    zero = [f.clone() for f in base]
    for f in zero:
        f[:, :, : f.shape[2] // 3] = 0.0
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    steps = torch.tensor([0.0, 0.5, 0.99, 1.01, 2.0, -0.5, -0.99, -1.01,
                          -2.0], device=dev) * float(np.float32(1e-4 * gg.h))
    guard = [torch.round(f * 100.0) / 100.0 + steps[torch.randint(
        0, len(steps), f.shape, device=dev, generator=gen)] for f in base]
    return {"smooth": base, "zero slab": zero, "guard": guard}


def dmc_phase(g, rng, dev, compare):
    """Phase 2, dmc_substep: bit for bit against its plain version on the
    n^3 grid, the reference scene's 100x200x200 and a ragged 37x29x45, for
    the face sets of ``dmc_faces`` and substeps of both signs that move
    the fastest face 1 and 3.5 cells (map positions past one cell and
    outside the lattice on every face); the displaced mode from a map
    displaced by up to 2 cells, the lattice mode (the identity peel)
    against its plain version. The run fails unless those cases occur.
    Timed on the n^3 grid in both modes. The bounds: the faces read once,
    3 map floats read (none in the lattice mode) and 3 written a cell, or
    the operations above."""
    import torch

    from gpufluidsimulation_tpu_torch.core import interp
    from gpufluidsimulation_tpu_torch.core.grids import Grid3D, band_mask
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    errs = []
    hit = dict.fromkeys(("|du| <= guard, du != 0", "|du| > guard",
                         "du == 0", "velocity 0", "displacement > 1 cell",
                         "map position < 0", "map position > n - 1"), 0)
    timing = None
    for shape in (g.shape_c,) + EDGE_SHAPES:
        gg = Grid3D(*shape, 0.2 / shape[0])
        tag = "x".join(map(str, shape))
        h = gg.h
        thresh = interp_fast.dmc_threshold(h)
        band = band_mask(shape, (2, 2, 2), (3, 3, 3), dev)
        lat = torch.stack(gg.node_coords("c", device=dev))
        maps = (lat + torch.stack([smooth(shape, rng, 2.0 * h, dev)
                                   for _ in range(3)])).contiguous()
        for label, (u, v, w) in dmc_faces(gg, rng, dev).items():
            top = max(float(t.abs().max()) for t in (u, v, w))
            sh1 = float(np.float32(np.float32(h) / np.float32(top))
                        / np.float32(h))
            for sh in (sh1, -sh1, 3.5 * sh1, -3.5 * sh1):
                name = f"{tag} {label} sh={sh:+.4f}"
                errs.append(compare(
                    f"dmc_substep {name}",
                    interp_fast.dmc_substep(u, v, w, maps, sh, thresh),
                    interp_fast.dmc_substep_plain(u, v, w, maps, sh, thresh),
                    0.0))
                errs.append(compare(
                    f"dmc_substep_lattice {name}",
                    interp_fast.dmc_substep_lattice(u, v, w, sh, thresh, h),
                    interp_fast.dmc_substep_lattice_plain(u, v, w, sh,
                                                          thresh, h), 0.0))
                vel = interp.mac_velocity_at_c_3d(u, v, w)
                signs = [c > 0 for c in vel]
                disp = interp_fast.dmc_displacements(u, v, w, sh, thresh)
                for ax, (c, d) in enumerate(zip(vel, disp)):
                    du = (c - interp_fast._upwind_corner(c, *signs))[band]
                    hit["|du| <= guard, du != 0"] += int(
                        ((du.abs() <= thresh) & (du != 0)).sum())
                    hit["|du| > guard"] += int((du.abs() > thresh).sum())
                    hit["du == 0"] += int((du == 0).sum())
                    hit["velocity 0"] += int((c[band] == 0).sum())
                    hit["displacement > 1 cell"] += int(
                        (d[band].abs() > 1.0).sum())
                    idx = torch.arange(shape[ax], device=dev).reshape(
                        [-1 if a == ax else 1 for a in range(3)])
                    pos = (idx - d)[band]
                    hit["map position < 0"] += int((pos < 0).sum())
                    hit["map position > n - 1"] += int(
                        (pos > shape[ax] - 1).sum())
            if shape == g.shape_c and label == "smooth":
                timing = (u, v, w, maps, sh1, thresh, h)
    log(f"[kernels] dmc_substep cases (band cells x axes over every run): "
        f"{json.dumps(hit)}")
    missing = [k for k, c in hit.items() if c == 0]
    if missing:
        raise AssertionError(f"dmc_substep: cases never occurred: {missing}")
    u, v, w, maps, sh, thresh, h = timing
    N = maps[0].numel()
    faces = 4 * (u.numel() + v.numel() + w.numel())
    variants = []
    for label, run, plain, nbytes, nops in (
            ("displaced map",
             lambda: interp_fast.dmc_substep(u, v, w, maps, sh, thresh),
             lambda: interp_fast.dmc_substep_plain(u, v, w, maps, sh, thresh),
             faces + 4 * 6 * N, N * DMC_OPS),
            ("lattice mode (identity peel)",
             lambda: interp_fast.dmc_substep_lattice(u, v, w, sh, thresh, h),
             lambda: interp_fast.dmc_substep_lattice_plain(u, v, w, sh,
                                                           thresh, h),
             faces + 4 * 3 * N, N * DMC_LATTICE_OPS)):
        k_ms = cuda_time(run, 20)
        p_ms = cuda_time(plain, 3, 1)
        b_ms, b_by = bound_ms(nbytes, nops)
        variants.append(dict(variant=label, max_abs_err=max(errs), tol=0.0,
                             ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None))
        log(f"[kernels] dmc_substep {label}: {k_ms:.4f} ms (plain "
            f"{p_ms:.3f}, bound {b_ms:.4f} by {b_by})")
    return dict(variants[0], variants=variants, lattice=variants[1],
                cases=hit,
                replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:3143 "
                          "(_kernel_dmc, pallas_call :3319)"))


# the kernels with a slab mode (the sharded path), and the wrappers whose
# slab launches the sharded main path counts
SLAB_KERNELS = ("trilerp_sample", "rk3_substep", "dmc_substep")
SLAB_WRAPPERS = SLAB_KERNELS + ("rk3_substep_lattice", "dmc_substep_lattice")


def slab_phase(n, seed):
    """Phase 2b: the slab modes of trilerp_sample, rk3_substep and
    dmc_substep (their lattice modes too) against their plain versions on
    the card, bit for bit and with equal overflow counts, on the n^3 grid
    (slabs of n/4 planes at origins 0, n/4 and 3n/4, halo 8: 0, 64 and
    192 at 256^3) and the ragged 37x29x45 (slabs of 15 at 0, 15 and 30,
    halo 4). Positions are displaced in z by +-reach, the sign alternating
    by column, so that both edge planes of every slab reach their
    farthest: up to the halo (the field slab's, or the velocity slab's
    less the substep's travel; one CFL substep for DMC, within its 2 map
    planes), where no node may leave the slab and the slab launch must
    equal the whole-grid launch bit for bit, and past it, where the count
    must not be 0. Timed at n^3, origin n/4, within the halo."""
    import functools

    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import interp_fast as F

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    errs = {k: [] for k in SLAB_KERNELS}
    counts = {k: {} for k in SLAB_KERNELS}
    timed = {}

    def check(kernel, name, got, want, ov_got, ov_want, whole=None,
              expect_zero=None):
        err = float((got - want).abs().max())
        c_got, c_want = int(ov_got), int(ov_want)
        log(f"[slab] {kernel} {name}: max_abs_err={err:.3e} overflow "
            f"kernel {c_got} plain {c_want}")
        if not err == 0.0 or c_got != c_want:
            raise AssertionError(f"{kernel} {name}: slab kernel disagrees "
                                 f"with its plain version ({err}, counts "
                                 f"{c_got} / {c_want})")
        if expect_zero is not None and (c_got == 0) != expect_zero:
            raise AssertionError(f"{kernel} {name}: overflow {c_got}, "
                                 f"expected {'0' if expect_zero else '> 0'}")
        if whole is not None:
            werr = float((got - whole).abs().max())
            if not werr == 0.0:
                raise AssertionError(f"{kernel} {name}: slab launch differs "
                                     f"from the whole-grid launch by {werr}")
        errs[kernel].append(err)
        counts[kernel][name] = c_got
        return c_got

    def zero():
        return torch.zeros(1, dtype=torch.int32, device=dev)

    for shape, D, halo in (((n, n, n), 4, 8), ((37, 29, 45), 3, 4)):
        gg = Grid3D(*shape, 0.2 / shape[0])
        h = gg.h
        tag = "x".join(map(str, shape))
        nk = shape[2]
        nzl = nk // D
        L = min(nzl + 2 * halo, nk)
        fields = torch.stack([smooth(shape, rng, 1.0, dev),
                              smooth(shape, rng, 50.0, dev)]).contiguous()
        u, v, w = (smooth(s_, rng, 0.06, dev)
                   for s_ in (gg.shape_u, gg.shape_v, gg.shape_w))
        top = max(float(t.abs().max()) for t in (u, v, w))
        # one cell a substep for the fastest face, as the CFL substep
        sh1 = float(np.float32(np.float32(h) / np.float32(top))
                    / np.float32(h))
        lat = torch.stack(gg.node_coords("c", device=dev))
        maps = (lat + torch.stack([smooth(shape, rng, 2.0 * h, dev)
                                   for _ in range(3)])).contiguous()
        clamp = (1.0, shape[0] - 1.0, 1.0, shape[1] - 1.0, 1.0, nk - 1.0)
        thresh = F.dmc_threshold(h)
        ii = torch.arange(shape[0], device=dev)[:, None, None]
        jj = torch.arange(shape[1], device=dev)[None, :, None]
        sign = torch.where((ii + jj) % 2 == 0, 1.0, -1.0)
        for z0 in (0, nzl, (D - 1) * nzl):
            s0 = min(max(z0 - halo, 0), nk - L)
            sl = slice(z0, z0 + nzl)
            faces = [f[..., s0:s0 + m].contiguous()
                     for f, m in ((u, L), (v, L), (w, L + 1))]
            # the halo-extended field slab and the map slab with its 2
            # exchanged planes, edge planes replicated at the global edges
            ext = fields[..., torch.arange(z0 - halo, z0 + nzl + halo,
                                           device=dev).clamp(0, nk - 1)]
            mext = maps[..., torch.arange(z0 - 2, z0 + nzl + 2,
                                          device=dev).clamp(0, nk - 1)]
            mext = mext.contiguous()
            xy = [lat[a][..., sl] + smooth(shape, rng, 2.0 * h, dev)[..., sl]
                  for a in (0, 1)]

            def positions(reach):
                """World positions of the slab's cells, x and y wandering
                2 cells, z moved by +-reach cells."""
                pz = lat[2][..., sl] + sign * (reach * h)
                return [q.contiguous() for q in (*xy, pz)]

            vslab = F.Slab(nz=nk, src=s0)
            dslab = F.Slab(nz=nk, src=s0, out=z0, out_nz=nzl, map=z0 - 2)
            fslab = F.Slab(nz=nk, src=z0 - halo)
            timing = shape[0] == n and z0 == nzl
            for within in (True, False):
                label = f"{tag} z0={z0} {'within' if within else 'past'}"
                pos = positions(halo - 0.5 if within else halo + 3.0)
                for dual, C in ((True, 2), (False, 1)):
                    f = fields[:C].contiguous()
                    e = ext[:C].contiguous()
                    offs = ((0.0, 0.0, 0.0),) * C
                    ok, op = zero(), zero()
                    got = F.trilerp_sample(e, *pos, h, offs, dual, fslab, ok)
                    want = F.trilerp_sample_plain(e, *pos, h, offs, dual,
                                                  fslab, op)
                    whole = (F.trilerp_sample(f, *pos, h, offs, dual)
                             if within else None)
                    check("trilerp_sample", f"{label} C={C} "
                          f"{'dual' if dual else 'plain'}", got, want, ok, op,
                          whole, within)
                    if within and dual and timing:
                        timed["trilerp_sample"] = (
                            functools.partial(F.trilerp_sample, e, *pos, h,
                                              offs, True, fslab),
                            functools.partial(F.trilerp_sample_plain, e,
                                              *pos, h, offs, True, fslab),
                            4 * (e.numel() + (3 + C) * pos[0].numel()),
                            dual_ops(pos, h, offs))
                # rk3_substep: the stages travel up to a cell, so within
                # is the velocity slab's halo less 2.5 cells; past it is
                # beyond the velocity slab of the edge slabs, which reaches
                # 2 halos into the grid
                gpos = torch.stack([q / h for q in positions(
                    halo - 2.5 if within else 2 * halo + 3.0)]).contiguous()
                ok, op = zero(), zero()
                got = F.rk3_substep(*faces, gpos, sh1, clamp, vslab, ok)
                want = F.rk3_substep_plain(*faces, gpos, sh1, clamp, vslab,
                                           op)
                whole = (F.rk3_substep(u, v, w, gpos, sh1, clamp)
                         if within else None)
                check("rk3_substep", f"{label} displaced", got, want, ok, op,
                      whole, within)
                if within and timing:
                    timed["rk3_substep"] = (
                        functools.partial(F.rk3_substep, *faces, gpos, sh1,
                                          clamp, vslab),
                        functools.partial(F.rk3_substep_plain, *faces, gpos,
                                          sh1, clamp, vslab),
                        4 * (sum(t.numel() for t in faces)
                             + 6 * gpos[0].numel()),
                        gpos[0].numel() * RK3_OPS)
                # dmc_substep: one CFL substep of either sign (within the
                # 2-plane map halo), and 3.5 (past it: the count of both
                # signs together must not be 0)
                past = 0
                for sh in ((sh1, -sh1) if within else (3.5 * sh1,
                                                       -3.5 * sh1)):
                    ok, op = zero(), zero()
                    got = F.dmc_substep(*faces, mext, sh, thresh, dslab, ok)
                    want = F.dmc_substep_plain(*faces, mext, sh, thresh,
                                               dslab, op)
                    whole = (F.dmc_substep(u, v, w, maps, sh, thresh)[..., sl]
                             if within else None)
                    past += check("dmc_substep", f"{label} sh={sh:+.3f}", got,
                                  want, ok, op, whole,
                                  True if within else None)
                if not within and past == 0:
                    raise AssertionError(f"dmc_substep {label}: no map "
                                         "corner left the map slab")
                if within and timing:
                    N = got[0].numel()
                    timed["dmc_substep"] = (
                        functools.partial(F.dmc_substep, *faces, mext, sh1,
                                          thresh, dslab),
                        functools.partial(F.dmc_substep_plain, *faces, mext,
                                          sh1, thresh, dslab),
                        4 * (sum(t.numel() for t in faces) + 6 * N),
                        N * DMC_OPS)
            # the lattice modes: no positions read, nothing to count
            lslab = F.Slab(nz=nk, src=s0, out=z0, out_nz=nzl)
            for kind in ("c", "u", "v", "w"):
                dim = gg.dim_of(kind)
                ok, op = zero(), zero()
                got = F.rk3_substep_lattice(*faces, dim, sh1, clamp, lslab, ok)
                want = F.rk3_substep_plain(
                    *faces, F.lattice_positions((shape[0], shape[1], nzl), dim,
                                                dev, z0), sh1, clamp, lslab,
                    op)
                check("rk3_substep", f"{tag} z0={z0} lattice {kind}", got,
                      want, ok, op, F.rk3_substep_lattice(
                          u, v, w, dim, sh1, clamp)[..., sl], True)
            got = F.dmc_substep_lattice(*faces, sh1, thresh, h, lslab)
            want = F.dmc_substep_lattice_plain(*faces, sh1, thresh, h, lslab)
            check("dmc_substep", f"{tag} z0={z0} lattice", got, want, 0, 0,
                  F.dmc_substep_lattice(u, v, w, sh1, thresh, h)[..., sl])
    results = {}
    for kernel in SLAB_KERNELS:
        run, plain, nbytes, nops = timed[kernel]
        k_ms = cuda_time(run, 20)
        p_ms = cuda_time(plain, 3, 1)
        b_ms, b_by = bound_ms(nbytes, nops)
        log(f"[slab] {kernel} slab mode {n}^3 slab of {n // 4} planes: "
            f"{k_ms:.4f} ms (plain {p_ms:.3f}, bound {b_ms:.4f} by {b_by})")
        results[kernel] = dict(max_abs_err=max(errs[kernel]), tol=0.0,
                               ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                               bound_by=b_by, overflow_counts=counts[kernel])
    return results


def jacobi_phase(g, rng, dev, compare):
    """Phase 2, the viscosity solve: the kernel against the plain sweeps,
    bit for bit, at iters 1, s-1, s, s+1 and 20 on the u lattice (b = x,
    as the solver calls it) and on an odd 100x200x200 field with its own b
    and a larger coef; the division at 1 and s sweeps for denominators
    log-spaced over the accepted range and numerators from 2^-140 to
    2^110 (``division_sweep``); then the 20-sweep solve of one velocity
    component timed with the bound of the solve (x and b read once, the
    result written once; 20 x 8 operations a cell) and the one-sweep
    launch beside it."""
    from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

    n, h = g.ni, g.h
    coef = 1e-6 * (8.0 / n) / (h * h)          # the main path's
    s = sk.SWEEPS_PER_LAUNCH
    x = smooth(g.shape_u, rng, 0.06, dev)
    xo = smooth((100, 200, 200), rng, 1.0, dev)
    bo = smooth((100, 200, 200), rng, 1.0, dev)
    errs = []
    for label, xi, bi, c in (("u", x, x, coef), ("100x200x200", xo, bo, 0.3)):
        for iters in sorted({1, max(s - 1, 1), s, s + 1, 20}):
            got = sk.jacobi_diffuse(xi, bi, iters, c)
            want = sk.jacobi_diffuse_plain(xi, bi, iters, c)
            errs.append(compare(f"jacobi_diffuse {label} iters={iters}", got,
                                want, 0.0))
    errs.append(division_sweep(rng, dev, s))
    p_ms = cuda_time(lambda: sk.jacobi_diffuse_plain(x, x, 20, coef), 3, 1)
    b_ms, b_by = bound_ms(4 * 3 * x.numel(), 20 * 8 * x.numel())
    k_ms = cuda_time(lambda: sk.jacobi_diffuse(x, x, 20, coef), 10)
    one_ms = cuda_time(lambda: sk.jacobi_diffuse(x, x, 1, coef), 40)
    log(f"[kernels] jacobi_diffuse 20-sweep solve, {s} sweeps a launch: "
        f"{k_ms:.4f} ms (plain {p_ms:.3f}, bound {b_ms:.4f} by {b_by}), "
        f"{k_ms / 20:.4f} ms a sweep; one sweep, one launch: "
        f"{one_ms:.4f} ms")
    return dict(max_abs_err=max(errs), tol=0.0, ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                one_sweep_ms=one_ms, sweeps_per_launch=s,
                replaces=("gpufluidsimulation_tpu/ops/pallas_kernels.py:200 "
                          "(_jacobi_diffuse_kernel, pallas_call :264)"))


def division_sweep(rng, dev, s):
    """The Jacobi kernel's division against the plain sweeps' a / denom,
    bit for bit: 255 coefs log-spaced so that denom = 1 + 6 coef spans
    [1, 2^20], and coef 0, at 1 and `s` sweeps on a 20x24x36 field. b has
    random signs and magnitudes 2^-140 .. 2^110, x magnitudes 2^-140 ..
    2^90, a tenth of each zero, and x is zero on the lower half of k, so
    that there the first sweep's numerators are b itself: normal and
    subnormal numerators around both ends of the fast path's range
    [2^-64, 2^100], divided by every denom. Returns the largest abs error
    in float64."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

    def field(top):
        shape = (20, 24, 36)
        mag = np.exp2(rng.uniform(-140.0, top, shape))
        v = (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
        v[rng.random(shape) < 0.1] = 0.0
        return v

    x, b = field(90.0), field(110.0)
    x[:, :, :18] = 0.0
    x, b = torch.from_numpy(x).to(dev), torch.from_numpy(b).to(dev)
    coefs = [0.0] + list(np.geomspace(1e-7, (2.0 ** 20 - 1.0) / 6.0, 255))
    worst, mismatched = 0.0, 0
    for c in coefs:
        for iters in sorted({1, s}):
            got = sk.jacobi_diffuse(x, b, iters, float(c))
            want = sk.jacobi_diffuse_plain(x, b, iters, float(c))
            mismatched += int((got.view(torch.int32)
                               != want.view(torch.int32)).sum())
            worst = max(worst, float((got.double() - want.double())
                                     .abs().max()))
    log(f"[kernels] jacobi_diffuse division sweep: {len(coefs)} coefs, "
        f"denom 1 .. 2^20, iters 1 and {s}: {mismatched} cells differ in "
        f"their bits, max_abs_err={worst:.3e} tol=0.0e+00")
    if mismatched or not np.isfinite(worst) or worst > 0.0:
        raise AssertionError(f"jacobi_diffuse division sweep: {mismatched} "
                             f"cells differ (max abs err {worst})")
    return worst


def smoother_shapes(n):
    """The grids on which the two smoothers are held bit for bit: n^3,
    100x200x200 and 37x29x45 with every level of their V-cycle
    hierarchies."""
    from gpufluidsimulation_tpu_torch.ops import poisson

    shapes = []
    for top in ((n, n, n),) + EDGE_SHAPES:
        for s in poisson.mg_shapes(top):
            if s not in shapes:
                shapes.append(s)
    return shapes


def obstacle_flag_levels(top, dev):
    """The obstacle scene's frame-0 cell flags (uint8) on a `top` grid and
    on each level of its V-cycle hierarchy, coarsened as the masked
    V-cycle coarsens them."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import poisson
    from gpufluidsimulation_tpu_torch.scenes.scenes3d import (
        moving_obstacle_config)
    from gpufluidsimulation_tpu_torch.solvers import smoke3d

    cfg = moving_obstacle_config(ni=top[0], nj=top[1], nk=top[2])
    f = smoke3d._update_boundary(
        cfg, cfg.grid, 0, cfg.dt,
        smoke3d.boundary_base_flags(cfg.grid, dev))[0]
    levels = {}
    for s in poisson.mg_shapes(top):
        f = (f if s == top else poisson.coarsen_flags(f, s))
        levels[s] = f.to(torch.uint8).contiguous()
    return levels


def smoother_division_sweep(rng, dev):
    """The smoothers' division by the integral diagonal against the plain
    versions' a / diag, bit for bit, on a 24x40x66 field: random flags that
    give the fluid cells every
    diagonal 1..6, b with random signs and magnitudes 2^-140 .. 2^110, x
    magnitudes 2^-140 .. 2^90, a tenth of each zero, and x zero on the
    lower half of k, so that there the first level's numerators are b
    itself: zero, subnormal, normal and large numerators divided by every
    diagonal. The masked smoother and the plain one (Neumann diagonals
    3..6, Dirichlet 6), iters 1 and 2, from x and from zero. Returns the
    largest abs error in float64."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

    shape = (24, 40, 66)

    def field(top):
        mag = np.exp2(rng.uniform(-140.0, top, shape))
        v = (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
        v[rng.random(shape) < 0.1] = 0.0
        return v

    x, b = field(90.0), field(110.0)
    x[:, :, :33] = 0.0
    x, b = torch.from_numpy(x).to(dev), torch.from_numpy(b).to(dev)
    flags = torch.from_numpy(rng.choice(
        np.arange(4, dtype=np.uint8), shape,
        p=[0.5, 0.15, 0.2, 0.15])).to(dev)
    diags = sk.masked_diag(flags)[flags == 0]
    seen = sorted({int(d) for d in diags.unique().tolist()})
    if seen != [1, 2, 3, 4, 5, 6]:
        raise AssertionError(f"division sweep: diagonals {seen}")
    worst, mismatched = 0.0, 0
    for iters in (1, 2):
        for x0 in (x, None):
            pairs = [(sk.masked_rbgs_smooth(x0, b, flags, iters),
                      sk.masked_rbgs_smooth_plain(x0, b, flags, iters))]
            pairs += [(sk.rbgs_smooth(x0, b, bc, iters),
                       sk.rbgs_smooth_plain(x0, b, bc, iters))
                      for bc in ("neumann", "dirichlet")]
            for got, want in pairs:
                mismatched += int((got.view(torch.int32)
                                   != want.view(torch.int32)).sum())
                worst = max(worst, float((got.double() - want.double())
                                         .abs().max()))
    log(f"[kernels] smoother division sweep: diagonals {seen}, numerators "
        f"2^-140 .. 2^110: {mismatched} cells differ in their bits, "
        f"max_abs_err={worst:.3e} tol=0.0e+00")
    if mismatched or not np.isfinite(worst) or worst > 0.0:
        raise AssertionError(f"smoother division sweep: {mismatched} cells "
                             f"differ (max abs err {worst})")
    return worst


def smoother_phase(n, rng, dev):
    """Phase 2, the two red-black Gauss-Seidel smoothers, bit for bit
    against their plain versions on every grid of ``smoother_shapes`` in
    every mode: iters 1-4, forward and reverse, from x and from x=None (which
    must equal the explicit zeros bit for bit); the plain smoother for both
    bcs, the masked one with the obstacle scene's frame-0 flags coarsened by
    ``poisson.coarsen_flags`` to each level and an x that is nonzero on the
    non-fluid cells. Then the 2-sweep call, the V-cycle's unit, timed on
    each level that the V-cycle smooths with these kernels (its post-
    smoother form: from x, reverse; at n^3 also its pre-smoother form, from
    x=None) against its one-pass bound (each input read once, the result
    written once; per sweep 8 operations a cell that updates, and the
    masked operator's diagonal, 7 a cell, once)."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import poisson
    from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

    modes = [(iters, reverse, from_zero) for iters in (1, 2, 3, 4)
             for reverse in (False, True) for from_zero in (False, True)]
    shapes = smoother_shapes(n)
    flags_of = {}
    for top in ((n, n, n),) + EDGE_SHAPES:
        for s, f in obstacle_flag_levels(top, dev).items():
            flags_of.setdefault(s, f)
    kinds = {s: [int((f == v).sum()) for v in range(4)]
             for s, f in flags_of.items()}
    log(f"[kernels] smoother grids {shapes}; masked flags (fluid, air, "
        f"wall, object) by grid {kinds}")
    errs = {"rbgs_smooth": [], "masked_rbgs_smooth": []}
    for shape in shapes:
        b = smooth(shape, rng, 1.0, dev)
        x = smooth(shape, rng, 1.0, dev)   # nonzero on non-fluid cells too
        flags = flags_of[shape]
        for iters, reverse, from_zero in modes:
            x0 = None if from_zero else x
            label = ("x".join(map(str, shape)) + f" iters={iters}"
                     + (" reverse" if reverse else "")
                     + (" x=None" if from_zero else ""))
            cases = [("rbgs_smooth", bc,
                      lambda x0, bc=bc: sk.rbgs_smooth(x0, b, bc, iters,
                                                       reverse=reverse),
                      lambda x0, bc=bc: sk.rbgs_smooth_plain(x0, b, bc, iters,
                                                             reverse))
                     for bc in ("dirichlet", "neumann")]
            cases.append(("masked_rbgs_smooth", "masked",
                          lambda x0: sk.masked_rbgs_smooth(
                              x0, b, flags, iters, reverse=reverse),
                          lambda x0: sk.masked_rbgs_smooth_plain(
                              x0, b, flags, iters, reverse)))
            for name, tag, kernel, plain in cases:
                got = kernel(x0)
                want = plain(x0)
                err = float((got - want).abs().max())
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {tag} {label}: kernel "
                                         f"differs from its plain version "
                                         f"(max abs err {err})")
                if from_zero and not torch.equal(
                        got, kernel(torch.zeros_like(b))):
                    raise AssertionError(f"{name} {tag} {label}: x=None is "
                                         "not bitwise the explicit zeros")
                errs[name].append(err)
    for name, e in errs.items():
        log(f"[kernels] {name}: {len(e)} cases on {len(shapes)} grids, "
            f"max_abs_err={max(e):.3e} tol=0.0e+00")
    division = smoother_division_sweep(rng, dev)
    for e in errs.values():
        e.append(division)

    # the 2-sweep call timed on the levels the V-cycle smooths with these
    # kernels
    levels = [s for s in poisson.mg_shapes((n, n, n))
              if poisson._use_rbgs(s, 2)]
    results = {}
    for name in ("rbgs_smooth", "masked_rbgs_smooth"):
        masked = name == "masked_rbgs_smooth"
        per_level = []
        for shape in levels:
            b = smooth(shape, rng, 1.0, dev)
            x = smooth(shape, rng, 1.0, dev)
            flags = flags_of[shape]
            cells = b.numel()
            fluid = int((flags == 0).sum()) if masked else cells
            forms = [("from x, reverse", x, True)]
            if shape == levels[0]:
                forms.append(("x=None", None, False))
            for form, x0, reverse in forms:
                if masked:
                    def kernel(x0=x0, reverse=reverse):
                        return sk.masked_rbgs_smooth(x0, b, flags, 2,
                                                     reverse=reverse)

                    def plain(x0=x0, reverse=reverse):
                        return sk.masked_rbgs_smooth_plain(x0, b, flags, 2,
                                                           reverse)
                else:
                    def kernel(x0=x0, reverse=reverse):
                        return sk.rbgs_smooth(x0, b, "neumann", 2,
                                              reverse=reverse)

                    def plain(x0=x0, reverse=reverse):
                        return sk.rbgs_smooth_plain(x0, b, "neumann", 2,
                                                    reverse)
                inputs = 1 if x0 is None else 2
                nbytes = 4 * (inputs + 1) * cells + (cells if masked else 0)
                nops = 2 * 8 * fluid + (7 * cells if masked else 0)
                b_ms, b_by = bound_ms(nbytes, nops)
                reps = 200 if cells <= 64 ** 3 else 40
                k_ms = cuda_time(kernel, reps)
                # the kernel alone (the call above is host-bound on the
                # small levels)
                d_ms = device_ms(kernel, 20, "levels_kernel")
                p_ms = cuda_time(plain, 3, 1) if shape == levels[0] else None
                per_level.append(dict(shape=list(shape), form=form, ms=k_ms,
                                      device_ms=d_ms, plain_ms=p_ms,
                                      bound_ms=b_ms, bound_by=b_by))
                log(f"[kernels] {name} 2-sweep call {'x'.join(map(str, shape))}"
                    f" {form}: {k_ms:.4f} ms a call, {d_ms:.4f} ms on the "
                    f"card (plain {p_ms}, bound {b_ms:.4f} by {b_by})")
        main = per_level[0]
        results[name] = dict(
            max_abs_err=max(errs[name]), tol=0.0, ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=None, variants=per_level,
            levels_per_launch=sk.LEVELS_PER_LAUNCH,
            cases=len(errs[name]),
            replaces=("gpufluidsimulation_tpu/ops/pallas_kernels.py:311 "
                      "(_masked_rbgs_kernel, pallas_call :385)" if masked else
                      "gpufluidsimulation_tpu/ops/pallas_kernels.py:93 "
                      "(_rbgs_kernel, pallas_call :179)"))
    return results


def volume_phase(g, rng, dev, compare, positions):
    """Phase 2, the two volume-form kernels: ``volume_prefilter`` on
    100x200x200 and 37x29x45 and, timed, at the n^3 path's shapes on the u
    lattice (C=1) and the cell lattice (C=2, rho+T) against its plain
    version and, as a yardstick, one replicate-padded conv3d with the same
    3x3x3 weights; then ``vol9_phase``."""
    import torch
    import torch.nn.functional as F

    from gpufluidsimulation_tpu_torch.ops import interp_fast

    results = {}
    fu = smooth(g.shape_u, rng, 0.06, dev)[None].contiguous()
    fc = torch.stack([smooth(g.shape_c, rng, 1.0, dev),
                      smooth(g.shape_c, rng, 50.0, dev)]).contiguous()
    # yardstick weights: 0.5 delta + 0.5 S(x)S(x)S with S = [1/8, 3/4, 1/8]
    s1 = torch.tensor([0.125, 0.75, 0.125], dtype=torch.float64)
    w = 0.5 * s1[:, None, None] * s1[None, :, None] * s1[None, None, :]
    w[1, 1, 1] += 0.5
    w = w.to(torch.float32).to(dev)[None, None].contiguous()
    torch.backends.cudnn.allow_tf32 = False
    variants = []
    for shape in EDGE_SHAPES:
        for C in (1, 2):
            f = torch.stack([smooth(shape, rng, 1.0, dev)
                             for _ in range(C)]).contiguous()
            label = f"C={C} {'x'.join(map(str, shape))}"
            variants.append(dict(variant=label, tol=0.0, max_abs_err=compare(
                f"volume_prefilter {label}", interp_fast.volume_prefilter(f),
                interp_fast.volume_prefilter_plain(f), 0.0)))
    for label, f in (("C=1 u", fu), ("C=2 c", fc)):
        got = interp_fast.volume_prefilter(f)
        want = interp_fast.volume_prefilter_plain(f)
        tol = 0.0           # the same expressions, each computed once
        err = compare(f"volume_prefilter {label}", got, want, tol)
        k_ms = cuda_time(lambda: interp_fast.volume_prefilter(f), 20)
        p_ms = cuda_time(lambda: interp_fast.volume_prefilter_plain(f), 3, 1)

        def conv():
            return F.conv3d(F.pad(f[:, None], (1,) * 6, mode="replicate"), w)

        lib_err = float((conv()[:, 0] - got).abs().max())
        lib_ms = cuda_time(conv, 20)
        # each field read once, each output written once; per output 27
        # loads, 13 products and sums in the three passes, 3 for the blend
        b_ms, b_by = bound_ms(4 * 2 * f.numel(), f.numel() * (3 * 5 + 3))
        variants.append(dict(variant=label, max_abs_err=err, tol=tol,
                             ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms,
                             library_max_abs_err=lib_err))
        log(f"[kernels] volume_prefilter {label}: {k_ms:.4f} ms (plain "
            f"{p_ms:.3f}, bound {b_ms:.4f} by {b_by}, conv3d {lib_ms:.4f} "
            f"ms with max_abs_err {lib_err:.3e} against the kernel)")
    timed = [v for v in variants if "ms" in v]
    results["volume_prefilter"] = dict(
        timed[0], max_abs_err=max(v["max_abs_err"] for v in variants),
        variants=variants,
        replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:1492 "
                  "(_kernel_prefilter, pallas_call :1552 in _prefilter_padded; "
                  "entry volume_prefilter_fast :1571)"))

    results.update(vol9_phase(g, rng, dev, compare, positions))
    return results


def vol9_ops(gg, kind, n_any, n_chan):
    """float32 operations of the exact composition once floors, weights
    and lerps are shared, as the dual sampler's are (``dual_ops``): per
    node flagged for any channel, per axis the 3 stencil coordinates (an
    add and a division each) and their 3 weight sets (floor, fraction,
    1 - f); per map channel the distinct lerps of the 9 samples, 3
    operations each (x lerps 2|J||K| + 4, y lerps 4|K| + 2, 9 z lerps,
    with |J| and |K| the y and z nodes the stencil spans: 3 on the cell
    lattice, 2 along a face kind's staggered axis, where the three
    coordinates share one floor); the 27 clamps (2 each); per mapped point
    the field coordinates (a division and a subtraction per axis) and one
    weight set (9). Per flagged node and channel: 9 field samples of 7
    lerps, 7 corner sums and 3 for the blend."""
    off = gg.off_of(kind)
    J, K = (3 if o == 0.0 else 2 for o in off[1:])
    per_node = (3 * (3 * 2 + 3 * 3)
                + 3 * 3 * (2 * J * K + 4 + 4 * K + 2 + 9)
                + 27 * 2 + 9 * (3 * 2 + 9))
    return n_any * per_node + n_chan * (9 * 7 * 3 + 7 + 3)


def vol9_map_spread(gg, dev):
    """The floors of the vol9 kernel's map stencil on the card: for every
    node coordinate of every kind of grid `gg`, x0 = (i + off) h and the
    three coordinates (x0 + d h)/h, d = -1/4, 0, 1/4, in float32 with IEEE
    division as the kernel computes them, must be ordered with floors
    within floor(c0) and floor(c0) + 1. Returns the coordinates checked."""
    import torch

    from gpufluidsimulation_tpu_torch.core import interp

    h = gg.h
    checked = 0
    for kind in ("c", "u", "v", "w"):
        off = gg.off_of(kind)
        for ax, n in enumerate(gg.shape_of(kind)):
            x0 = (torch.arange(n, dtype=torch.float32, device=dev)
                  + off[ax]) * h
            c = [interp.div_scalar(x0 + float(np.float32(d) * np.float32(h)),
                                   h) for d in (-0.25, 0.0, 0.25)]
            b = torch.floor(c[0])
            ok = ((c[0] <= c[1]) & (c[1] <= c[2])
                  & (torch.floor(c[2]) - b <= 1))
            if not bool(ok.all()):
                raise AssertionError(f"vol9 map stencil on {gg.shape_c} "
                                     f"{kind} axis {ax}: floors span more "
                                     "than two nodes")
            checked += n
    return checked


def vol9_phase(g, rng, dev, compare, positions):
    """Phase 2, ``vol9_fixup``: bit for bit against its plain version, u
    (C=1, the error stage's clamp and band) and rho+T (C=2, the advect
    stage's), with every block flagged (tol = 0) and at the default tol.
    On 100x200x200 and 37x29x45 through a map stretched to reach 3 cells
    past the domain on every face (so that mapped positions clamp on
    every face) with a smooth wobble; on the n^3 grid through a map
    displaced by up to ~2 cells, timed. The vol9 fields are a smooth
    patch per channel (u: x < n*3/8; rho: x >= n/2, y < n/2; T: y >= n*5/8)
    over a faint short wave, so at the default tol only the blocks near a
    patch are flagged, the two channels' flags differ, and the unflagged
    nodes' dual values differ from the exact composition: a kernel that
    ignored the flags, mixed up the block index or read another channel's
    flag would disagree with the plain version. The floors of the map
    stencil are checked on the card for every grid (``vol9_map_spread``)."""
    import torch

    from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    h = g.h

    def vol9_field(shape, amp, xs, ys):
        """A smooth field of size `amp` on the nodes of x range `xs` and y
        range `ys`, over a background wave of 1/1000 of it, ~6 cells long,
        where the decision falls below tol but the dual form still differs
        from the exact composition."""
        f = smooth(shape, rng, amp, dev)
        mask = torch.zeros_like(f, dtype=torch.bool)
        mask[xs, ys] = True
        idx = torch.meshgrid(*[torch.arange(m, device=dev, dtype=torch.float32)
                               for m in shape], indexing="ij")
        k = rng.uniform(0.8, 1.2, 3)
        wave = torch.sin(sum(float(kk) * ii for kk, ii in zip(k, idx))
                         + float(rng.uniform(0, 2 * np.pi)))
        return torch.where(mask, f, 0.0) + (amp / 1000) * wave

    def fields_of(gg):
        n0, n1 = gg.shape_c[:2]
        vu = vol9_field(gg.shape_u, 1.0, slice(0, 3 * n0 // 8),
                        slice(None))[None].contiguous()
        vc = torch.stack([
            vol9_field(gg.shape_c, 1.0, slice(n0 // 2, None),
                       slice(0, n1 // 2)),
            vol9_field(gg.shape_c, 50.0, slice(None),
                       slice(5 * n1 // 8, None))]).contiguous()
        return (("C=1 u", vu, "u", 0.0, 1), ("C=2 c", vc, "c", 1.0, 2))

    def band_of(gg, kind, band_lo):
        dim = gg.dim_of(kind)
        return (band_lo + dim[0], band_lo + dim[1], band_lo + dim[2],
                band_lo + 1)

    errs = []
    spread = vol9_map_spread(g, dev)
    for shape in EDGE_SHAPES:
        gg = Grid3D(*shape, 0.2 / shape[0])
        hh = gg.h
        tag = "x".join(map(str, shape))
        spread += vol9_map_spread(gg, dev)
        lat = torch.stack(gg.node_coords("c", device=dev))
        n_ = torch.tensor(shape, dtype=torch.float32, device=dev).reshape(
            3, 1, 1, 1)
        maps = (lat * ((n_ + 6.0) / n_) - 3.0 * hh + torch.stack(
            [smooth(shape, rng, 0.5 * hh, dev) for _ in range(3)]))
        maps = maps.contiguous()
        stats = interp_fast.vol9_map_stats(maps, hh, shape)
        for label, f, kind, clamp, band_lo in fields_of(gg):
            lo, hi = interp_fast.clamp_bounds(gg, clamp, clamp)
            for a in range(3):
                if not (bool((maps[a] < lo[a]).any())
                        and bool((maps[a] > hi[a]).any())):
                    raise AssertionError(f"vol9_fixup {tag}: the map does "
                                         f"not clamp on both faces of {a}")
            band = band_of(gg, kind, band_lo)
            p1 = mp.map_at_lattice_3d(gg, maps, kind, clamp, clamp)
            duals = interp_fast.trilerp_sample(
                f, *(p.contiguous() for p in p1), hh,
                (gg.off_of(kind),) * len(f), dual=True)
            for tol_label, tol in (("tol=0", 0.0), ("default tol", None)):
                got = interp_fast.vol9_fixup(duals.clone(), f, stats, maps,
                                             p1, gg, kind, clamp, clamp,
                                             band=band, tol=tol)
                want = interp_fast.vol9_fixup_plain(duals, f, stats, maps, p1,
                                                    gg, kind, clamp, clamp,
                                                    band=band, tol=tol)
                errs.append(compare(f"vol9_fixup {tag} {label} {tol_label}",
                                    got, want, 0.0))
    log(f"[kernels] vol9_fixup map stencil: {spread} node coordinates, "
        "floors within two adjacent nodes")
    results = {}
    maps = torch.stack(positions("c")).contiguous()
    stats = interp_fast.vol9_map_stats(maps, h, g.shape_c)
    n0, n1 = g.shape_c[:2]
    vu = vol9_field(g.shape_u, 1.0, slice(0, 3 * n0 // 8),
                    slice(None))[None].contiguous()
    vc = torch.stack([
        vol9_field(g.shape_c, 1.0, slice(n0 // 2, None), slice(0, n1 // 2)),
        vol9_field(g.shape_c, 50.0, slice(None),
                   slice(5 * n1 // 8, None))]).contiguous()
    variants = []
    for label, f, kind, clamp, band_lo in (("C=1 u", vu, "u", 0.0, 1),
                                           ("C=2 c", vc, "c", 1.0, 2)):
        dim = g.dim_of(kind)
        band = (band_lo + dim[0], band_lo + dim[1], band_lo + dim[2],
                band_lo + 1)
        p1 = mp.map_at_lattice_3d(g, maps, kind, clamp, clamp)
        duals = interp_fast.trilerp_sample(
            f, *(p.contiguous() for p in p1), h, (g.off_of(kind),) * len(f),
            dual=True)
        for tol_label, tol in (("tol=0", 0.0), ("default tol", None)):
            name = f"{label} {tol_label}"
            flags = interp_fast.vol9_flags(f, p1, stats, g.shape_c, h, dim,
                                           clamp, clamp, band=band, tol=tol)
            got = interp_fast.vol9_fixup(duals.clone(), f, stats, maps, p1, g,
                                         kind, clamp, clamp, band=band,
                                         tol=tol)
            want = interp_fast.vol9_fixup_plain(duals, f, stats, maps, p1, g,
                                                kind, clamp, clamp, band=band,
                                                tol=tol)
            scale = max(1.0, float(want.abs().max()))
            err = compare(f"vol9_fixup {name}", got, want, 0.0)
            out = duals.clone()
            k_ms = cuda_time(lambda: interp_fast.vol9_launch(
                out, f, maps, flags, g, kind, clamp, clamp), 10)
            call_ms = cuda_time(lambda: interp_fast.vol9_fixup(
                out, f, stats, maps, p1, g, kind, clamp, clamp, band=band,
                tol=tol), 10)
            p_ms = cuda_time(lambda: interp_fast.vol9_fixup_plain(
                duals, f, stats, maps, p1, g, kind, clamp, clamp, band=band,
                tol=tol), 2, 1)
            # the work of this run's flags: vol9_ops operations; the flags
            # and the flagged share of the map read once, each flagged
            # node's field read and output written once (the in-place
            # kernel reads no dual value)
            _, block, _ = interp_fast.vol9_blocks(g.shape_c)
            node_flags = interp_fast._expand_flags(flags, f.shape[1:], block)
            n_chan = int(node_flags.sum())
            n_any = int(node_flags.any(dim=0).sum())
            share = n_any / node_flags[0].numel()
            nbytes = (flags.numel() + 4 * share * maps.numel()
                      + 4 * 2 * n_chan)
            b_ms, b_by = bound_ms(nbytes, vol9_ops(g, kind, n_any, n_chan))
            flagged = float(flags.float().mean())
            if tol == 0.0:
                exact = want
            else:
                # the default tol must leave blocks unflagged where the
                # exact composition differs from the dual value, and the
                # channels' flags must differ, or the flags go untested
                miss = float((exact - duals).abs()[~node_flags].max())
                log(f"[kernels] vol9_fixup {name}: a kernel that ignored the "
                    f"flags would be off by {miss:.3e} (scale {scale:.3e})")
                if not 0.0 < flagged < 1.0 or not miss > 10e-6 * scale:
                    raise AssertionError(
                        f"vol9_fixup {name}: the flags go untested: flagged "
                        f"share {flagged}, unflagged nodes off by {miss}")
                if len(f) > 1 and torch.equal(flags[0], flags[1]):
                    raise AssertionError(f"vol9_fixup {name}: the channels' "
                                         "flags are equal")
            variants.append(dict(variant=name, max_abs_err=err,
                                 tol=0.0, ms=k_ms, call_ms=call_ms,
                                 plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None, flagged_share=flagged))
            log(f"[kernels] vol9_fixup {name}: kernel {k_ms:.4f} ms, with "
                f"the flag prepass {call_ms:.4f} ms (plain {p_ms:.3f}, bound "
                f"{b_ms:.4f} by {b_by}); {100 * flagged:.1f}% of the block "
                "channels flagged")
    results["vol9_fixup"] = dict(
        variants[0], max_abs_err=max([v["max_abs_err"] for v in variants]
                                     + errs),
        variants=variants, edge_max_abs_err=max(errs), spread=spread,
        replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:2816 "
                  "(_kernel_vol9fix, pallas_call :2995 in _vol9_fixup_padded; "
                  "entries vol9_fixup :3012, sample3_vol9 :3075)"))
    return results


def pullback_fields(g, kinds, rng, device):
    """One smooth field per kind: velocity components of size 0.06, and
    for the cell kind rho and T (sizes 1 and 50) in turn."""
    scales = iter((1.0, 50.0) * 2)
    return [smooth(g.shape_of(k), rng, next(scales) if k == "c" else 0.06,
                   device).contiguous() for k in kinds]


def wobbled_map(g, rng, amp_cells, device):
    """The identity map plus a smooth displacement of up to `amp_cells`."""
    import torch

    return torch.stack([p + smooth(g.shape_c, rng, amp_cells * g.h, device)
                        for p in g.node_coords("c", device=device)]
                       ).contiguous()


# the fused pull-back's kind sets: the velocity triplet and rho+T, timed;
# and mixed sets with a repeated kind, compared only
PULLBACK_KINDS = (("u", "v", "w"), ("c", "c"))
PULLBACK_MIXED = (("u", "c", "c"), ("u", "v", "w", "c"))


def pullback_clip(maps, dims, h, n3, extent, clamp):
    """The share of a pull-back's outputs whose map position is clipped,
    and for each channel the grid_sample grid (border, align_corners) of
    the positions it samples."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import interp_fast

    grids5, clipped = [], 0.0
    for d in dims:
        pos = interp_fast.pullback_positions(maps, d, h, n3, extent)
        hit = torch.zeros_like(pos[0], dtype=torch.bool)
        gpos = []
        for p, n, s in zip(pos, n3, d):
            hit |= (p < clamp) | (p > n - clamp)
            gpos.append(p.clamp(clamp, n - clamp) + 0.5 * s)
        clipped += float(hit.float().mean()) / len(dims)
        ext = [n + s for n, s in zip(n3, d)]
        grids5.append(torch.stack([
            gpos[a] * (2.0 / (ext[a] - 1)) - 1.0 for a in (2, 1, 0)],
            dim=-1)[None])
    return clipped, grids5


def pullback_phase(g, rng, dev, compare):
    """Phase 2, the fused multi-kind pull-back: bit for bit against its
    plain version on the n^3 grid, the reference scene's 100x200x200 and a
    ragged 37x29x45, for the velocity triplet (C=3), rho+T (C=2), (u, c,
    c) and (u, v, w, c), clamps (1, 1) and (0, 0), through a map displaced
    by a smooth wobble of up to 3 cells, so that some nodes near the faces
    are clipped and most are not (the run fails otherwise). The velocity
    triplet and rho+T are timed on the n^3 grid. No one PyTorch call
    computes the function (the map at each kind's lattice, the clip and
    the sample of fields of several shapes), so its library time is null;
    as a yardstick for the sampling part alone, grid_sample (border,
    align_corners) of the same fields at the positions the kernel samples
    is timed beside it."""
    import torch
    import torch.nn.functional as F

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    variants, errs = [], []
    for shape in (g.shape_c,) + EDGE_SHAPES:
        gg = g if shape == g.shape_c else Grid3D(*shape, 0.2 / shape[0])
        h, n3 = gg.h, gg.shape_c
        maps = wobbled_map(gg, rng, 3.0, dev)
        for kinds in PULLBACK_KINDS + PULLBACK_MIXED:
            fields = pullback_fields(gg, kinds, rng, dev)
            dims = [gg.dim_of(k) for k in kinds]
            for clamp in (1.0, 0.0):
                label = (f"{''.join(kinds)} clamp ({clamp:g}, {clamp:g})"
                         + ("" if gg is g else " " + "x".join(map(str, shape))))
                args = (maps, fields, dims, h, n3, clamp, clamp)
                got = interp_fast.pullback_sample(*args)
                want = interp_fast.pullback_sample_plain(*args)
                errs.append(compare(f"pullback_sample {label}", got, want,
                                    0.0))
                clipped, grids5 = pullback_clip(maps, dims, h, n3,
                                                got.shape[1:], clamp)
                if not 0.0 < clipped < 1.0:
                    raise AssertionError(f"pullback_sample {label}: clipped "
                                         f"share {clipped}, the clip goes "
                                         "untested")
                if gg is not g or kinds not in PULLBACK_KINDS:
                    continue
                # one grid_sample per distinct kind: (c, c) shares its
                # positions
                calls = []
                for kind in dict.fromkeys(kinds):
                    idx = [i for i, k in enumerate(kinds) if k == kind]
                    src = torch.stack([fields[i] for i in idx])[None]
                    calls.append((idx, src, grids5[idx[0]]))

                def yardstick():
                    return [F.grid_sample(src, grid5, mode="bilinear",
                                          padding_mode="border",
                                          align_corners=True)
                            for _, src, grid5 in calls]

                lib_err = max(float((r[0, q] - got[i]).abs().max())
                              for (idx, _, _), r in zip(calls, yardstick())
                              for q, i in enumerate(idx))
                k_ms = cuda_time(lambda: interp_fast.pullback_sample(*args),
                                 20)
                p_ms = cuda_time(lambda: interp_fast.pullback_sample_plain(
                    *args), 3, 1)
                y_ms = cuda_time(yardstick, 20)
                # the map and each field read once, each output written
                # once; per output and map channel a division and the clip
                # (2), on a staggered kind one more division, the add and
                # the halving, then the half-cell shift and one trilerp
                n_out = got[0].numel()
                nbytes = 4 * (maps.numel() + sum(f.numel() for f in fields)
                              + got.numel())
                nops = n_out * sum(9 + (10 if any(d) else 0) + TRILERP_OPS
                                   for d in dims)
                b_ms, b_by = bound_ms(nbytes, nops)
                variants.append(dict(
                    variant=label, tol=0.0, ms=k_ms, plain_ms=p_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    clipped_share=clipped, sampling_grid_sample_ms=y_ms,
                    sampling_grid_sample_max_abs_err=lib_err))
                log(f"[kernels] pullback_sample {label}: {k_ms:.4f} ms "
                    f"(plain {p_ms:.3f}, bound {b_ms:.4f} by {b_by}; "
                    f"grid_sample of the sampling part alone {y_ms:.4f} ms, "
                    f"max_abs_err {lib_err:.3e} against the kernel); "
                    f"{100 * clipped:.2f}% of the outputs clipped")
    for v_ in variants:
        v_["max_abs_err"] = max(errs)
    return {"pullback_sample": dict(
        variants[0], variants=variants,
        replaces=("gpufluidsimulation_tpu/ops/interp_fast.py:2154 "
                  "(_kernel_pullback, pallas_call :2291 in _pullback_padded; "
                  "entry sample3_pullback :2344)"))}


def bench_config(n, scheme=None, **overrides):
    """The main-path configuration as bench.py builds it (scheme BiMocq
    unless `scheme` names another)."""
    from gpufluidsimulation_tpu_torch.scenes.scenes3d import (
        vortex_collision_config)
    from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Emitter3D

    return vortex_collision_config(
        ni=n, nj=n, nk=n, scheme=Scheme.BIMOCQ if scheme is None else scheme,
        dt=8.0 / n,
        emitters=(
            Emitter3D(center=(0.04, 0.10, 0.10), radius=0.015, sign=1.0),
            Emitter3D(center=(0.16, 0.101, 0.10), radius=0.015, sign=-1.0),
        ),
        proj_tol=1e-4, proj_max_iters=30, **overrides,
    )


def obstacle_config(n, **overrides):
    """The moving-obstacle configuration as scripts/bench_matrix.py builds
    it: the packaged scene at n^3, dt = 1.6/n, MG-PCG to 1e-4 in at most
    40 iterations."""
    from gpufluidsimulation_tpu_torch.scenes.scenes3d import (
        moving_obstacle_config)

    return moving_obstacle_config(ni=n, nj=n, nk=n, proj_tol=1e-4,
                                  proj_max_iters=40, **overrides)


FIELDS = ("u", "v", "w", "rho", "T", "u_init", "v_init", "w_init")


def parity_phase(cfg, label, steps=3):
    """Phase 3: `steps` steps of the port on the card against the port on
    the CPU from one numpy state. With boundaries the flags must be
    identical and the CG iteration counts equal."""
    import torch

    from gpufluidsimulation_tpu_torch import convert
    from gpufluidsimulation_tpu_torch.solvers import smoke3d

    gpu = smoke3d.Smoke3D(cfg)
    cpu = smoke3d.Smoke3D(cfg, device="cpu")
    start = convert.state_to_numpy(cpu.init_state())
    sg = convert.state_from_numpy(start, cfg, gpu.device)
    sc = convert.state_from_numpy(start, cfg, "cpu")
    worst = {}
    iters, reinits = [], []
    for k in range(steps):
        sg = gpu.step(sg)
        sc = cpu.step(sc)
        for key in ("substeps", "vel_last_reinit", "scalar_last_reinit"):
            if getattr(sg, key) != getattr(sc, key):
                raise AssertionError(
                    f"parity {label} step {k}: {key} {getattr(sg, key)} "
                    f"(card) != {getattr(sc, key)} (cpu)")
        if cfg.boundaries:
            if sg.proj_iters != sc.proj_iters:
                raise AssertionError(
                    f"parity step {k}: proj_iters {sg.proj_iters} (card) != "
                    f"{sc.proj_iters} (cpu)")
            fg, fc = (smoke3d._update_boundary(
                cfg, cfg.grid, k, cfg.dt,
                smoke3d.boundary_base_flags(cfg.grid, dev))[0]
                for dev in (gpu.device, "cpu"))
            if not torch.equal(fg.cpu(), fc):
                raise AssertionError(f"parity step {k}: flags differ")
        iters.append(sg.proj_iters)
        reinits.append((sg.vel_last_reinit, sg.scalar_last_reinit))
    a, b = convert.state_to_numpy(sg), convert.state_to_numpy(sc)
    for key in FIELDS:
        err = float(np.abs(a[key].astype(np.float64) - b[key]).max())
        scale = max(1.0, float(np.abs(b[key]).max()))
        worst[key] = err
        # fp32 with another summation order (cuBLAS vs CPU BLAS in the
        # dense contractions, the CG dots): the 2e-3 fidelity bound of
        # tests/test_fidelity3d.py, relative to the field's scale
        if not np.isfinite(err) or err > 2e-3 * scale:
            raise AssertionError(f"parity {label} {key}: card vs cpu {err}")
    n = cfg.ni
    log(f"[parity] {label} {n}^3, {steps} steps, proj_iters {iters}, "
        f"(vel, scalar) last reinit {reinits}, card vs cpu max abs err "
        "(bound 2e-3 of scale): " + json.dumps(worst))
    return worst


def mgpcg_parity_phase(n=32, seed=1):
    """Phase 3: one MG-PCG solve of a seeded right-hand side, card
    against CPU: same iteration count, p within 1e-4 of its scale."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import poisson

    b = np.random.default_rng(seed).standard_normal((n, n, n)).astype(
        np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        ctx = poisson.MGContext((n, n, n), "dirichlet", dev)
        out[dev] = poisson.mgpcg(torch.from_numpy(b).to(dev), ctx, 1e-5, 40)
    (pg, ig, rg, _), (pc, ic, rc, _) = out["cuda"], out["cpu"]
    err = float((pg.cpu() - pc).abs().max())
    tol = 1e-4 * float(pc.abs().max())
    log(f"[parity] mgpcg {n}^3: iters card {ig} cpu {ic}, res card "
        f"{float(rg):.3e} cpu {float(rc):.3e}, p max_abs_err={err:.3e} "
        f"tol={tol:.1e}")
    if ig != ic or not ig < 40 or not err <= tol:
        raise AssertionError("mgpcg: card and cpu disagree")


def octasphere(r, sub=2):
    """A triangle mesh of a sphere of radius r: the octahedron subdivided
    `sub` times with its vertices pushed onto the sphere."""
    verts = [np.array(v, float) for v in
             ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1))]
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4), (2, 0, 5),
             (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    for _ in range(sub):
        cache = {}

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (verts[i] + verts[j]) / 2
                cache[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return cache[key]

        faces = [t for a, b, c in faces
                 for ab, bc, ca in [(mid(a, b), mid(b, c), mid(c, a))]
                 for t in ((a, ab, ca), (ab, b, bc), (ca, bc, c),
                           (ab, bc, ca))]
    return ((np.array(verts) * r).astype(np.float32),
            np.asarray(faces, np.int32))


def voxel_obstacle_config(n, **overrides):
    """The obstacle configuration with its sphere replaced by a voxel level
    set: ``mesh_to_sdf`` of an octasphere of the same radius on a cube of
    cells around it, placed so that the level set's centre is the
    sphere's, moving by the scene's own trans."""
    import dataclasses

    from gpufluidsimulation_tpu_torch.io_utils import mesh
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Boundary3D

    cfg = obstacle_config(n, **overrides)
    (bd,) = cfg.boundaries
    h = cfg.h
    m = int(np.ceil(2 * bd.radius / h)) + 4
    half = (m - 1) * h / 2
    verts, faces = octasphere(bd.radius, sub=3)
    sdf = mesh.mesh_to_sdf(verts + half, faces, (m, m, m), h)
    voxel = Boundary3D(center=tuple(c - half for c in bd.center),
                       kind="voxel", sdf_grid=sdf, trans=bd.trans)
    return dataclasses.replace(cfg, boundaries=(voxel,))


def voxel_emitter_config(n, **overrides):
    """The main-path configuration with one moving voxel emitter: a sphere
    level set of radius 0.015 (8 cells a side at 32^3) moving 0.002 a
    frame in x and emitting the velocity (0.05, 0.01 sin(40 y), 0) of its
    emit_velocity."""
    import dataclasses

    import torch

    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Emitter3D

    h = 0.2 / n
    m = int(np.ceil(0.03 / h)) + 4
    x = np.arange(m) * h
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    c = (m - 1) * h / 2
    sdf = (np.sqrt((X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2)
           - 0.015).astype(np.float32)

    def trans(frame):
        return (np.float32(0.002) * frame, 0.0, 0.0)

    def emit_velocity(X, Y, Z):
        return (0.05 * torch.ones_like(X), 0.01 * torch.sin(40.0 * Y),
                torch.zeros_like(Z))

    em = Emitter3D(center=(0.04 - c, 0.1 - c, 0.1 - c), sdf_grid=sdf,
                   trans=trans, emit_velocity=emit_velocity)
    return dataclasses.replace(bench_config(n, **overrides), emitters=(em,))


def multi_parity_phase(n=32, seed=2, blend=0.5):
    """Phase 3: ``bimocq_advect_multi_3d`` (the fused prefilter form) on
    the card against the port on the CPU, the same numpy inputs, for the
    velocity triplet and rho+T: within 1e-5 of each field's scale (the
    kernels are their plain versions to the bit; what differs is the
    rounding of the elementwise glue, if any)."""
    import torch

    from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
    from gpufluidsimulation_tpu_torch.core.grids import Grid3D

    g = Grid3D(n, n, n, 0.2 / n)
    rng = np.random.default_rng(seed)
    for kinds in PULLBACK_KINDS:
        cur, init, prev = (pullback_fields(g, kinds, rng, "cpu")
                           for _ in range(3))
        bwd, fwd, bwd_prev = (wobbled_map(g, rng, a, "cpu")
                              for a in (1.5, 1.5, 0.75))
        out = {}
        for dev in ("cuda", "cpu"):
            def on(fs):
                return [f.to(dev) for f in fs]

            out[dev] = mp.bimocq_advect_multi_3d(
                g, kinds, on(cur), on(init), on(prev), bwd.to(dev),
                bwd_prev.to(dev), fwd.to(dev), blend)
        errs = []
        for kind, a, b in zip(kinds, out["cuda"], out["cpu"]):
            err = float((a.cpu() - b).abs().max())
            scale = float(b.abs().max())
            errs.append(err / scale)
            if not err <= 1e-5 * scale:
                raise AssertionError(f"multi parity {kind}: card vs cpu "
                                     f"{err} of scale {scale}")
        log(f"[parity] bimocq_advect_multi_3d {''.join(kinds)} {n}^3 blend "
            f"{blend}: card vs cpu max abs err over scale {errs} (bound "
            "1e-5)")


KERNELS = ("trilerp_sample", "rk3_substep", "dmc_substep", "jacobi_diffuse",
           "rbgs_smooth", "masked_rbgs_smooth", "minmax_sample",
           "volume_prefilter", "vol9_fixup", "pullback_sample",
           "bilerp_sample", "p2g_splat")
# the kernels of the main path
MAIN_KERNELS = KERNELS[:4] + ("volume_prefilter",)
# redesigned for Hopper after their first port (PERF.md, kernel table)
REDESIGNED = ("trilerp_sample", "jacobi_diffuse", "rk3_substep",
              "volume_prefilter", "dmc_substep", "vol9_fixup", "rbgs_smooth",
              "masked_rbgs_smooth", "minmax_sample", "pullback_sample",
              "p2g_splat", "bilerp_sample")
# the lattice modes of rk3_substep and dmc_substep, each launched under its
# own count
LATTICE = {"rk3_substep": "rk3_substep_lattice",
           "dmc_substep": "dmc_substep_lattice"}
# every kernel's other modes with a wrapper and a count of their own: the
# lattice modes and bilerp_sample's mac, cp, trace and DMC modes
MODES = {name: (mode,) for name, mode in LATTICE.items()}
MODES["bilerp_sample"] = ("bilerp_sample_mac", "bilerp_sample_cp",
                          "bilerp_trace", "bilerp_dmc")


def wrappers():
    """Every launching wrapper by name: one per kernel, and the other
    modes."""
    from gpufluidsimulation_tpu_torch.ops import interp_fast, stencil_kernels

    return {name: getattr(interp_fast, name, None)
            or getattr(stencil_kernels, name)
            for name in KERNELS + sum(MODES.values(), ())}


def kernel_launches(counts, name):
    """Launches of kernel `name` in `counts` (by wrapper), those of its
    other modes included."""
    return counts[name] + sum(counts[m] for m in MODES.get(name, ()))


def timed_steps(solver, steps, expect, warm=lambda state: True,
                max_warmup=150, on_reset=lambda: None):
    """Drive one path: from the initial state, warm-up steps until
    `warm(state)` (at least one, at most `max_warmup`), then reset every
    launch count (and call `on_reset`), run and time `steps` steps with
    CUDA events and read the counts; fail if a kernel of `expect` never
    launched or a field is not finite. The state lives only here, so the
    peak memory is one path's."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import interp_fast

    fns = wrappers()
    t0 = time.time()
    state = solver.step(solver.init_state())
    warmup_steps = 1
    while warmup_steps < max_warmup and not warm(state):
        state = solver.step(state)
        warmup_steps += 1
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    gc.collect()                    # earlier phases' tensors are not this path's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # the state and what is cached
    for fn in fns.values():
        fn.launches = 0
    interp_fast.reset_vol9_block_counts()
    on_reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    per_step = []
    t0 = time.time()
    start.record()
    for _ in range(steps):
        state = solver.step(state)
        per_step.append(dict(substeps=state.substeps,
                             proj_iters=state.proj_iters,
                             reinit=(state.vel_last_reinit,
                                     state.scalar_last_reinit)))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.time() - t0) / steps * 1e3
    dev_ms = start.elapsed_time(end) / steps
    launches = {k: fn.launches for k, fn in fns.items()}
    vol9_blocks = interp_fast.vol9_block_counts()
    missing = [k for k in expect if kernel_launches(launches, k) == 0]
    if missing:
        raise AssertionError(f"the path never launched {missing}")
    for key in FIELDS:
        if not bool(torch.isfinite(getattr(state, key)).all()):
            raise AssertionError(f"non-finite {key}")
    n = solver.cfg.ni
    res = dict(n=n, steps=steps, warmup_steps=warmup_steps,
               warmup_s=warmup_s, ms_per_step=dev_ms, host_ms_per_step=host_ms,
               mcells_per_s=solver.cfg.ni * solver.cfg.nj * solver.cfg.nk
               / 1e6 / (dev_ms / 1e3),
               substeps=[p["substeps"] for p in per_step],
               proj_iters=[p["proj_iters"] for p in per_step],
               last_reinit=[p["reinit"] for p in per_step],
               proj_res=float(state.proj_res), cfl=state.cfl,
               rho_max=float(state.rho.max()), launches=launches,
               vol9_blocks_exact_total=vol9_blocks,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               held_before_gib=held / 2 ** 30)
    return state, res


def observe_smoother_calls(calls):
    """Record every smoother call in `calls` as (kernel, iters, launches it
    made) until the returned function is called. Only observes: the call
    runs as it would."""
    from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

    launch = sk._launch_levels

    def observed(wrapper, name, fn, x, b, extra, iters, reverse):
        before = wrapper.launches
        out = launch(wrapper, name, fn, x, b, extra, iters, reverse)
        calls.append((name, int(iters), wrapper.launches - before))
        return out

    sk._launch_levels = observed

    def restore():
        sk._launch_levels = launch
    return restore


def smoother_stats(calls, name, steps):
    """Calls and launches a step of smoother `name` in the timed steps;
    fails unless each call made ceil(2 iters / LEVELS_PER_LAUNCH) launches
    (one for the V-cycle's 2-sweep calls)."""
    from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

    mine = [c for c in calls if c[0] == name]
    wrong = [c for c in mine
             if c[2] != -(-2 * c[1] // sk.LEVELS_PER_LAUNCH)]
    if not mine or wrong:
        raise AssertionError(f"{name}: {len(mine)} calls, launches not "
                             f"ceil(2 iters / {sk.LEVELS_PER_LAUNCH}) in "
                             f"{wrong[:5]}")
    return dict(calls_per_step=len(mine) / steps,
                launches_per_step=sum(c[2] for c in mine) / steps,
                iters=sorted({c[1] for c in mine}),
                levels_per_launch=sk.LEVELS_PER_LAUNCH)


def observe_trace_clamps(calls):
    """Record, until the returned function is called, every minmax_sample
    call that ops/advect.py makes as ("minmax_sample", sample mode), and
    every trilerp_sample call it makes at the positions of its last
    minmax_sample call as ("fallback", False): the trace clamp's fallback
    sample made by a launch of its own. advect's calls go through an
    observer of the module; the wrappers themselves, and their counts,
    are untouched."""
    from gpufluidsimulation_tpu_torch.ops import advect, interp_fast

    last = []

    class Observer:
        def __getattr__(self, name):
            return getattr(interp_fast, name)

        @staticmethod
        def minmax_sample(fields, px, *args, sample=False):
            calls.append(("minmax_sample", bool(sample)))
            last[:] = [px]
            return interp_fast.minmax_sample(fields, px, *args,
                                             sample=sample)

        @staticmethod
        def trilerp_sample(fields, px, *args, **kwargs):
            if last and px is last[0]:
                calls.append(("fallback", False))
            return interp_fast.trilerp_sample(fields, px, *args, **kwargs)

    advect.interp_fast = Observer()

    def restore():
        advect.interp_fast = interp_fast
        last.clear()
    return restore


def main_phase(n, steps, profile):
    """Phase 4: the main path through the entry points, launches counted."""
    from gpufluidsimulation_tpu_torch.ops import interp_fast, stencil_kernels
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D

    solver = Smoke3D(bench_config(n))
    # the identity peel of the backward march is the lattice mode of
    # dmc_substep: no plain displacement work may run on the card
    plain_calls = []
    displacements = interp_fast.dmc_displacements

    def counted(u, *args):
        if u.is_cuda:
            plain_calls.append(tuple(u.shape))
        return displacements(u, *args)

    interp_fast.dmc_displacements = counted
    try:
        state, res = timed_steps(solver, steps, MAIN_KERNELS)
    finally:
        interp_fast.dmc_displacements = displacements
    if plain_calls:
        raise AssertionError(f"the main path computed {len(plain_calls)} "
                             "plain DMC displacements on the card")
    if not 0.0 < res["rho_max"] <= 10.0:
        raise AssertionError(f"implausible rho_max={res['rho_max']}")
    # 12 dual pull-back samples (3 stages x u, v, w, rho+T), 3 viscosity
    # solves of 20 sweeps, s sweeps a launch, the forward- and backward-map
    # marches' 3 substeps each (the first in the lattice mode) and the 3
    # post-reinit accumulates' prefilters, per step
    counts = res["launches"]
    per_step = {k: kernel_launches(counts, k) / steps
                for k in ("trilerp_sample", "jacobi_diffuse", "rk3_substep",
                          "dmc_substep", "volume_prefilter")}
    for lattice in LATTICE.values():
        per_step[lattice] = counts[lattice] / steps
    want = {"trilerp_sample": 12,
            "jacobi_diffuse": 3 * len(stencil_kernels.sweep_chunks(20)),
            "rk3_substep": 3, "dmc_substep": 3, "volume_prefilter": 3,
            "rk3_substep_lattice": 1, "dmc_substep_lattice": 1}
    if per_step != want:
        raise AssertionError(f"main path launches per step {per_step}, "
                             f"expected {want}")
    log("[main] " + json.dumps(res))
    if profile:
        profile_steps(solver, state, profile, "main path", "w",
                      res["ms_per_step"])
    return res["launches"], solver, res["ms_per_step"]


# the sharded main path: 4 slabs on the card, halo 8
SHARDED_SLABS = 4
SHARDED_HALO = 8
SHARDED_COMPARE_STEPS = 2
SHARDED_STEPS = 3


def sharded_phase(solver, single_ms, profile=None):
    """Phase 4b: the main path's step through ``parallel.sharding.
    sharded_step`` on a mesh of SHARDED_SLABS slabs on the one card (halo
    SHARDED_HALO; fast sampling on, as for cards): the map marches and
    the u, v and cell-kind pull-back samples run slab by slab in the
    kernels' slab modes, w's samples, the forces, the viscosity and the
    spectral projection whole on the card. Held against the main phase's
    single-device step (the same solver) after SHARDED_COMPARE_STEPS steps
    from the initial state: every field and map bit for bit (tolerance 0:
    no sample leaves its slab, so every slab launch gives the whole-grid
    launch's bits, and the rest is the same code on the same device), and
    interp_overflow and slab_clamped 0. Then 1 warm-up and SHARDED_STEPS
    timed steps with the launch counts (and the slab-mode counts) reset
    before and read after: per step D times the single-device marches'
    launches, of which the first substep's in the lattice mode, and 3 D +
    3 trilerp_sample launches a stage set (u, v and c sharded, w whole),
    all but w's in the slab mode."""
    import types

    import torch

    from gpufluidsimulation_tpu_torch.ops import interp_fast, stencil_kernels
    from gpufluidsimulation_tpu_torch.parallel.sharding import (
        make_mesh, shard_state, sharded_step)

    D = SHARDED_SLABS
    mesh = make_mesh(D, devices=[torch.device("cuda", 0)] * D)
    step = sharded_step(solver, mesh, halo=SHARDED_HALO)
    t0 = time.time()
    ref = solver.init_state()
    got = shard_state(solver.init_state(), mesh)
    for _ in range(SHARDED_COMPARE_STEPS):
        ref = solver.step(ref)
        got = step(got)
    errs = {}
    for key in FIELDS + ("rho", "T"):
        errs[key] = float((getattr(got, key) - getattr(ref, key)).abs().max())
    for key in ("fwd", "bwd"):
        errs[f"vel_map.{key}"] = float(
            (getattr(got.vel_map, key) - getattr(ref.vel_map, key))
            .abs().max())
    bad = {k: e for k, e in errs.items() if not e == 0.0}
    if (bad or got.interp_overflow != 0 or got.slab_clamped != 0
            or got.proj_iters != ref.proj_iters):
        raise AssertionError(f"sharded main path vs the single-device step "
                             f"after {SHARDED_COMPARE_STEPS} steps: {bad}, "
                             f"overflow {got.interp_overflow}, slab_clamped "
                             f"{got.slab_clamped}, proj_iters "
                             f"{got.proj_iters} / {ref.proj_iters}")
    log(f"[sharded] {D} slabs on one card, halo {SHARDED_HALO}: bit for bit "
        f"with the single-device step after {SHARDED_COMPARE_STEPS} steps "
        f"({json.dumps(errs)}), compared in {time.time() - t0:.1f} s")
    del ref, got
    slab_fns = [getattr(interp_fast, name) for name in SLAB_WRAPPERS]

    def reset_slab_counts():
        for fn in slab_fns:
            fn.slab_launches = 0

    path = types.SimpleNamespace(
        cfg=solver.cfg, step=step,
        init_state=lambda: shard_state(solver.init_state(), mesh))
    steps = SHARDED_STEPS
    state, res = timed_steps(path, steps, MAIN_KERNELS,
                             on_reset=reset_slab_counts)
    if state.interp_overflow != 0 or state.slab_clamped != 0:
        raise AssertionError(f"sharded main path: interp_overflow "
                             f"{state.interp_overflow}, slab_clamped "
                             f"{state.slab_clamped}")
    counts = res["launches"]
    subs = sum(res["substeps"])
    per_step = {k: kernel_launches(counts, k) for k in
                ("trilerp_sample", "jacobi_diffuse", "rk3_substep",
                 "dmc_substep", "volume_prefilter")}
    for lattice in LATTICE.values():
        per_step[lattice] = counts[lattice]
    want = {"trilerp_sample": (3 * D + 1) * 3 * steps,
            "jacobi_diffuse": 3 * len(stencil_kernels.sweep_chunks(20))
            * steps,
            "rk3_substep": D * subs, "dmc_substep": D * subs,
            "volume_prefilter": 3 * steps,
            "rk3_substep_lattice": D * steps,
            "dmc_substep_lattice": D * steps}
    slab = {fn.__name__: fn.slab_launches for fn in slab_fns}
    want_slab = {"trilerp_sample": 3 * D * 3 * steps,
                 "rk3_substep": D * (subs - steps),
                 "rk3_substep_lattice": D * steps,
                 "dmc_substep": D * (subs - steps),
                 "dmc_substep_lattice": D * steps}
    if per_step != want or slab != want_slab:
        raise AssertionError(f"sharded main path launches {per_step} (slab "
                             f"mode {slab}), expected {want} ({want_slab})")
    res.update(slabs=D, halo=SHARDED_HALO, slab_launches=slab,
               launches_per_step={k: c / steps for k, c in per_step.items()},
               slab_launches_per_step={k: c / steps
                                       for k, c in slab.items()},
               single_device_ms_per_step=single_ms,
               compare_steps=SHARDED_COMPARE_STEPS, max_abs_err=errs)
    log(f"[sharded] {res['ms_per_step']:.2f} ms/step against the "
        f"single-device {single_ms:.2f} (same solver, this run); launches a "
        f"step {json.dumps(res['launches_per_step'])}, slab mode "
        f"{json.dumps(res['slab_launches_per_step'])}; peak memory "
        f"{res['peak_mem_gib']:.2f} GiB")
    log("[sharded] " + json.dumps(res))
    if profile:
        profile_steps(path, state, profile, "sharded main path", "a",
                      res["ms_per_step"])
    return counts, slab


def obstacle_phase(n, steps, profile):
    """Phase 5: the moving-obstacle scene at full width. The plume starts
    at rest; warm-up steps run until it passes CFL 1, so that the timed
    steps substep both map marches as the developed flow does."""
    from gpufluidsimulation_tpu_torch.ops import forces, poisson
    from gpufluidsimulation_tpu_torch.solvers import smoke3d

    cfg = obstacle_config(n)
    solver = smoke3d.Smoke3D(cfg)
    calls = []
    restore = observe_smoother_calls(calls)
    try:
        state, res = timed_steps(
            solver, steps,
            ("masked_rbgs_smooth", "rk3_substep", "dmc_substep",
             "trilerp_sample", "jacobi_diffuse"),
            warm=lambda state: state.substeps >= 2, on_reset=calls.clear)
    finally:
        restore()
    res["smoother"] = smoother_stats(calls, "masked_rbgs_smooth", steps)
    if max(res["proj_iters"]) >= cfg.proj_max_iters:
        raise AssertionError(f"projection hit its iteration limit: "
                             f"{res['proj_iters']}")
    if not res["proj_res"] <= cfg.proj_tol:
        raise AssertionError(f"projection residual {res['proj_res']}")
    flags, us, vs, ws, _ = smoke3d._update_boundary(
        cfg, cfg.grid, state.frame - 1, cfg.dt, solver._base_flags)
    inside = flags == poisson.OBJECT
    rho_inside = float(state.rho[inside].abs().max())
    if rho_inside != 0.0 or not res["rho_max"] > 0.5:
        raise AssertionError(f"rho inside the object {rho_inside}, "
                             f"rho_max {res['rho_max']}")
    # the projection at full width against a right-hand side of known
    # scale: one more buoyancy kick on the stepped velocity, projected
    # with this frame's flags; the divergence left on fluid cells must be
    # below 10 * proj_tol of the divergence before
    v_kick = forces.buoyancy_3d(state.v, state.rho, state.T, cfg.alpha,
                                cfg.beta, cfg.dt)
    before = poisson.masked_divergence_3d(state.u, v_kick, state.w, flags,
                                          us, vs, ws)[0].abs().max()
    pu, pv, pw, _, iters, _, _ = poisson.project_masked_3d(
        state.u, v_kick, state.w, flags, us, vs, ws, solver.ctx,
        cfg.proj_tol, cfg.proj_max_iters)
    after = poisson.masked_divergence_3d(pu, pv, pw, flags, us, vs,
                                         ws)[0].abs().max()
    rel = float(after / before)
    if not rel < 10 * cfg.proj_tol or iters >= cfg.proj_max_iters:
        raise AssertionError(f"divergence on fluid cells {rel} of the "
                             f"right-hand side after {iters} iterations")
    log("[obstacle] " + json.dumps(dict(
        res, frame=state.frame,
        object_cells=int(inside.sum()), div_after_over_before=rel,
        check_iters=iters)))
    if profile:
        profile_steps(solver, state, profile, "obstacle path", "a",
                      res["ms_per_step"])
    return res["launches"], res["smoother"]


def mgpcg_phase(n, steps, profile):
    """Phase 6: the vortex path with the MG-PCG projection."""
    from gpufluidsimulation_tpu_torch.config import EngineMode
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D

    cfg = bench_config(n, engine_mode=EngineMode(spectral_poisson=False))
    solver = Smoke3D(cfg)
    calls = []
    restore = observe_smoother_calls(calls)
    try:
        state, res = timed_steps(solver, steps,
                                 MAIN_KERNELS + ("rbgs_smooth",),
                                 on_reset=calls.clear)
    finally:
        restore()
    res["smoother"] = smoother_stats(calls, "rbgs_smooth", steps)
    if not res["proj_res"] <= cfg.proj_tol or (
            max(res["proj_iters"]) >= cfg.proj_max_iters):
        raise AssertionError(f"MG-PCG missed proj_tol: {res}")
    log("[mgpcg] " + json.dumps(res))
    if profile:
        profile_steps(solver, state, profile, "MG-PCG path", "a",
                      res["ms_per_step"])
    return res


def jacobi_mgpcg_phase(n, steps, mgpcg_res):
    """Phase 6b: the MG-PCG vortex path with EngineMode(rbgs=False), every
    V-cycle level smoothed by damped Jacobi in plain torch (the JAX
    package's V-cycle with use_rbgs off): no rbgs_smooth launch, and
    ms/step and proj_iters logged beside the red-black path of this run
    (`mgpcg_res`)."""
    from gpufluidsimulation_tpu_torch.config import EngineMode
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D

    cfg = bench_config(n, engine_mode=EngineMode(spectral_poisson=False,
                                                 rbgs=False))
    solver = Smoke3D(cfg)
    if solver.ctx.rbgs:
        raise AssertionError("rbgs=False built a red-black MG context")
    state, res = timed_steps(solver, steps, MAIN_KERNELS)
    if res["launches"]["rbgs_smooth"]:
        raise AssertionError("the Jacobi-smoothed path launched "
                             f"{res['launches']['rbgs_smooth']} rbgs_smooth")
    if not res["proj_res"] <= cfg.proj_tol or (
            max(res["proj_iters"]) >= cfg.proj_max_iters):
        raise AssertionError(f"Jacobi MG-PCG missed proj_tol: {res}")
    res["beside_rbgs"] = dict(ms_per_step=mgpcg_res["ms_per_step"],
                              proj_iters=mgpcg_res["proj_iters"])
    log("[mgpcg_jacobi] " + json.dumps(res))
    return res["launches"]


def scheme_phase(n, steps, profile):
    """Phase 7: the vortex scene at n^3 built as the main path, with
    MAC_REFLECTION, MACCORMACK, BiMocq under adaptive reinit (blend 1, the
    hybrid solver's policy with the reference's default blend), BiMocq
    under adaptive reinit in the vol9 volume form, and BiMocq in the
    prefilter volume form."""
    from gpufluidsimulation_tpu_torch.config import EngineMode
    from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D

    paths = {
        "reflection": (bench_config(n, scheme=Scheme.MAC_REFLECTION),
                       ("trilerp_sample", "minmax_sample", "rk3_substep",
                        "jacobi_diffuse")),
        "maccormack": (bench_config(n, scheme=Scheme.MACCORMACK),
                       ("trilerp_sample", "minmax_sample", "rk3_substep",
                        "jacobi_diffuse")),
        "bimocq_adaptive": (bench_config(n, reinit_mode="adaptive"),
                            KERNELS[:4]),
        "bimocq_vol9": (bench_config(n, reinit_mode="adaptive",
                                     engine_mode=EngineMode(volume_vol9=True)),
                        KERNELS[:4] + ("vol9_fixup",)),
        "bimocq_prefilter": (bench_config(
            n, engine_mode=EngineMode(volume_dual=False)), MAIN_KERNELS),
    }
    by_path = {}
    for name, (cfg, expect) in paths.items():
        solver = Smoke3D(cfg)
        clamps = []
        restore = observe_trace_clamps(clamps)
        try:
            state, res = timed_steps(solver, steps, expect,
                                     on_reset=clamps.clear)
        finally:
            restore()
        if "minmax_sample" in expect:
            # the trace clamp of rho+T: one minmax_sample launch a step in
            # its sample mode, and no fallback trilerp_sample launch
            want = [("minmax_sample", True)] * steps
            if (clamps != want
                    or res["launches"]["minmax_sample"] != steps):
                raise AssertionError(
                    f"{name}: trace clamp calls {clamps} and "
                    f"{res['launches']['minmax_sample']} minmax_sample "
                    f"launches in {steps} steps, expected {want}")
            res["trace_clamp_calls_per_step"] = len(clamps) / steps
        if not 0.0 < res["rho_max"] <= 10.0:
            raise AssertionError(f"{name}: implausible rho_max "
                                 f"{res['rho_max']}")
        log(f"[{name}] " + json.dumps(res))
        if profile:
            profile_steps(solver, state, profile, f"{name} path", "a",
                          res["ms_per_step"])
        del state, solver
        by_path[name] = res["launches"]
    return by_path


def pullback_multi_phase(n, reps):
    """Phase 8, the parked fused pull-back at full width. The vortex path
    built as the main path with counter reinit, blend 0.5 and the
    prefilter volume form is stepped until both maps have been
    reinitialized twice and the last step reinitialized neither, so that
    bwd, fwd and bwd_prev are all off the identity and the prev tier is
    live. On that state ``bimocq_advect_multi_3d`` runs for the velocity
    triplet (velocity maps) and for rho+T (scalar maps), every launch
    count reset before and read after; then the per-kind
    ``bimocq_advect_3d(mode="prefilter")`` on the same inputs. The fused
    call must equal, to the bit, the same function run one kind per call
    (so mixing the kinds' shapes in one launch changes nothing), and the
    per-kind form within 5e-5 of each field's scale, the JAX package's
    tolerance for the same comparison (test_pullback_multi_matches_per_kind):
    the fused form takes the map in grid units, averages and clips there,
    the per-kind form in world units, so a sample position differs by an
    ulp of up to 256 cells (3e-5 cells), which moves a sample across the
    emitters' one-cell edges by ~1e-5 of the scale. Both are timed."""
    import torch

    from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
    from gpufluidsimulation_tpu_torch.config import EngineMode
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D

    cfg = bench_config(n, reinit_mode="counter", blend_coeff=0.5,
                       engine_mode=EngineMode(volume_dual=False))
    solver = Smoke3D(cfg)
    t0 = time.time()
    state = solver.step(solver.init_state())
    while not (state.vel_map.reinit_count >= 2
               and state.scalar_map.reinit_count >= 2
               and state.vel_last_reinit < state.frame - 1
               and state.scalar_last_reinit < state.frame - 1):
        if state.frame >= 100:
            raise AssertionError("pullback_multi: no live prev tier")
        state = solver.step(state)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    g, blend = cfg.grid, cfg.blend_coeff
    s = state
    calls = {
        "uvw": (("u", "v", "w"), [s.u, s.v, s.w], [s.u_init, s.v_init,
                                                    s.w_init],
                [s.u_prev, s.v_prev, s.w_prev], s.vel_map),
        "rho+T": (("c", "c"), [s.rho, s.T], [s.rho_init, s.T_init],
                  [s.rho_prev, s.T_prev], s.scalar_map)}
    ident = mp.identity_map_3d(g, solver.device)
    for name, (_, _, _, _, m) in calls.items():
        off = [float((x - ident).abs().max()) / g.h
               for x in (m.bwd, m.fwd, m.bwd_prev)]
        log(f"[pullback_multi] {name} maps off the identity by up to (bwd, "
            f"fwd, bwd_prev) {off} cells")
        if not min(off) > 0.0:
            raise AssertionError(f"pullback_multi {name}: a map is the "
                                 "identity")

    def multi(kinds, cur, init, prev, m):
        return mp.bimocq_advect_multi_3d(g, kinds, cur, init, prev, m.bwd,
                                         m.bwd_prev, m.fwd, blend)

    def per_kind(kinds, cur, init, prev, m):
        if kinds[0] == "c":
            return mp.bimocq_advect_3d(g, "c", cur, init, prev, m.bwd,
                                       m.bwd_prev, m.fwd, blend,
                                       mode="prefilter")
        return [mp.bimocq_advect_3d(g, k, [c], [i], [p], m.bwd, m.bwd_prev,
                                    m.fwd, blend, mode="prefilter")[0]
                for k, c, i, p in zip(kinds, cur, init, prev)]

    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    got = {name: multi(*args) for name, args in calls.items()}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in fns.items()}
    missing = [k for k in ("pullback_sample", "volume_prefilter",
                           "trilerp_sample") if launches[k] == 0]
    if missing:
        raise AssertionError(f"pullback_multi never launched {missing}")
    res = dict(n=n, frame=state.frame, warmup_steps=state.frame,
               warmup_s=warm_s, launches=launches)
    failed = []
    for name, (kinds, cur, init, prev, m) in calls.items():
        args = (kinds, cur, init, prev, m)
        want = per_kind(*args)
        errs = []
        for i, (kind, a, b) in enumerate(zip(kinds, got[name], want)):
            (alone,) = multi((kind,), [cur[i]], [init[i]], [prev[i]], m)
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            errs.append(err / scale)
            if not torch.equal(a, alone):
                failed.append(f"{name} {kind}: differs from its kind alone")
            if not (np.isfinite(err) and err <= 5e-5 * scale):
                failed.append(f"{name} {kind}: fused vs per-kind {err} of "
                              f"scale {scale}")
        counts = {}
        for label, fn in (("fused", multi), ("per_kind", per_kind)):
            for w in fns.values():
                w.launches = 0
            fn(*args)
            counts[label] = {k: w.launches for k, w in fns.items()
                             if w.launches}
        res[name] = dict(
            fused_ms=cuda_time(lambda: multi(*args), reps, 1),
            per_kind_ms=cuda_time(lambda: per_kind(*args), reps, 1),
            max_abs_err_over_scale=errs, launches_per_call=counts)
    log("[pullback_multi] " + json.dumps(res))
    if failed:
        raise AssertionError("pullback_multi: " + "; ".join(failed))
    return launches


ANSI = re.compile(r"\x1b\[[0-9;]*m")
# what each CLI run must launch (sim3d 0 on either scene carries the
# main path's kernels; reflection the trace clamp's minmax_sample)
CLI_REFLECTION = ("trilerp_sample", "minmax_sample", "rk3_substep",
                  "jacobi_diffuse")


def observe_cli(records):
    """Record, until the returned function is called, every frame of a
    CLI run: the step's milliseconds (the CLI's FrameTimer, fenced on the
    card), its launches by wrapper, proj_iters, substeps, cfl and its rho
    (the tensor, read after the run); every write_volume's milliseconds
    (the device-to-host copy, pack_vdb and the hand-off to the writer
    thread) and every checkpoint's. Only observes: each call runs as it
    would."""
    from gpufluidsimulation_tpu_torch.io_utils import checkpoint, volume
    from gpufluidsimulation_tpu_torch.utils import timing

    fns = wrappers()
    write, save = volume.write_volume, checkpoint.save_state
    time_step = timing.FrameTimer.time_step

    def timed_step(self, step_fn, state, *args):
        before = {k: fn.launches for k, fn in fns.items()}
        out, ms = time_step(self, step_fn, state, *args)
        records.append(dict(
            kind="step", ms=ms, proj_iters=out.proj_iters,
            substeps=out.substeps, cfl=out.cfl, rho=out.rho, state=out,
            launches={k: fn.launches - before[k] for k, fn in fns.items()
                      if fn.launches > before[k]}))
        return out, ms

    def timed(kind, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            records.append(dict(kind=kind, path=out,
                                ms=(time.perf_counter() - t0) * 1e3))
            return out
        return call

    volume.write_volume = timed("write_volume", write)
    checkpoint.save_state = timed("checkpoint", save)
    timing.FrameTimer.time_step = timed_step

    def restore():
        volume.write_volume, checkpoint.save_state = write, save
        timing.FrameTimer.time_step = time_step
    return restore


def cli_run(argv, expect):
    """One in-process run of the port's CLI (``cli.main(argv)``), every
    launch count set to 0 just before and read just after; fails unless it
    exits 0 and launched each kernel of `expect`. Returns (summary,
    records, printed output)."""
    from gpufluidsimulation_tpu_torch import cli

    fns = wrappers()
    records = []
    for fn in fns.values():
        fn.launches = 0
    buf = io.StringIO()
    restore = observe_cli(records)
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        restore()
    wall_s = time.time() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    printed = ANSI.sub("", buf.getvalue())
    for line in printed.splitlines():
        log(f"[cli] {line}")
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    missing = [k for k in expect if kernel_launches(launches, k) == 0]
    if missing:
        raise AssertionError(f"cli {' '.join(argv)} never launched "
                             f"{missing}")
    steps = [r for r in records if r["kind"] == "step"]
    summary = dict(
        argv=" ".join(argv), wall_s=wall_s, launches=launches,
        step_ms=[r["ms"] for r in steps],
        write_volume_ms=[r["ms"] for r in records
                         if r["kind"] == "write_volume"],
        checkpoint_ms=[r["ms"] for r in records if r["kind"] == "checkpoint"],
        proj_iters=[r["proj_iters"] for r in steps],
        substeps=[r["substeps"] for r in steps],
        cfl=[r["cfl"] for r in steps],
        launches_by_frame=[r["launches"] for r in steps])
    return summary, records, printed


def frame_readback(path, rho):
    """The frame file at `path` read back through read_volume against the
    state's rho: equal above the 1e-4 threshold, zero below it (a vdb
    reads back to the extent of its 8^3 leaves, background outside)."""
    from gpufluidsimulation_tpu_torch.io_utils import volume

    dense, _ = volume.read_volume(path)
    want = rho.cpu().numpy()
    want = np.where(want > volume.DENSITY_THRESHOLD, want, 0.0)
    inside = tuple(slice(0, n) for n in want.shape)
    rest = dense.copy()
    rest[inside] = 0.0
    got = np.zeros(want.shape, np.float32)
    part = dense[inside]
    got[tuple(slice(0, n) for n in part.shape)] = part
    if rest.any() or not np.array_equal(got, want):
        raise AssertionError(f"{path} does not read back as the frame's rho")
    if not (np.isfinite(got).all() and 0.0 < got.max() <= 10.0):
        raise AssertionError(f"{path}: implausible rho max {got.max()}")
    return dense


def median_ms(fn, reps=3):
    """Median wall milliseconds of fn() over `reps` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def output_split(state, out_dir):
    """Where a CLI frame's output time goes, on one stepped state: the
    device-to-host copy of rho, pack_vdb, the hand-off to the writer
    thread and the thread's disk write (flush); write_volume whole in
    each of its formats; and a checkpoint's device-to-host copies against
    its compressed write (np.savez_compressed, as save_state writes it)
    and an uncompressed np.savez of the same arrays. Medians of 3."""
    import torch

    from gpufluidsimulation_tpu_torch import convert, native
    from gpufluidsimulation_tpu_torch.io_utils import vdb, volume

    h = 0.2 / state.rho.shape[0]
    torch.cuda.synchronize()
    dense = state.rho.cpu().numpy()
    payload = vdb.pack_vdb(dense, h, threshold=volume.DENSITY_THRESHOLD)
    writer = native.load()
    path = os.path.join(out_dir, "split.vdb")
    res = dict(
        rho_d2h_ms=median_ms(lambda: state.rho.cpu()),
        pack_vdb_ms=median_ms(lambda: vdb.pack_vdb(
            dense, h, threshold=volume.DENSITY_THRESHOLD)),
        hand_off_ms=median_ms(lambda: writer.async_write(path, payload)),
        flush_ms=median_ms(volume.flush_volumes), vdb_bytes=len(payload),
        active_voxels=int((dense > volume.DENSITY_THRESHOLD).sum()))
    failed = volume.flush_volumes()
    for fmt in ("vdb", "gfsvol", "npz"):
        def write():
            volume.write_volume(0, out_dir, h, state.rho, fmt=fmt)
            if volume.flush_volumes() != failed:
                raise AssertionError(f"write_volume {fmt} failed")
        res[f"write_volume_{fmt}_ms"] = median_ms(write)
    arrays = {}
    res["checkpoint_d2h_ms"] = median_ms(
        lambda: arrays.update(convert.state_to_numpy(state)))
    res["checkpoint_bytes_raw"] = sum(a.nbytes for a in arrays.values())
    for label, save in (("savez_compressed", np.savez_compressed),
                        ("savez", np.savez)):
        dest = os.path.join(out_dir, f"{label}.npz")
        res[f"checkpoint_{label}_ms"] = median_ms(lambda: save(dest,
                                                               **arrays))
        res[f"checkpoint_{label}_bytes"] = os.path.getsize(dest)
    return res


def cli_phase(res, obstacle_res):
    """Phase 9: the port's CLI, in-process, with --out in a temporary
    directory: sim3d 0 at res x 2res x 2res (the vortex collision under
    BiMocq), 4 frames, a checkpoint every 2; a resume from the checkpoint
    of frame 1 into a second directory, whose frames 3-4 must read back
    bit-identical to the first run's; sim3d 3 (reflection, the
    reference's default scheme), 2 frames; sim3d 0 --example 1 (the
    obstacle scene through masked MG-PCG) at obstacle_res, 3 frames. Each
    run's launches are counted alone; every frame file reads back as its
    state's rho. Logs each frame's step ms, write_volume ms and
    checkpoint ms, the obstacle run's proj_iters a frame, and where the
    first run's output time goes (output_split)."""
    import tempfile

    from gpufluidsimulation_tpu_torch.io_utils import volume

    by_run, summaries = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        first, second = os.path.join(tmp, "run"), os.path.join(tmp, "resumed")
        base = ["sim3d", "0", "--res", str(res)]
        summary, records, _ = cli_run(
            base + ["--frames", "4", "--checkpoint-every", "2", "--out",
                    first], MAIN_KERNELS)
        frames = os.path.join(first, "0-BiMocq-Gpu")
        steps = [r for r in records if r["kind"] == "step"]
        written = {}
        for k, r in enumerate(steps):
            name = f"{k + 1:04d}.vdb"
            written[name] = frame_readback(os.path.join(frames, name),
                                           r["rho"])
        ckpts = [os.path.basename(r["path"]) for r in records
                 if r["kind"] == "checkpoint"]
        if ckpts != ["ckpt_0001.npz", "ckpt_0003.npz"]:
            raise AssertionError(f"checkpoints written: {ckpts}")
        summary["output_split"] = output_split(steps[-1]["state"], tmp)
        summaries["sim3d_0"] = summary
        del steps, records
        ckpt = os.path.join(frames, "ckpt_0001.npz")
        summary, records, printed = cli_run(
            base + ["--frames", "4", "--resume", ckpt, "--out", second],
            MAIN_KERNELS)
        if f"resumed from {ckpt} at frame 2" not in printed:
            raise AssertionError("the resumed run did not start at frame 2")
        resumed = os.path.join(second, "0-BiMocq-Gpu")
        names = sorted(os.listdir(resumed))
        if names != ["0003.vdb", "0004.vdb"]:
            raise AssertionError(f"resumed run wrote {names}")
        for name in names:
            again, _ = volume.read_volume(os.path.join(resumed, name))
            if not np.array_equal(again, written[name]):
                err = float(np.abs(again - written[name]).max()) if (
                    again.shape == written[name].shape) else float("inf")
                raise AssertionError(f"resumed {name} differs from the "
                                     f"uninterrupted run by {err}")
        summary["frames_bit_identical"] = names
        summaries["sim3d_0_resume"] = summary
        summaries["sim3d_3"], _, _ = cli_run(
            ["sim3d", "3", "--res", str(res), "--frames", "2", "--out",
             os.path.join(tmp, "reflection")], CLI_REFLECTION)
        summaries["sim3d_0_example_1"], records, _ = cli_run(
            ["sim3d", "0", "--example", "1", "--res", str(obstacle_res),
             "--frames", "3", "--out", os.path.join(tmp, "obstacle")],
            MAIN_KERNELS + ("masked_rbgs_smooth",))
        obstacle = os.path.join(tmp, "obstacle", "0-BiMocq-Gpu")
        for k, r in enumerate(r for r in records if r["kind"] == "step"):
            frame_readback(os.path.join(obstacle, f"{k + 1:04d}.vdb"),
                           r["rho"])
    for label, summary in summaries.items():
        log(f"[cli] {label} " + json.dumps(summary))
        by_run[f"cli_{label}"] = summary.pop("launches")
    return by_run


def profile_steps(solver, state, path, title, mode, ms_per_step, steps=2):
    """Device time by kernel name over `steps` steps, written to `path`,
    with the card's busy time per step (the sum over kernels) beside
    `ms_per_step`, the step time measured without the profiler: the rest
    of the step the card waits for the host. The backward-map march runs
    in a record_function range, whose span on the card is reported
    beside."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gpufluidsimulation_tpu_torch.ops import advect

    march = advect.update_backward_map_3d

    def ranged(*args, **kwargs):
        with torch.profiler.record_function("update_backward_map_3d"):
            return march(*args, **kwargs)

    torch.cuda.synchronize()
    advect.update_backward_map_3d = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                state = solver.step(state)
            torch.cuda.synchronize()
    finally:
        advect.update_backward_map_3d = march
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key != "update_backward_map_3d"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    # the two smoothers' kernels (gs::levels_kernel<levels, masked>)
    gs = [e for e in kernels if "levels_kernel" in e.key]
    gs_ms = sum(e.self_device_time_total for e in gs) / 1e3 / steps
    gs_launches = sum(e.count for e in gs) / steps
    # the range's span on the card: its kernels, launched through ctypes,
    # are not attributed to the range's CPU side
    march_ms = sum(e.device_time_total for e in events
                   if e.key == "update_backward_map_3d"
                   and e.device_type == DeviceType.CUDA) / 1e3 / steps
    table = events.table(sort_by="cuda_time_total", row_limit=45)
    head = (f"== {title}: {steps} steps under the profiler: device busy "
            f"{busy_ms:.2f} ms/step in {launches:.0f} kernel launches/step, "
            f"against {ms_per_step:.2f} ms/step measured without the "
            f"profiler: idle {100 * (1 - busy_ms / ms_per_step):.1f}%; the "
            f"backward-map march (update_backward_map_3d) spans {march_ms:.3f} "
            f"ms/step on the card; the smoothers take {gs_ms:.3f} ms/step in "
            f"{gs_launches:.1f} launches/step")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, mode) as f:
        f.write(head + "\n" + table + "\n")
    log("[profile] " + head)
    log("[profile] " + "\n".join(table.splitlines()[:30]))


# ---------------------------------------------------------------------------
# The bf16 mode (phase 14)
# ---------------------------------------------------------------------------

# the kernels with a bf16 mode (EngineMode.interp_bf16): their field values
# are read as bfloat16 and widened at the load
BF16_KERNELS = ("trilerp_sample", "minmax_sample", "rk3_substep",
                "dmc_substep")
BF16_WRAPPERS = BF16_KERNELS + ("rk3_substep_lattice",)
BF16_DRIFT_STEPS = 8


def bf16_same_bits(label, got, want, values=False):
    """Raise unless `got` equals `want` bit for bit, NaN for NaN (with
    `values`, value for value: ``same_bits``); returns the max abs
    error."""
    differ, err = same_bits(got, want, values)
    log(f"[bf16] {label}: {differ} elements differ, max_abs_err={err:.3e}")
    if differ:
        raise AssertionError(f"bf16 {label}: the kernel differs from its "
                             f"plain version in {differ} elements")
    return err


def bf16_kernel_phase(n, seed):
    """Phase 14a: each of the four kernels' bf16 modes at n^3 shapes
    against its plain version (the float32 one on the widened values) on
    the same inputs, bit for bit, NaN for NaN, and timed by CUDA graph
    beside its float32 form on the unrounded inputs. trilerp_sample: C=1
    dual (u), C=2 dual (rho+T), C=1 plain, C=3 plain on the MAC pack (the
    trace clamp's second midpoint stage), also with NaNs sown into the
    fields; minmax_sample: C=2 in both modes; rk3_substep from displaced
    positions and in its lattice mode for every kind (stage 1 from the
    float32 faces); dmc_substep from a displaced map. Bounds: the bytes
    with the bf16 fields at 2 bytes a value (the lattice mode also reads
    the float32 faces), or the float32 operations of the float32 form."""
    import torch

    from gpufluidsimulation_tpu_torch.core import interp
    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import interp_fast as ifa

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 14)
    g = Grid3D(n, n, n, 0.2 / n)
    h = g.h
    bf = torch.bfloat16
    out = {name: [] for name in BF16_KERNELS}

    def positions(kind, amp_cells=2.0):
        px, py, pz = g.node_coords(kind, device=dev)
        return [(p + smooth(p.shape, rng, amp_cells * h, dev)).contiguous()
                for p in (px, py, pz)]

    def record(name, label, run16, run32, plain, err, nbytes, nops):
        k_ms = graph_ms(run16)
        f_ms = graph_ms(run32)
        p_ms = cuda_time(plain, 2, warmup=1)
        b_ms, b_by = bound_ms(nbytes, nops)
        out[name].append(dict(variant=label, max_abs_err=err, tol=0.0,
                              ms=k_ms, float32_ms=f_ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by))
        log(f"[bf16] {name} {label}: {k_ms:.4f} ms (float32 {f_ms:.4f}, "
            f"plain {p_ms:.3f}, bf16 bound {b_ms:.4f} by {b_by})")

    fu = smooth(g.shape_u, rng, 0.06, dev)[None].contiguous()
    fc = torch.stack([smooth(g.shape_c, rng, 1.0, dev),
                      smooth(g.shape_c, rng, 50.0, dev)]).contiguous()
    u, v, w = (smooth(s, rng, 0.06, dev)
               for s in (g.shape_u, g.shape_v, g.shape_w))
    pack = interp.mac_pack_3d(u, v, w).contiguous()
    pu, pc = positions("u"), positions("c")
    for label, f32, pos, offs, dual in (
            ("C=1 dual u", fu, pu, (g.OFF_U,), True),
            ("C=2 dual c", fc, pc, (g.OFF_C,) * 2, True),
            ("C=1 plain u", fu, pu, (g.OFF_U,), False),
            ("C=3 plain MAC pack", pack, pc, interp.MAC_OFFS, False)):
        f16 = f32.to(bf)
        got = ifa.trilerp_sample(f16, *pos, h, offs, dual=dual)
        err = bf16_same_bits(f"trilerp_sample {label}", got,
                        ifa.trilerp_sample_plain(f16, *pos, h, offs, dual))
        sown = f16.clone()
        sown.view(-1)[::997] = float("nan")
        bf16_same_bits(f"trilerp_sample {label}, NaNs sown",
                  ifa.trilerp_sample(sown, *pos, h, offs, dual=dual),
                  ifa.trilerp_sample_plain(sown, *pos, h, offs, dual))
        n_out, C = pos[0].numel(), f32.shape[0]
        nops = (dual_ops(pos, h, offs) if dual
                else n_out * (6 + C * TRILERP_OPS))
        record("trilerp_sample", label,
               lambda: ifa.trilerp_sample(f16, *pos, h, offs, dual=dual),
               lambda: ifa.trilerp_sample(f32, *pos, h, offs, dual=dual),
               lambda: ifa.trilerp_sample_plain(f16, *pos, h, offs, dual),
               err, 2 * f16.numel() + 4 * (3 + C) * n_out, nops)

    fc16 = fc.to(bf)
    offs = (g.OFF_C,) * 2
    for sample in (True, False):
        got = ifa.minmax_sample(fc16, *pc, h, offs, sample=sample)
        want = ifa.minmax_sample_plain(fc16, *pc, h, offs, sample)
        err = max(bf16_same_bits(f"minmax_sample sample={sample} {i}", a, b,
                                 values=i < 2)
                  for i, (a, b) in enumerate(zip(got, want)))
        n_out = pc[0].numel()
        record("minmax_sample", f"C=2 sample={sample}",
               lambda: ifa.minmax_sample(fc16, *pc, h, offs, sample=sample),
               lambda: ifa.minmax_sample(fc, *pc, h, offs, sample=sample),
               lambda: ifa.minmax_sample_plain(fc16, *pc, h, offs, sample),
               err, 2 * fc16.numel() + 4 * (3 + (3 if sample else 2) * 2)
               * n_out, n_out * (3 + 2 * (20 + (7 if sample else 0)
                                          * LERP_OPS)))

    faces16 = [f.to(bf) for f in (u, v, w)]
    face_vals = u.numel() + v.numel() + w.numel()
    sh = float(np.float32(1.0 / 0.06))         # a substep of about a cell
    clamp = (1.0, n - 1.0) * 3
    N = n ** 3
    lat = ifa.lattice_positions(g.shape_c, (0, 0, 0), dev)
    start = (lat + torch.stack([smooth(g.shape_c, rng, 2.0, dev)
                                for _ in range(3)])).contiguous()
    err = bf16_same_bits("rk3_substep displaced",
                    ifa.rk3_substep(*faces16, start, sh, clamp),
                    ifa.rk3_substep_plain(*faces16, start, sh, clamp))
    record("rk3_substep", "displaced positions",
           lambda: ifa.rk3_substep(*faces16, start, sh, clamp),
           lambda: ifa.rk3_substep(u, v, w, start, sh, clamp),
           lambda: ifa.rk3_substep_plain(*faces16, start, sh, clamp),
           err, 2 * face_vals + 4 * 6 * N, N * RK3_OPS)
    for kind in ("c", "u", "v", "w"):
        dim = g.dim_of(kind)
        got = ifa.rk3_substep_lattice(*faces16, dim, sh, clamp,
                                      stage1=(u, v, w))
        err = bf16_same_bits(f"rk3_substep lattice mode {kind}", got,
                        ifa.rk3_substep_plain(
                            *faces16, ifa.lattice_positions(g.shape_c, dim,
                                                            dev),
                            sh, clamp, stage1=(u, v, w)))
        if kind == "c":
            record("rk3_substep", "lattice mode (identity peel), cell kind",
                   lambda: ifa.rk3_substep_lattice(*faces16, dim, sh, clamp,
                                                   stage1=(u, v, w)),
                   lambda: ifa.rk3_substep_lattice(u, v, w, dim, sh, clamp),
                   lambda: ifa.rk3_substep_plain(*faces16, lat, sh, clamp,
                                                 stage1=(u, v, w)),
                   err, 6 * face_vals + 4 * 3 * N, N * RK3_OPS)

    thresh = ifa.dmc_threshold(h)
    maps = (lat * h + torch.stack([smooth(g.shape_c, rng, 2.0 * h, dev)
                                   for _ in range(3)])).contiguous()
    sub = float(np.float32(np.float32(h / 0.06) / np.float32(h)))
    err = bf16_same_bits("dmc_substep displaced map",
                    ifa.dmc_substep(*faces16, maps, sub, thresh),
                    ifa.dmc_substep_plain(*faces16, maps, sub, thresh))
    record("dmc_substep", "displaced map",
           lambda: ifa.dmc_substep(*faces16, maps, sub, thresh),
           lambda: ifa.dmc_substep(u, v, w, maps, sub, thresh),
           lambda: ifa.dmc_substep_plain(*faces16, maps, sub, thresh),
           err, 2 * face_vals + 4 * 6 * N, N * DMC_OPS)
    return {name: dict(rows[0], variants=rows) for name, rows in out.items()}


def bf16_conversions(calls):
    """Count the bf16 mode's conversions to bfloat16 (one elementwise
    launch each) in `calls` until the returned function restores: the
    faces (three a call) and every rounded field sample."""
    from gpufluidsimulation_tpu_torch.bimocq import mapping
    from gpufluidsimulation_tpu_torch.ops import advect

    window, values, sample = (advect.window_faces, advect._values,
                              mapping._sample_fields_at)

    def window_faces(u, v, w, bf16):
        calls.append(3 if bf16 else 0)
        return window(u, v, w, bf16)

    def _values(fields, win):
        calls.append(0 if win is None else 1)
        return values(fields, win)

    def _sample_fields_at(*args, bf16=False, **kw):
        calls.append(int(bf16))
        return sample(*args, bf16=bf16, **kw)

    advect.window_faces, advect._values = window_faces, _values
    mapping._sample_fields_at = _sample_fields_at

    def restore():
        advect.window_faces, advect._values = window, values
        mapping._sample_fields_at = sample

    return restore


def bf16_path_phase(n, steps, scheme_steps):
    """Phase 14b-d: parity of the bf16 main path and MacCormack on the
    card against the port on the CPU at 32^3 (3 steps, 2e-3 of scale); the
    bf16 main path at n^3 (1 warm-up and `steps` timed steps, launch
    counts and bf16-mode counts reset before and read after: 12
    trilerp_sample, 2 rk3_substep and 1 in its lattice mode and 2
    dmc_substep launches a step in the bf16 mode, the backward march's
    identity peel in float32) with its conversions to bfloat16 counted;
    the drift of rho and u from the float32 main path after
    BF16_DRIFT_STEPS steps from the same state; and the bf16 MacCormack
    path at n^3 (1 bf16 minmax_sample launch a step, in its sample
    mode)."""
    import torch

    from gpufluidsimulation_tpu_torch.config import EngineMode
    from gpufluidsimulation_tpu_torch.ops import interp_fast
    from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D

    bf16 = EngineMode(interp_bf16=True)
    parity = {
        "main": parity_phase(bench_config(32, engine_mode=bf16),
                             "bf16 vortex"),
        "maccormack": parity_phase(bench_config(
            32, scheme=Scheme.MACCORMACK, engine_mode=bf16),
            "bf16 maccormack vortex")}
    fns = [getattr(interp_fast, name) for name in BF16_WRAPPERS]

    def reset():
        for fn in fns:
            fn.bf16_launches = 0
        conversions.clear()

    conversions = []
    restore = bf16_conversions(conversions)
    results, by_path = {}, {}
    try:
        for label, cfg, n_steps, expect in (
                ("bf16_main", bench_config(n, engine_mode=bf16), steps,
                 MAIN_KERNELS),
                ("bf16_maccormack", bench_config(
                    n, scheme=Scheme.MACCORMACK, engine_mode=bf16),
                 scheme_steps, ("minmax_sample", "rk3_substep",
                                "trilerp_sample"))):
            solver = Smoke3D(cfg)
            state, res = timed_steps(solver, n_steps, expect, on_reset=reset)
            del state
            bf = {fn.__name__: fn.bf16_launches / n_steps for fn in fns}
            res.update(bf16_launches_per_step=bf,
                       conversions_per_step=sum(conversions) / n_steps)
            by_path[label] = {fn.__name__: fn.bf16_launches for fn in fns}
            results[label] = res
            log(f"[bf16] {label} {n}^3: {res['ms_per_step']:.2f} ms/step, "
                f"bf16-mode launches a step {json.dumps(bf)}, "
                f"{res['conversions_per_step']} conversions to bfloat16 a "
                "step")
            log(f"[bf16] {label} " + json.dumps(res))
    finally:
        restore()
    want = {"trilerp_sample": 12, "minmax_sample": 0, "rk3_substep": 2,
            "rk3_substep_lattice": 1, "dmc_substep": 2}
    if results["bf16_main"]["bf16_launches_per_step"] != want:
        raise AssertionError(
            f"bf16 main path: bf16-mode launches a step "
            f"{results['bf16_main']['bf16_launches_per_step']}, expected "
            f"{want}")
    if results["bf16_maccormack"]["bf16_launches_per_step"][
            "minmax_sample"] != 1:
        raise AssertionError("bf16 maccormack path: not one bf16 "
                             "minmax_sample launch a step")
    # the drift from the float32 main path
    states = {}
    for label, mode in (("float32", None), ("bf16", bf16)):
        solver = Smoke3D(bench_config(n, engine_mode=mode))
        st = solver.init_state()
        for _ in range(BF16_DRIFT_STEPS):
            st = solver.step(st)
        states[label] = {k: getattr(st, k) for k in ("rho", "u")}
        del solver, st
    drift = {}
    for k in ("rho", "u"):
        a, b = states["bf16"][k], states["float32"][k]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"bf16 main path: non-finite {k}")
        drift[k] = float((a - b).abs().max() / b.abs().max())
    results["drift_of_scale"] = drift
    results["parity"] = parity
    log(f"[bf16] drift from the float32 main path after "
        f"{BF16_DRIFT_STEPS} steps at {n}^3 (max abs difference over the "
        f"float32 field's max): {json.dumps(drift)}")
    return results, by_path


# ---------------------------------------------------------------------------
# The 2D solver (phases 10-13)
# ---------------------------------------------------------------------------

# float32 operations of one bilerp_sample output, counted from the kernel's
# source: 2 divisions by h a position; per run of channels sharing an
# offset 2 subtractions, 2 floors, 2 fractions and 2 complements; per
# channel the blend's 6 products and 3 sums
BILERP_POS_OPS, BILERP_OFFSET_OPS, BILERP_CHANNEL_OPS = 2, 8, 9
# ... and in the cp mode: per run of channels sharing an offset 2
# subtractions, 2 floors and 2 fractions; per channel qx, qy, a, b (4), c0
# (8 products, 3 sums, a division), c1 and c2 (a negation, 4 products, 3
# sums, a division each), c3 (3 sums, a division) and the band's select
CP_OFFSET_OPS, CP_CHANNEL_OPS = 6, 4 + 12 + 9 + 9 + 4 + 1
# ... and in the trace and DMC modes: one MAC velocity sample (2
# divisions by h, per component the offset's 2 subtractions, 2 floors, 2
# fractions, 2 complements and the blend's 9); a substep's 3 samples, the
# two stage updates (a product and a sum a coordinate), the combination
# (3 products and 3 sums a coordinate) and the clamp (2 compares a
# coordinate); a lattice start's 2 sums and 2 products; at the foot 2
# divisions and the offset's 8, then 9 a field and its min/max 6 more; a
# DMC substep's 2 velocity samples, the upwind position (a compare and a
# sum a coordinate), the slopes (2 differences and a division a
# coordinate), the step (|a|, its compare, a negation, a product, exp,
# a difference, a product, a division, a difference: 9 a coordinate), the
# clamp and the C=2 map sample
MAC2_OPS = 2 + 2 * 17
TRACE_SUBSTEP_OPS = 3 * MAC2_OPS + 2 * 2 * 2 + 2 * 6 + 2 * 2
TRACE_LATTICE_OPS, TRACE_FOOT_OPS, TRACE_FIELD_OPS = 4, 10, 9
TRACE_MINMAX_OPS = 6
DMC2_OPS = 2 * MAC2_OPS + 2 * 2 + 2 * 3 + 2 * 9 + 2 * 2 + 10 + 2 * 9


def same_bits(got, want, values=False):
    """Where got and want differ: NaN in one and not the other, or
    different bits (with `values`, different values: the min/max may
    take either zero where corners hold +0 and -0). Returns the number of
    such elements and the largest abs difference over the rest."""
    import torch

    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if values:
        diff = (got != want) & ~(nan_g & nan_w)
    else:
        diff = (got.view(torch.int32) != want.view(torch.int32)) & ~(
            nan_g & nan_w)
    both = ~(nan_g | nan_w)
    err = float((got[both] - want[both]).abs().max()) if bool(
        both.any()) else 0.0
    return int(diff.sum()) + int((nan_g != nan_w).sum()), err


def march_fields(g, rng, dev, nan=False):
    """A 2D state for the trace and DMC modes: u, v of amplitude 1 (a
    substep of 1.5 h moves ~1.5 cells), rho, T, a second pair (du, dv),
    and with `nan` a NaN in u on the 4 nodes around the grid's centre."""
    u = smooth(g.shape_u, rng, 2.0, dev)
    v = smooth(g.shape_v, rng, 2.0, dev)
    if nan:
        u[g.ni // 2:g.ni // 2 + 2, g.nj // 2:g.nj // 2 + 2] = float("nan")
    extra = [smooth(g.shape_c, rng, a, dev) for a in (1.0, 50.0, 3.0, 0.5)]
    return u, v, extra


def march_cases():
    """The trace-mode cases of each grid: (label, start, kind or None,
    substeps in units of 1.5h, C, minmax, write_pos, final clamp name,
    interleave, nan)."""
    return (
        ("lattice c, 2 substeps, C=2 minmax", "c", 2, 2, True, False, None,
         False, False),
        ("lattice u, 3 substeps (last partial), C=1 minmax", "u", 3, 1, True,
         False, None, False, False),
        ("lattice v, 1 substep back, C=1", "v", -1, 1, False, False, None,
         False, False),
        ("lattice c, 2 substeps back, C=4 minmax, foot", "c", -2, 4, True,
         True, None, False, False),
        ("lattice c, 3 substeps, C=3, foot", "c", 3, 3, False, True, None,
         False, False),
        ("positions 3 cells outside, 2 substeps, C=2 minmax, foot", "out", 2,
         2, True, True, None, False, False),
        ("map positions, 3 substeps, [h, L-h]", "map", 3, 0, False, True,
         "map", False, False),
        ("map positions, 1 substep back, [h, L-h]", "map", -1, 0, False,
         True, "map", False, False),
        ("particle columns, 2 substeps, [h, (n-1)h], (P, 2)", "particles", 2,
         0, False, True, "particles", True, False),
        ("particle columns, 3 substeps back, [h, (n-1)h], (P, 2)",
         "particles", -3, 0, False, True, "particles", True, False),
        ("NaN velocity: lattice c, 2 substeps, C=2 minmax, foot", "c", 2, 2,
         True, True, None, False, True),
        ("NaN velocity: particle columns, 2 substeps", "particles", 2, 0,
         False, True, "particles", True, True),
    )


def march_subs(count, h):
    """`count` signed substeps of 1.5h (the last of 3 at 0.37 of it)."""
    s = np.float32(1.5 * h) * np.float32(1 if count > 0 else -1)
    n = abs(count)
    return [s] * (n - 1) + [s * np.float32(0.37) if n == 3 else s]


def bilerp_march_phase(rng, timed):
    """Phase 10, the trace and DMC modes of bilerp_sample against their
    plain versions on the card, bit for bit (NaN where the plain version
    has NaN; the corner min/max by value), on 256^2, 256x1280 and 37x29:
    the trace from each kind's lattice and from read positions (the cell
    lattice wandering 2 cells, stretched to 3 cells outside, a map, and
    the (P, 2) particle columns, 16 a cell as the solver seeds them:
    1,048,576 on 256^2 and 5,242,880 on 256x1280), 1, 2 and 3 substeps (the last
    of 3 partial), forward and back, C = 0-4 fields at the foot with and
    without the min/max, the foot written or not, no final clamp, the
    map's [h, L - h] and the particles' [h, (n-1)h], and a NaN in the
    velocity; the DMC mode from a displaced map at 1 and 3 substeps (the
    last partial), a negative substep and with a NaN velocity. On the
    grids in `timed` each case is timed by a CUDA graph of launches beside
    its bound and its plain version. Returns the cases' records."""
    import torch

    from gpufluidsimulation_tpu_torch.core import interp
    from gpufluidsimulation_tpu_torch.core.grids import Grid2D
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    dev = torch.device("cuda")
    records = []
    for ni, nj in ((256, 256), (256, 1280), (37, 29)):
        g = Grid2D(ni, nj, 1.0 / ni)
        h = g.h
        state = march_fields(g, rng, dev)
        nan_state = march_fields(g, rng, dev, nan=True)
        pstart = particle_positions(g, rng, dev)
        wobble = [(q + smooth(q.shape, rng, 2.0 * h, dev)).contiguous()
                  for q in g.node_coords("c", dev)]
        stretched = [(p * ((m + 6.0) / m) - 3.0 * h).contiguous()
                     for p, m in zip(wobble, (ni, nj))]
        clamps = {"map": interp.clamp_bounds_2d(h, ni, nj),
                  "particles": ((h, (ni - 1) * h), (h, (nj - 1) * h))}
        for (label, start, count, C, minmax, foot, clamp, inter,
             nan) in march_cases():
            u, v, extra = nan_state if nan else state
            if start in ("c", "u", "v"):
                origin = interp_fast.Lattice2D(g.shape_of(start),
                                               g.off_of(start))
                off = g.off_of(start)
                if start == "c":
                    fields = extra[:C]
                else:
                    # the velocity component itself, as a scheme traces it
                    f = u if start == "u" else v
                    fields = [f, f * 2.0, f + 1.0, -f][:C]
            elif start == "particles":
                origin = (pstart[:, 0], pstart[:, 1])
                off, fields = g.OFF_C, extra[:C]
            else:
                origin = tuple(stretched if start == "out" else wobble)
                off, fields = g.OFF_C, extra[:C]
            subs = march_subs(count, h)
            kw = dict(fields=fields, off=off, minmax=minmax, write_pos=foot,
                      final_clamp=clamps.get(clamp), interleave=inter)
            run = lambda: interp_fast.bilerp_trace(u, v, h, subs, origin,
                                                   **kw)
            plain = lambda: interp_fast.bilerp_trace_plain(u, v, h, subs,
                                                           origin, **kw)
            got, want = run(), plain()
            torch.cuda.synchronize()
            worst, bad, nans = 0.0, 0, 0
            for part, (a, b) in enumerate(zip(got, want)):
                if (a is None) != (b is None):
                    raise AssertionError(f"trace {label}: output {part} "
                                         "missing")
                if a is None:
                    continue
                n_bad, err = same_bits(a, b, values=part >= 2)
                bad += n_bad
                worst = max(worst, err)
                nans += int(torch.isnan(a).sum())
            name = f"bilerp_sample trace {label} {ni}x{nj}"
            log(f"[kernels] {name}: {bad} elements differ, max_abs_err "
                f"{worst:.3e} tol 0, {nans} NaN")
            if bad or worst:
                raise AssertionError(f"{name}: the trace mode disagrees with "
                                     f"its plain version")
            if nan and not nans:
                raise AssertionError(f"{name}: the NaN reached no output")
            rec = dict(variant=f"trace {label} {ni}x{nj}", max_abs_err=worst,
                       tol=0.0, nan_outputs=nans)
            if (ni, nj) in timed:
                n = (g.shape_of(start)[0] * g.shape_of(start)[1]
                     if isinstance(origin, interp_fast.Lattice2D)
                     else origin[0].numel())
                outs = (2 if foot else 0) + C * (3 if minmax else 1)
                nbytes = 4 * (u.numel() + v.numel()
                              + sum(f.numel() for f in fields)
                              + (0 if isinstance(origin,
                                                 interp_fast.Lattice2D)
                                 else 2 * n) + outs * n)
                nops = n * (abs(count) * TRACE_SUBSTEP_OPS
                            + TRACE_LATTICE_OPS
                            + (TRACE_FOOT_OPS + C * (
                                TRACE_FIELD_OPS
                                + (TRACE_MINMAX_OPS if minmax else 0))
                               if C else 0))
                b_ms, b_by = bound_ms(nbytes, nops)
                rec.update(ms=graph_ms(run), plain_ms=graph_ms(plain),
                           bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           host_us_a_call=host_us(run, 300))
                log(f"[kernels] {name}: {rec['ms']:.5f} ms (CUDA graph), "
                    f"plain {rec['plain_ms']:.4f} (its launches, CUDA "
                    f"graph), bound {b_ms:.5f} by {b_by}, "
                    f"{rec['host_us_a_call']:.1f} us of host a call")
            records.append(rec)
        maps = [w.contiguous() for w in wobble]
        for label, count, sign, nan in (
                ("DMC 1 substep", 1, 1, False),
                ("DMC 3 substeps (last partial)", 3, 1, False),
                ("DMC 1 substep, negative", 1, -1, False),
                ("NaN velocity: DMC 3 substeps", 3, 1, True)):
            u, v, _ = nan_state if nan else state
            subs = [s * np.float32(sign) for s in march_subs(count, h)]
            run = lambda: interp_fast.bilerp_dmc(u, v, *maps, h, subs)
            plain = lambda: interp_fast.bilerp_dmc_plain(u, v, *maps, h,
                                                         subs)
            got, want = run(), plain()
            torch.cuda.synchronize()
            bad, worst = same_bits(got, want)
            nans = int(torch.isnan(got).sum())
            name = f"bilerp_sample {label} {ni}x{nj}"
            log(f"[kernels] {name}: {bad} elements differ, max_abs_err "
                f"{worst:.3e} tol 0, {nans} NaN")
            if bad or worst:
                raise AssertionError(f"{name}: the DMC mode disagrees with "
                                     "its plain version")
            if nan and not nans:
                raise AssertionError(f"{name}: the NaN reached no output")
            rec = dict(variant=f"{label} {ni}x{nj}", max_abs_err=worst,
                       tol=0.0, nan_outputs=nans)
            if (ni, nj) in timed:
                n = ni * nj
                nbytes = 4 * (u.numel() + v.numel() + 2 * n + 2 * n)
                b_ms, b_by = bound_ms(count * nbytes, count * n * DMC2_OPS)
                rec.update(ms=graph_ms(run), plain_ms=graph_ms(plain),
                           bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           launches_a_call=count,
                           host_us_a_call=host_us(run, 300))
                log(f"[kernels] {name}: {rec['ms']:.5f} ms a call of "
                    f"{count} launches (CUDA graph), plain "
                    f"{rec['plain_ms']:.4f}, bound {b_ms:.5f} by {b_by}")
            records.append(rec)
    return records


def bilerp_phase(rng):
    """Phase 10: bilerp_sample in its modes against its plain versions,
    bit for bit, on 256^2, 256x1280 (the Rayleigh-Taylor grid) and 37x29:
    the sample mode at C=1 (a cell field at positions wandering 2 cells),
    C=2 (rho and T on the 5-point volume stencil's (5, ni, nj) batch, 0.3
    cells) and C=2 with differing offsets (u's and v's lattices), the
    mac mode at positions wandering 1.5 cells, and G2P at the particles as
    the solver seeds them (16 a cell: 1,048,576 on 256^2, 5,242,880 on
    256x1280): the mac mode with two pairs, the sample mode at C=4 and the
    cp mode (calculateCp of u, v, rho and T, each in its own band); each
    also at positions stretched to 3 cells outside the domain (outside
    every cp band too). At 256^2 each is timed: the kernel by a CUDA graph
    of launches (also with the L2 flushed before each launch), a call
    with its launch, the host's microseconds a call, the plain version,
    and for the sample modes grid_sample (bilinear, border padding,
    align_corners) on the same samples, by a CUDA graph. Then the trace
    and DMC modes (``bilerp_march_phase``)."""
    import torch
    import torch.nn.functional as F

    from gpufluidsimulation_tpu_torch.core.grids import Grid2D
    from gpufluidsimulation_tpu_torch.ops import interp_fast
    from gpufluidsimulation_tpu_torch.solvers import particles

    dev = torch.device("cuda")
    flush = torch.empty(2 ** 24, dtype=torch.float32, device=dev)

    def compare(name, got, want, tol):
        err = float((got - want).abs().max())
        log(f"[kernels] {name}: max_abs_err={err:.3e} tol={tol:.1e}")
        if not np.isfinite(err) or err > tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version: {err} > {tol}")
        return err

    variants, edges = [], []
    for ni, nj in ((256, 256), (256, 1280), (37, 29)):
        g = Grid2D(ni, nj, 1.0 / ni)
        h = g.h

        def wander(kind, cells, reps=None):
            out = []
            for p in g.node_coords(kind, dev):
                if reps is None:
                    out.append((p + smooth(p.shape, rng, cells * h, dev))
                               .contiguous())
                else:
                    out.append(torch.stack([
                        p + smooth(p.shape, rng, cells * h, dev)
                        for _ in range(reps)]).contiguous())
            return out

        def outside(pos):
            """The positions stretched to reach 3 cells past every
            edge."""
            return [(p * ((m + 6.0) / m) - 3.0 * h).contiguous()
                    for p, m in zip(pos, (ni, nj))]

        rho = smooth(g.shape_c, rng, 1.0, dev)
        T = smooth(g.shape_c, rng, 50.0, dev)
        u = smooth(g.shape_u, rng, 1.0, dev)
        v = smooth(g.shape_v, rng, 1.0, dev)
        uv = torch.stack([u[:ni], v[:, :nj]]).contiguous()
        # FLIP's grid changes, G2P's second MAC pair and cell fields
        du = smooth(g.shape_u, rng, 0.1, dev)
        dv = smooth(g.shape_v, rng, 0.1, dev)
        cells = torch.stack([rho, T, smooth(g.shape_c, rng, 0.1, dev),
                             smooth(g.shape_c, rng, 5.0, dev)])
        parts = list(particles.columns(particle_positions(g, rng, dev)))
        cp_fields = [u, v, rho, T]
        cp_offs = (g.OFF_U, g.OFF_V, g.OFF_C, g.OFF_C)
        cp_bands = particles.cp_bands(g)
        cases = (
            ("sample C=1 c", rho[None].contiguous(), wander("c", 2.0),
             (g.OFF_C,)),
            ("sample C=2 c stencil", torch.stack([rho, T]),
             wander("c", 0.3, reps=5), (g.OFF_C,) * 2),
            ("sample C=2 u,v offsets", uv, wander("c", 2.0),
             (g.OFF_U, g.OFF_V)),
            ("mac", None, wander("c", 1.5), None),
            # G2P at the particles as the solver seeds them: FLIP's two
            # MAC pairs and four cell fields, and calculateCp of u, v, rho
            # and T (APIC/PolyPIC)
            ("G2P mac two pairs", None, parts, None),
            ("G2P sample C=4 rho,T,drho,dT", cells, parts, (g.OFF_C,) * 4),
            ("cp C=4 u,v,rho,T", cp_fields, parts, cp_offs))
        pairs = {"mac": (), "G2P mac two pairs": (du, dv)}
        for label, fields, pos, offs in cases:
            name = f"bilerp_sample {label} {ni}x{nj}"
            for where, p in ((" outside", outside(pos)), ("", pos)):
                if label.startswith("cp"):
                    got = interp_fast.bilerp_sample_cp(fields, *p, h, offs,
                                                       cp_bands)
                    want = interp_fast.bilerp_sample_cp_plain(
                        fields, *p, h, offs, cp_bands)
                    if where:
                        # the stretched positions leave every band
                        inside = (want != 0).any(-1)
                        if bool(inside.all()) or not bool(inside.any()):
                            raise AssertionError(f"{name}{where}: the "
                                                 "positions miss a band edge")
                elif fields is None:
                    got = interp_fast.bilerp_sample_mac(u, v, *p, h,
                                                        *pairs[label])
                    want = interp_fast.bilerp_sample_mac_plain(
                        u, v, *p, h, *pairs[label])
                else:
                    got = interp_fast.bilerp_sample(fields, *p, h, offs)
                    want = interp_fast.bilerp_sample_plain(fields, *p, h,
                                                           offs)
                err = compare(name + where, got, want, 0.0)
                if where:
                    edges.append(dict(variant=f"{label} {ni}x{nj} outside",
                                      max_abs_err=err, tol=0.0))
            if (ni, nj) != (256, 256):
                edges.append(dict(variant=f"{label} {ni}x{nj}",
                                  max_abs_err=err, tol=0.0))
                continue
            n_out = pos[0].numel()
            if label.startswith("cp"):
                run = lambda: interp_fast.bilerp_sample_cp(
                    fields, *pos, h, offs, cp_bands)
                plain = lambda: interp_fast.bilerp_sample_cp_plain(
                    fields, *pos, h, offs, cp_bands)
                C, runs = 4, 3
                field_values = sum(f.numel() for f in fields)
            elif fields is None:
                extra = pairs[label]
                run = lambda: interp_fast.bilerp_sample_mac(u, v, *pos, h,
                                                            *extra)
                plain = lambda: interp_fast.bilerp_sample_mac_plain(
                    u, v, *pos, h, *extra)
                C, runs = 2 + len(extra), 2
                field_values = sum(f.numel() for f in (u, v) + extra)
            else:
                run = lambda: interp_fast.bilerp_sample(fields, *pos, h,
                                                        offs)
                plain = lambda: interp_fast.bilerp_sample_plain(
                    fields, *pos, h, offs)
                C = fields.shape[0]
                runs = 1 + sum(a != b for a, b in zip(offs, offs[1:]))
                field_values = fields.numel()
            if label.startswith("cp"):
                nbytes = 4 * (field_values + 2 * n_out + 4 * C * n_out)
                nops = n_out * (BILERP_POS_OPS + runs * CP_OFFSET_OPS
                                + C * CP_CHANNEL_OPS)
            else:
                nbytes = 4 * (field_values + 2 * n_out + C * n_out)
                nops = n_out * (BILERP_POS_OPS + runs * BILERP_OFFSET_OPS
                                + C * BILERP_CHANNEL_OPS)
            b_ms, b_by = bound_ms(nbytes, nops)
            k_ms = graph_ms(run)
            # the same with the L2 flushed before each launch (a 64 MiB
            # write, more than the 50 MB L2, timed alone and taken off):
            # the inputs come from device memory; the outputs still land
            # in the write-back L2
            cold_ms = (graph_ms(lambda: (flush.zero_(), run()))
                       - graph_ms(flush.zero_))
            call_ms = cuda_time(run, 50)
            host = host_us(run)
            p_ms = cuda_time(plain, 10)
            lib_ms = lib_err = None
            if fields is not None and not label.startswith("cp"):
                # yardstick only: grid_sample computes the same clamped
                # bilinear (border padding, align_corners) channel by
                # channel; one call a run of shared offsets
                shape = pos[0].shape
                flat = [q.reshape(1, -1, shape[-1]) for q in pos]
                grids = [torch.stack([
                    (flat[1] / h - off[1]) * (2.0 / (nj - 1)) - 1.0,
                    (flat[0] / h - off[0]) * (2.0 / (ni - 1)) - 1.0],
                    dim=-1) for off in dict.fromkeys(offs)]
                if len(grids) == 1:
                    lib = lambda: F.grid_sample(
                        fields[None], grids[0], mode="bilinear",
                        padding_mode="border", align_corners=True)
                    ref = lib()[0].reshape((C,) + tuple(shape))
                else:
                    lib = lambda: [F.grid_sample(
                        fields[c][None, None], grids[c], mode="bilinear",
                        padding_mode="border", align_corners=True)
                        for c in range(C)]
                    ref = torch.stack([r[0, 0].reshape(shape)
                                       for r in lib()])
                lib_err = float((ref - got).abs().max())
                lib_ms = graph_ms(lib)
            variants.append(dict(
                variant=f"{label} {ni}x{nj}", max_abs_err=err, tol=0.0,
                ms=k_ms, ms_l2_flushed=cold_ms, call_ms=call_ms,
                host_us_a_call=host, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                library_max_abs_err=lib_err))
            log(f"[kernels] bilerp_sample {label} {ni}x{nj}: {k_ms:.5f} ms "
                f"(CUDA graph), {cold_ms:.5f} with the L2 flushed before "
                f"each launch ({call_ms:.4f} ms a call with its launch, "
                f"{host:.1f} us of host a call; plain {p_ms:.3f}, bound "
                f"{b_ms:.5f} by {b_by}, grid_sample {lib_ms} ms, "
                f"max_abs_err {lib_err} against the kernel)")
    marches = bilerp_march_phase(rng, timed=((256, 256), (256, 1280)))
    return dict(variants[0], variants=variants + edges + marches, replaces=(
        "gpufluidsimulation_tpu/ops/interp_fast.py:915 (_kernel, "
        "pallas_call :995) as the 2D solver reaches it: sample2_fast :3450 "
        "(core/interp.py:187 sample2_lattice) and mac2_fast :3483 "
        "(core/interp.py:204 mac_velocity_2d_lattice)"))


# float32 operations one particle needs in p2g_splat's function: its 2
# divisions by h; per lattice (3) the 2 offset subtractions and the 2 x
# and 2 y hats (4 each: subtraction, |.|, 1 - ., max); per tap (4 a
# lattice) the weight's product and the weight sum's add; per tap and
# channel (4 channels over the 3 lattices) a product and an add (FLIP),
# or the polynomial (4 operations, 7 with PolyPIC's dx dy term) on dx and
# dy formed once per x and y tap (2 each, 8 a lattice), then a product
# and an add; per node the weight's + 1e-4 and a division a channel
P2G_PARTICLE_OPS, P2G_LATTICE_OPS, P2G_TAP_OPS = 2, 2 + 16, 2
P2G_CHANNEL_OPS = {"flip": 2, "apic": 6, "polypic": 9}
P2G_TOL = 1e-5


def p2g_ops(order, P, nodes, outputs):
    lattice = P2G_LATTICE_OPS + (0 if order == "flip" else 8)
    per_particle = (P2G_PARTICLE_OPS + 3 * lattice + 12 * P2G_TAP_OPS
                    + 4 * 4 * P2G_CHANNEL_OPS[order])
    return P * per_particle + nodes + outputs


def particle_positions(g, rng, dev):
    """(P, 2) particle positions as the solver seeds them (4 x 4 a cell,
    seed_particles: 1,048,576 on 256^2, 5,242,880 on 256x1280), jittered
    by up to half a cell and clamped to [h, (n-1)h]."""
    import torch

    from gpufluidsimulation_tpu_torch.solvers import particles

    h = g.h
    pos = particles.seed_particles(g, 4, dev).pos
    pos = pos + torch.from_numpy(rng.uniform(-0.5, 0.5, tuple(
        pos.shape)).astype(np.float32)).to(dev) * h
    return torch.stack([pos[:, 0].clamp(h, (g.ni - 1) * h),
                        pos[:, 1].clamp(h, (g.nj - 1) * h)], dim=-1)


def p2g_particles(g, rng, dev, pile=0, at=None):
    """The particle state of a 2D P2G case, bin-sorted, with its sorted
    keys: 4 x 4 particles a cell (seed_particles), jittered by up to half
    a cell and clamped to [h, (n-1)h], `pile` of them moved onto the
    world position `at`, and random columns; and how many lie on `at`."""
    import torch

    from gpufluidsimulation_tpu_torch.solvers import particles

    pos = particle_positions(g, rng, dev)
    P = pos.shape[0]
    if pile:
        at = torch.tensor(at, dtype=torch.float32, device=dev)
        pos[5000:5000 + pile] = at

    def col(*shape, positive=False):
        x = (rng.uniform(0, 2, shape) if positive
             else rng.normal(0, 1, shape))
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    state = particles.ParticleState(
        pos=pos, vel=col(P, 2), rho=col(P, positive=True), T=col(P),
        C_x=col(P, 4), C_y=col(P, 4), C_rho=col(P, 4), C_T=col(P, 4))
    state, keys = particles.bin_sort(g, state, return_keys=True)
    on_pile = int((state.pos == at).all(1).sum()) if pile else 0
    if on_pile < pile:
        raise AssertionError(f"p2g_splat: {on_pile} particles on the pile, "
                             f"expected {pile} or more")
    return state, keys, on_pile


def p2g_cols(p, order):
    if order == "flip":
        return (p.vel[:, 0], p.vel[:, 1], p.rho, p.T)
    return (p.C_x, p.C_y, p.C_rho, p.C_T)


def p2g_cases():
    """Phase 10's P2G cases: (label, grid, state, keys, particles on the
    pile). The Taylor grid (256^2, h = 2 pi / 256) with 12,000 particles
    piled on the clamp ring's corner node (x = h, y = (nj-1)h), without a
    pile, and with 5,000 piled at an interior position (100.3h, 77.6h),
    whose run spans ten of the kernel's 512-particle chunks; and RT's grid
    (256x1280, h = 0.2/256) with its 5,242,880 particles."""
    from gpufluidsimulation_tpu_torch.core.grids import Grid2D

    taylor = Grid2D(256, 256, 2 * np.pi / 256)
    rt = Grid2D(256, 1280, 0.2 / 256)
    h = taylor.h
    return [
        ("256x256 ring pile", taylor, 12000, (h, 255 * h)),
        ("256x256", taylor, 0, None),
        ("256x1280 (RT)", rt, 0, None),
        ("256x256 interior pile", taylor, 5000,
         (float(np.float32(100.3 * h)), float(np.float32(77.6 * h)))),
    ]


def p2g_call_trace(run, reps=5):
    """torch.profiler over `reps` wrapper calls: each device kernel's ms a
    call (the bin starts' arange and searchsorted, p2g_splat_kernel) and
    the CPU time of the call's ops; what a call by CUDA events adds to the
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    device, host = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            device[e.key[:60]] = e.device_time_total / 1e3 / reps
        elif e.key.startswith("aten::") and e.count >= reps:
            host[e.key] = e.cpu_time_total / 1e3 / reps
    return dict(device_ms=device, host_ms=host)


def p2g_phase(rng):
    """Phase 10, P2G: the p2g_splat kernel in its FLIP, APIC and PolyPIC
    modes on the cases of p2g_cases (a 12,000-particle pile on the clamp
    ring's corner node, the Taylor grid without a pile, RT's 256x1280
    with 5,242,880 particles and a 5,000-particle pile at an interior
    node whose runs span ten chunks), held against its plain version
    three ways: on the CPU bit for bit (the kernel sums every tap's run
    in order and the taps in the plain version's order, and the CPU's
    index_add_ sums in order; every order and case, RT's included, ~4 s
    of CPU an order there); on the card within P2G_TOL of each output's
    scale (the card's index_add_ adds with atomics in a run-dependent
    order: shuffling the particles of a CPU run moved each output by at
    most 9.9e-7 of its scale at 256^2 with the ring pile); and against
    its own second launch, bit for bit. Timed: the kernel's device time
    (a CUDA graph of 20 launches on bin starts made once, replayed between
    CUDA events; torch.profiler's reading beside it, which a long run's
    trace can undercount), a call with its bin bounds (one searchsorted)
    and launch, the plain
    version on the card, its bound and, as a yardstick, index_add_ of
    the same tap payloads (one call a tap, 14 calls) alone. The first
    case's FLIP call is also traced (p2g_call_trace)."""
    import torch

    from gpufluidsimulation_tpu_torch.core import interp
    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast
    from gpufluidsimulation_tpu_torch.solvers import particles

    dev = torch.device("cuda")
    VP = ctypes.c_void_p
    variants, trace = [], None
    for label, g, pile, at in p2g_cases():
        ni, nj, h = g.ni, g.nj, g.h
        state, keys, on_pile = p2g_particles(g, rng, dev, pile, at)
        P = state.pos.shape[0]
        cpu = particles.ParticleState(**{k: getattr(state, k).cpu()
                                         for k in particles._COLUMNS})
        nodes = (ni + 1) * nj + ni * (nj + 1) + ni * nj
        W = interp_fast.p2g_bin_width(nj)
        for order in ("flip", "apic", "polypic"):
            cols = p2g_cols(state, order)
            run = lambda: interp_fast.p2g_splat(state.pos, cols, h, ni, nj,
                                                keys, order)
            plain = lambda: interp_fast.p2g_splat_plain(state.pos, cols, h,
                                                        ni, nj, order)
            # the launch alone, on bin starts and an output made once
            starts = interp_fast.p2g_bin_starts(keys, ni, nj)
            out = torch.empty(nodes + ni * nj, device=dev)
            fn = _build.function("p2g_splat", "gfs_p2g_splat", [
                VP, ctypes.POINTER(VP), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, VP, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_longlong, VP, VP])
            ptrs = (VP * 4)(*[c.data_ptr() for c in cols])
            strides = (ctypes.c_int * 4)(
                *[c.stride(0) if order == "flip" else 4 for c in cols])

            def launch():
                _build.check(fn(_build.ptr(state.pos), ptrs, strides,
                                interp_fast.P2G_ORDERS[order],
                                _build.ptr(starts), ni, nj, float(h), P,
                                _build.ptr(out), _build.stream(out)),
                             "p2g_splat")

            got, again = run(), run()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"p2g_splat {order} {label}: two "
                                     "launches differ")
            t0 = time.time()
            want_cpu = interp_fast.p2g_splat_plain(
                cpu.pos, p2g_cols(cpu, order), h, ni, nj, order)
            cpu_s = time.time() - t0
            cpu_err = max(float((a.cpu() - b).abs().max())
                          for a, b in zip(got, want_cpu))
            del want_cpu
            log(f"[kernels] p2g_splat {order} {label} vs the plain version "
                f"on the CPU: max_abs_err={cpu_err:.3e} tol=0.0e+00 "
                f"({cpu_s:.1f} s on the CPU)")
            if cpu_err != 0.0:
                raise AssertionError(f"p2g_splat {order} {label}: kernel "
                                     "differs from its plain version on "
                                     f"the CPU: {cpu_err}")
            want = plain()
            errs, rels = [], []
            for name, a, b in zip(("u", "v", "rho", "T"), got, want):
                err = float((a - b).abs().max())
                scale = max(float(b.abs().max()), 1e-6)
                errs.append(err)
                rels.append(err / scale)
                if not np.isfinite(err) or err > P2G_TOL * scale:
                    raise AssertionError(
                        f"p2g_splat {order} {label} {name}: kernel vs plain "
                        f"on the card {err} > {P2G_TOL} x {scale}")
            del want
            log(f"[kernels] p2g_splat {order} {label} vs the plain version "
                f"on the card: max_abs_err={max(errs):.3e}, of each "
                f"output's scale {max(rels):.2e} tol={P2G_TOL:.1e}")
            k_ms = graph_ms(launch)
            profiler_ms = device_ms(run, 10, "p2g_splat_kernel")
            call_ms = cuda_time(run, 20)
            p_ms = cuda_time(plain, 3, warmup=1)
            if trace is None:
                trace = dict(case=f"{order} {label}",
                             **p2g_call_trace(run), call_ms=call_ms,
                             kernel_ms=k_ms)
                log(f"[kernels] p2g_splat call trace: {json.dumps(trace)}")
            # yardstick: index_add_ of the plain version's tap payloads,
            # one call a tap (6 + 4 + 4), into each lattice's sums
            taps = []
            for (shape, off), chans in zip(
                    ((g.shape_u, g.OFF_U), (g.shape_v, g.OFF_V),
                     (g.shape_c, g.OFF_C)), ((0,), (1,), (2, 3))):
                acc = torch.zeros((shape[0] * shape[1], len(chans) + 1),
                                  device=dev)
                x = interp.div_scalar(state.pos[:, 0], h) - off[0]
                y = interp.div_scalar(state.pos[:, 1], h) - off[1]
                for flat, w, ii, jj in particles._sorted_taps(
                        shape, state.pos, h, off):
                    if order == "flip":
                        vals = [cols[c] for c in chans]
                    else:
                        dx, dy = (ii.float() - x) * h, (jj.float() - y) * h
                        vals = [particles._poly_value(cols[c], dx, dy, order)
                                for c in chans]
                    taps.append((acc, flat, torch.stack(
                        [w * v for v in vals] + [w], dim=-1).contiguous()))

            def lib():
                for acc, flat, payload in taps:
                    acc.index_add_(0, flat, payload)

            lib_ms = cuda_time(lib, 5)
            del taps
            col_bytes = 16 if order == "flip" else 64
            nbytes = (8 * P + col_bytes * P + 4 * (ni * W + 1)
                      + 4 * (nodes + ni * nj))
            b_ms, b_by = bound_ms(nbytes, p2g_ops(order, P, nodes,
                                                   nodes + ni * nj))
            variants.append(dict(
                variant=f"{order} {label}", particles=P, pile=on_pile,
                max_abs_err=max(errs), max_rel_err=max(rels), tol=P2G_TOL,
                tol_of="each output's scale", cpu_plain_max_abs_err=cpu_err,
                cpu_plain_s=cpu_s, ms=k_ms, profiler_ms=profiler_ms,
                call_ms=call_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library="index_add_ of the tap payloads, 14 calls (one a "
                "tap)"))
            log(f"[kernels] p2g_splat {order} {label}, {P} particles "
                f"({on_pile} on the pile): {k_ms:.4f} ms on the card (a "
                f"CUDA graph of launches; torch.profiler {profiler_ms:.4f}; "
                f"{call_ms:.4f} ms a call with its bin bounds and launch; "
                f"plain {p_ms:.3f}, bound {b_ms:.5f} by {b_by}, index_add_ "
                f"yardstick {lib_ms:.4f})")
        del state, keys, cpu
        gc.collect()
        torch.cuda.empty_cache()
    return dict(variants[0], variants=variants, call_trace=trace,
                replaces=(
                    "gpufluidsimulation_tpu/solvers/particles.py:106-165 "
                    "(_sorted_taps, _splat_multi_sorted, "
                    "_splat_poly_multi_sorted: XLA sorted segment sums, no "
                    "pallas_call)"))


STATE_2D = ("u", "v", "u_temp", "v_temp", "rho", "T", "u_init", "v_init",
            "u_origin", "v_origin", "du", "dv", "du_prev", "dv_prev",
            "rho_init", "rho_orig", "drho", "drho_prev", "T_init", "T_orig",
            "dT", "dT_prev", "vel_map.fwd", "vel_map.bwd", "vel_map.bwd_prev",
            "scalar_map.fwd", "scalar_map.bwd", "scalar_map.bwd_prev")
PARTICLES_2D = tuple(f"particles.{c}" for c in ("pos", "vel", "rho", "T",
                                                 "C_x", "C_y", "C_rho", "C_T"))
PARTICLE_SCHEMES_2D = (4, 5, 6)     # FLIP, APIC, POLYPIC
COUNTERS_2D = ("frame", "last_remeshing", "rho_last_remeshing",
               "total_resample_count", "total_scalar_resample", "proj_iters",
               "substeps")


def parity_2d_phase(ni=32, nj=48, steps=3, seed=3):
    """Phase 11: each grid scheme at ni x nj (spectral projection, buoyancy
    on, dt 0.4: 2 or more CFL substeps), BiMocq in the level-set mode and
    the particle schemes FLIP, APIC and POLYPIC (4 x 4 particles a cell,
    sampled from the start's grid on the CPU), 3 steps on the card
    against the port on the CPU from one numpy state of smooth seeded
    velocities; BiMocq at blend 0.5 with remap gaps 2 and 1, so the
    two-level pull-back and both remaps run. Every field and map, and
    every particle column (both sort on the same keys, so the order is
    the same), within 2e-3 of its scale (the 3D gate), every counter
    (proj_iters, remap frames, substeps) equal."""
    from gpufluidsimulation_tpu_torch import convert
    from gpufluidsimulation_tpu_torch.solvers import smoke2d
    from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme

    rng = np.random.default_rng(seed)
    start = dict(u=smooth((ni + 1, nj), rng, 0.2, "cpu").numpy(),
                 v=smooth((ni, nj + 1), rng, 0.2, "cpu").numpy(),
                 rho=np.abs(smooth((ni, nj), rng, 2.0, "cpu").numpy()),
                 T=smooth((ni, nj), rng, 1.0, "cpu").numpy())
    out = {}
    for label, scheme, extra in (
            ("semilag", Scheme.SEMILAG, {}),
            ("maccormack", Scheme.MACCORMACK, {}),
            ("bfecc", Scheme.BFECC, {}),
            ("reflection", Scheme.MAC_REFLECTION, {}),
            ("bimocq", Scheme.BIMOCQ, dict(blend_coeff=0.5, vel_remap_gap=2,
                                           rho_remap_gap=1)),
            ("bimocq levelset", Scheme.BIMOCQ, dict(advect_levelset=True)),
            ("flip", Scheme.FLIP, {}), ("apic", Scheme.APIC, {}),
            ("polypic", Scheme.POLYPIC, {})):
        cfg = smoke2d.Smoke2DConfig(ni=ni, nj=nj, L=1.0, scheme=scheme,
                                    alpha=0.2, beta=0.05, proj_tol=1e-5,
                                    **extra)
        gpu = smoke2d.Smoke2D(cfg)
        cpu = smoke2d.Smoke2D(cfg, device="cpu")
        arrays = dict(convert.state_to_numpy(cpu.init_state()), **start)
        if scheme in PARTICLE_SCHEMES_2D:
            # the CLI's bootstrap, once, on the CPU: both start from it
            arrays = convert.state_to_numpy(cpu.sample_particles_from_grid(
                convert.state_from_numpy(arrays, cfg, "cpu")))
        sg = convert.state_from_numpy(arrays, cfg, gpu.device)
        sc = convert.state_from_numpy(arrays, cfg, "cpu")
        iters = []
        for k in range(steps):
            sg, sc = gpu.step(sg, 0.4), cpu.step(sc, 0.4)
            for key in COUNTERS_2D:
                if getattr(sg, key) != getattr(sc, key):
                    raise AssertionError(
                        f"parity 2D {label} step {k}: {key} "
                        f"{getattr(sg, key)} (card) != {getattr(sc, key)}")
            iters.append(sg.proj_iters)
        a, b = convert.state_to_numpy(sg), convert.state_to_numpy(sc)
        worst = {}
        keys = STATE_2D + (PARTICLES_2D if scheme in PARTICLE_SCHEMES_2D
                           else ())
        for key in keys:
            err = float(np.abs(a[key].astype(np.float64) - b[key]).max())
            scale = max(1.0, float(np.abs(b[key]).max()))
            worst[key] = err
            if not np.isfinite(err) or err > 2e-3 * scale:
                raise AssertionError(f"parity 2D {label} {key}: card vs cpu "
                                     f"{err}")
        log(f"[parity] 2D {label} {ni}x{nj}, {steps} steps, proj_iters "
            f"{iters}, substeps {sg.substeps}, remaps (vel, scalar) "
            f"{(sg.total_resample_count, sg.total_scalar_resample)}, card vs "
            "cpu max abs err (bound 2e-3 of scale): "
            + json.dumps({k: v for k, v in worst.items() if v}))
        out[label] = max(worst.values())
    return out


def count_syncs(fn):
    """fn() and the synchronizing CUDA operations it made, as
    torch.cuda.set_sync_debug_mode reports them: their count and the
    port's source lines that made them."""
    import traceback
    import warnings

    import torch

    where = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()
                      if "gpufluidsimulation_tpu_torch" in f.filename]
            where.append(f"{os.path.basename(frames[-1].filename)}:"
                         f"{frames[-1].lineno}" if frames else filename)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, len(where), where


def busy_ms(fn, steps):
    """Device-busy milliseconds a step and kernel launches a step over
    `steps` calls of fn(), from torch.profiler (the sum over the card's
    kernels and copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in events) / 1e3 / steps,
            sum(e.count for e in events) / steps, prof)


def observe_plain_calls(calls):
    """Count, in `calls`, every call of a plain particle splat (the P2G
    kernel's plain version and the unsorted splats) and of a plain 2D
    march (the trace and DMC modes' plain versions and their parts)
    until the returned function is called. Only observes: each call runs
    as it would."""
    from gpufluidsimulation_tpu_torch.ops import interp_fast
    from gpufluidsimulation_tpu_torch.solvers import particles

    saved = []
    for mod, name in ((interp_fast, "p2g_splat_plain"),
                      (particles, "_splat_multi_sorted"),
                      (particles, "_splat_poly_multi_sorted"),
                      (particles, "_splat_multi"),
                      (particles, "_splat_poly_multi"),
                      (interp_fast, "bilerp_trace_plain"),
                      (interp_fast, "rk3_step_2d_plain"),
                      (interp_fast, "bilerp_dmc_plain"),
                      (interp_fast, "dmc_slopes_2d_plain")):
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return restore


def path_2d_phase(label, example, steps, profile, scheme=None):
    """Phase 12: a 2D scene as the CLI builds it (``make_scene_2d`` with
    BiMocq or `scheme`, the scene's init on the card, for the particle
    schemes the CLI's bootstrap from the grid, its fixed dt), 2 warm-up
    steps, then `steps` steps timed with CUDA events, every launch count
    set to 0 just before and read just after; the host syncs of one step
    (torch.cuda.set_sync_debug_mode) and the device's busy time and
    launches over 2 profiled steps, whose ratio to the step time is the
    card's idle share. Every path must trace in bilerp_sample's trace
    mode (and a BiMocq path march its backward map in the DMC mode) and
    call no plain trace or DMC; a particle path must launch p2g_splat
    every step (and bilerp_sample's cp mode on APIC and PolyPIC) and call
    no plain splat."""
    import torch

    from gpufluidsimulation_tpu_torch.scenes import scenes2d
    from gpufluidsimulation_tpu_torch.solvers import smoke2d
    from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme

    scheme = Scheme.BIMOCQ if scheme is None else scheme
    particles = scheme in (Scheme.FLIP, Scheme.APIC, Scheme.POLYPIC)
    scene = scenes2d.make_scene_2d(example, scheme)
    solver = smoke2d.Smoke2D(scene.cfg)
    t0 = time.time()
    state = scene.init(solver, solver.init_state())
    if particles:
        state = solver.sample_particles_from_grid(state)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    for _ in range(2):
        state = solver.step(state, scene.dt)
    fns = wrappers()
    plain_calls = {}
    torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
    restore = observe_plain_calls(plain_calls)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    try:
        start.record()
        for _ in range(steps):
            state = solver.step(state, scene.dt)
        end.record()
        torch.cuda.synchronize()
    finally:
        restore()
    host_ms = (time.time() - t0) / steps * 1e3
    ms = start.elapsed_time(end) / steps
    launches = {k: fn.launches for k, fn in fns.items()}
    if kernel_launches(launches, "bilerp_sample") == 0:
        raise AssertionError(f"the 2D path {label} never launched "
                             "bilerp_sample")
    # every trace is one trace-mode launch, every backward-map substep one
    # DMC-mode launch: a step traces at least once, and a BiMocq step
    # marches its backward map at least one substep
    if plain_calls:
        raise AssertionError(f"the 2D path {label} called plain versions "
                             f"on the card: {plain_calls}")
    if launches["bilerp_trace"] < steps:
        raise AssertionError(f"the 2D path {label} made "
                             f"{launches['bilerp_trace']} trace-mode launches "
                             f"in {steps} steps")
    if scheme == Scheme.BIMOCQ and launches["bilerp_dmc"] < steps:
        raise AssertionError(f"the 2D path {label} made "
                             f"{launches['bilerp_dmc']} DMC-mode launches in "
                             f"{steps} steps")
    if particles:
        if launches["p2g_splat"] < steps:
            raise AssertionError(f"the 2D path {label} launched p2g_splat "
                                 f"{launches['p2g_splat']} times in {steps} "
                                 "steps")
        if (scheme != Scheme.FLIP
                and launches["bilerp_sample_cp"] < steps):
            raise AssertionError(f"the 2D path {label} made "
                                 f"{launches['bilerp_sample_cp']} cp-mode "
                                 f"launches in {steps} steps")
    state, syncs, sync_lines = count_syncs(
        lambda: solver.step(state, scene.dt))
    holder = [state]

    def one():
        holder[0] = solver.step(holder[0], scene.dt)

    busy, kernels, prof = busy_ms(one, 2)
    state = holder[0]
    for key in ("u", "v", "rho", "T"):
        if not bool(torch.isfinite(getattr(state, key)).all()):
            raise AssertionError(f"2D path {label}: non-finite {key}")
    for key in ("pos", "vel", "rho", "T", "C_x", "C_y", "C_rho", "C_T"):
        if not bool(torch.isfinite(getattr(state.particles, key)).all()):
            raise AssertionError(f"2D path {label}: non-finite particle "
                                 f"{key}")
    g = solver.grid
    res = dict(
        scene=scene.name, grid=[g.ni, g.nj], dt=scene.dt, steps=steps,
        init_s=init_s, ms_per_step=ms, host_ms_per_step=host_ms,
        scheme=scheme.display_name(),
        particles=int(state.particles.pos.shape[0]),
        bilerp_sample_per_step=launches["bilerp_sample"] / steps,
        bilerp_sample_mac_per_step=launches["bilerp_sample_mac"] / steps,
        bilerp_sample_cp_per_step=launches["bilerp_sample_cp"] / steps,
        bilerp_trace_per_step=launches["bilerp_trace"] / steps,
        bilerp_dmc_per_step=launches["bilerp_dmc"] / steps,
        wrapper_launches_per_step={k: n / steps for k, n in launches.items()
                                   if n},
        p2g_splat_per_step=launches["p2g_splat"] / steps,
        plain_calls=plain_calls,
        syncs_per_step=syncs, sync_lines=sync_lines,
        device_busy_ms_per_step=busy,
        device_launches_per_step=kernels,
        idle_share=1.0 - busy / ms, substeps=state.substeps,
        proj_iters=state.proj_iters, cfl=state.cfl,
        remaps=[state.total_resample_count, state.total_scalar_resample],
        rho_max=float(state.rho.max()))
    log(f"[path2d] {label} " + json.dumps(res))
    if profile:
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=25)
        with open(profile, "a") as f:
            f.write(f"== 2D path {label}: 2 steps under the profiler, "
                    f"busy {busy:.3f} ms/step of {ms:.3f}\n{table}\n")
    return launches


def cli_2d_phase():
    """Phase 13: the CLI's sim2d, in-process, --out in a temporary
    directory: sim2d 7 0 (BiMocq, the Taylor vortex at 256^2), 3 frames;
    sim2d 3 2 (reflection, Rayleigh-Taylor at 256x1280), 2 frames; sim2d
    7 3 (BiMocq, the Zalesak level set, CFL-driven substeps), 1 frame;
    sim2d 4 0 (FLIP, 1,048,576 particles), 2 frames; sim2d 6 2 (PolyPIC,
    Rayleigh-Taylor with 5,242,880 particles), 1 frame.
    Each run's launches are counted alone; every BMP must be a 24-bit
    image of the grid's size and every level-set file finite, of the
    grid's shape and equal to the frame's rho to its printed digits."""
    import tempfile

    by_run = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli2d_") as tmp:
        for label, argv, files, shape in (
                ("sim2d_7_0", ["sim2d", "7", "0", "--frames", "3"],
                 [os.path.join("2D_Taylor_vortex", "BiMocq",
                               f"vort_{k:04d}.bmp") for k in range(3)],
                 (256, 256)),
                ("sim2d_3_2", ["sim2d", "3", "2", "--frames", "2"],
                 [os.path.join("2D_RayleighTaylor", "Reflection",
                               f"density_{k:04d}.bmp") for k in range(2)],
                 (256, 1280)),
                ("sim2d_7_3", ["sim2d", "7", "3", "--frames", "1"],
                 [os.path.join("2D_Zalesak", "BiMocq",
                               "levelset_0000.txt")], (200, 200)),
                ("sim2d_4_0", ["sim2d", "4", "0", "--frames", "2"],
                 [os.path.join("2D_Taylor_vortex", "FLIP",
                               f"vort_{k:04d}.bmp") for k in range(2)],
                 (256, 256)),
                ("sim2d_6_2", ["sim2d", "6", "2", "--frames", "1"],
                 [os.path.join("2D_RayleighTaylor", "PolyPIC",
                               "density_0000.bmp")], (256, 1280))):
            expect = ("bilerp_sample",) + (
                ("p2g_splat",) if argv[1] in "456" else ())
            summary, records, _ = cli_run(
                argv + ["--out", os.path.join(tmp, label)], expect)
            if argv[1] == "6" and summary["launches"]["bilerp_sample_cp"] < 2:
                raise AssertionError(f"{label}: no cp-mode launch a frame "
                                     "and in the bootstrap")
            steps = [r for r in records if r["kind"] == "step"]
            for name in files:
                path = os.path.join(tmp, label, name)
                if name.endswith(".bmp"):
                    raw = open(path, "rb").read()
                    width, height = np.frombuffer(raw[18:26], "<i4")
                    row = (3 * shape[0] + 3) & ~3
                    if (raw[:2] != b"BM" or (width, height) != shape
                            or len(raw) != 54 + row * shape[1]
                            or not any(raw[54:])):
                        raise AssertionError(f"{label}: bad image {name}")
                else:
                    got = np.loadtxt(path)
                    want = steps[-1]["rho"].cpu().numpy()
                    if (got.shape != shape or not np.isfinite(got).all()
                            or not np.allclose(got, want, rtol=1e-5,
                                               atol=1e-7)):
                        raise AssertionError(f"{label}: bad level set")
            summary["files"] = files
            summary.pop("write_volume_ms")
            summary.pop("checkpoint_ms")
            log(f"[cli] {label} " + json.dumps(summary))
            by_run[f"cli_{label}"] = summary.pop("launches")
    return by_run


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256, help="main-path grid n^3")
    ap.add_argument("--steps", type=int, default=8,
                    help="timed steps of the main path")
    ap.add_argument("--obstacle-n", type=int, default=256,
                    help="grid n^3 of the obstacle and MG-PCG paths")
    ap.add_argument("--obstacle-steps", type=int, default=4,
                    help="timed steps of the obstacle and MG-PCG paths")
    ap.add_argument("--kernel-n", type=int, default=256,
                    help="grid of the kernel-vs-plain phase")
    ap.add_argument("--scheme-n", type=int, default=256,
                    help="grid n^3 of the reflection, maccormack, "
                    "bimocq_adaptive, bimocq_vol9 and bimocq_prefilter "
                    "paths")
    ap.add_argument("--scheme-steps", type=int, default=3,
                    help="timed steps of each of those paths")
    ap.add_argument("--cli-res", type=int, default=100,
                    help="--res of the CLI phase's vortex runs (res x 2res "
                    "x 2res)")
    ap.add_argument("--cli-obstacle-res", type=int, default=64,
                    help="--res of the CLI phase's obstacle run")
    ap.add_argument("--steps-2d", type=int, default=10,
                    help="timed steps of each 2D path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="PATH",
                    help="write torch.profiler tables of 2 steps of the "
                    "main, obstacle, MG-PCG and phase-7 paths to PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        from gpufluidsimulation_tpu_torch.config import EngineMode
        from gpufluidsimulation_tpu_torch.ops import _build, interp_fast
        from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
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
            if ("registers" in line or "spill" in line
                    or "entry function" in line and name in REDESIGNED):
                log(f"[build] {name}: {line.strip()}")
    # the redesigned kernels keep their neighbourhoods, rings and stage
    # values in registers: none of them may spill to local memory
    spills = [f"{name}: {line.strip()}" for name in REDESIGNED
              for line in logs[name].splitlines()
              if re.search(r"[1-9]\d* bytes spill", line)]
    if spills:
        raise AssertionError(f"redesigned kernels spill: {spills}")

    results = kernel_phase(args.kernel_n, args.seed)
    slab_results = slab_phase(args.kernel_n, args.seed)
    rng2d = np.random.default_rng(args.seed + 2)
    parity_phase(bench_config(32), "vortex")
    parity_phase(obstacle_config(32), "obstacle")
    parity_phase(bench_config(32, scheme=Scheme.MAC_REFLECTION),
                 "reflection vortex")
    parity_phase(obstacle_config(32, scheme=Scheme.MACCORMACK),
                 "maccormack obstacle")
    small_gaps = dict(reinit_mode="adaptive", blend_coeff=0.5,
                      vel_reinit_gap=2, scalar_reinit_gap=3)
    parity_phase(bench_config(32, **small_gaps), "bimocq adaptive blend 0.5")
    parity_phase(bench_config(32, engine_mode=EngineMode(volume_exact=True),
                              **small_gaps),
                 "bimocq adaptive blend 0.5 exact volume")
    interp_fast.reset_vol9_block_counts()
    parity_phase(bench_config(32, engine_mode=EngineMode(volume_vol9=True),
                              **small_gaps),
                 "bimocq adaptive blend 0.5 vol9 volume")
    # both runs take the same steps, so each made half of the fixups
    per_run = interp_fast.vol9_fixup.total_blocks // 2
    exact = {dev: int(n)
             for dev, n in interp_fast.vol9_fixup.exact_blocks.items()}
    log(f"[parity] vol9 32^3: block channels flagged, by device, {exact} "
        f"of {per_run} in each run")
    parity_phase(bench_config(32, engine_mode=EngineMode(volume_dual=False),
                              **small_gaps),
                 "bimocq adaptive blend 0.5 prefilter volume")
    multi_parity_phase()
    mgpcg_parity_phase()
    parity_phase(voxel_obstacle_config(32), "voxel obstacle (mesh_to_sdf)")
    parity_phase(voxel_emitter_config(32),
                 "voxel emitter with trans and emit_velocity")
    parity_phase(bench_config(32, engine_mode=EngineMode(
        spectral_poisson=False, rbgs=False)), "mgpcg jacobi (rbgs=False)")
    by_path = {}
    by_path["main"], main_solver, main_ms = main_phase(args.n, args.steps,
                                                       args.profile)
    by_path["sharded_main"], sharded_slab = sharded_phase(
        main_solver, main_ms, args.profile)
    del main_solver
    by_path["obstacle"], obstacle_calls = obstacle_phase(
        args.obstacle_n, args.obstacle_steps, args.profile)
    mgpcg_res = mgpcg_phase(args.obstacle_n, args.obstacle_steps,
                            args.profile)
    by_path["mgpcg"] = mgpcg_res["launches"]
    by_path["mgpcg_jacobi"] = jacobi_mgpcg_phase(
        args.obstacle_n, args.scheme_steps, mgpcg_res)
    results["masked_rbgs_smooth"].update(obstacle_calls)
    results["rbgs_smooth"].update(mgpcg_res["smoother"])
    by_path.update(scheme_phase(args.scheme_n, args.scheme_steps,
                                args.profile))
    by_path["pullback_multi"] = pullback_multi_phase(args.scheme_n, 5)
    by_path.update(cli_phase(args.cli_res, args.cli_obstacle_res))
    t16 = time.time()
    bf16_results = bf16_kernel_phase(args.kernel_n, args.seed)
    bf16_paths, bf16_by_path = bf16_path_phase(args.n, args.steps,
                                               args.scheme_steps)
    log(f"[bf16] the bf16 phases took {time.time() - t16:.1f} s")
    t2d = time.time()
    results["bilerp_sample"] = bilerp_phase(rng2d)
    results["p2g_splat"] = p2g_phase(rng2d)
    parity_2d_phase()
    by_path["sim2d_bimocq"] = path_2d_phase("sim2d_bimocq", 0,
                                            args.steps_2d, args.profile)
    by_path["sim2d_rt"] = path_2d_phase("sim2d_rt", 2, args.steps_2d,
                                        args.profile)
    for label, example, scheme in (
            ("sim2d_flip", 0, Scheme.FLIP), ("sim2d_apic", 0, Scheme.APIC),
            ("sim2d_polypic", 0, Scheme.POLYPIC),
            ("sim2d_rt_flip", 2, Scheme.FLIP)):
        by_path[label] = path_2d_phase(label, example, args.steps_2d,
                                       args.profile, scheme)
    by_path.update(cli_2d_phase())
    log(f"[path2d] the 2D phases took {time.time() - t2d:.1f} s")
    # each kernel's count comes from the path that was added for it
    path_of = dict.fromkeys(KERNELS, "main")
    path_of.update(masked_rbgs_smooth="obstacle", rbgs_smooth="mgpcg",
                   minmax_sample="reflection", vol9_fixup="bimocq_vol9",
                   volume_prefilter="bimocq_prefilter",
                   pullback_sample="pullback_multi",
                   bilerp_sample="sim2d_bimocq", p2g_splat="sim2d_flip")

    line = []
    for name in KERNELS:
        r = results[name]
        launches = kernel_launches(by_path[path_of[name]], name)
        if launches == 0:
            raise AssertionError(f"{name} was never launched on its path")
        entry = dict(name=name, route="cuda",
                     source=f"gpufluidsimulation_tpu_torch/csrc/{name}.cu",
                     replaces=r["replaces"], launches=launches,
                     launches_by_path={p: kernel_launches(c, name)
                                       for p, c in by_path.items()},
                     max_abs_err=r["max_abs_err"], max_err=r["max_abs_err"],
                     tol=r["tol"], ms=r["ms"], kernel_ms=r["ms"],
                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                     bound_by=r["bound_by"], library_ms=r["library_ms"])
        if name in LATTICE:
            entry["lattice_launches_by_path"] = {
                p: c[LATTICE[name]] for p, c in by_path.items()}
        elif name in MODES:
            for mode in MODES[name]:
                entry[f"{mode.rsplit('_', 1)[1]}_launches_by_path"] = {
                    p: c[mode] for p, c in by_path.items()}
        if name in BF16_KERNELS:
            entry["bf16"] = dict(bf16_results[name], launches_by_path={
                p: c[name] + c.get(LATTICE.get(name), 0)
                for p, c in bf16_by_path.items()}, paths={
                p: {k: r[k] for k in ("ms_per_step", "launches",
                                      "bf16_launches_per_step",
                                      "conversions_per_step")}
                for p, r in bf16_paths.items() if p.startswith("bf16_")},
                drift_of_scale=bf16_paths["drift_of_scale"])
        if name in SLAB_KERNELS:
            entry["slab"] = dict(slab_results[name], launches_by_path={
                "sharded_main": sum(
                    n_ for w_, n_ in sharded_slab.items()
                    if w_ == name or w_ == LATTICE.get(name))})
        for extra in ("variants", "call_trace", "lattice", "one_sweep_ms",
                      "sweeps_per_launch", "levels_per_launch", "cases",
                      "calls_per_step", "launches_per_step"):
            if extra in r:
                entry[extra] = r[extra]
        line.append(entry)
    log(json.dumps({"kernels": line}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
