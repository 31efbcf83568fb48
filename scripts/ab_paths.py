#!/usr/bin/env python3
"""Time the port's solver paths in several source trees on one GPU.

    python3 scripts/ab_paths.py _archive/parent . . _archive/parent
    python3 scripts/ab_paths.py A B --paths main,maccormack --n 128 --steps 8
    python3 scripts/ab_paths.py _archive/parent . --paths main --march
    python3 scripts/ab_paths.py _archive/parent . . _archive/parent \
        --paths sim2d_bimocq,sim2d_rt,sim2d_flip,sim2d_rt_flip --steps 10

Each tree runs in its own process, from its own root, in the order given,
so each builds its own kernels and imports its own package (a tree is any
checkout of the repository, e.g. a ``git archive`` of a commit unpacked
under the gitignored ``_archive/``). Listing the trees as parent, change,
change, parent gives each one an early and a late turn on the same card.
In each process the tree's kernels are built first, then every path is
built as that tree's ``chip_smoke.bench_config`` builds it (256^3 by
default; ``obstacle`` as its ``obstacle_config``, ``mgpcg`` with the
spectral solve off; the 2D paths ``sim2d_*`` as that tree's
``chip_smoke.path_2d_phase`` builds them: the scene of ``make_scene_2d``,
its init and fixed dt, the particle bootstrap), stepped twice to warm up
(the first step of a path
allocates its working set; the obstacle path until both map marches
substep, as chip_smoke.py warms it), then timed over ``--steps`` steps
with CUDA events. Prints one JSON line per tree and path (with each timed
step's ``proj_iters``), then ms/step by path and run.
With ``--profile``, each path then runs 2 more steps under torch.profiler:
the card's busy time, its launches and the smoothers' kernels (names with
``rbgs`` or ``levels_kernel``) per step, and the idle share against the
timed ms/step. With ``--march``, each tree's main path also times its
backward-map march
(``advect.update_backward_map_3d`` from the identity, as a step calls it,
on the state the step saw) with CUDA events, and profiles one call of it:
its kernels by name, launches and device time. Needs a GPU; imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PATHS = ("main", "reflection", "maccormack", "bimocq_adaptive",
         "bimocq_vol9", "bimocq_prefilter", "obstacle", "mgpcg")
# the 2D paths: (example, scheme name)
PATHS_2D = {"sim2d_bimocq": (0, "BIMOCQ"), "sim2d_rt": (2, "BIMOCQ"),
            "sim2d_flip": (0, "FLIP"), "sim2d_apic": (0, "APIC"),
            "sim2d_polypic": (0, "POLYPIC"), "sim2d_rt_flip": (2, "FLIP")}


class Stepper:
    """A 2D solver stepped at its scene's fixed dt, as a 3D solver steps."""

    def __init__(self, solver, dt):
        self.solver, self.dt = solver, dt

    def step(self, state):
        return self.solver.step(state, self.dt)


def path_2d(path):
    """The 2D path's solver (a Stepper) and its state after the scene's
    init and, for the particle schemes, the CLI's bootstrap."""
    from gpufluidsimulation_tpu_torch.scenes import scenes2d
    from gpufluidsimulation_tpu_torch.solvers import smoke2d
    from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme

    example, name = PATHS_2D[path]
    scheme = getattr(Scheme, name)
    scene = scenes2d.make_scene_2d(example, scheme)
    solver = smoke2d.Smoke2D(scene.cfg)
    state = scene.init(solver, solver.init_state())
    if name in ("FLIP", "APIC", "POLYPIC"):
        state = solver.sample_particles_from_grid(state)
    return Stepper(solver, scene.dt), state


def march(solver, state, reps=20):
    """Time and profile the backward-map march of one step of `solver`
    from `state`: the step's own call is captured, then repeated."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gpufluidsimulation_tpu_torch.ops import advect

    fn = advect.update_backward_map_3d
    calls = []

    def capture(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    advect.update_backward_map_3d = capture
    try:
        solver.step(state)
    finally:
        advect.update_backward_map_3d = fn
    args, kwargs = calls[0]
    for _ in range(3):
        fn(*args, **kwargs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args, **kwargs)
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("update_backward_map_3d"):
            fn(*args, **kwargs)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.key != "update_backward_map_3d"),
                     key=lambda k: -k[2])
    return dict(from_identity=kwargs.get("from_identity"),
                march_ms=start.elapsed_time(end) / reps,
                profiled_device_ms=sum(k[2] for k in kernels),
                launches=sum(k[1] for k in kernels),
                kernels=[dict(name=k[0][:80], count=k[1], device_ms=k[2])
                         for k in kernels])


def profiled(solver, state, ms_per_step, steps=2):
    """Device busy ms, launches and the smoothers' ms and launches per step
    over `steps` steps under torch.profiler; idle share against
    `ms_per_step`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state = solver.step(state)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    gs = [e for e in kernels if "rbgs" in e.key or "levels_kernel" in e.key]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    return dict(busy_ms=busy, idle=1.0 - busy / ms_per_step,
                launches=sum(e.count for e in kernels) / steps,
                smoother_ms=sum(e.self_device_time_total for e in gs)
                / 1e3 / steps,
                smoother_launches=sum(e.count for e in gs) / steps)


def child(tree, paths, n, steps, with_march, with_profile):
    """Time `paths` with the package and chip_smoke of `tree`."""
    sys.path.insert(0, tree)
    import gc

    import torch

    import chip_smoke as cs
    import gpufluidsimulation_tpu_torch as port
    from gpufluidsimulation_tpu_torch.config import EngineMode
    from gpufluidsimulation_tpu_torch.ops import _build
    from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D

    if not os.path.abspath(port.__file__).startswith(tree):
        raise SystemExit(f"{tree}: imported the package from {port.__file__}")
    # the 2D paths need only the two 2D kernels
    _build.build(["bilerp_sample", "p2g_splat"]
                 if all(p in PATHS_2D for p in paths) else _build.SOURCES)
    configs = {
        "main": dict(),
        "reflection": dict(scheme=Scheme.MAC_REFLECTION),
        "maccormack": dict(scheme=Scheme.MACCORMACK),
        "bimocq_adaptive": dict(reinit_mode="adaptive"),
        "bimocq_vol9": dict(reinit_mode="adaptive",
                            engine_mode=EngineMode(volume_vol9=True)),
        "bimocq_prefilter": dict(engine_mode=EngineMode(volume_dual=False)),
        "mgpcg": dict(engine_mode=EngineMode(spectral_poisson=False)),
    }
    for path in paths:
        if path in PATHS_2D:
            solver, state = path_2d(path)
        else:
            cfg = (cs.obstacle_config(n) if path == "obstacle"
                   else cs.bench_config(n, **configs[path]))
            solver = Smoke3D(cfg)
            state = solver.init_state()
        state = solver.step(solver.step(state))
        while path == "obstacle" and state.substeps < 2 and state.frame < 150:
            state = solver.step(state)
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        events[0].record()
        proj_iters = []
        for k in range(steps):
            state = solver.step(state)
            events[k + 1].record()
            proj_iters.append(state.proj_iters)
        torch.cuda.synchronize()
        per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        res = dict(tree=tree, path=path, n=n, frame=state.frame,
                   ms_per_step=sum(per_step) / steps, per_step_ms=per_step,
                   substeps=state.substeps, proj_iters=proj_iters)
        if with_march and path == "main":
            res["march"] = march(solver, state)
        if with_profile:
            res["profile"] = profiled(solver, state, res["ms_per_step"])
        print(json.dumps(res), flush=True)
        del state, solver
        gc.collect()
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="source trees, in run order")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--march", action="store_true",
                    help="also time and profile the main path's "
                    "backward-map march")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 2 steps of each path")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    paths = args.paths.split(",")
    if args.child:
        child(os.path.abspath(args.trees[0]), paths, args.n, args.steps,
              args.march, args.profile)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("ab_paths: no GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    table = {p: [] for p in paths}
    iters = {p: [] for p in paths}
    marches, profiles = [], []
    for run, label in enumerate(args.trees):
        tree = os.path.abspath(label)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--child",
             "--paths", args.paths, "--n", str(args.n), "--steps",
             str(args.steps)] + (["--march"] if args.march else [])
            + (["--profile"] if args.profile else []),
            cwd=tree, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(f"ab_paths: {tree} failed")
        for line in proc.stdout.splitlines():
            print(line, flush=True)
            res = json.loads(line)
            table[res["path"]].append(f"{run}:{label} "
                                      f"{res['ms_per_step']:.2f}")
            iters[res["path"]].append(f"{run}:{label} {res['proj_iters']}")
            if "profile" in res:
                prof = res["profile"]
                profiles.append(
                    f"{res['path']} {run}:{label} busy "
                    f"{prof['busy_ms']:.2f} ms/step ({100 * prof['idle']:.1f}% "
                    f"idle) in {prof['launches']:.0f} launches; smoothers "
                    f"{prof['smoother_ms']:.3f} ms in "
                    f"{prof['smoother_launches']:.1f} launches")
            if "march" in res:
                marches.append(f"{run}:{label} "
                               f"{res['march']['march_ms']:.3f} ms in "
                               f"{res['march']['launches']} launches")
    for path, cells in table.items():
        print(f"[ab] {path} ms/step: " + ", ".join(cells), flush=True)
        print(f"[ab] {path} proj_iters: " + ", ".join(iters[path]),
              flush=True)
    for line in profiles:
        print(f"[ab] profile {line}", flush=True)
    if marches:
        print("[ab] main backward-map march: " + ", ".join(marches),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
