"""Command-line entry points of both reference executables on the port:

    python -m gpufluidsimulation_tpu_torch.cli sim2d <scheme> <example>
        [--frames F] [--out DIR] [--no-strict-contract] [--device DEV]
    python -m gpufluidsimulation_tpu_torch.cli sim3d <scheme3d> [--res N]
        [--example E] [--dt DT] [--frames F] [--out DIR] [--resume CKPT]
        [--checkpoint-every K] [--no-strict-contract] [--residual-trace]
        [--device DEV]

2D (bimocq2D/main.cpp): scheme 0 Semilag, 1 MacCormack, 2 BFECC, 3
Reflection, 4 FLIP, 5 APIC, 6 PolyPIC, 7 BiMocq; example 0 Taylor
vortex, 1 leapfrog, 2 Rayleigh-Taylor, 3 Zalesak, 4 vortex box, at the
reference's sizes (the particle schemes 4-6 run examples 0-2, with 4 x 4
particles a cell seeded and sampled from the scene's initial grid).
Fixed-dt examples take one step a frame; the level-set examples substep
each frame at their CFL number.
Each frame prints its time on the card, CFL number and projection, and
writes ``<out>/<scene>/<Scheme>/vort_NNNN.bmp``, ``density_NNNN.bmp`` or
``levelset_NNNN.txt``.

3D (bimocq3D/main.cpp:82-91): scheme 0 BiMocq, 1 Semilag, 2 MacCormack,
3 Reflection; example 0 the vortex collision at ni x 2ni x 2ni (ni =
``--res``, 100 by default), 1 the plume with the moving sphere obstacle.
Each frame prints its CFL number, the step's time on the card and the
projection's iterations and residual, and writes
``<out>/<scheme>-<Name>-Gpu/NNNN.vdb``; every ``--checkpoint-every``
frames a ``ckpt_NNNN.npz`` in the JAX package's checkpoint format, which
``--resume`` takes (from either package).

Both run on the card unless ``--device`` names another device; without
a card they exit non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys

from gpufluidsimulation_tpu_torch import config
from gpufluidsimulation_tpu_torch.io_utils import (bmp, checkpoint, colormap,
                                                   volume)
from gpufluidsimulation_tpu_torch.ops import forces
from gpufluidsimulation_tpu_torch.scenes import scenes2d, scenes3d
from gpufluidsimulation_tpu_torch.solvers import smoke2d
from gpufluidsimulation_tpu_torch.solvers.schemes import (SCHEME_3D_ARGV,
                                                          Scheme)
from gpufluidsimulation_tpu_torch.utils import timing


def _device(name):
    """The run's device, or None after printing why there is none."""
    try:
        return config.resolve_device(name)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _run_2d(args) -> int:
    try:
        scheme = Scheme(args.scheme)
        scene = scenes2d.make_scene_2d(args.example, scheme)
        smoke2d.check_supported(scene.cfg)
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    device = _device(args.device)
    if device is None:
        return 1
    solver = smoke2d.Smoke2D(scene.cfg, device=device)
    state = scene.init(solver, solver.init_state())
    if scheme in (Scheme.FLIP, Scheme.APIC, Scheme.POLYPIC):
        state = solver.sample_particles_from_grid(state)
    out_dir = os.path.join(args.out, scene.name, scheme.display_name())
    os.makedirs(out_dir, exist_ok=True)
    frames = args.frames or scene.total_frames
    timer = timing.FrameTimer(device)
    g = solver.grid
    retried = [False]

    def _step(st, dt):
        if args.no_strict_contract:
            return solver.step(st, dt)
        st, r = solver.step_checked(st, dt)
        retried[0] = retried[0] or r
        return st

    for frame in range(frames):
        retried[0] = False
        if scene.dt is not None:
            state, _ = timer.time_step(_step, state, scene.dt)
        else:
            # CFL-driven substepping of the level-set examples
            T = 0.0
            while T < scene.frame_dt:
                mv = float(smoke2d.max_vel(state.u, state.v))
                sub = min(scene.cfl_number * g.h / mv, scene.frame_dt - T)
                state, _ = timer.time_step(_step, state, sub)
                T += sub
        print(timing.BLUE + f"{scheme.display_name()} frame {frame} done "
              + timing.RESET + timer.report(frame, {
                  "cfl": f"{float(state.cfl):.3f}",
                  "proj_iters": int(state.proj_iters),
                  "proj_res": f"{float(state.proj_res):.2e}"}))
        if retried[0]:
            print(timing.YELLOW + "[contract] displacement budget tripped "
                  "— frame recomputed on the exact path" + timing.RESET)
        if scene.output == "vorticity":
            rgb = colormap.render_vorticity(forces.curl_2d(state.u, state.v,
                                                           g.h), g.ni, g.nj)
            bmp.write_bmp_rgb(os.path.join(out_dir, f"vort_{frame:04d}.bmp"),
                              rgb)
        elif scene.output == "density":
            bmp.write_bmp_color(
                os.path.join(out_dir, f"density_{frame:04d}.bmp"),
                state.rho, state.T)
        else:
            volume.write_levelset_txt(out_dir, frame, state.rho)
    return 0


def _run_3d(args) -> int:
    if args.scheme not in SCHEME_3D_ARGV:
        print(f"error: unknown 3D scheme {args.scheme}; valid: "
              + ", ".join(f"{k}={v.display_name()}"
                          for k, v in sorted(SCHEME_3D_ARGV.items())),
              file=sys.stderr)
        return 2
    device = _device(args.device)
    if device is None:
        return 1
    scheme = SCHEME_3D_ARGV[args.scheme]
    res = args.res
    make_scene = scenes3d.SCENES_3D.get(args.example,
                                        scenes3d.make_vortex_collision)
    extra = {}
    if args.interp_bf16:
        from gpufluidsimulation_tpu_torch.config import EngineMode

        extra["engine_mode"] = EngineMode(interp_bf16=True)
    solver, state = make_scene(scheme=scheme, ni=res, nj=2 * res,
                               nk=2 * res, dt=args.dt, device=device,
                               **extra)
    out_dir = os.path.join(args.out,
                           f"{args.scheme}-{scheme.display_name()}-Gpu")
    os.makedirs(out_dir, exist_ok=True)
    start_frame = 0
    if args.resume:
        state = checkpoint.load_state(args.resume, state)
        start_frame = int(state.frame)
        print(f"resumed from {args.resume} at frame {start_frame}")
    frames = args.frames or scenes3d.TOTAL_FRAMES
    timer = timing.FrameTimer(device)
    failed_before = volume.flush_volumes()
    retried = [False]

    def _step(st):
        if args.no_strict_contract:
            return solver.step(st)
        st, r = solver.step_checked(st)
        retried[0] = r
        return st

    for frame in range(start_frame, frames):
        print(f"Frame {frame} Starts !!!")
        state, _ = timer.time_step(_step, state)
        print(timing.YELLOW + f"[ CFL number is: {float(state.cfl):.4f} ] "
              + timing.RESET + timer.report(frame,
              {"proj_iters": int(state.proj_iters),
               "proj_res": f"{float(state.proj_res):.3e}"}))
        if args.residual_trace:
            # the reference's per-iteration residual scoreboard
            # (BimocqGPUSolver.cpp:447-452)
            hist = state.proj_res_hist.cpu().numpy()
            hist = hist[hist >= 0.0]
            print("Residual: " + "   ".join(f"{r:.3e}" for r in hist))
        if retried[0]:
            print(timing.YELLOW + "[contract] displacement budget tripped "
                  "— frame recomputed on the exact path" + timing.RESET)
        volume.write_volume(frame + 1, out_dir, solver.grid.h, state.rho)
        if args.checkpoint_every and (frame + 1) % args.checkpoint_every == 0:
            checkpoint.save_state(
                os.path.join(out_dir, f"ckpt_{frame:04d}.npz"), state)
    errors = volume.flush_volumes() - failed_before
    if errors:
        print(f"error: {errors} volume files failed to write",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpufluidsimulation_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    p2 = sub.add_parser("sim2d", help="2D solver (bimocq2D parity)")
    p2.add_argument("scheme", type=int,
                    help="0 Semilag | 1 MacCormack | 2 BFECC | 3 Reflection "
                         "| 4 FLIP | 5 APIC | 6 PolyPIC | 7 BiMocq")
    p2.add_argument("example", type=int,
                    help="0 Taylor | 1 Leapfrog | 2 RayleighTaylor | "
                         "3 Zalesak | 4 VortexBox")
    p2.add_argument("--frames", type=int, default=None)
    p2.add_argument("--out", default="Out")
    p2.add_argument("--no-strict-contract", action="store_true",
                    help="step without the contract check (the port's "
                         "kernels gather exactly: the same frames)")
    p2.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    p2.set_defaults(fn=_run_2d)

    p3 = sub.add_parser("sim3d", help="3D solver (bimocq3D parity)")
    p3.add_argument("scheme", type=int,
                    help="0 BiMocq | 1 Semilag | 2 MacCormack | 3 Reflection")
    p3.add_argument("--res", type=int, default=100, help="ni (nj=nk=2*ni)")
    p3.add_argument("--example", type=int, default=0,
                    help="0 vortex collision (main.cpp:27-80) | "
                         "1 plume + moving sphere obstacle")
    p3.add_argument("--resume", default=None,
                    help="checkpoint NPZ to resume from (written by this "
                         "CLI or the JAX package's)")
    p3.add_argument("--dt", type=float, default=0.08)
    p3.add_argument("--frames", type=int, default=None)
    p3.add_argument("--out", default="Out")
    p3.add_argument("--checkpoint-every", type=int, default=0)
    p3.add_argument("--no-strict-contract", action="store_true",
                    help="step without the contract check (the port's "
                         "kernels gather exactly: the same frames)")
    p3.add_argument("--residual-trace", action="store_true",
                    help="print the per-iteration pressure residual trace "
                         "(the reference's scoreboard printout)")
    p3.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    p3.add_argument("--interp-bf16", action="store_true",
                    help="round the field values the samplers read to "
                         "bfloat16 (EngineMode.interp_bf16; the JAX CLI's "
                         "GFS_INTERP_BF16=1)")
    p3.set_defaults(fn=_run_3d)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
