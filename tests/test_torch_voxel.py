"""Voxel level-set boundaries and emitters, emitter motion and emission
velocity, against the JAX package.

The scene, at 16^3 (h = 0.0125, dt = 0.02, BiMocq, viscosity on, masked
MG-PCG): the mesh obstacle of tests/test_mesh_boundary.py (an octasphere
of radius 0.03 turned into a 10^3 level set by ``mesh_to_sdf``, moving
0.0005 a frame in y) and its moving voxel emitter (an 8^3 sphere level
set of radius 0.03 moving 0.002 a frame in x, emitting rho, T and the
velocity (0.05, 0, 0) of its ``emit_velocity``), in one box. The JAX step
runs under ``EngineMode(fast_interp=False)``, the JAX package's CPU
default: the exact volume form and, with no ``rbgs`` given, the
Jacobi-smoothed V-cycle, which ``convert`` carries across as the port's
``volume_exact=True, rbgs=False``. It runs op by op (``jax.disable_jit``:
jitted, its exact DMC substep jumps a cell at lattice-aligned upwind
samples, ROADMAP §3 item 3(c)) in one child process shared by the
workers (tests/jax_oracle.shared). Bound: 1e-4 of each field's scale
over 3 steps, with the same CG iteration count every step. A node whose
level-set value sits within round-off of 0 (or of the shell's edge) can
take the other flag in the other package, so the test asserts that none
lies within 1e-5 h of either, at every frame the steps use.

Stage by stage, with no JAX step (the references from a second shared
child): the boundary state (flags, solid velocities, shells) cell for
cell, the voxel emission and the analytic emitter moved by ``trans``,
and the configuration across ``convert``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config as jconfig
from gpufluidsimulation_tpu.solvers import smoke3d as jsmoke
from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.io_utils import mesh
from gpufluidsimulation_tpu_torch.solvers import smoke3d
from tests import jax_oracle
from tests.test_torch_io import _octasphere

N = 16
H = 0.2 / N
STEPS = 3
JMODE = jconfig.EngineMode(fast_interp=False)
FIELDS = ("u", "v", "w", "rho", "T", "u_init", "v_init", "w_init",
          "rho_init", "T_init", "vel_map.fwd", "vel_map.bwd")
F32 = np.float32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The whole-step references (~80 s of JAX op by op): one test."""
    return jax_oracle.shared(tmp_path_factory, __file__, "voxel_scene")


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """The stage references, from a child of their own, so that the stage
    tests do not wait for the whole steps."""
    return jax_oracle.shared(tmp_path_factory, __file__,
                             "voxel_stages")["voxel_stages"]


def _obstacle_sdf():
    v, f = _octasphere(0.03, sub=2)
    m = 10
    csd = (m - 1) * H / 2
    return mesh.mesh_to_sdf(v + csd, f, (m, m, m), H)


def _emitter_sdf():
    m = 8
    x = np.arange(m) * H
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    c = (m - 1) * H / 2
    return (np.sqrt((X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2)
            - 0.03).astype(np.float32)


# trans and emit_velocity, once for each package (float32 arithmetic)
def _jax_obstacle_trans(fr):
    return (0.0, 0.0005 * fr, 0.0)


def _port_obstacle_trans(fr):
    return (0.0, F32(0.0005) * fr, 0.0)


def _jax_emitter_trans(fr):
    return (0.002 * fr, 0.0, 0.0)


def _port_emitter_trans(fr):
    return (F32(0.002) * fr, 0.0, 0.0)


def _jax_emit_velocity(X, Y, Z):
    return (0.05 * jnp.ones_like(X), jnp.zeros_like(Y), jnp.zeros_like(Z))


def _port_emit_velocity(X, Y, Z):
    return (0.05 * torch.ones_like(X), torch.zeros_like(Y),
            torch.zeros_like(Z))


def _jax_cfg():
    return jsmoke.Smoke3DConfig(
        ni=N, nj=N, nk=N, L=0.2, dt=0.02, scheme=JScheme.BIMOCQ,
        viscosity=1e-6, proj_tol=1e-4, proj_max_iters=60,
        emitters=(jsmoke.Emitter3D(
            center=(0.02, 0.06, 0.06),
            sdf_grid=_emitter_sdf(),
            emit_velocity=_jax_emit_velocity, trans=_jax_emitter_trans),),
        boundaries=(jsmoke.Boundary3D(
            center=(0.10, 0.06, 0.06), kind="voxel",
            sdf_grid=_obstacle_sdf(),
            trans=_jax_obstacle_trans),),
        engine_mode=JMODE)


def _port_cfg(jcfg):
    return convert.config_from_dict(
        dataclasses.asdict(jcfg), boundary_trans=(_port_obstacle_trans,),
        emitter_trans=(_port_emitter_trans,),
        emitter_emit_velocity=(_port_emit_velocity,))


def _flatten(state):
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if val is None:
            continue
        if f.name in ("vel_map", "scalar_map"):
            for g in dataclasses.fields(val):
                x = getattr(val, g.name)
                if x is not None:
                    out[f"{f.name}.{g.name}"] = np.array(x)
        else:
            out[f.name] = np.array(val)
    return out


BOUNDARY_FRAMES = (0, 1, 7)
EMISSIONS = [(kind, frame) for kind in ("voxel", "analytic")
             for frame in (0, 2)]


def _emission_case(kind, frame):
    """The JAX config and seeded (u, v, w, rho, T) of one emission case:
    the scene's voxel emitter, or an analytic sphere moved by trans."""
    jcfg = _jax_cfg()
    if kind == "analytic":
        jcfg = dataclasses.replace(jcfg, emitters=(jsmoke.Emitter3D(
            center=(0.07, 0.1, 0.11), radius=0.03, sign=-1.0,
            trans=_jax_emitter_trans),))
    rng = np.random.default_rng(frame)
    g = jcfg.grid
    fields = [rng.standard_normal(getattr(g, f"shape_{k}")).astype(
        np.float32) for k in ("u", "v", "w", "c", "c")]
    return jcfg, fields


def _jax_run(name):
    """voxel_scene: the JAX states before and after each of the 3 steps,
    op by op; voxel_stages: the boundary states and emissions."""
    if name == "voxel_stages":
        return _jax_stages()
    assert name == "voxel_scene"
    jcfg = _jax_cfg()
    solver = jsmoke.Smoke3D(jcfg)
    state = solver.init_state()
    out = {f"0#{k}": v for k, v in _flatten(state).items()}
    with jconfig.engine_mode_scope(JMODE), jax.disable_jit():
        for k in range(1, STEPS + 1):
            state = jsmoke._step_bimocq(jcfg, jcfg.grid, solver.ctx, state)
            out.update({f"{k}#{key}": v
                        for key, v in _flatten(state).items()})
    return out


def _jax_stages():
    jcfg = _jax_cfg()
    out = {}
    for frame in BOUNDARY_FRAMES:
        flags, us, vs, ws, shells = jsmoke._update_boundary(
            jcfg, jcfg.grid, jnp.int32(frame), jcfg.dt)
        for key, val in (("flags", flags), ("u", us), ("v", vs),
                         ("w", ws)):
            out[f"boundary{frame}#{key}"] = np.asarray(val)
        for kind, mask in shells.items():
            out[f"boundary{frame}#shell_{kind}"] = np.asarray(mask)
    for kind, frame in EMISSIONS:
        jcfg, fields = _emission_case(kind, frame)
        got = jsmoke._emit_smoke(jcfg, jcfg.grid,
                                 *(jnp.asarray(f) for f in fields),
                                 jnp.int32(frame), jcfg.dt)
        for i, val in enumerate(got):
            out[f"emit_{kind}{frame}#{i}"] = np.asarray(val)
    return out


def _states(run):
    states = [{} for _ in range(STEPS + 1)]
    for key, val in run.items():
        k, name = key.split("#", 1)
        states[int(k)][name] = val
    return states


def test_scene_keeps_clear_of_flag_flips():
    """No node's level-set value lies within 1e-5 h of 0 (the flags) or
    of the shell's edge, at any frame of the steps."""
    cfg = _port_cfg(_jax_cfg())
    bd, em = cfg.boundaries[0], cfg.emitters[0]
    g = cfg.grid
    closest = []
    for frame in range(STEPS):
        pos, _ = bd.pose_at(frame, cfg.dt)
        epos = em.position_at(frame)
        for kind in ("c", "u", "v", "w"):
            ax = g.axis_coords(kind)
            sd = bd.sdf(*ax, pos, g.h)
            esd = smoke3d.sample3_separable(
                torch.from_numpy(em.sdf_grid),
                *(a - float(p) for a, p in zip(ax, epos)), g.h)
            closest += [float(sd.abs().min()),
                        float((sd - bd.half_width * g.h).abs().min()),
                        float(esd.abs().min())]
            assert (sd <= 0).any() and (esd <= 0).any()
    assert min(closest) > 1e-5 * H, min(closest)


def test_voxel_scene_steps_match_jax(oracle):
    states = _states(oracle["voxel_scene"])
    cfg = _port_cfg(_jax_cfg())
    assert cfg.engine_mode.volume_exact and cfg.engine_mode.rbgs is False
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    assert solver.ctx is not None and solver.ctx.rbgs is False
    st = convert.state_from_numpy(states[0], cfg, "cpu")
    for k in range(1, STEPS + 1):
        st = solver.step(st)
        got, want = convert.state_to_numpy(st), states[k]
        for key in FIELDS:
            scale = max(float(np.abs(want[key]).max()), 1e-3)
            err = float(np.abs(got[key].astype(np.float64) - want[key]).max())
            assert err <= 1e-4 * scale, (k, key, err, scale)
        assert int(got["proj_iters"]) == int(want["proj_iters"]) > 1, k
        assert int(got["frame"]) == int(want["frame"]) == k
    # the emitter moved and emitted its velocity; the obstacle holds no
    # smoke
    assert float(np.abs(got["u"]).max()) > 0.04 and got["rho"].max() > 0.5
    flags = smoke3d._update_boundary(cfg, cfg.grid, STEPS - 1, cfg.dt,
                                     smoke3d.boundary_base_flags(cfg.grid))[0]
    inside = (flags == 3).numpy()
    assert inside.sum() > 20 and float(np.abs(got["rho"][inside]).max()) == 0


@pytest.mark.parametrize("frame", BOUNDARY_FRAMES)
def test_voxel_boundary_cell_for_cell(stages, frame):
    cfg = _port_cfg(_jax_cfg())
    want = {key.split("#")[1]: val
            for key, val in stages.items()
            if key.startswith(f"boundary{frame}#")}
    got = smoke3d._update_boundary(cfg, cfg.grid, frame, cfg.dt,
                                   smoke3d.boundary_base_flags(cfg.grid))
    np.testing.assert_array_equal(got[0].numpy(), want["flags"])
    for a, key in zip(got[1:4], "uvw"):
        np.testing.assert_array_equal(a.numpy(), want[key])
    for kind in ("c", "u", "v", "w"):
        np.testing.assert_array_equal(got[4][kind].numpy(),
                                      want[f"shell_{kind}"])
    assert float(got[2].abs().max()) > 0.02     # the y motion, v faces
    assert int((got[0] == 3).sum()) > 20


@pytest.mark.parametrize("kind,frame", EMISSIONS)
def test_emission_matches_jax(stages, kind, frame):
    """``_emit_smoke`` of the moving voxel emitter, and of an analytic
    sphere emitter moved by ``trans``, on seeded fields."""
    jcfg, fields = _emission_case(kind, frame)
    cfg = _port_cfg(jcfg)
    got = smoke3d._emit_smoke(cfg, cfg.grid, *(torch.from_numpy(f)
                                               for f in fields), frame)
    changed = 0
    for i, (a, f) in enumerate(zip(got, fields)):
        want = stages[f"emit_{kind}{frame}#{i}"]
        np.testing.assert_allclose(a.numpy(), want, rtol=2e-7, atol=0)
        changed += int((a.numpy() != f).sum())
    assert changed > 40


def test_voxel_config_across():
    jcfg = _jax_cfg()
    d = dataclasses.asdict(jcfg)
    for what in ("emitter_trans", "emitter_emit_velocity",
                 "boundary_trans"):
        kw = dict(boundary_trans=(_port_obstacle_trans,),
                  emitter_trans=(_port_emitter_trans,),
                  emitter_emit_velocity=(_port_emit_velocity,))
        kw.pop(what)
        with pytest.raises(ValueError, match=what):
            convert.config_from_dict(d, **kw)
    cfg = _port_cfg(jcfg)
    bd, em = cfg.boundaries[0], cfg.emitters[0]
    assert bd.kind == "voxel" and bd.is_voxel
    assert bd.sdf_grid.dtype == np.float32 and bd.sdf_grid.shape == (10,) * 3
    np.testing.assert_array_equal(em.sdf_grid, _emitter_sdf())
    assert em.trans is _port_emitter_trans
    assert em.emit_velocity is _port_emit_velocity
    assert em.position_at(3) == (F32(F32(0.02) + F32(F32(0.002) * F32(3))),
                                 F32(0.06), F32(0.06))


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
