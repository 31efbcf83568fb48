"""The port's moving obstacles against the JAX solver.

Boundary state: ``_update_boundary`` (cell flags, staggered solid
velocities, per-kind shell masks) is compared CELL FOR CELL with the JAX
function at frames 0, 1, 30 and 90 of the moving-obstacle scene and for a
constant-velocity sphere and a box. The port computes the pose on the host
in float32 numpy, the JAX step on the device in float32; where the two
``sin`` implementations differ in the last bit, no cell of these grids sits
close enough to the surface to change sides.

The slice as a whole: 3 steps of the packaged moving-obstacle scene at
16x16x16 (dt = 0.02, viscosity on, masked MG-PCG to 1e-4) against the JAX
solver under ``EngineMode(fast_interp=True, interp_interpret=True,
rbgs=True, spectral_poisson=False)``: every Pallas kernel of the step (the
samplers, both map marches, the semi-Lagrangian traces, viscosity, the
masked red-black smoother) in interpret mode; its one-off compile takes
~65 s, once a test session in a child process shared by the workers
(tests/jax_oracle.shared). Bound: 1e-4 of each field's scale, with the same CG iteration count
every step (measured, of each field's scale: u 4.9e-6, v 9.7e-6, w 8.6e-6,
rho and T 8.3e-6, w_init 1.7e-5, the maps 0), far inside the 2e-3 fidelity
bound of tests/test_fidelity3d.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.scenes import scenes3d as jscenes
from gpufluidsimulation_tpu.solvers import smoke3d as jsmoke
from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.ops import poisson, stencil_kernels
from gpufluidsimulation_tpu_torch.scenes import scenes3d
from gpufluidsimulation_tpu_torch.solvers import smoke3d
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from tests import jax_oracle
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

MODE = config.EngineMode(fast_interp=True, interp_interpret=True, rbgs=True,
                         spectral_poisson=False)
FIELDS = ("u", "v", "w", "rho", "T", "u_init", "v_init", "w_init",
          "rho_init", "T_init", "vel_map.fwd", "vel_map.bwd")


def _flatten(state):
    """JAX state -> flat numpy dict (the port never sees JAX objects)."""
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


def _jax_boundary_state(jcfg, frame):
    flags, us, vs, ws, shells = jsmoke._update_boundary(
        jcfg, jcfg.grid, jnp.int32(frame), jcfg.dt)
    return (np.asarray(flags), np.asarray(us), np.asarray(vs),
            np.asarray(ws), {k: np.asarray(m) for k, m in shells.items()})


def _port_boundary_state(cfg, frame):
    base = smoke3d.boundary_base_flags(cfg.grid, "cpu")
    flags, us, vs, ws, shells = smoke3d._update_boundary(
        cfg, cfg.grid, frame, cfg.dt, base)
    assert flags.dtype == torch.uint8
    return (flags.numpy(), us.numpy(), vs.numpy(), ws.numpy(),
            {k: m.numpy() for k, m in shells.items()})


def _assert_same_boundary(jcfg, cfg, frame):
    want = _jax_boundary_state(jcfg, frame)
    got = _port_boundary_state(cfg, frame)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(a, b)
    for kind in ("c", "u", "v", "w"):
        np.testing.assert_array_equal(got[4][kind], want[4][kind])
    return got


@pytest.mark.parametrize("frame", [0, 1, 30, 90])
@pytest.mark.parametrize("dims", [(16, 32, 32), (16, 16, 16)])
def test_obstacle_scene_boundary_cell_for_cell(dims, frame):
    ni, nj, nk = dims
    jcfg = jscenes.moving_obstacle_config(ni=ni, nj=nj, nk=nk)
    cfg = scenes3d.moving_obstacle_config(ni=ni, nj=nj, nk=nk)
    flags, _, _, ws, shells = _assert_same_boundary(jcfg, cfg, frame)
    assert (flags == poisson.OBJECT).sum() > 20
    assert shells["u"].sum() > 20
    # the sphere sweeps in z: its rigid velocity is on the w faces only,
    # the one-frame finite difference of the float32 offsets
    jpos, jvel = jcfg.boundaries[0].pose_at(jnp.int32(frame), jcfg.dt)
    pos, vel = cfg.boundaries[0].pose_at(frame, cfg.dt)
    np.testing.assert_allclose(np.float32(pos[2]), np.float32(jpos[2]),
                               rtol=2e-7)
    np.testing.assert_allclose(np.float32(vel[2]), np.float32(jvel[2]),
                               rtol=1e-4, atol=1e-7)
    assert np.abs(ws).max() == np.abs(np.float32(vel[2]))


@pytest.mark.parametrize("frame", [0, 3, 17])
@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_constant_velocity_boundary_cell_for_cell(kind, frame):
    kw = dict(center=(0.09, 0.1, 0.11), radius=0.03,
              velocity=(0.05, -0.02, 0.03), half_width=2.0, kind=kind,
              half_extents=(0.03, 0.02, 0.04))
    base = dict(ni=16, nj=20, nk=24, L=0.2, dt=0.02)
    jcfg = jsmoke.Smoke3DConfig(boundaries=(jsmoke.Boundary3D(**kw),), **base)
    cfg = smoke3d.Smoke3DConfig(boundaries=(smoke3d.Boundary3D(**kw),),
                                **base)
    _, us, vs, ws, _ = _assert_same_boundary(jcfg, cfg, frame)
    assert {float(np.abs(a).max()) for a in (us, vs, ws)} == {
        float(np.float32(0.05)), float(np.float32(0.02)),
        float(np.float32(0.03))}


def test_blend_and_clear_boundary():
    cfg = scenes3d.moving_obstacle_config(ni=16, nj=16, nk=16)
    bnd = smoke3d._update_boundary(
        cfg, cfg.grid, 0, cfg.dt, smoke3d.boundary_base_flags(cfg.grid))
    ones = torch.ones(cfg.grid.shape_c)
    cleared = smoke3d._clear_boundary(bnd, ones)
    assert torch.equal(cleared == 0.0, bnd[0] == poisson.OBJECT)
    blended = smoke3d._blend_boundary(bnd, "c", ones, 2.0 * ones)
    assert torch.equal(blended == 2.0, bnd[4]["c"])
    assert smoke3d._blend_boundary(None, "c", ones, 2 * ones) is ones
    assert smoke3d._clear_boundary(None, ones) is ones


def _jax_obstacle():
    return jscenes.make_moving_obstacle(
        ni=16, nj=16, nk=16, dt=0.02, proj_max_iters=40, engine_mode=MODE)


def _jax_run(name):
    """The JAX obstacle scene's states after each of 3 steps (one ~65 s
    interpret-mode compile), flat: key "k:field" after k steps."""
    solver, state = _jax_obstacle()
    states = [_flatten(state)]
    for _ in range(3):
        state = solver.step(state)
        states.append(_flatten(state))
    return {f"{k}:{key}": val for k, st in enumerate(states)
            for key, val in st.items()}


@pytest.fixture(scope="module")
def jax_obstacle_run(tmp_path_factory):
    """The JAX obstacle scene's configuration and its states after each
    of 3 steps."""
    flat = jax_oracle.shared(tmp_path_factory, __file__, "obstacle")[
        "obstacle"]
    states = [{} for _ in range(4)]
    for key, val in flat.items():
        k, field = key.split(":", 1)
        states[int(k)][field] = val
    return _jax_obstacle()[0].cfg, states


def test_three_obstacle_steps_match_jax(jax_obstacle_run):
    jcfg, states = jax_obstacle_run
    assert jcfg.scheme == JScheme.BIMOCQ and jcfg.viscosity > 0
    lz = jcfg.nk * jcfg.h
    cfg = convert.config_from_dict(
        dataclasses.asdict(jcfg),
        boundary_trans=(scenes3d.sweep_trans(0.125 * lz),))
    assert cfg == dataclasses.replace(
        scenes3d.moving_obstacle_config(ni=16, nj=16, nk=16, dt=0.02,
                                        proj_max_iters=40),
        engine_mode=cfg.engine_mode)
    assert cfg.engine_mode.spectral_poisson is False
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    st = convert.state_from_numpy(states[0], cfg, "cpu")
    for k in range(1, 4):
        st = solver.step(st)
        got, want = convert.state_to_numpy(st), states[k]
        assert int(want["interp_overflow"]) == 0
        for key in FIELDS:
            scale = max(float(np.abs(want[key]).max()), 1e-3)
            err = float(np.abs(got[key].astype(np.float64) - want[key]).max())
            assert err <= 1e-4 * scale, (k, key, err, scale)
        assert int(got["proj_iters"]) == int(want["proj_iters"]) > 1, k
        assert int(got["frame"]) == int(want["frame"]) == k
        np.testing.assert_allclose(got["proj_res_hist"],
                                   want["proj_res_hist"], rtol=2e-2,
                                   atol=1e-7)
        np.testing.assert_allclose(got["cfl"], want["cfl"], rtol=1e-6)
    inside = _port_boundary_state(cfg, 2)[0] == poisson.OBJECT
    assert float(np.abs(got["rho"][inside]).max()) == 0.0
    assert float(got["rho"].max()) > 0.5
    assert stencil_kernels.masked_rbgs_smooth.launches == 0


def test_obstacle_config_across_and_refusals():
    jcfg = _jax_obstacle()[0].cfg
    d = dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="trans"):
        convert.config_from_dict(d)         # the JAX closure is not carried
    static = dataclasses.asdict(dataclasses.replace(
        jcfg, boundaries=(jsmoke.Boundary3D(center=(0.1, 0.1, 0.1),
                                            kind="box",
                                            half_extents=(0.02, 0.03, 0.04)),)))
    bd = convert.config_from_dict(static).boundaries[0]
    assert (bd.kind, bd.half_extents, bd.trans) == ("box", (0.02, 0.03, 0.04),
                                                    None)
    voxel = dict(static, boundaries=(dict(center=(0.1, 0.1, 0.1),
                                          kind="voxel",
                                          sdf_grid=np.zeros((4, 4, 4))),))
    vbd = convert.config_from_dict(voxel).boundaries[0]
    assert vbd.kind == "voxel" and vbd.is_voxel
    assert vbd.sdf_grid.dtype == np.float32 and vbd.sdf_grid.shape == (4,) * 3
    # the Jacobi-smoothed V-cycle and the bf16 windows are carried across
    # (the vol9, sharded and 2D refusals of the bf16 mode:
    # tests/test_torch_bf16.py)
    mode = dict(d["engine_mode"], rbgs=False)
    assert convert.config_from_dict(dict(
        static, engine_mode=mode)).engine_mode.rbgs is False
    mode = dict(d["engine_mode"], interp_bf16=True)
    assert convert.config_from_dict(dict(
        static, engine_mode=mode)).engine_mode.interp_bf16 is True
    # the prefilter and vol9 volume forms are carried across
    for field, value, form in (("volume_dual", False, "prefilter"),
                               ("volume_vol9", True, "vol9")):
        mode = dict(d["engine_mode"], **{field: value})
        em = convert.config_from_dict(dict(static, engine_mode=mode)).engine_mode
        assert getattr(em, field) is value and em.volume_mode == form
    # the exact volume form is carried across; an emitter that is not an
    # Emitter3D is refused
    exact = convert.config_from_dict(dict(static, engine_mode=dict(
        d["engine_mode"], volume_exact=True)))
    assert exact.engine_mode.volume_exact is True
    with pytest.raises(NotImplementedError):
        smoke3d.Smoke3D(dataclasses.replace(
            scenes3d.moving_obstacle_config(ni=16, nj=16, nk=16),
            scheme=Scheme.MACCORMACK, emitters=(object(),)), device="cpu")


def test_scene_table_and_mgpcg_ownership():
    assert set(scenes3d.SCENES_3D) == {0, 1}
    solver, state = scenes3d.SCENES_3D[1](ni=8, nj=8, nk=8, device="cpu")
    assert solver.ctx is not None and solver.cfg.boundaries
    assert state.frame == 0
    solver, _ = scenes3d.make_vortex_collision(
        scheme=Scheme.BIMOCQ, ni=8, nj=8, nk=8, device="cpu")
    assert solver.ctx is None       # open box: spectral by default
    from gpufluidsimulation_tpu_torch.config import EngineMode
    solver, _ = scenes3d.make_vortex_collision(
        scheme=Scheme.BIMOCQ, ni=8, nj=8, nk=8, device="cpu",
        engine_mode=EngineMode(spectral_poisson=False))
    assert solver.ctx is not None and solver.ctx.bc == "dirichlet"


jax_oracle.prefetch(__file__, "obstacle")


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
