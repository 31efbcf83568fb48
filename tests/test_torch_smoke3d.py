"""The port's 3D BiMocq step against the JAX solver's production numerics.

Three ``_step_bimocq`` steps at 16^3 (the vortex-collision physics with
one emitter scaled into the box) from one numpy state carried across by
``convert.state_from_numpy``. The JAX solver runs under
``EngineMode(fast_interp=True, interp_interpret=True,
spectral_poisson=True)``: its Pallas kernels in interpret mode, the dual
volume form and the spectral projection — the accelerator defaults. The
steps take 1, 2 and 3 CFL substeps, so both marches' kernels and the
identity peels all run.

Tolerance: float32 round-off through three steps of gathers and dense
transforms, measured at ~1e-5 of each field's scale (rho 8.5e-6, T 4.2e-4
of 50, u 3.6e-7 of 0.06); the bound is 1e-4 of the field's scale, far
inside the 2e-3 fidelity bound of tests/test_fidelity3d.py.

The JAX steps run once a test session, in a child process shared by the
workers (tests/jax_oracle.shared); the tests that need only the JAX
configuration build it here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.scenes.scenes3d import (
    vortex_collision_config as jax_vortex_config)
from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
from gpufluidsimulation_tpu.solvers.smoke3d import Emitter3D as JEmitter3D
from gpufluidsimulation_tpu.solvers.smoke3d import Smoke3D as JSmoke3D
from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.ops import interp_fast, stencil_kernels
from gpufluidsimulation_tpu_torch.solvers import smoke3d
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from tests import jax_oracle
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

N = 16
STEPS = 3
FIELDS = ("u", "v", "w", "rho", "T", "u_init", "v_init", "w_init",
          "rho_init", "T_init", "vel_map.fwd", "vel_map.bwd")


def _jax_cfg():
    return jax_vortex_config(
        ni=N, nj=N, nk=N, scheme=JScheme.BIMOCQ, dt=8.0 / N,
        emitters=(JEmitter3D(center=(0.1, 0.1, 0.1), radius=0.04,
                             sign=1.0),),
        proj_tol=1e-4, proj_max_iters=30,
        engine_mode=config.EngineMode(fast_interp=True,
                                      interp_interpret=True,
                                      spectral_poisson=True))


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


def _jax_run(name):
    """The JAX solver's states (one ~60 s interpret-mode compile), flat:
    key "k:field" for the state after k steps."""
    solver = JSmoke3D(_jax_cfg())
    state = solver.init_state()
    states = [_flatten(state)]
    for _ in range(STEPS):
        state = solver.step(state)     # donates its input: fresh each step
        states.append(_flatten(state))
    return {f"{k}:{key}": val for k, st in enumerate(states)
            for key, val in st.items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX configuration and its states after 0 .. STEPS steps."""
    flat = jax_oracle.shared(tmp_path_factory, __file__, "steps")["steps"]
    states = [{} for _ in range(STEPS + 1)]
    for key, val in flat.items():
        k, field = key.split(":", 1)
        states[int(k)][field] = val
    return _jax_cfg(), states


def _port_cfg(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


def test_three_steps_match_jax(jax_run):
    jcfg, states = jax_run
    for s in states[1:]:
        assert int(s["interp_overflow"]) == 0   # the JAX windows were exact
    assert float(states[-1]["rho"].max()) > 0
    cfg = _port_cfg(jcfg)
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    st = convert.state_from_numpy(states[0], cfg, "cpu")
    counts = (interp_fast.trilerp_sample.launches,
              stencil_kernels.jacobi_diffuse.launches)
    subs = []
    for k in range(1, STEPS + 1):
        st = solver.step(st)
        subs.append(st.substeps)
        got, want = convert.state_to_numpy(st), states[k]
        for key in FIELDS:
            scale = max(float(np.abs(want[key]).max()), 1e-3)
            err = float(np.abs(got[key].astype(np.float64) - want[key]).max())
            assert err <= 1e-4 * scale, (k, key, err, scale)
        for key in ("frame", "vel_last_reinit", "scalar_last_reinit",
                    "proj_iters", "vel_map.reinit_count",
                    "scalar_map.reinit_count", "interp_overflow"):
            assert int(got[key]) == int(want[key]), (k, key)
        np.testing.assert_allclose(got["cfl"], want["cfl"], rtol=1e-6)
        assert abs(float(got["proj_res"]) - float(want["proj_res"])) < 1e-6
    assert subs == [1, 2, 3]
    assert (interp_fast.trilerp_sample.launches,
            stencil_kernels.jacobi_diffuse.launches) == counts == (0, 0)


def test_state_round_trip_and_dieted_leaves(jax_run):
    jcfg, states = jax_run
    cfg = _port_cfg(jcfg)
    st = convert.state_from_numpy(states[2], cfg, "cpu")
    assert st.u_prev is None and st.rho_prev is None
    assert st.vel_map.bwd_prev is None and st.scalar_map.fwd is None
    back = convert.state_to_numpy(st)
    for key, val in states[2].items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)


def test_config_from_dict_matches_jax_fields():
    jcfg = _jax_cfg()
    cfg = _port_cfg(jcfg)
    assert cfg.scheme == Scheme.BIMOCQ
    assert (cfg.ni, cfg.nj, cfg.nk, cfg.L, cfg.dt) == (
        jcfg.ni, jcfg.nj, jcfg.nk, jcfg.L, jcfg.dt)
    assert cfg.h == jcfg.h
    em = cfg.emitters[0]
    assert (em.center, em.radius, em.sign) == ((0.1, 0.1, 0.1), 0.04, 1.0)


def test_default_device_raises_without_cuda(monkeypatch):
    """Smoke3D(cfg) with no device is the card; without one it raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg(_jax_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smoke3d.Smoke3D(cfg)
    with pytest.raises(RuntimeError):
        smoke3d.Smoke3D(cfg, device="cuda")


@pytest.mark.parametrize("change", [
    dict(emitters=(object(),)),
    dict(engine_mode=config.EngineMode(volume_vol9=True)),
    dict(reinit_mode="sometimes"),
    dict(boundaries=(smoke3d.Boundary3D(center=(0.1, 0.1, 0.1),
                                        kind="cylinder"),)),
    dict(boundaries=(object(),)), dict(bc="periodic"),
    dict(boundaries=(smoke3d.Boundary3D(center=(0.1, 0.1, 0.1),
                                        kind="voxel"),)),
    dict(engine_mode=config.EngineMode(spectral_poisson=False)),
])
def test_unported_configs_raise(change):
    """What the port does not run raises: emitters and boundaries that
    are not its own classes, the JAX package's own mode objects (vol9
    among them), unknown boundary kinds, a voxel boundary without its
    level set, other bcs and reinit modes. MACCORMACK, MAC_REFLECTION,
    counter/adaptive reinit and blends below 1 run since the third slice
    (tests/test_torch_maccormack_step.py, test_torch_bimocq_full.py),
    voxel level sets since the twelfth (tests/test_torch_voxel.py)."""
    cfg = dataclasses.replace(_port_cfg(_jax_cfg()), **change)
    with pytest.raises(NotImplementedError):
        smoke3d.Smoke3D(cfg, device="cpu")


@pytest.mark.parametrize("change", [
    dict(boundaries=(smoke3d.Boundary3D(center=(0.1, 0.1, 0.1),
                                        sdf_grid=np.zeros((4, 4, 4))),)),
])
def test_configs_that_now_run(change):
    """Configurations the port refused before and runs now: a voxel level
    set given as ``sdf_grid`` on a boundary of the default kind (here a
    zero level set, inside everywhere, so every cell is the object's)."""
    cfg = dataclasses.replace(_port_cfg(_jax_cfg()), **change)
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    st = solver.step(solver.init_state())
    assert st.frame == 1 and bool(torch.isfinite(st.u).all())
    flags = smoke3d._update_boundary(cfg, cfg.grid, 0, cfg.dt,
                                     smoke3d.boundary_base_flags(cfg.grid))[0]
    assert bool((flags == 3).all())


jax_oracle.prefetch(__file__, "steps")


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
