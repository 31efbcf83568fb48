"""The port's ``_step_semilag`` against the JAX solver.

2 steps of the SEMILAG scheme through ``Smoke3D`` at 16^3 from a
numpy-seeded velocity (CFL 1.6-2.7, 2-3 substeps): the moving-obstacle
scene (boundaries, masked MG-PCG) and the open box (MG-PCG,
``spectral_poisson=False``), against the JAX solver under
``EngineMode(fast_interp=True, interp_interpret=True, rbgs=True,
spectral_poisson=False)``: its Pallas kernels in interpret mode (one
~30-45 s compile per scene).

Tolerance: 1e-4 of each field's scale (measured <= 2.8e-5), with the same CG
iteration count every step; inside the 2e-3 fidelity bound.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.scenes import scenes3d as jscenes
from gpufluidsimulation_tpu.solvers import smoke3d as jsmoke
from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.scenes import scenes3d
from gpufluidsimulation_tpu_torch.solvers import smoke3d

DT = 0.5
MODE = config.EngineMode(fast_interp=True, interp_interpret=True, rbgs=True,
                         spectral_poisson=False)


def _smooth(shape, seed, amp):
    """amp * a normalised sum of three random-phase sine modes."""
    rng = np.random.default_rng(seed)
    idx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(3):
        k = rng.uniform(0.5, 2.5, 3) * 2 * np.pi / np.array(shape)
        f += np.sin(sum(kk * ii for kk, ii in zip(k, idx))
                    + rng.uniform(0, 2 * np.pi))
    return (amp * f / np.abs(f).max()).astype(np.float32)


def _velocity(shape_c, amp):
    ni, nj, nk = shape_c
    return (_smooth((ni + 1, nj, nk), 1, amp), _smooth((ni, nj + 1, nk), 2, amp),
            _smooth((ni, nj, nk + 1), 3, amp))


def _flatten(state):
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if val is None:
            continue
        if f.name in ("vel_map", "scalar_map"):
            continue          # the semi-Lagrangian step does not touch maps
        out[f.name] = np.array(val)
    return out


def _seeded(state, n, amp):
    u, v, w = _velocity((n, n, n), amp=amp)
    rho = np.abs(_smooth((n, n, n), 20, 1.0))
    T = np.abs(_smooth((n, n, n), 21, 50.0))
    return state.replace(u=jnp.asarray(u), v=jnp.asarray(v),
                         w=jnp.asarray(w), rho=jnp.asarray(rho),
                         T=jnp.asarray(T))


@pytest.mark.parametrize("scene", ["obstacle", "open_box"])
def test_two_semilag_steps_match_jax(scene):
    """The obstacle scene is buoyant, so it runs at dt = 0.1 from a faster
    seed (CFL 1.6 on both steps): at dt = 0.5 its second step reaches CFL 10.6,
    where the JAX window kernels leave their displacement contract (they
    then differ from JAX's own exact gathers by 0.1 in u, while the port
    stays within 1.3e-6 of the exact gathers)."""
    n = 16
    if scene == "obstacle":
        dt, amp = 0.1, 0.2
        jsolver, jstate = jscenes.make_moving_obstacle(
            scheme=JScheme.SEMILAG, ni=n, nj=n, nk=n, dt=dt,
            proj_max_iters=40, engine_mode=MODE)
        trans = (scenes3d.sweep_trans(0.125 * n * jsolver.cfg.h),)
    else:
        amp = 0.06
        jsolver, jstate = jscenes.make_vortex_collision(
            scheme=JScheme.SEMILAG, ni=n, nj=n, nk=n, dt=DT,
            proj_max_iters=40, engine_mode=MODE,
            emitters=(jsmoke.Emitter3D(center=(0.1, 0.1, 0.1), radius=0.04),))
        trans = ()
    jstate = _seeded(jstate, n, amp)
    states = [_flatten(jstate)]
    for _ in range(2):
        jstate = jsolver.step(jstate)
        states.append(_flatten(jstate))

    cfg = convert.config_from_dict(dataclasses.asdict(jsolver.cfg),
                                   boundary_trans=trans)
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    assert solver.ctx is not None
    st = convert.state_from_numpy(states[0], cfg, "cpu")
    subs = []
    for k in (1, 2):
        st = solver.step(st)
        subs.append(st.substeps)
        got, want = convert.state_to_numpy(st), states[k]
        for key in ("u", "v", "w", "rho", "T"):
            scale = max(float(np.abs(want[key]).max()), 1e-3)
            err = float(np.abs(got[key].astype(np.float64) - want[key]).max())
            assert err <= 1e-4 * scale, (k, key, err, scale)
        assert int(got["proj_iters"]) == int(want["proj_iters"]) > 1
        assert int(got["frame"]) == int(want["frame"]) == k
        np.testing.assert_allclose(got["cfl"], want["cfl"], rtol=1e-6)
        np.testing.assert_allclose(got["proj_res_hist"],
                                   want["proj_res_hist"], rtol=2e-2,
                                   atol=1e-7)
    assert subs[0] == (2 if scene == "obstacle" else 3) and subs[1] >= 2
