"""The port's MACCORMACK and MAC_REFLECTION steps against the JAX solver.

Whole steps through ``Smoke3D`` at 16^3 from one numpy-seeded state,
against the JAX solver on its exact path (``EngineMode(fast_interp=False,
rbgs=True)``): exact gathers, whose MacCormack trace clamp is the
8-corner min/max of ``minmax_sample``. Each JAX solver runs in a child
process with a single-threaded XLA (tests/jax_oracle.py) and feeds
exactly one test function, which holds every step of its run.

* MACCORMACK, vortex scene, spectral projection, 3 steps;
* MAC_REFLECTION (the vortex scene's own default scheme), vortex scene,
  spectral projection, 3 steps (two projections per step);
* MAC_REFLECTION, moving-obstacle scene (boundaries, masked MG-PCG with
  the red-black smoother in interpret mode), 2 steps.

Tolerance: 1e-4 of each field's scale with equal frame and ``proj_iters``,
inside the 2e-3 fidelity bound of tests/test_fidelity3d.py.
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
from gpufluidsimulation_tpu_torch.ops import interp_fast
from gpufluidsimulation_tpu_torch.scenes import scenes3d
from gpufluidsimulation_tpu_torch.solvers import smoke3d
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from tests import jax_oracle

N = 16
FIELDS = ("u", "v", "w", "rho", "T")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU work in these tests is small tensors, and under the
    tier-1 suite's six workers torch's intra-op pool spends more CPU
    waiting for its threads than computing: one thread for each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _seeded(state, amp):
    """The JAX initial state with a seeded velocity and smoke blob."""
    rho = np.abs(_smooth((N, N, N), 20, 1.0))
    rho[5:10, 6:11, 4:12] = 1.0                  # a sharp edge to clamp
    return state.replace(
        u=jnp.asarray(_smooth((N + 1, N, N), 1, amp)),
        v=jnp.asarray(_smooth((N, N + 1, N), 2, amp)),
        w=jnp.asarray(_smooth((N, N, N + 1), 3, amp)),
        rho=jnp.asarray(rho), T=jnp.asarray(50.0 * rho))


def _flatten(state):
    return {f.name: np.array(getattr(state, f.name))
            for f in dataclasses.fields(state)
            if f.name not in ("vel_map", "scalar_map")}


def _vortex(scheme):
    return jscenes.make_vortex_collision(
        scheme=scheme, ni=N, nj=N, nk=N, dt=0.5, proj_max_iters=30,
        emitters=(jsmoke.Emitter3D(center=(0.1, 0.1, 0.1), radius=0.04),),
        engine_mode=config.EngineMode(fast_interp=False, rbgs=True,
                                      spectral_poisson=True))


def _obstacle():
    return jscenes.make_moving_obstacle(
        scheme=JScheme.MAC_REFLECTION, ni=N, nj=N, nk=N, dt=0.1,
        proj_max_iters=40,
        engine_mode=config.EngineMode(fast_interp=False, rbgs=True,
                                      interp_interpret=True,
                                      spectral_poisson=False))


# run name: (JAX solver and initial state, seed amplitude, steps)
RUNS = {
    "maccormack_vortex": (lambda: _vortex(JScheme.MACCORMACK), 0.06, 3),
    "reflection_vortex": (lambda: _vortex(JScheme.MAC_REFLECTION), 0.06, 3),
    "reflection_obstacle": (_obstacle, 0.2, 2),
}
for _name in RUNS:
    jax_oracle.prefetch(__file__, _name)


def _jax_run(name):
    """The JAX solver's flat states after each step of run `name`."""
    make, amp, steps = RUNS[name]
    jsolver, jstate = make()
    jstate = _seeded(jstate, amp)
    out = {}
    for k in range(steps + 1):
        if k:
            jstate = jsolver.step(jstate)      # donates its input
        out.update({f"{k}#{key}": val
                    for key, val in _flatten(jstate).items()})
    return out


def _run_both(tmp_path_factory, name, trans=()):
    """The JAX run `name` (in a child process, tests/jax_oracle.py) and
    the port on the CPU from the same state; returns the port's config,
    the pairs of flat states after each step and the port's substep
    counts."""
    make, _, steps = RUNS[name]
    run = jax_oracle.shared(tmp_path_factory, __file__, name)[name]
    want = [{key.split("#", 1)[1]: val for key, val in run.items()
             if key.split("#", 1)[0] == str(k)} for k in range(steps + 1)]
    cfg = convert.config_from_dict(dataclasses.asdict(make()[0].cfg),
                                   boundary_trans=trans)
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    st = convert.state_from_numpy(want[0], cfg, "cpu")
    pairs, subs = [], []
    for k in range(1, steps + 1):
        st = solver.step(st)
        subs.append(st.substeps)
        pairs.append((convert.state_to_numpy(st), want[k]))
    return cfg, pairs, subs


def _assert_steps_match(pairs, rel=1e-4):
    for k, (got, want) in enumerate(pairs, 1):
        for key in FIELDS:
            scale = max(float(np.abs(want[key]).max()), 1e-3)
            err = float(np.abs(got[key].astype(np.float64) - want[key]).max())
            assert err <= rel * scale, (k, key, err, scale)
        assert int(got["frame"]) == int(want["frame"]) == k
        assert int(got["proj_iters"]) == int(want["proj_iters"]), k
        np.testing.assert_allclose(got["cfl"], want["cfl"], rtol=1e-6)
        assert np.isfinite(got["proj_res"]) and got["proj_res"] <= 1e-4


def test_maccormack_vortex_steps_match_jax(tmp_path_factory):
    launches = interp_fast.minmax_sample.launches
    cfg, pairs, subs = _run_both(tmp_path_factory, "maccormack_vortex")
    assert cfg.scheme == Scheme.MACCORMACK and cfg.engine_mode.volume_exact
    _assert_steps_match(pairs)
    assert subs[0] == 3                     # CFL ~2.4 at the seed
    assert interp_fast.minmax_sample.launches == launches
    assert float(pairs[-1][0]["rho"].max()) > 0.5


def test_reflection_vortex_steps_match_jax(tmp_path_factory):
    cfg, pairs, subs = _run_both(tmp_path_factory, "reflection_vortex")
    assert cfg.scheme == Scheme.MAC_REFLECTION
    _assert_steps_match(pairs)
    assert subs[0] == 2                     # half steps: CFL ~1.2
    # two spectral projections per step, one pass each
    assert all(int(got["proj_iters"]) == 2 for got, _ in pairs)


def test_reflection_obstacle_steps_match_jax(tmp_path_factory):
    trans = (scenes3d.sweep_trans(0.125 * N * (0.2 / N)),)   # 0.125 lz
    cfg, pairs, _ = _run_both(tmp_path_factory, "reflection_obstacle", trans)
    assert cfg.boundaries and cfg.scheme == Scheme.MAC_REFLECTION
    _assert_steps_match(pairs)
    for got, want in pairs:
        assert int(got["proj_iters"]) > 2       # MG-PCG, twice a step
        np.testing.assert_allclose(got["proj_res_hist"],
                                   want["proj_res_hist"], rtol=2e-2,
                                   atol=1e-7)
    flags = smoke3d._update_boundary(cfg, cfg.grid, 1, cfg.dt,
                                     smoke3d.boundary_base_flags(cfg.grid))[0]
    inside = (flags == 3).numpy()
    assert inside.sum() > 20
    assert float(np.abs(pairs[-1][0]["rho"][inside]).max()) == 0.0


@pytest.mark.parametrize("scheme", [Scheme.MACCORMACK, Scheme.MAC_REFLECTION])
def test_new_schemes_run_both_packaged_scenes(scheme):
    """Both packaged scenes build and step with the new schemes on the
    CPU (the vortex scene at its own default scheme when MAC_REFLECTION)."""
    for make in (scenes3d.make_vortex_collision,
                 scenes3d.make_moving_obstacle):
        solver, state = make(scheme=scheme, ni=8, nj=8, nk=8, device="cpu")
        state = solver.step(state)
        assert state.frame == 1 and np.isfinite(float(state.u.abs().max()))


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
