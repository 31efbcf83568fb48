"""The port's 2D solver against the JAX package, whole steps and scenes.

Whole steps: every grid scheme (SEMILAG, MACCORMACK, BFECC,
MAC_REFLECTION, BIMOCQ) at 24x40 (h = 1/24, a non-square grid), with the
spectral projection and with MG-PCG, and BIMOCQ in the level-set mode,
from one numpy state of seeded smooth velocities with no symmetry (no
stagnation line falls on the lattice, where the upwind choice of the DMC
step is a coin toss: ROADMAP §3 item 3(e)) and buoyancy on. The JAX steps
run under ``EngineMode(fast_interp=False)`` (the exact
``sample2``/``mac_velocity_2d``, the JAX package's CPU default), jitted,
but BIMOCQ op by op (``jax.disable_jit``): its jitted exact DMC substep
moves the backward map by up to 0.12 cell at nodes next to the wall,
where the upwind sample sits on the edge of the MAC band (ROADMAP §3
item 3(g)); run op by op it agrees with the port to round-off. They run
in child processes shared by the workers (tests/jax_oracle.shared): one
for each scheme's two projections, one for each BIMOCQ case. dt 0.5 puts the CFL number near 2: the traces take 2 or 3
substeps. The BIMOCQ cases remap by frame gap (gaps 2 and 1) and, with
MG-PCG, blend at 0.5, so the two-level pull-back, the origins and the
accumulates through a reinitialized map all run. The port runs steps 1
and 2 from its own state and step 3 from JAX's state 2 (ROADMAP §3 item
2's caution); each field is held within 1e-4 of its scale after each
step, with the same CG iteration count and the same counters.

Stages: the scene inits (the stream-function MG-PCG of the Taylor vortex
and leapfrog among them) at 48x40, the configuration and the state
across ``convert`` both ways, the particle schemes' ``step_checked``
(their whole steps are held in tests/test_torch_particles.py).

The 3D main path at 16x20x24 (the non-cubic whole step, ROADMAP §3 item
2): three BiMocq steps of the vortex-collision physics with the emitter
centre on the lattice (8h = 0.1), against the jitted JAX step in the
accelerator's numerics (Pallas kernels in interpret mode, the dual
volume form, the spectral projection), within 1e-4 of each field's
scale.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.ops import interp_fast
from gpufluidsimulation_tpu_torch.scenes import scenes2d
from gpufluidsimulation_tpu_torch.solvers import smoke2d, smoke3d
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from tests import jax_oracle

NI, NJ = 24, 40
DT = 0.5
STEPS = 3
SCHEMES = {"semilag": Scheme.SEMILAG, "maccormack": Scheme.MACCORMACK,
           "bfecc": Scheme.BFECC, "reflection": Scheme.MAC_REFLECTION,
           "bimocq": Scheme.BIMOCQ}
CASES = [(name, proj) for name in SCHEMES for proj in ("spectral", "mgpcg")]
CASES.append(("bimocq", "levelset"))
COUNTERS = ("frame", "last_remeshing", "rho_last_remeshing",
            "total_resample_count", "total_scalar_resample", "proj_iters",
            "interp_overflow")
SCENE_NI, SCENE_NJ = 48, 40


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smooth(shape, seed, amp):
    """amp * a sum of two random-phase sine modes on the index lattice."""
    rng = np.random.default_rng(seed)
    idx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(2):
        k = rng.uniform(0.5, 2.0, len(shape)) * 2 * np.pi / np.array(shape)
        f += np.sin(sum(kk * ii for kk, ii in zip(k, idx))
                    + rng.uniform(0, 2 * np.pi))
    return (amp * f / 2).astype(np.float32)


def _cfg_fields(name, proj):
    """The JAX 2D config's fields of one case (scheme as an int)."""
    d = dict(ni=NI, nj=NJ, L=1.0, scheme=int(SCHEMES[name]), alpha=0.2,
             beta=0.05, proj_tol=1e-5, proj_max_iters=60)
    if name == "bimocq":
        d.update(vel_remap_gap=2, rho_remap_gap=1)
        if proj == "mgpcg":
            d.update(blend_coeff=0.5)
    if proj == "levelset":
        d.update(advect_levelset=True, alpha=0.0, beta=0.0)
    return d


def _start():
    """The initial fields: smooth non-symmetric velocities of amplitude
    0.2, a smooth density and temperature."""
    return dict(u=_smooth((NI + 1, NJ), 1, 0.2), v=_smooth((NI, NJ + 1), 2,
                                                           0.2),
                rho=np.abs(_smooth((NI, NJ), 3, 2.0)),
                T=_smooth((NI, NJ), 4, 1.0))


def _flatten(state):
    """A JAX (or port) state as flat numpy arrays, nested records as
    '<field>.<subfield>'."""
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if val is None:
            continue
        if dataclasses.is_dataclass(val):
            for g in dataclasses.fields(val):
                x = getattr(val, g.name)
                if x is not None:
                    out[f"{f.name}.{g.name}"] = np.array(x)
        else:
            out[f.name] = np.array(val)
    return out


def _child(name, proj):
    """The oracle child of a case: one a scheme, one a BIMOCQ case (run
    op by op, each takes ~25 s)."""
    return f"bimocq-{proj}" if name == "bimocq" else name


def _jax_steps(child):
    """states 0..3 of every case of one child: jitted JAX steps, BIMOCQ
    op by op."""
    import jax
    import jax.numpy as jnp

    from gpufluidsimulation_tpu import config as jconfig
    from gpufluidsimulation_tpu.solvers import smoke2d as js
    from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme

    out = {}
    for case, proj in CASES:
        if _child(case, proj) != child:
            continue
        d = _cfg_fields(case, proj)
        d["scheme"] = JScheme(d["scheme"])
        cfg = js.Smoke2DConfig(**d, engine_mode=jconfig.EngineMode(
            fast_interp=False, spectral_poisson=proj != "mgpcg"))
        solver = js.Smoke2D(cfg)
        st = solver.init_state()
        st = st.replace(**{k: jnp.asarray(v) for k, v in _start().items()})
        for k in range(STEPS + 1):
            out.update({f"{proj}#{k}#{key}": v
                        for key, v in _flatten(st).items()})
            if k == STEPS:
                break
            if case == "bimocq":
                # op by op: jitted, the exact DMC substep moves the map by
                # up to 0.12 cell at band-edge nodes (ROADMAP §3 item 3(g))
                with jax.disable_jit():
                    st = solver.step(st, DT)
            else:
                st = solver.step(st, DT)
    return out


def _jax_noncubic():
    """3D: the JAX states 0..3 of the main path at 16x20x24."""
    from gpufluidsimulation_tpu import config as jconfig
    from gpufluidsimulation_tpu.scenes.scenes3d import vortex_collision_config
    from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
    from gpufluidsimulation_tpu.solvers.smoke3d import Emitter3D, Smoke3D

    cfg = vortex_collision_config(
        ni=16, nj=20, nk=24, scheme=JScheme.BIMOCQ, dt=0.25,
        emitters=(Emitter3D(center=(0.1, 0.1, 0.1), radius=0.04,
                            sign=1.0),),
        proj_tol=1e-4, proj_max_iters=30,
        engine_mode=jconfig.EngineMode(fast_interp=True,
                                       interp_interpret=True,
                                       spectral_poisson=True))
    solver = Smoke3D(cfg)
    st = solver.init_state()
    out = {}
    for k in range(STEPS + 1):
        out.update({f"{k}#{key}": v for key, v in _flatten(st).items()})
        if k < STEPS:
            st = solver.step(st)
    return out


def _jax_scenes():
    """The five scene inits at 48x40 and the 2D config fields."""
    from gpufluidsimulation_tpu.scenes import scenes2d as jscenes
    from gpufluidsimulation_tpu.solvers import smoke2d as js

    out = {}
    for label, L, init in _SCENE_INITS:
        cfg = js.Smoke2DConfig(ni=SCENE_NI, nj=SCENE_NJ, L=L)
        solver = js.Smoke2D(cfg)
        st = getattr(jscenes, init)(solver, solver.init_state())
        if isinstance(st, tuple):
            out[f"{label}#curl_max"] = np.float32(st[1])
            st = st[0]
        for key in ("u", "v", "rho", "T", "u_init", "v_origin", "rho_init",
                    "T_orig"):
            out[f"{label}#{key}"] = np.array(getattr(st, key))
    return out


_SCENE_INITS = (("taylor", 2 * math.pi, "init_taylor_vortex"),
                ("leapfrog", 2 * math.pi, "init_leapfrog"),
                ("zalesak", 1.0, "init_zalesak"),
                ("vortex_box", 1.0, "init_vortex_box"))


def _jax_run(name):
    if name == "noncubic3d":
        return _jax_noncubic()
    if name == "scenes":
        out = _jax_scenes()
        from gpufluidsimulation_tpu.scenes import scenes2d as jscenes
        from gpufluidsimulation_tpu.solvers import smoke2d as js

        cfg = js.Smoke2DConfig(ni=SCENE_NI, nj=SCENE_NJ, L=0.2)
        solver = js.Smoke2D(cfg)
        st = jscenes.init_rayleigh_taylor(solver, solver.init_state(), 0.1)
        out["rt#rho"], out["rt#T"] = np.array(st.rho), np.array(st.T)
        return out
    return _jax_steps(name)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__, "scenes")["scenes"]


def _steps(tmp_path_factory, name, proj):
    child = _child(name, proj)
    return jax_oracle.shared(tmp_path_factory, __file__, child)[child]


def _case_state(ref, proj, k):
    return {key.split("#", 2)[2]: v for key, v in ref.items()
            if key.startswith(f"{proj}#{k}#")}


def _compare(label, got, want, tol=1e-4):
    for key, w in want.items():
        if key in COUNTERS:
            assert int(got[key]) == int(w), (label, key, got[key], w)
            continue
        if key == "cfl":
            np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=label)
            continue
        if key == "proj_res":   # a residual: compared by the iterations
            continue
        assert got[key].shape == w.shape, (label, key)
        if w.size == 0:
            continue
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(got[key].astype(np.float64) - w).max())
        assert err <= tol * scale, (label, key, err, scale)


@pytest.mark.parametrize("name,proj", CASES)
def test_whole_steps_match_jax(tmp_path_factory, name, proj):
    ref = _steps(tmp_path_factory, name, proj)
    cfg = convert.config_2d_from_dict(dict(
        _cfg_fields(name, proj),
        engine_mode=dict(fast_interp=False,
                         spectral_poisson=proj != "mgpcg")))
    assert cfg.engine_mode.spectral_poisson is (proj != "mgpcg")
    solver = smoke2d.Smoke2D(cfg, device="cpu")
    state = convert.state_from_numpy(_case_state(ref, proj, 0), cfg, "cpu")
    before = interp_fast.bilerp_sample.launches
    for k in range(1, STEPS + 1):
        if k == STEPS:   # the last step from JAX's state
            state = convert.state_from_numpy(_case_state(ref, proj, k - 1),
                                             cfg, "cpu")
        state = solver.step(state, DT)
        _compare(f"{name}/{proj} step {k}", convert.state_to_numpy(state),
                 _case_state(ref, proj, k))
    assert state.substeps >= 2
    assert interp_fast.bilerp_sample.launches == before
    if name == "bimocq" and proj != "levelset":
        assert state.total_resample_count >= 1
        assert state.total_scalar_resample >= 2


def test_noncubic_3d_main_path_matches_jax(tmp_path_factory):
    ref = jax_oracle.shared(tmp_path_factory, __file__,
                            "noncubic3d")["noncubic3d"]
    from gpufluidsimulation_tpu_torch.scenes.scenes3d import (
        vortex_collision_config)

    cfg = vortex_collision_config(
        ni=16, nj=20, nk=24, scheme=Scheme.BIMOCQ, dt=0.25,
        emitters=(smoke3d.Emitter3D(center=(0.1, 0.1, 0.1), radius=0.04,
                                    sign=1.0),),
        proj_tol=1e-4, proj_max_iters=30)
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    states = [{key.split("#", 1)[1]: v for key, v in ref.items()
               if key.startswith(f"{k}#")} for k in range(STEPS + 1)]
    state = convert.state_from_numpy(states[0], cfg, "cpu")
    subs = []
    for k in range(1, STEPS + 1):
        if k == STEPS:
            state = convert.state_from_numpy(states[k - 1], cfg, "cpu")
        state = solver.step(state)
        subs.append(state.substeps)
        got = convert.state_to_numpy(state)
        for key in ("u", "v", "w", "rho", "T", "u_init", "v_init", "w_init",
                    "rho_init", "T_init", "vel_map.fwd", "vel_map.bwd"):
            want = states[k][key]
            scale = max(float(np.abs(want).max()), 1e-6)
            err = float(np.abs(got[key].astype(np.float64) - want).max())
            assert err <= 1e-4 * scale, (k, key, err, scale)
        assert int(got["proj_iters"]) == int(states[k]["proj_iters"])
    assert max(subs) >= 2, subs


@pytest.mark.parametrize("label,L,init", _SCENE_INITS)
def test_scene_inits_match_jax(scenes, label, L, init):
    cfg = smoke2d.Smoke2DConfig(ni=SCENE_NI, nj=SCENE_NJ, L=L)
    solver = smoke2d.Smoke2D(cfg, device="cpu")
    st = getattr(scenes2d, init)(solver, solver.init_state())
    if isinstance(st, tuple):
        np.testing.assert_allclose(st[1], scenes[f"{label}#curl_max"],
                                   rtol=1e-6)
        st = st[0]
    for key in ("u", "v", "rho", "T", "u_init", "v_origin", "rho_init",
                "T_orig"):
        want = scenes[f"{label}#{key}"]
        got = getattr(st, key).numpy()
        scale = max(float(np.abs(want).max()), 1e-6)
        # the stream-function solve stops at the 1e-6 residual: two MG-PCG
        # runs with other round-off agree to a few 1e-6 of the velocity
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, key
    # fresh buffers: the aliased inits are distinct tensors, each laid
    # out as the kernels take them
    assert st.u.data_ptr() != st.u_init.data_ptr()
    for key in ("u", "v", "rho", "T", "u_init", "v_init", "rho_init"):
        assert getattr(st, key).is_contiguous(), key


def test_rayleigh_taylor_init_and_scene_table(scenes):
    cfg = smoke2d.Smoke2DConfig(ni=SCENE_NI, nj=SCENE_NJ, L=0.2)
    solver = smoke2d.Smoke2D(cfg, device="cpu")
    st = scenes2d.init_rayleigh_taylor(solver, solver.init_state(), 0.1)
    np.testing.assert_array_equal(st.rho.numpy(), scenes["rt#rho"])
    np.testing.assert_array_equal(st.T.numpy(), scenes["rt#T"])
    from gpufluidsimulation_tpu.scenes import scenes2d as jscenes
    from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme

    assert scenes2d.SCENES_2D == jscenes.SCENES_2D
    for ex in range(5):
        mine = scenes2d.make_scene_2d(ex, Scheme.BIMOCQ)
        theirs = jscenes.make_scene_2d(ex, JScheme.BIMOCQ)
        for f in ("name", "dt", "cfl_number", "frame_dt", "total_frames",
                  "output"):
            assert getattr(mine, f) == getattr(theirs, f), (ex, f)
        cfg = dataclasses.asdict(theirs.cfg)
        assert convert.config_2d_from_dict(cfg) == mine.cfg
    with pytest.raises(ValueError):
        scenes2d.make_scene_2d(3, Scheme.FLIP)
    with pytest.raises(ValueError):
        scenes2d.make_scene_2d(5, Scheme.BIMOCQ)


def test_state_round_trips_both_ways(tmp_path_factory):
    """A JAX state carried across and back gives its arrays and counters
    unchanged, in the JAX field order; a port state through numpy and
    back is the same state."""
    ref = _steps(tmp_path_factory, "bimocq", "mgpcg")
    cfg = convert.config_2d_from_dict(_cfg_fields("bimocq", "mgpcg"))
    want = _case_state(ref, "mgpcg", 2)
    state = convert.state_from_numpy(want, cfg, "cpu")
    got = convert.state_to_numpy(state)
    assert [k for k in got if k != "substeps"] == list(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
        assert got[key].shape == val.shape, key
    assert isinstance(state.frame, int) and isinstance(state.cfl, float)
    assert state.particles.pos.shape == (0, 2)
    again = convert.state_to_numpy(convert.state_from_numpy(got, cfg, "cpu"))
    for key, val in got.items():
        np.testing.assert_array_equal(again[key], val, err_msg=key)


def test_particle_schemes_and_step_checked(monkeypatch):
    """The particle schemes build on the CPU with their seeded particles,
    and every scheme's step_checked is (step, False), bit for bit: the
    port's transfers are exact, so nothing is ever recomputed."""
    u0 = torch.from_numpy(_smooth((13, 16), 5, 0.2))
    for scheme in (Scheme.FLIP, Scheme.APIC, Scheme.POLYPIC, Scheme.BIMOCQ):
        solver = smoke2d.Smoke2D(smoke2d.Smoke2DConfig(
            ni=12, nj=16, L=1.0, scheme=scheme), device="cpu")
        st = dataclasses.replace(solver.init_state(), u=u0)
        particles = scheme != Scheme.BIMOCQ
        assert st.particles.pos.shape == ((12 * 16 * 16 if particles else 0),
                                          2)
        if particles:
            st = solver.sample_particles_from_grid(st)
        a = solver.step(st, 0.1)
        b, retried = solver.step_checked(st, 0.1)
        assert retried is False and b.interp_overflow == 0
        for key, val in convert.state_to_numpy(a).items():
            np.testing.assert_array_equal(convert.state_to_numpy(b)[key],
                                          val, err_msg=f"{scheme} {key}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smoke2d.Smoke2D(smoke2d.Smoke2DConfig(ni=8, nj=8, L=1.0))


for _name in ("scenes", "noncubic3d",
              *dict.fromkeys(_child(n, p) for n, p in CASES)):
    jax_oracle.prefetch(__file__, _name)


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
