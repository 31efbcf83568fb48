"""The port's full BiMocq step against the JAX solver: maps that live
across frames (``reinit_mode`` 'counter' and 'adaptive'), the two-level
blend below 1, the accumulates through non-identity forward maps, the
distortion estimate, and the exact volume form.

Whole steps through ``Smoke3D`` at 16^3 from one numpy-seeded state (the
vortex scene with one emitter in the box, spectral projection), each JAX
solver feeding exactly one test function:

* counter, blend 0.5, exact volume form (JAX ``fast_interp=False``);
* adaptive, blend 1, exact volume form;
* adaptive, blend 0.5, dual volume form (JAX ``fast_interp=True``, its
  Pallas kernels in interpret mode).

The JAX runs happen in a child process with a single-threaded XLA
(tests/jax_oracle.py), which writes their states under ``tmp_path``. The
exact-form JAX steps run op by op (``jax.disable_jit``): jitted, the JAX exact
path's DMC substep differs from the same function run op by op by up to
0.17 cell (127 of 4096 cells at 16^3 after one substep from the identity,
at the upwind velocity samples px +- h, which lie on lattice planes),
while op by op it agrees with the JAX fast path and with the port to 3e-7
(ROADMAP.md, faults that are the JAX package's own).

Reinit gaps of 2 and 3 frames make reinit and non-reinit frames both
occur within 4 steps. Each adaptive decision is checked to sit more than
1e-3 (relative) from its limit in both packages, so no rounding can flip
it. Tolerance: 1e-4 of each field's scale (maps: of their world extent)
with equal frame, reinit counters, ``*_last_reinit`` and ``proj_iters``.

The dual-form functions (``bimocq_advect_3d`` with a blend,
``accumulate_multi_3d`` through a non-identity map,
``estimate_distortion_3d`` with and without its exclude mask) are held at
16x20x24 against the JAX functions in interpret mode within 1e-5 of
scale; the exact-form ones are held through the whole steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.bimocq import mapping as jmp
from gpufluidsimulation_tpu.core import grids as jgrids
from gpufluidsimulation_tpu.scenes import scenes3d as jscenes
from gpufluidsimulation_tpu.solvers import smoke3d as jsmoke
from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
from gpufluidsimulation_tpu_torch.core import grids
from gpufluidsimulation_tpu_torch.ops import interp_fast
from gpufluidsimulation_tpu_torch.solvers import smoke3d
from tests import jax_oracle

N = 16
FAST = config.EngineMode(fast_interp=True, interp_interpret=True)
EXACT = config.EngineMode(fast_interp=False)
FIELDS = ("u", "v", "w", "rho", "T", "u_init", "v_init", "w_init",
          "rho_init", "T_init", "u_prev", "v_prev", "w_prev", "rho_prev",
          "T_prev", "vel_map.fwd", "vel_map.bwd", "vel_map.bwd_prev",
          "scalar_map.fwd", "scalar_map.bwd", "scalar_map.bwd_prev")
COUNTERS = ("frame", "vel_last_reinit", "scalar_last_reinit", "proj_iters",
            "vel_map.reinit_count", "scalar_map.reinit_count")


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _flatten(state):
    """JAX state -> flat numpy dict (the port never sees JAX objects)."""
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if f.name in ("vel_map", "scalar_map"):
            for g in dataclasses.fields(val):
                out[f"{f.name}.{g.name}"] = np.array(getattr(val, g.name))
        else:
            out[f.name] = np.array(val)
    return out


# ---------------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------------


def _jax_solver(mode, reinit, blend, dt):
    solver, state = jscenes.make_vortex_collision(
        scheme=JScheme.BIMOCQ, ni=N, nj=N, nk=N, dt=dt, proj_max_iters=30,
        reinit_mode=reinit, blend_coeff=blend, vel_reinit_gap=2,
        scalar_reinit_gap=3,
        emitters=(jsmoke.Emitter3D(center=(0.1, 0.1, 0.1), radius=0.04),),
        engine_mode=dataclasses.replace(mode, rbgs=True,
                                        spectral_poisson=True))
    amp = 0.06
    state = state.replace(
        u=jnp.asarray(_smooth((N + 1, N, N), 1, amp)),
        v=jnp.asarray(_smooth((N, N + 1, N), 2, amp)),
        w=jnp.asarray(_smooth((N, N, N + 1), 3, amp)))
    return solver, state


def _jax_distortions(jcfg, flat):
    """(vel, scalar) distortion over maxvel*dt from the state `flat`
    before a step, as the JAX step computes them, in the JAX exact form
    run op by op (for the dual-form run its maps differ from these by
    ~1e-6 of their extent, far inside the 1e-3 margin)."""
    g = jcfg.grid
    u, v, w = (jnp.asarray(flat[k]) for k in ("u", "v", "w"))
    maxvel = jsmoke._max_velocity(u, v, w)
    out = []
    with config.engine_mode_scope(EXACT), jax.disable_jit():
        for name in ("vel_map", "scalar_map"):
            m = jmp.MappingState(*(jnp.asarray(flat[f"{name}.{k}"]) for k in
                                   ("fwd", "bwd", "bwd_prev",
                                    "reinit_count")))
            m = jmp.update_mapping_3d(m, g, u, v, w, g.h / maxvel, jcfg.dt)
            out.append(float(jmp.estimate_distortion_3d(g, m)
                             / (maxvel * jcfg.dt)))
    return out


# the configurations of the whole-step runs: (mode, reinit, blend, steps, dt)
RUNS = {
    "exact_counter": (EXACT, "counter", 0.5, 4, 0.5),
    "exact_adaptive": (EXACT, "adaptive", 1.0, 4, 0.5),
    # dt 0.25 and 3 steps keep the JAX window kernels inside their
    # displacement contract (interp_overflow 0): a 4th step, on scalar maps
    # 4 frames old, leaves it, and the JAX scalars then differ from the
    # exact samples (ROADMAP.md, faults that are the JAX package's own)
    "dual_adaptive": (FAST, "adaptive", 0.5, 3, 0.25),
}


def _jax_run(name):
    return _jax_states(*RUNS[name])


def _jax_states(mode, reinit, blend, steps, dt, eager=False):
    """The JAX solver's states (and, under adaptive reinit, its distortions
    before each step) for one run, as flat numpy arrays. The fast path
    runs the jitted step (or, with `eager`, the step function outside jit,
    its Pallas calls each jitted on its own); the exact path runs op by
    op."""
    jsolver, jstate = _jax_solver(mode, reinit, blend, dt)
    jcfg = jsolver.cfg
    states = [_flatten(jstate)]
    if mode.fast_interp and not eager:
        for _ in range(steps):
            jstate = jsolver.step(jstate)      # donates its input
            states.append(_flatten(jstate))
    else:
        with config.engine_mode_scope(jcfg.engine_mode), (
                jax.disable_jit(not mode.fast_interp)):
            for _ in range(steps):
                jstate = jsmoke._step_bimocq(jcfg, jcfg.grid, jsolver.ctx,
                                             jstate)
                states.append(_flatten(jstate))
    out = {f"{k}#{key}": val for k, st in enumerate(states)
           for key, val in st.items()}
    if reinit == "adaptive":
        out["distortions"] = np.array([_jax_distortions(jcfg, st)
                                       for st in states[:-1]])
    out["config"] = np.array(repr(dataclasses.asdict(jcfg)))
    return out


def _unflatten(run):
    steps = 1 + max(int(key.split("#")[0]) for key in run if "#" in key)
    states = [{} for _ in range(steps)]
    for key, val in run.items():
        if "#" in key:
            k, name = key.split("#", 1)
            states[int(k)][name] = val
    return states


def _port_distortions(cfg, st):
    g = cfg.grid
    maxvel = smoke3d._max_velocity(st.u, st.v, st.w)
    cfldt = np.float32(np.float32(g.h) / maxvel)
    out = []
    for m in (st.vel_map, st.scalar_map):
        m = mp.update_mapping_3d(m, g, st.u, st.v, st.w, cfldt, cfg.dt)
        out.append(float(np.float32(mp.estimate_distortion_3d(g, m))
                         / np.float32(maxvel * np.float32(cfg.dt))))
    return out


def _compare_run(name, run, rel=1e-4):
    return _compare_states(run, *RUNS[name], rel=rel, name=name)


def _compare_states(run, mode, reinit, blend, steps, dt, rel=1e-4,
                    name=""):
    """Step the port on the CPU from the JAX run's first state and hold
    every step against it; returns the port's config and the JAX states."""
    want = _unflatten(run)
    assert len(want) == steps + 1
    jcfg = _jax_solver(mode, reinit, blend, dt)[0].cfg
    assert str(run["config"]) == repr(dataclasses.asdict(jcfg))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    st = convert.state_from_numpy(want[0], cfg, "cpu")
    assert st.u_prev is not None and st.scalar_map.bwd_prev is not None
    limits = (cfg.vel_distortion_limit, cfg.scalar_distortion_limit)
    for k in range(1, steps + 1):
        if reinit == "adaptive":
            # no decision may sit on a rounding edge, in either package
            for pkg, d in (("port", _port_distortions(cfg, st)),
                           ("jax", run["distortions"][k - 1])):
                for dd, lim in zip(d, limits):
                    assert abs(dd / lim - 1.0) > 1e-3, (name, k, pkg, dd)
        st = solver.step(st)
        got = convert.state_to_numpy(st)
        for key in FIELDS:
            scale = max(float(np.abs(want[k][key]).max()), 1e-3)
            err = float(np.abs(got[key].astype(np.float64)
                               - want[k][key]).max())
            assert err <= rel * scale, (name, k, key, err, scale)
        for key in COUNTERS:
            assert int(got[key]) == int(want[k][key]), (name, k, key)
        assert int(want[k]["interp_overflow"]) == 0
        np.testing.assert_allclose(got["cfl"], want[k]["cfl"], rtol=1e-6)
    return cfg, want


def _reinit_frames(states):
    """Frames at which each map was reinitialized."""
    vel = sorted({int(s["vel_last_reinit"]) for s in states[1:]})
    sc = sorted({int(s["scalar_last_reinit"]) for s in states[1:]})
    return vel, sc


def test_bimocq_exact_counter_and_adaptive_match_jax(tmp_path):
    """Counter reinit with blend 0.5 and adaptive reinit with blend 1, in
    the exact volume form, 4 steps each (one child process for both JAX
    runs: they share its operation compiles)."""
    runs = jax_oracle.run(__file__, tmp_path, "exact_counter",
                          "exact_adaptive")
    cfg, states = _compare_run("exact_counter", runs["exact_counter"])
    assert cfg.engine_mode.volume_exact and cfg.blend_coeff == 0.5
    # vel reinits at frames 0 and 3, scalar at 0 only; the blend is live
    # from frame 1 on
    assert _reinit_frames(states) == ([0, 3], [0])
    assert int(states[-1]["vel_map.reinit_count"]) == 2
    cfg, states = _compare_run("exact_adaptive", runs["exact_adaptive"])
    assert cfg.engine_mode.volume_exact and cfg.blend_coeff == 1.0
    # frame 2's vel reinit is the distortion's (the gap alone waits for 3)
    assert _reinit_frames(states) == ([0, 2], [0])


def test_bimocq_dual_adaptive_blend_half_matches_jax(tmp_path):
    """The slice's one interpret-mode step compile: the JAX production
    numerics (dual volume form, Pallas samplers, fused marches)."""
    launches = interp_fast.trilerp_sample.launches
    run = jax_oracle.run(__file__, tmp_path, "dual_adaptive")
    cfg, states = _compare_run("dual_adaptive", run["dual_adaptive"])
    assert not cfg.engine_mode.volume_exact
    # the velocity maps' second reinit (frame 2) is the distortion's: the
    # gap alone waits for frame 3
    assert _reinit_frames(states) == ([0, 2], [0])
    assert interp_fast.trilerp_sample.launches == launches


def test_full_state_round_trip_and_dieted_choice():
    """Only BiMocq with always/blend 1 diets the state, as JAX's
    _aux_dead; every other configuration carries the prev tier and the
    scalar maps, and the numpy round trip keeps every leaf."""
    jsolver, jstate = _jax_solver(EXACT, "counter", 0.5, 0.5)
    flat = _flatten(jstate)
    cfg = convert.config_from_dict(dataclasses.asdict(jsolver.cfg))
    st = convert.state_from_numpy(flat, cfg, "cpu")
    back = convert.state_to_numpy(st)
    assert set(back) == set(flat) | {"substeps", "slab_clamped"}
    for key, val in flat.items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)
    for change, dead in ((dict(reinit_mode="always", blend_coeff=1.0), True),
                         (dict(reinit_mode="always", blend_coeff=0.5), False),
                         (dict(reinit_mode="adaptive"), False),
                         (dict(scheme=smoke3d.Scheme.MACCORMACK), False)):
        s = smoke3d.init_state(dataclasses.replace(cfg, **change), "cpu")
        assert (s.u_prev is None) == dead
        assert (s.scalar_map.fwd is None) == dead
        assert (s.vel_map.bwd_prev is None) == dead


def test_engine_mode_volume_form_across():
    """The JAX exact form (fast_interp=False, or volume_exact) maps to the
    port's volume_exact; the prefilter and vol9 forms are carried with the
    JAX precedence (mapping._volume_mode); the rbgs-off smoother maps to
    the port's Jacobi-smoothed V-cycle."""
    def port_mode(**kw):
        return convert._engine_mode(dataclasses.asdict(
            config.EngineMode(**kw)))

    assert port_mode(fast_interp=False, rbgs=True).volume_exact is True
    assert port_mode(fast_interp=True, volume_exact=True).volume_exact
    assert port_mode(fast_interp=True).volume_exact is None
    assert port_mode(fast_interp=False, rbgs=True,
                     volume_vol9=True).volume_exact is True
    for kw, form in ((dict(fast_interp=True), "dual"),
                     (dict(fast_interp=True, volume_vol9=True), "vol9"),
                     (dict(fast_interp=True, volume_dual=False), "prefilter"),
                     (dict(fast_interp=True, volume_dual=False,
                           volume_vol9=True), "prefilter"),
                     (dict(fast_interp=True, interp_adaptive=False),
                      "prefilter"),
                     (dict(fast_interp=True, volume_exact=True,
                           volume_vol9=True), "exact"),
                     (dict(fast_interp=False, rbgs=True, volume_dual=False),
                      "exact")):
        with config.engine_mode_scope(config.EngineMode(**kw)):
            assert jmp._volume_mode() == form, kw
        assert port_mode(**kw).volume_mode == form, kw
    # without rbgs, fast_interp=False is the JAX package's red-black
    # smoother off too: the port's Jacobi-smoothed V-cycle
    jacobi = port_mode(fast_interp=False)
    assert jacobi.rbgs is False and jacobi.volume_exact is True
    assert jacobi.volume_mode == "exact"


# ---------------------------------------------------------------------------
# The mapping functions at 16x20x24
# ---------------------------------------------------------------------------

SHAPE = (16, 20, 24)
H = 0.2 / SHAPE[0]


def _maps_at(shape, h, seed, amp=0.3):
    """The identity map of a `shape` grid plus smooth displacements of
    up to `amp` cells."""
    jg = jgrids.Grid3D(*shape, h)
    ident = [np.asarray(p) for p in jg.node_coords("c")]
    return np.stack([(p + _smooth(p.shape, seed + i, amp * h))
                     for i, p in enumerate(ident)]).astype(np.float32)


def _fields_at(shape, h, kind, n, seed):
    """n smooth fields of `kind` (scales 1 and 50) with a raised box."""
    shape = grids.Grid3D(*shape, h).shape_of(kind)
    out = []
    for c in range(n):
        f = _smooth(shape, seed + c, (1.0, 50.0)[c])
        f[4:9, 5:11, 6:13] += (1.0, 50.0)[c]
        out.append(f)
    return out


def _maps(seed, amp=0.3):
    return _maps_at(SHAPE, H, seed, amp)


def _fields(kind, n, seed):
    return _fields_at(SHAPE, H, kind, n, seed)


@pytest.mark.parametrize("kind", ["c"])
def test_bimocq_advect_blend_matches_jax(kind):
    jg, tg = jgrids.Grid3D(*SHAPE, H), grids.Grid3D(*SHAPE, H)
    n = 2 if kind == "c" else 1
    cur, init, prev = (_fields(kind, n, s) for s in (1, 11, 21))
    bwd, fwd, bwd_prev = _maps(20), _maps(30), _maps(40)
    with config.engine_mode_scope(FAST):
        assert jmp._volume_mode() == "dual"
        want = jmp.bimocq_advect_3d(
            jg, kind, *([jnp.asarray(f) for f in fs]
                        for fs in (cur, init, prev)),
            jnp.asarray(bwd), jnp.asarray(bwd_prev), jnp.asarray(fwd), 0.6)
    got = mp.bimocq_advect_3d(
        tg, kind, *([_t(f) for f in fs] for fs in (cur, init, prev)),
        _t(bwd), _t(bwd_prev), _t(fwd), 0.6)
    no_blend = mp.bimocq_advect_3d(
        tg, kind, *([_t(f) for f in fs] for fs in (cur, init, prev)),
        _t(bwd), _t(bwd_prev), _t(fwd), None)
    for c in range(n):
        scale = float(np.abs(init[c]).max())
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want[c]),
                                   rtol=0, atol=1e-5 * scale)
        # the level-2 term moved the result
        assert float((got[c] - no_blend[c]).abs().max()) > 0.01 * scale
    with pytest.raises(ValueError):
        mp.bimocq_advect_3d(tg, kind, [_t(f) for f in cur],
                            [_t(f) for f in init], [None] * n, _t(bwd),
                            None, _t(fwd), 0.6)


@pytest.mark.parametrize("kind", ["c", "v"])
def test_accumulate_non_identity_matches_jax(kind):
    jg, tg = jgrids.Grid3D(*SHAPE, H), grids.Grid3D(*SHAPE, H)
    a, b = _fields(kind, 2, 50)
    c, d = _fields(kind, 2, 60)
    groups = [(a, [(c, 1.0), (d, 2.0)]), (b, [(d, 1.0)])]
    fwd = _maps(70)
    with config.engine_mode_scope(FAST):
        want = jmp.accumulate_multi_3d(
            jg, kind, [(jnp.asarray(base), [(jnp.asarray(ch), k)
                                            for ch, k in pairs])
                       for base, pairs in groups], jnp.asarray(fwd))
    got = mp.accumulate_multi_3d(
        tg, kind, [(_t(base), [(_t(ch), k) for ch, k in pairs])
                   for base, pairs in groups], _t(fwd))
    for g_out, w_out, (base, pairs) in zip(got, want, groups):
        # the JAX window sampler rounds ~6e-6 of the sampled field's scale
        scale = float(np.abs(base).max()) + sum(
            abs(k) * float(np.abs(ch).max()) for ch, k in pairs)
        np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), rtol=0,
                                   atol=1e-5 * scale)
        assert float(np.abs(g_out.numpy() - base).max()) > 0.01 * scale


@pytest.mark.parametrize("exclude", [False, True])
def test_estimate_distortion_matches_jax(exclude):
    jg, tg = jgrids.Grid3D(*SHAPE, H), grids.Grid3D(*SHAPE, H)
    bwd, fwd = _maps(80, 0.6), _maps(90, 0.6)
    mask = None
    if exclude:
        mask = np.zeros(SHAPE, bool)
        mask[:, :, :12] = True
    with config.engine_mode_scope(FAST):
        jm = jmp.MappingState(jnp.asarray(fwd), jnp.asarray(bwd), None,
                              jnp.int32(0))
        want = float(jmp.estimate_distortion_3d(
            jg, jm, None if mask is None else jnp.asarray(mask)))
    before = interp_fast.trilerp_sample.launches
    got = mp.estimate_distortion_3d(
        tg, mp.MappingState(_t(fwd), _t(bwd), None),
        None if mask is None else torch.from_numpy(mask))
    assert interp_fast.trilerp_sample.launches == before
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert float(got) > 0.1 * H
    if exclude:
        full = mp.estimate_distortion_3d(
            tg, mp.MappingState(_t(fwd), _t(bwd), None))
        assert float(got) <= float(full)


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
