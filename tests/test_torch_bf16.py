"""The port's bf16 mode (``EngineMode.interp_bf16``) against the JAX
package's bf16 field windows.

The JAX side runs its production numerics with bf16 windows on the CPU:
``EngineMode(fast_interp=True, interp_interpret=True, interp_bf16=True)``,
the Pallas kernels in interpret mode. Every JAX reference is computed in a
child process shared by the workers (``tests/jax_oracle.shared``): one
for the samplers of each lattice kind, one for each other stage group,
one for each whole-step run. The port runs its plain versions
(CPU tensors), which in the bf16 mode are the float32 ones on the
widened bfloat16 values; on the card the kernels equal them bit for bit
(chip_smoke.py).

Each stage is held within the tolerance of the float32 stage test of the
same function, and the port's float32 result must miss the JAX bf16
result by at least 100 times that tolerance, so that the test sees the
mode: the samplers on 40x32x24 at 1e-5 of the field's scale
(tests/test_torch_interp.py), with unit-normal fields, which bf16 moves
by up to ~2e-3 of their scale (measured bf16 agreement <= 7.2e-6, float32
miss >= 1.3e-3); the marches (3 substeps on tests/test_torch_advect.py's
16x20x24 inputs) at its 2e-6 world (measured 7e-7 and 6e-8). The
forward march is the one exception to the 100 times: bf16 moves its
positions by 5.2e-5 to 6.3e-5 world (26 times the tolerance), since the
JAX window kernels' reach contract bounds a march to a few cells, and
bf16 moves a position by at most ~0.4% of its displacement. The
semi-Lagrangian stage (its lattice-mode trace and the rounded samples of
unit-normal fields there) is held at tests/test_torch_semilag.py's 1e-4
of the field's scale (measured 2.7e-5: the trace's position round-off
against the window kernels times the field's gradient), and its float32
miss is 23 times that (2.3e-3 to 2.8e-3: bf16 rounds a value by at most
~0.4%), the second exception. MacCormack's min/max is held on the
samplers' inputs at tests/test_torch_minmax.py's 1e-6 (of a field of
scale ~4), its clamp through the whole MACCORMACK step (at the trace
clamp a position's round-off may flip a node between the corrected value
and the fallback, so a stage comparison at the stage tolerance would
compare round-off). The identity peels read the unrounded faces in JAX
(the DMC peel and the RK3 peel's stage 1): the port's must too.
Two whole-step runs: the main path at 16^3 for 3 steps from rest (as
tests/test_torch_smoke3d.py) and one MACCORMACK step from a ball of
developed flow. Rounding to bf16 is not continuous: a value that two
implementations compute a few float32 ulp apart (the window kernels and
the port's trilerps, ~5e-6 relative) can round to neighbouring bf16
values, up to 2^-8 of the value apart, wherever it sits near a rounding
boundary, and the samples there follow. Within a step the pull-backs'
second and third stages and MacCormack's second semi-Lagrangian stage
round fields the step computed, so the port cannot hold every node within
the float32 tests' 1e-4 of scale: 5e-6 relative noise on a state moves
the port's own bf16 steps by 1e-4 to 1.1e-3 of scale after 2 steps
(float32: 6e-6); against JAX, the first step from rest agrees to 7.6e-7,
the third to 2.3e-4 on 0.073% of a field's values (MacCormack 2.8e-4 on
0.12%). So each field of each step is held within the 2e-3 fidelity
bound of tests/test_fidelity3d.py at every value and within 1e-4 of its
scale at all but 0.5% of its values, and ``interp_overflow`` is 0; the
port's float32 steps, against the same bf16 references, miss 1e-4 at
11% to 13% of some field's values from step 2 on.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch import config as tconfig
from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.core import grids
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from gpufluidsimulation_tpu_torch.solvers import smoke3d
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from tests import jax_oracle
from tests.test_torch_advect import DT as MARCH_DT
from tests.test_torch_advect import _setup as _march_setup

SHAPE = (40, 32, 24)
H = 0.2 / SHAPE[0]
KINDS = ("c", "u", "v", "w")
N = 16                   # the whole steps
STEP_FIELDS = ("u", "v", "w", "rho", "T", "u_init", "v_init", "w_init",
               "rho_init", "T_init", "vel_map.fwd", "vel_map.bwd")
SAMPLE_TOL = 1e-5        # of the field's scale
POS_TOL = 2e-6           # world
FIELD_TOL = 1e-4         # of the field's scale (semilag, whole steps)
FLIP_SHARE = 5e-3        # share of a field's values a step may move past it
FIDELITY = 2e-3          # of the field's scale, at every value


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU tensors under six workers: one torch thread a test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noise(shape, seed, amp=1.0):
    return (amp * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


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


def _shape_of(kind):
    ni, nj, nk = SHAPE
    return {"c": SHAPE, "u": (ni + 1, nj, nk), "v": (ni, nj + 1, nk),
            "w": (ni, nj, nk + 1)}[kind]


def _node_coords(kind):
    return [p.numpy() for p in grids.Grid3D(*SHAPE, H).node_coords(kind)]


def _sample_inputs(kind):
    """Two unit-normal fields (the second x50) and `kind`'s lattice
    displaced by up to one cell, uniformly at random."""
    fields = np.stack([_noise(_shape_of(kind), 10 + i, 1.0 + 49.0 * i)
                       for i in range(2)])
    rng = np.random.default_rng(20)
    pos = [(p + rng.uniform(-H, H, p.shape)).astype(np.float32)
           for p in _node_coords(kind)]
    return fields, pos


def _rounding_input():
    """float32 values with every bf16 rounding case: ties to even both
    ways, values just off the ties, subnormals, +-0, +-inf, NaN, the
    largest finite floats (which round to inf) and seeded random bits."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2 ** 16, 512, dtype=np.uint64).astype(np.uint32)
    ties = np.concatenate([(hi << 16) | 0x8000, (hi << 16) | 0x7FFF,
                           (hi << 16) | 0x8001, (hi << 16) | 0x0001])
    special = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                        0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FBFFFFF,
                        0x00000001, 0x80000001, 0x007FFFFF, 0x00008000,
                        0x00018000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000,
                        0x3F808000, 0x3F818000], np.uint32)
    return np.concatenate([bits, ties, special]).view(np.float32)


# ---------------------------------------------------------------------------
# the JAX side (child process)
# ---------------------------------------------------------------------------


def _jax_samplers(kind):
    """sample3_fast (one field) and sample3_multi (two) with bf16 windows
    at `kind`'s sampler inputs, plain and dual."""
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.core import grids as jgrids
    from gpufluidsimulation_tpu.ops import interp_fast as jfast

    out = {}
    fields, pos = _sample_inputs(kind)
    jpos = [jnp.asarray(p) for p in pos]
    off = jgrids.Grid3D(*SHAPE, H).off_of(kind)
    for dual in (False, True):
        out[f"fast_{int(dual)}"] = np.asarray(jfast.sample3_fast(
            jnp.asarray(fields[0]), *jpos, H, off, Rr=2, interpret=True,
            dtype=jnp.bfloat16, dual=dual))
        out[f"multi_{int(dual)}"] = np.asarray(jfast.sample3_multi(
            jnp.asarray(fields), *jpos, H, (off, off), Rr=2, interpret=True,
            dtype=jnp.bfloat16, dual=dual))
    return out


def _jax_stages(part):
    """One part of the stage references: "round" (XLA's rounding and the
    DMC identity peel, float32 whatever the mode), "marches" (both maps
    from the identity and from a displaced map), "semilag" or
    "minmax"."""
    import jax.numpy as jnp

    from gpufluidsimulation_tpu import config
    from gpufluidsimulation_tpu.core import grids as jgrids
    from gpufluidsimulation_tpu.ops import advect as jadvect
    from gpufluidsimulation_tpu.ops import interp_fast as jfast

    out = {}
    mg, _, vel, cfldt, ident, maps = _march_setup()
    vel = [jnp.asarray(a) for a in vel]
    cfldt = jnp.float32(cfldt)
    if part == "round":
        x = _rounding_input()
        out["round"] = np.asarray(
            jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
        ).view(np.uint32)
        out["peel"] = np.stack([np.asarray(a) for a in
                                jadvect.dmc_backward_identity_3d(
                                    mg, *vel, cfldt)])
        return out
    with config.engine_mode_scope(config.EngineMode(
            fast_interp=True, interp_interpret=True, interp_bf16=True)):
        if part == "marches":
            for start, m in (("ident", ident), ("maps", maps)):
                m = tuple(jnp.asarray(a) for a in m)
                for march, fn in (("fwd", jadvect.update_forward_map_3d),
                                  ("bwd", jadvect.update_backward_map_3d)):
                    out[f"{march}_{start}"] = np.stack([
                        np.asarray(a) for a in fn(
                            mg, *vel, m, cfldt, MARCH_DT,
                            from_identity=start == "ident")])
        elif part == "semilag":
            for kind in ("c", "u"):
                out[f"semilag_{kind}"] = np.stack([
                    np.asarray(a) for a in jadvect.semilag_multi_3d(
                        mg, kind,
                        [jnp.asarray(f) for f in _march_fields(kind)],
                        *vel, cfldt, -MARCH_DT)])
        else:
            jg = jgrids.Grid3D(*SHAPE, H)
            for kind in ("c", "w"):
                fields, pos = _sample_inputs(kind)
                out[f"minmax_{kind}"] = np.stack([np.stack([
                    np.asarray(a) for a in jfast.minmax3_fast(
                        jnp.asarray(f), *(jnp.asarray(p) for p in pos), H,
                        jg.off_of(kind), Rr=2, interpret=True)])
                    for f in fields])
    return out


def _march_fields(kind):
    """Two unit-normal fields (the second x50) on `kind`'s lattice of the
    march inputs."""
    shape = grids.Grid3D(*_MARCH_SHAPE, _MARCH_H).shape_of(kind)
    return [_noise(shape, 40, 1.0), _noise(shape, 41, 50.0)]


def _jax_cfg(scheme, bf16=True):
    from gpufluidsimulation_tpu import config
    from gpufluidsimulation_tpu.scenes.scenes3d import vortex_collision_config
    from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
    from gpufluidsimulation_tpu.solvers.smoke3d import Emitter3D

    return vortex_collision_config(
        ni=N, nj=N, nk=N, scheme=JScheme(int(scheme)), dt=8.0 / N,
        emitters=(Emitter3D(center=(0.1, 0.1, 0.1), radius=0.04,
                            sign=1.0),),
        proj_tol=1e-4, proj_max_iters=30,
        engine_mode=config.EngineMode(fast_interp=True,
                                      interp_interpret=True,
                                      spectral_poisson=True,
                                      interp_bf16=bf16))


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


def _start_state(state, scheme):
    """The main path starts at rest (the emitter alone makes its flow, as
    in tests/test_torch_smoke3d.py); MACCORMACK from a ball of radius 5
    cells at the box's centre holding a smooth velocity of 0.05 and rho,
    T blobs, at rest outside, so that its one step traces and samples
    non-trivial values."""
    d = _flatten(state)
    if scheme == Scheme.BIMOCQ:
        return d
    for i, key in enumerate(("u", "v", "w", "rho", "T")):
        shape = d[key].shape
        idx = np.meshgrid(*[np.arange(m) - (m - 1) / 2 for m in shape],
                          indexing="ij")
        ball = sum(x * x for x in idx) <= 25.0
        amp = {"rho": 1.0, "T": 50.0}.get(key, 0.05)
        f = _smooth(shape, 60 + i, amp)
        d[key] = np.where(ball, np.abs(f) if key in ("rho", "T") else f,
                          0.0).astype(np.float32)
    return d


def _jax_steps(scheme, steps):
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.solvers.smoke3d import Smoke3D

    cfg = _jax_cfg(scheme)
    solver = Smoke3D(cfg)
    start = _start_state(solver.init_state(), scheme)
    state = solver.init_state()
    state = dataclasses.replace(state, **{
        k: jnp.asarray(v) for k, v in start.items()
        if "." not in k and v.ndim == 3})
    states = [_flatten(state)]
    for _ in range(steps):
        state = solver.step(state)
        states.append(_flatten(state))
    return {f"{k}:{key}": val for k, s in enumerate(states)
            for key, val in s.items()}


STAGE_PARTS = ("round", "marches", "semilag", "minmax")


def _jax_run(name):
    if name in STAGE_PARTS:
        return _jax_stages(name)
    if name.startswith("samplers_"):
        return _jax_samplers(name.split("_", 1)[1])
    if name == "main":
        return _jax_steps(Scheme.BIMOCQ, 3)
    if name == "maccormack":
        return _jax_steps(Scheme.MACCORMACK, 1)
    raise KeyError(name)


def _stage(tmp_path_factory, part):
    """A part of the stage references (a child each, shared by the
    workers)."""
    return jax_oracle.shared(tmp_path_factory, __file__, part)[part]


def _states(tmp_path_factory, name):
    flat = jax_oracle.shared(tmp_path_factory, __file__, name)[name]
    states = {}
    for key, val in flat.items():
        k, field = key.split(":", 1)
        states.setdefault(int(k), {})[field] = val
    return [states[k] for k in sorted(states)]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf(a):
    return _t(a).to(torch.bfloat16)


def test_rounding_matches_xla(tmp_path_factory):
    """torch's float32 -> bfloat16 rounding is XLA's convert, bit for bit:
    round to nearest even, subnormals kept, inf and NaN kept, the largest
    floats to inf."""
    x = _rounding_input()
    got = _t(x).to(torch.bfloat16).float().numpy().view(np.uint32)
    want = _stage(tmp_path_factory, "round")["round"]
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(got.view(np.float32)[nan]).all()
    assert np.isnan(want.view(np.float32)[nan]).all()
    assert (got[~nan] != x.view(np.uint32)[~nan]).mean() > 0.9


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_samplers_match_jax_bf16(tmp_path_factory, kind, dual):
    """``trilerp_sample`` on bf16 fields against ``sample3_fast`` (one
    field) and ``sample3_multi`` (two) with bf16 windows (one child a
    kind)."""
    name = f"samplers_{kind}"
    want_all = jax_oracle.shared(tmp_path_factory, __file__, name)[name]
    fields, pos = _sample_inputs(kind)
    off = grids.Grid3D(*SHAPE, H).off_of(kind)
    tpos = [_t(p) for p in pos]
    got = interp_fast.trilerp_sample(_bf(fields), *tpos, H, (off, off),
                                     dual=dual).numpy()
    f32 = interp_fast.trilerp_sample(_t(fields), *tpos, H, (off, off),
                                     dual=dual).numpy()
    one = interp_fast.trilerp_sample(_bf(fields[:1]), *tpos, H, (off,),
                                     dual=dual).numpy()
    np.testing.assert_array_equal(one[0], got[0])
    for want, chans in ((want_all[f"fast_{int(dual)}"][None], 1),
                        (want_all[f"multi_{int(dual)}"], 2)):
        for c in range(chans):
            tol = SAMPLE_TOL * float(np.abs(fields[c]).max())
            np.testing.assert_allclose(got[c], want[c], rtol=0, atol=tol)
            assert float(np.abs(f32[c] - want[c]).max()) >= 100 * tol


_MARCH_SHAPE = (16, 20, 24)     # tests/test_torch_advect.py's inputs
_MARCH_H = 0.2 / _MARCH_SHAPE[0]


def _march_inputs(bf16):
    """The port's grid, float32 faces, window (``advect.window_faces``),
    cfldt, identity and displaced map on the march inputs."""
    _, tg, vel, cfldt, ident, maps = _march_setup()
    u, v, w = (_t(a) for a in vel)
    return (tg, (u, v, w), advect.window_faces(u, v, w, bf16), cfldt,
            ident, maps)


@pytest.mark.parametrize("start", ["ident", "maps"])
@pytest.mark.parametrize("march", ["fwd", "bwd"])
def test_marches_match_jax_bf16(tmp_path_factory, march, start):
    """The forward (``rk3_substep``, its lattice mode from the identity)
    and backward (``dmc_substep``, the float32 peel from the identity)
    marches on the bf16 faces against ``trace_rk3_fused`` and
    ``dmc_substep_fast`` on the JAX bf16 MAC pack, 3 substeps. The
    forward march's float32 miss is 26 times the tolerance, not 100: see
    the module's docstring."""
    fn = (advect.update_forward_map_3d if march == "fwd"
          else advect.update_backward_map_3d)
    want = _stage(tmp_path_factory, "marches")[f"{march}_{start}"]
    results = {}
    for bf16 in (True, False):
        tg, vel, window, cfldt, ident, maps = _march_inputs(bf16)
        m = ident if start == "ident" else maps
        assert len(advect.substeps(cfldt, MARCH_DT)) == 3
        results[bf16] = torch.stack(fn(
            tg, *vel, tuple(_t(a) for a in m), cfldt, MARCH_DT,
            from_identity=start == "ident", window=window)).numpy()
    np.testing.assert_allclose(results[True], want, rtol=0, atol=POS_TOL)
    ratio = 100 if march == "bwd" else 25
    assert float(np.abs(results[False] - want).max()) >= ratio * POS_TOL


@pytest.mark.parametrize("kind", ["c", "u"])
def test_semilag_matches_jax_bf16(tmp_path_factory, kind):
    """The semi-Lagrangian trace (the lattice mode, its stage 1 from the
    float32 faces) and the bf16 samples of the traced fields."""
    fields = _march_fields(kind)
    want = _stage(tmp_path_factory, "semilag")[f"semilag_{kind}"]
    results = {}
    for bf16 in (True, False):
        tg, vel, window, cfldt, _, _ = _march_inputs(bf16)
        results[bf16] = torch.stack(advect.semilag_multi_3d(
            tg, kind, [_t(f) for f in fields], *vel, cfldt, -MARCH_DT,
            window)).numpy()
    for c, f in enumerate(fields):
        tol = FIELD_TOL * float(np.abs(f).max())
        np.testing.assert_allclose(results[True][c], want[c], rtol=0,
                                   atol=tol)
        assert float(np.abs(results[False][c] - want[c]).max()) >= 20 * tol


@pytest.mark.parametrize("kind", ["c", "w"])
def test_minmax_matches_jax_bf16(tmp_path_factory, kind):
    """``minmax_sample`` on bf16 fields (its sample mode, as MacCormack's
    trace clamp calls it) against ``minmax3_fast`` with bf16 windows, and
    its samples against ``trilerp_sample``'s."""
    fields, pos = _sample_inputs(kind)
    off = grids.Grid3D(*SHAPE, H).off_of(kind)
    tpos = [_t(p) for p in pos]
    mn, mx, smp = interp_fast.minmax_sample(_bf(fields), *tpos, H,
                                            (off, off), sample=True)
    mn32, mx32 = interp_fast.minmax_sample(_t(fields), *tpos, H, (off, off))
    assert torch.equal(smp, interp_fast.trilerp_sample(
        _bf(fields), *tpos, H, (off, off)))
    want = _stage(tmp_path_factory, "minmax")[f"minmax_{kind}"]  # (C, 2, ..)
    for c in range(2):
        for got, f32, w in ((mn, mn32, want[c, 0]), (mx, mx32, want[c, 1])):
            np.testing.assert_allclose(got[c].numpy(), w, rtol=0, atol=1e-6)
            assert float(np.abs(f32[c].numpy() - w).max()) >= 100 * 1e-6


def test_identity_peel_reads_float32(tmp_path_factory):
    """One backward substep from the identity in the bf16 mode is the
    float32 peel (``dmc_substep_lattice`` on the unrounded faces), as the
    JAX package's ``dmc_backward_identity_3d`` (the bound of
    tests/test_torch_advect.py, 1e-6 world); the same peel of the
    rounded faces misses it by over 100 times that. The lattice mode
    refuses bf16 faces."""
    tg, vel, window, cfldt, _, _ = _march_inputs(True)
    got = torch.stack(advect.update_backward_map_3d(
        tg, *vel, None, cfldt, cfldt, from_identity=True,
        window=window)).numpy()
    peel = _stage(tmp_path_factory, "round")["peel"]
    np.testing.assert_allclose(got, peel, rtol=0, atol=1e-6)
    rounded = torch.stack(advect.dmc_backward_identity_3d(
        tg, *(f.float() for f in window), cfldt)).numpy()
    assert float(np.abs(rounded - peel).max()) >= 100 * 1e-6
    with pytest.raises(ValueError, match="float32"):
        interp_fast.dmc_substep_lattice(
            *window, float(advect._sh(cfldt, tg.h)),
            interp_fast.dmc_threshold(tg.h), tg.h)


def _port_steps(jcfg_dict, states, steps, bf16):
    cfg = convert.config_from_dict(jcfg_dict)
    if not bf16:
        cfg = dataclasses.replace(cfg, engine_mode=dataclasses.replace(
            cfg.engine_mode, interp_bf16=None))
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    st = convert.state_from_numpy(states[0], cfg, "cpu")
    out = []
    for _ in range(steps):
        st = solver.step(st)
        out.append(convert.state_to_numpy(st))
    return out


def _field_errors(got, want, fields):
    """Per field: (max abs error, share of values off by more than
    FIELD_TOL), both of the field's scale."""
    out = {}
    for key in fields:
        if key in want:
            err = (np.abs(got[key].astype(np.float64) - want[key])
                   / max(float(np.abs(want[key]).max()), 1e-3))
            out[key] = (float(err.max()), float((err > FIELD_TOL).mean()))
    return out


@pytest.mark.parametrize("scheme,steps", [(Scheme.BIMOCQ, 3),
                                          (Scheme.MACCORMACK, 1)])
def test_whole_steps_match_jax_bf16(tmp_path_factory, scheme, steps):
    """The port's bf16 steps against the JAX bf16 steps at 16^3: the main
    path (BiMocq, per-frame reinit, dual form) for 3 steps and one
    MACCORMACK step; see the module's docstring for the bound. Frame and
    ``proj_iters`` equal, ``interp_overflow`` 0. The port's float32 steps
    miss the bf16 references: more than FLIP_SHARE of some field's values
    off by more than 1e-4 of its scale."""
    name = "main" if scheme == Scheme.BIMOCQ else "maccormack"
    states = _states(tmp_path_factory, name)
    jcfg = dataclasses.asdict(_jax_cfg(scheme))
    cfg = convert.config_from_dict(jcfg)
    assert cfg.engine_mode.interp_bf16 is True
    got = _port_steps(jcfg, states, steps, True)
    for k in range(1, steps + 1):
        want = states[k]
        assert int(want["interp_overflow"]) == 0
        for key, (err, share) in _field_errors(got[k - 1], want,
                                               STEP_FIELDS).items():
            assert err <= FIDELITY and share <= FLIP_SHARE, (k, key, err,
                                                            share)
        for key in ("frame", "proj_iters"):
            assert int(got[k - 1][key]) == int(want[key]), (k, key)
    assert float(states[-1]["rho"].max()) > 0
    f32 = _port_steps(jcfg, states, steps, False)
    worst = max(share for _, share in _field_errors(
        f32[-1], states[-1], STEP_FIELDS).values())
    assert worst > 10 * FLIP_SHARE


def test_convert_carries_interp_bf16():
    """``convert`` carries interp_bf16 across where the JAX package's
    window samplers run (fast_interp None or True, or under a mesh) and
    drops it where its exact engine rounds nothing (fast_interp False)."""
    for fast, want in ((None, True), (True, True), (False, None)):
        em = convert._engine_mode(dict(fast_interp=fast, interp_bf16=True))
        assert em.interp_bf16 is want, fast
    em = convert._engine_mode(dict(interp_bf16=False))
    assert em.interp_bf16 is False and not em.bf16
    em = convert._engine_mode(dict(fast_interp=False, interp_bf16=True,
                                   sharded_sampling=(_Mesh(2), 2)))
    assert em.interp_bf16 is True


class _Mesh:
    def __init__(self, size):
        self.size = size


def _vortex(mode, **kw):
    from gpufluidsimulation_tpu_torch.scenes import scenes3d

    return dataclasses.replace(
        scenes3d.vortex_collision_config(ni=8, nj=8, nk=8), engine_mode=mode,
        **kw)


@pytest.mark.parametrize("path", ["vol9", "sharded_mode", "sharded_step",
                                  "2d"])
def test_unported_bf16_paths_raise(path):
    """vol9, a sharded mesh, ``sharded_step`` and the 2D solver raise
    NotImplementedError naming interp_bf16: none computes float32 where
    the JAX package would round."""
    with pytest.raises(NotImplementedError, match="interp_bf16"):
        if path == "vol9":
            smoke3d.Smoke3D(_vortex(tconfig.EngineMode(
                volume_vol9=True, interp_bf16=True)), device="cpu")
        elif path == "sharded_mode":
            smoke3d.Smoke3D(_vortex(tconfig.EngineMode(
                sharded_sampling=(2, 2), interp_bf16=True)), device="cpu")
        elif path == "sharded_step":
            from gpufluidsimulation_tpu_torch.parallel import sharding

            solver = smoke3d.Smoke3D(_vortex(tconfig.EngineMode(
                interp_bf16=True)), device="cpu")
            sharding.sharded_step(solver, sharding.make_mesh(
                2, devices=["cpu"] * 2), halo=2)
        else:
            from gpufluidsimulation_tpu_torch.solvers import smoke2d

            cfg = smoke2d.Smoke2DConfig(
                ni=16, nj=16, L=1.0,
                engine_mode=tconfig.EngineMode(interp_bf16=True))
            smoke2d.Smoke2D(cfg, device="cpu")


@pytest.mark.parametrize("scheme", [Scheme.BIMOCQ, Scheme.SEMILAG,
                                    Scheme.MACCORMACK, Scheme.MAC_REFLECTION])
def test_every_3d_scheme_steps_in_bf16(scheme):
    """Every 3D scheme steps on the CPU in the bf16 mode, with the exact
    and prefilter volume forms and the counter, adaptive and blended
    BiMocq modes, and reads bfloat16 in its samplers."""
    from gpufluidsimulation_tpu_torch.scenes import scenes3d

    modes = [tconfig.EngineMode(interp_bf16=True)]
    if scheme == Scheme.BIMOCQ:
        modes += [tconfig.EngineMode(interp_bf16=True, volume_exact=True),
                  tconfig.EngineMode(interp_bf16=True, volume_dual=False)]
    for mode in modes:
        for extra in ({}, dict(reinit_mode="adaptive", blend_coeff=0.5)):
            if extra and scheme != Scheme.BIMOCQ:
                continue
            cfg = dataclasses.replace(
                scenes3d.vortex_collision_config(ni=8, nj=8, nk=8),
                scheme=scheme, engine_mode=mode, **extra)
            solver = smoke3d.Smoke3D(cfg, device="cpu")
            st = solver.init_state()
            st = dataclasses.replace(st, **{
                k: _t(_smooth(tuple(getattr(st, k).shape), 70 + i, 0.05))
                for i, k in enumerate(("u", "v", "w"))})
            seen = []
            orig = interp_fast.trilerp_sample_plain

            def spy(fields, *a, **k):
                seen.append(fields.dtype)
                return orig(fields, *a, **k)

            interp_fast.trilerp_sample_plain = spy
            try:
                for _ in range(2):
                    st = solver.step(st)
            finally:
                interp_fast.trilerp_sample_plain = orig
            assert torch.isfinite(st.u).all() and torch.isfinite(st.rho).all()
            assert torch.bfloat16 in seen, (scheme, mode, extra)


@pytest.mark.parametrize("example", [0, 1])
def test_sim3d_cli_runs_bf16(tmp_path, example):
    """``sim3d --interp-bf16`` runs the bf16 mode (the vortex scene and
    the obstacle scene with its semi-Lagrangian fallbacks) on the CPU:
    its samplers read bfloat16 and its frames are finite."""
    from gpufluidsimulation_tpu_torch import cli
    from gpufluidsimulation_tpu_torch.io_utils.volume import read_volume

    seen = []
    orig = interp_fast.trilerp_sample_plain

    def spy(fields, *a, **k):
        seen.append(fields.dtype)
        return orig(fields, *a, **k)

    interp_fast.trilerp_sample_plain = spy
    try:
        assert cli.main(["sim3d", "0", "--example", str(example), "--res",
                         "8", "--frames", "2", "--device", "cpu",
                         "--interp-bf16", "--out", str(tmp_path)]) == 0
    finally:
        interp_fast.trilerp_sample_plain = orig
    assert torch.bfloat16 in seen
    frame = next(tmp_path.glob("0-*-Gpu/0002.*"))
    dense, _ = read_volume(str(frame))
    assert np.isfinite(dense).all() and float(np.abs(dense).max()) > 0


for _name in (STAGE_PARTS + tuple(f"samplers_{k}" for k in KINDS)
              + ("main", "maccormack")):
    jax_oracle.prefetch(__file__, _name)


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
