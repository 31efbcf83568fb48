"""The port's bf16 mode (``EngineMode.interp_bf16``) on the vol9 form, the
z-slab sharded step and the 2D solver, against the JAX package's bf16
field windows.

The JAX side runs ``EngineMode(fast_interp=True, interp_interpret=True,
interp_bf16=True)``, its Pallas kernels in interpret mode, in child
processes shared by the workers (``tests/jax_oracle.shared``), with 8
virtual CPU devices; the port runs its plain versions (CPU tensors), on
the sharded path over meshes of 8 repeated CPU devices, halo 2, as
tests/test_torch_sharding.py sets them. The JAX package does not round
the same reads on every path, and each test pins where it does and where
it does not:

* vol9 (40x32x24, tests/test_torch_vol9.py's fields and map): the vol9
  pull-back stage (the dual launch and the fixup's composition) samples
  bf16 fields, the decision reads the float32 ones, so the flagged block
  channels equal JAX's; values within 1e-5 of scale. No whole vol9 bf16
  step is held against JAX here: its child would run JAX's vol9 step
  outside jit, as tests/test_torch_vol9.py's does (~280 s for 3 steps),
  beyond this file's budget; the bf16 vol9 step is held against the CPU
  port on the card by chip_smoke.py (phase 14) and steps here.
* sharded (16^3): the slab samplers round the kinds whose z extent
  divides the mesh (c, u) and sample the z-staggered w whole in float32
  (JAX gathers it exactly); the forward march reads the bf16 pack in
  every stage, its first substep from the identity too (the JAX sharded
  march has no identity peel), and the backward march reads the float32
  faces: the port's bf16 backward map equals its float32 one bit for bit.
* 2D (24x40): every field sample rounds (semi-Lagrangian, MacCormack,
  BFECC, the BiMocq pull-back, correction and accumulate); the velocity,
  the maps, MacCormack's corner min/max and the particle transfers do
  not: a FLIP step in the bf16 mode is the float32 step bit for bit.

Each comparison states its tolerance, and the port's float32 result
misses the JAX bf16 result by at least 100 times it, or the test names
the exception and its measured factor. The exceptions: the forward
marches (bf16 moves a position by at most ~0.4% of its displacement, a
cell and a half here, so the float32 march misses by 16-20 times the
2e-6 world tolerance of tests/test_torch_bf16.py's marches) and the
2D correction (it samples half the difference of two fields, whose
rounding is a small part of the corrected field: the float32 miss is
70-99 times the tolerance). Whole steps round fields that the step
computed, where round-off between the implementations can move a value
to the neighbouring bf16 value (the docstring of
tests/test_torch_bf16.py): each field is held within 2e-3 of its scale
at every value and within 1e-4 of its scale at all but FLIP_SHARE of its
values (3D: 0.5%; 2D: 2%, since on the 24x40 grid one such value is
0.1% of a field and the global projection moves its neighbours past
1e-4 too: 2 MacCormack steps measured 1.2%, from 2 values of 1000
rounded the other way after the first trace), ``interp_overflow`` 0;
and the port's float32 steps miss 1e-4 at more than 10 times (2D: 5
times) FLIP_SHARE of some field's values (measured: 22%; 2D 17% and
81%).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch import config as tconfig
from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
from gpufluidsimulation_tpu_torch.core import grids
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from gpufluidsimulation_tpu_torch.parallel import sharded_interp
from gpufluidsimulation_tpu_torch.parallel.sharding import (
    make_mesh, shard_state, sharded_step)
from gpufluidsimulation_tpu_torch.solvers import smoke2d, smoke3d
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from tests import jax_oracle

SAMPLE_TOL = 1e-5        # of the field's scale (a stage of rounded inputs)
POS_TOL = 2e-6           # world (the marches)
FIELD_TOL = 1e-4         # of the field's scale (semilag; whole steps)
FLIP_SHARE = 5e-3        # share of a field's values a step may move past it
FLIP_SHARE_2D = 2e-2     # ... on the 24x40 grid (the module's docstring)
FIDELITY = 2e-3          # of the field's scale, at every value

# vol9: tests/test_torch_vol9.py's grid, fields and maps
VOL9_SHAPE = (40, 32, 24)
VOL9_H = 0.2 / VOL9_SHAPE[0]
# (kind, clamp, channels, band_lo, band_hi): the advect stage of c, the
# error stage of v
VOL9_STAGES = (("c", 1.0, 2, 2, 3), ("v", 0.0, 1, 1, 2))

# sharded: 8 slabs of 2 planes, halo 2
SHARD_N = 16
SHARD_H = 0.2 / SHARD_N
DEVICES = 8
HALO = 2
SHARD_STEPS = 2

# 2D
NI, NJ = 24, 40
H2 = 1.0 / NI
DT2 = np.float32(0.25)      # ~1.2 cells: 2 CFL substeps
STEPS_2D = 2
# the stages' kinds: the cell lattice and a face lattice (v mirrors u)
STAGE_KINDS_2D = ("c", "u")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU tensors under six workers: one torch thread a test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smooth(shape, seed, amp):
    """amp * a normalised sum of two random-phase sine modes."""
    rng = np.random.default_rng(seed)
    idx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(2):
        k = rng.uniform(0.5, 2.0, len(shape)) * 2 * np.pi / np.array(shape)
        f += np.sin(sum(kk * ii for kk, ii in zip(k, idx))
                    + rng.uniform(0, 2 * np.pi))
    return (amp * f / np.abs(f).max()).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scale_err(got, want):
    """max |got - want| over the scale of `want`."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(float(np.abs(want).max()), 1e-6)
    return float(np.abs(got.astype(np.float64) - want).max()) / scale


def _field_errors(got, want):
    """(max error, share of values off by more than FIELD_TOL), both of
    the field's scale."""
    err = (np.abs(np.asarray(got, np.float64) - want)
           / max(float(np.abs(want).max()), 1e-3))
    return float(err.max()), float((err > FIELD_TOL).mean())


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _vol9_fields(kind, C, seed):
    """tests/test_torch_vol9.py's fields: a constant with a rough patch
    (channel 0 at the high-x end, channel 1, scale 50, at the low-x end),
    so that some decision blocks are flat and keep the dual form."""
    shape = grids.Grid3D(*VOL9_SHAPE, VOL9_H).shape_of(kind)
    rng = np.random.default_rng(seed)
    out = []
    for c in range(C):
        f = np.full(shape, (1.0, 50.0)[c], np.float32)
        patch = (slice(34, None) if c == 0 else slice(0, 6), slice(4, 20),
                 slice(3, 21))
        f[patch] += (1.0, 50.0)[c] * rng.random(f[patch].shape).astype(
            np.float32)
        out.append(f)
    return np.stack(out)


def _displaced_map(shape, h, seed, amp):
    """The identity map of a `shape` cell grid plus smooth displacements
    of up to `amp` cells."""
    ident = [p.numpy() for p in grids.Grid3D(*shape, h).node_coords("c")]
    return np.stack([p + _smooth(p.shape, seed + i, amp * h)
                     for i, p in enumerate(ident)]).astype(np.float32)


def _shard_inputs():
    """16^3: the faces (amplitude 0.06, ~1 cell a CFL substep), two cell
    fields and one of each face kind, the kinds' lattices displaced by up
    to a cell (inside the halo), the CFL substep and a dt of 1.5 of them
    (2 substeps)."""
    g = grids.Grid3D(SHARD_N, SHARD_N, SHARD_N, SHARD_H)
    d = {f"vel_{a}": _smooth(s, 1 + i, 0.06)
         for i, (a, s) in enumerate(zip("uvw", (g.shape_u, g.shape_v,
                                                  g.shape_w)))}
    for i, kind in enumerate(("c", "u", "w")):
        C = 2 if kind == "c" else 1
        d[f"fields_{kind}"] = np.stack([
            _smooth(g.shape_of(kind), 10 + 2 * i + c, (1.0, 50.0)[c])
            for c in range(C)])
        d[f"pos_{kind}"] = np.stack([
            p.numpy() + _smooth(p.shape, 20 + 3 * i + a, SHARD_H)
            for a, p in enumerate(g.node_coords(kind))]).astype(np.float32)
    top = max(float(np.abs(d[f"vel_{a}"]).max()) for a in "uvw")
    d["cfldt"] = np.float32(np.float32(SHARD_H) / np.float32(top))
    d["dt"] = np.float32(np.float32(1.5) * d["cfldt"])
    return d


def _step_cfg_fields():
    """The sharded whole steps' configuration (JAX's field values): the
    main path's BiMocq at 16^3 with tests/test_torch_sharding.py's
    emitter, the spectral projection."""
    return dict(ni=SHARD_N, nj=SHARD_N, nk=SHARD_N, dt=0.01, viscosity=0.0,
                proj_tol=1e-6, proj_max_iters=60)


def _step_start(shapes):
    """The sharded steps' initial velocity (amplitude 0.05), so that the
    first step advects: {name: array} for the faces' `shapes`."""
    return {a: _smooth(shapes[a], 60 + i, 0.05)
            for i, a in enumerate("uvw")}


def _inputs_2d():
    """24x40: velocities of amplitude 0.2 (0.48 cells of dt), a field of
    each kind (amplitudes 1-5), maps displaced by up to 1.2 cells, the CFL
    substep."""
    g = grids.Grid2D(NI, NJ, H2)
    px, py = (c.numpy() for c in g.node_coords("c"))

    def wobbled(seed):
        return np.stack([px + _smooth(px.shape, seed, 1.2 * H2),
                         py + _smooth(py.shape, seed + 1, 1.2 * H2)])

    d = dict(u=_smooth(g.shape_u, 1, 0.2), v=_smooth(g.shape_v, 2, 0.2),
             bwd=wobbled(30), bwd_prev=wobbled(32), fwd=wobbled(34))
    mv = np.float32(max(np.abs(d["u"]).max(), np.abs(d["v"]).max()))
    d["cfldt"] = np.float32(np.float32(H2) / mv)
    for i, kind in enumerate(("c", "u", "v")):
        for j, name in enumerate(("semi", "init", "origin", "d", "d_prev",
                                  "change")):
            d[f"{kind}_{name}"] = _smooth(g.shape_of(kind), 100 + 10 * i + j,
                                          1.0 + j)
    return d


def _start_2d():
    """The 2D steps' initial fields: tests/test_torch_smoke2d.py's."""
    return dict(u=_smooth((NI + 1, NJ), 1, 0.2),
                v=_smooth((NI, NJ + 1), 2, 0.2),
                rho=np.abs(_smooth((NI, NJ), 3, 2.0)),
                T=_smooth((NI, NJ), 4, 1.0))


def _cfg_2d_fields(scheme):
    return dict(ni=NI, nj=NJ, L=1.0, scheme=int(scheme), alpha=0.2,
                beta=0.05, proj_tol=1e-5, proj_max_iters=60,
                vel_remap_gap=2, rho_remap_gap=1)


# ---------------------------------------------------------------------------
# the JAX side (child processes)
# ---------------------------------------------------------------------------


def _jax_mode(**kw):
    from gpufluidsimulation_tpu import config

    return config.EngineMode(fast_interp=True, interp_interpret=True,
                             interp_bf16=True, **kw)


def _flatten(state):
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


def _jax_vol9():
    """sample3_vol9 with bf16 windows at the default tol, each stage's
    flags read from its fixup launch."""
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.core import grids as jgrids
    from gpufluidsimulation_tpu.ops import interp_fast as jif

    jg = jgrids.Grid3D(*VOL9_SHAPE, VOL9_H)
    maps = jnp.asarray(_displaced_map(VOL9_SHAPE, VOL9_H, 50, 0.8))
    fixup, flags = jif._vol9_fixup_padded, []

    def spy(*args, **kw):
        out = fixup(*args, **kw)
        flags.append(np.asarray(out[1]) > 0)
        return out

    jif._vol9_fixup_padded = spy
    out = {}
    for kind, clamp, C, lo, hi in VOL9_STAGES:
        dim = jg.dim_of(kind)
        out[kind] = np.asarray(jif.sample3_vol9(
            jnp.asarray(_vol9_fields(kind, C, 1)), maps, dim, VOL9_H,
            (jg.ni, jg.nj, jg.nk), clamp, clamp, Rr=2, interpret=True,
            dtype=jnp.bfloat16, band=(lo + dim[0], lo + dim[1], lo + dim[2],
                                      hi)))
        out[f"{kind}_flags"] = flags[-1]
    return out


def _jax_sharded():
    """On 8 devices: the dual sharded samplers of c, u and w through the
    mapping module's routing, both marches from the identity and 2 whole
    sharded steps."""
    import jax
    import jax.numpy as jnp

    from gpufluidsimulation_tpu import config
    from gpufluidsimulation_tpu.bimocq import mapping as jmp
    from gpufluidsimulation_tpu.core import grids as jgrids
    from gpufluidsimulation_tpu.parallel import sharded_interp as jsi
    from gpufluidsimulation_tpu.parallel.sharding import (
        make_mesh as jmesh, shard_state as jshard, sharded_step as jstep)
    from gpufluidsimulation_tpu.scenes.scenes3d import vortex_collision_config
    from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
    from gpufluidsimulation_tpu.solvers.smoke3d import Emitter3D
    from gpufluidsimulation_tpu.solvers.smoke3d import Smoke3D as JSmoke3D

    assert len(jax.devices()) >= DEVICES
    mesh = jmesh(DEVICES)
    d = {k: jnp.asarray(v) for k, v in _shard_inputs().items()}
    jg = jgrids.Grid3D(SHARD_N, SHARD_N, SHARD_N, SHARD_H)
    out = {}
    with config.engine_mode_scope(_jax_mode(
            sharded_sampling=(mesh, HALO))):
        assert jmp._volume_mode() == "dual"
        for kind in ("c", "u", "w"):
            out[f"sample_{kind}"] = np.stack([np.asarray(a) for a in (
                jmp._sample_fields_at(jg, kind, list(d[f"fields_{kind}"]),
                                      tuple(d[f"pos_{kind}"]), dual=True))])
    ident = jmp.identity_map_3d(jg)
    config.set_interp_interpret(True)
    with config.engine_mode_scope(_jax_mode()):
        got = jsi.update_mapping_3d_sharded(
            jmp.MappingState(fwd=ident, bwd=ident, bwd_prev=None,
                             reinit_count=jnp.int32(0)), jg, d["vel_u"],
            d["vel_v"], d["vel_w"], d["cfldt"], d["dt"], mesh, halo=HALO)
        out["march_fwd"], out["march_bwd"] = (np.asarray(got.fwd),
                                              np.asarray(got.bwd))
    cfg = vortex_collision_config(
        scheme=JScheme.BIMOCQ, emitters=(Emitter3D(
            center=(0.05, 0.1, 0.1), radius=0.03, sign=1.0),),
        engine_mode=_jax_mode(spectral_poisson=True), **_step_cfg_fields())
    solver = JSmoke3D(cfg)
    step = jstep(solver, mesh, halo_smoother=True, fast_sampling=True,
                 halo=HALO)
    s = solver.init_state()
    s = dataclasses.replace(s, **{k: jnp.asarray(v) for k, v in _step_start(
        {a: getattr(s, a).shape for a in "uvw"}).items()})
    s = jshard(s, mesh)
    for k in range(1, SHARD_STEPS + 1):
        s = step(s)
        out.update({f"step{k}#{key}": v for key, v in _flatten(s).items()})
    return out


def _jax_2d_stages():
    """The 2D stages with bf16 windows: semilag_2d and maccormack_2d of
    each kind, the BiMocq pull-back at blend 0.5, the correction and the
    accumulate."""
    import jax.numpy as jnp

    from gpufluidsimulation_tpu import config
    from gpufluidsimulation_tpu.bimocq import mapping as jm
    from gpufluidsimulation_tpu.core.grids import Grid2D as JGrid2D
    from gpufluidsimulation_tpu.ops import advect as ja

    d = {k: jnp.asarray(v) for k, v in _inputs_2d().items()}
    g = JGrid2D(NI, NJ, H2)
    out = {}
    with config.engine_mode_scope(_jax_mode()):
        for kind in STAGE_KINDS_2D:
            f = {n: d[f"{kind}_{n}"] for n in ("semi", "init", "origin", "d",
                                               "d_prev", "change")}
            out[f"semilag_{kind}"] = ja.semilag_2d(
                g, kind, f["semi"], d["u"], d["v"], None, d["cfldt"], DT2)
            out[f"maccormack_{kind}"] = ja.maccormack_2d(
                g, kind, f["semi"], d["u"], d["v"], d["cfldt"], DT2)
            out[f"advect_{kind}"] = jm.advect_bimocq_2d(
                g, kind, f["semi"], f["init"], f["origin"], f["d"],
                f["d_prev"], d["bwd"], d["bwd_prev"], 0.5)
            out[f"correct_{kind}"] = jm.correct_2d(
                g, kind, f["semi"], f["init"], f["d"], d["fwd"], d["bwd"])
            out[f"accum_{kind}"] = jm.accumulate_2d(
                g, kind, f["d"], f["change"], d["fwd"], 2.0)
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_2d_steps(scheme):
    """States 0..STEPS_2D of one 2D scheme with bf16 windows, jitted: at
    these displacements (~1.2 cells a step) the jitted DMC substep of
    ROADMAP §3 item 3(g) does not bite (the port's backward maps agree
    with it to 5e-6 of scale), and op by op the interpret-mode kernels
    took over 10 minutes."""
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.solvers import smoke2d as js
    from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme

    fields = _cfg_2d_fields(scheme)
    fields["scheme"] = JScheme(fields["scheme"])
    solver = js.Smoke2D(js.Smoke2DConfig(
        **fields, engine_mode=_jax_mode(spectral_poisson=True)))
    st = solver.init_state()
    st = st.replace(**{k: jnp.asarray(v) for k, v in _start_2d().items()})
    out = {}
    for k in range(STEPS_2D + 1):
        out.update({f"{k}#{key}": v for key, v in _flatten(st).items()})
        if k == STEPS_2D:
            break
        st = solver.step(st, DT2)
    return out


def _jax_run(name):
    if name == "vol9":
        return _jax_vol9()
    if name == "sharded":
        return _jax_sharded()
    if name == "stages_2d":
        return _jax_2d_stages()
    if name in ("maccormack_2d", "bimocq_2d"):
        return _jax_2d_steps(Scheme.MACCORMACK if name == "maccormack_2d"
                             else Scheme.BIMOCQ)
    raise KeyError(name)


def _ref(tmp_path_factory, name):
    return jax_oracle.shared(tmp_path_factory, __file__, name)[name]


def _states(flat, steps):
    """States 0..steps from a child's "<k>#<field>" (or "step<k>#...")
    keys."""
    out = [{} for _ in range(steps + 1)]
    for key, val in flat.items():
        if "#" in key:
            k, field = key.split("#", 1)
            out[int(k.removeprefix("step"))][field] = val
    return out


# ---------------------------------------------------------------------------
# vol9
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", VOL9_STAGES, ids=[s[0] for s in VOL9_STAGES])
def test_vol9_stage_matches_jax_bf16(tmp_path_factory, stage):
    """The vol9 pull-back stage (``mapping._vol9_sample``: the dual
    ``trilerp_sample`` launch on the bf16 fields, then ``vol9_fixup``
    sampling them where the float32 decision flags) against JAX's
    ``sample3_vol9`` with bf16 windows at the default tol: values within
    SAMPLE_TOL of scale, the flagged block channels equal (some flagged,
    some not). The port's float32 stage misses by over 100 times the
    tolerance."""
    kind, clamp, C, lo, hi = stage
    want = _ref(tmp_path_factory, "vol9")
    tg = grids.Grid3D(*VOL9_SHAPE, VOL9_H)
    fields = list(_t(_vol9_fields(kind, C, 1)))
    maps = _t(_displaced_map(VOL9_SHAPE, VOL9_H, 50, 0.8))
    stats = interp_fast.vol9_map_stats(maps, tg.h, tg.shape_c)
    flags = []
    decide = interp_fast.vol9_flags

    def spy(*args, **kw):
        flags.append(decide(*args, **kw))
        return flags[-1]

    interp_fast.vol9_flags = spy
    try:
        got = torch.stack(mp._vol9_sample(tg, kind, fields, stats, maps,
                                          clamp, clamp, lo, hi, bf16=True))
        f32 = torch.stack(mp._vol9_sample(tg, kind, fields, stats, maps,
                                          clamp, clamp, lo, hi))
    finally:
        interp_fast.vol9_flags = decide
    assert torch.equal(flags[0], flags[1])
    np.testing.assert_array_equal(flags[0].numpy(), want[f"{kind}_flags"])
    assert flags[0].any() and not flags[0].all()
    for c in range(C):
        err = _scale_err(got[c], want[kind][c])
        assert err <= SAMPLE_TOL, (c, err)
        assert _scale_err(f32[c], want[kind][c]) >= 100 * SAMPLE_TOL, c


# ---------------------------------------------------------------------------
# sharded
# ---------------------------------------------------------------------------


def _mesh():
    return make_mesh(DEVICES, devices=["cpu"] * DEVICES)


def _sampling(bf16):
    """The sharded routing of a step in the bf16 mode or in float32."""
    return sharded_interp.Sampling(_mesh(), HALO, bf16=bf16)


@pytest.mark.parametrize("kind", ["c", "u", "w"])
def test_sharded_samplers_match_jax_bf16(tmp_path_factory, kind):
    """The mapping module's sharded routing of the dual samples in the
    bf16 mode against JAX's: c and u (z extent 16, divided by the mesh)
    through the slab samplers on the bf16 fields, within SAMPLE_TOL of
    scale and the float32 samples over 100 times that off; w (17 planes)
    sampled whole from the float32 fields, as JAX gathers it exactly: the
    bf16 mode's samples equal the float32 mode's bit for bit."""
    want = _ref(tmp_path_factory, "sharded")[f"sample_{kind}"]
    d = _shard_inputs()
    tg = grids.Grid3D(SHARD_N, SHARD_N, SHARD_N, SHARD_H)
    fields = list(_t(d[f"fields_{kind}"]))
    pos = tuple(_t(d[f"pos_{kind}"]))
    slabs = interp_fast.trilerp_sample_plain
    seen = []

    def spy(f, *args, **kw):
        seen.append((f.dtype, kw.get("slab") is not None
                     or (len(args) > 6 and args[6] is not None)))
        return slabs(f, *args, **kw)

    interp_fast.trilerp_sample_plain = spy
    try:
        runs = {bf16: torch.stack(mp._sample_fields_at(
            tg, kind, fields, pos, dual=True, sharded=_sampling(bf16),
            bf16=bf16)) for bf16 in (True, False)}
    finally:
        interp_fast.trilerp_sample_plain = slabs
    if kind == "w":
        assert torch.equal(runs[True], runs[False])
        assert {dt for dt, _ in seen} == {torch.float32}
    else:
        assert (torch.bfloat16, True) in seen
    for c in range(len(fields)):
        err = _scale_err(runs[True][c], want[c])
        assert err <= SAMPLE_TOL, (c, err)
        if kind != "w":
            assert _scale_err(runs[False][c], want[c]) >= 100 * SAMPLE_TOL


def test_sharded_march_matches_jax_bf16(tmp_path_factory):
    """``update_mapping_3d_sharded`` in the bf16 mode from the identity (2
    substeps: the lattice mode, then the displaced one) against JAX's on
    8 devices: the forward map within POS_TOL world of JAX's bf16 march,
    which the port's float32 march misses by 10 times the tolerance or
    more (the exception of the module's docstring; measured 16-20 times
    from the identity and from a displaced map); the backward map reads
    the float32 faces, so it equals the port's float32 sharded march bit
    for bit and JAX's within tests/test_torch_sharding.py's 1e-6 world."""
    ref = _ref(tmp_path_factory, "sharded")
    d = _shard_inputs()
    tg = grids.Grid3D(SHARD_N, SHARD_N, SHARD_N, SHARD_H)
    vel = [_t(d[f"vel_{a}"]) for a in "uvw"]
    window = advect.window_faces(*vel, True)
    ident = torch.stack(tg.node_coords("c"))
    mapping = mp.MappingState(fwd=ident, bwd=ident, bwd_prev=None)
    assert len(advect.substeps(d["cfldt"], d["dt"])) == 2
    runs = {}
    for key, win in (("bf16", window), ("float32", None)):
        counts = []
        runs[key] = sharded_interp.update_mapping_3d_sharded(
            mapping, tg, *vel, d["cfldt"], float(d["dt"]), _mesh(), HALO,
            from_identity=True, counts=counts, window=win)
        assert [int(c) for c in counts] == [0]
    assert torch.equal(runs["bf16"].bwd, runs["float32"].bwd)
    np.testing.assert_allclose(runs["bf16"].bwd.numpy(), ref["march_bwd"],
                               rtol=0, atol=1e-6)
    want = ref["march_fwd"]
    np.testing.assert_allclose(runs["bf16"].fwd.numpy(), want, rtol=0,
                               atol=POS_TOL)
    miss = float(np.abs(runs["float32"].fwd.numpy() - want).max())
    assert miss >= 10 * POS_TOL, miss


def _port_sharded_steps(bf16):
    from gpufluidsimulation_tpu_torch.scenes import scenes3d
    from gpufluidsimulation_tpu_torch.solvers.smoke3d import Emitter3D

    cfg = scenes3d.vortex_collision_config(
        scheme=Scheme.BIMOCQ, emitters=(Emitter3D(
            center=(0.05, 0.1, 0.1), radius=0.03, sign=1.0),),
        engine_mode=tconfig.EngineMode(spectral_poisson=True,
                                       interp_bf16=bf16 or None),
        **_step_cfg_fields())
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    step = sharded_step(solver, _mesh(), halo_smoother=True,
                        fast_sampling=True, halo=HALO)
    s = solver.init_state()
    s = dataclasses.replace(s, **{k: _t(v) for k, v in _step_start(
        {a: tuple(getattr(s, a).shape) for a in "uvw"}).items()})
    s = shard_state(s, _mesh())
    out = []
    for _ in range(SHARD_STEPS):
        s = step(s)
        out.append(s)
    return out


def test_sharded_steps_match_jax_bf16(tmp_path_factory):
    """2 whole sharded bf16 steps (BiMocq, the main path's form, 16^3 on 8
    slabs, halo 2, from a smooth velocity) against JAX's ``sharded_step``
    with bf16 windows: each field within FIDELITY of its scale everywhere
    and FIELD_TOL on all but FLIP_SHARE of its values, ``interp_overflow``
    and ``slab_clamped`` 0; the port's float32 sharded steps miss
    FIELD_TOL at more than 10 times FLIP_SHARE of some field's values."""
    ref = _states(_ref(tmp_path_factory, "sharded"), SHARD_STEPS)
    keys = ("u", "v", "w", "rho", "T", "vel_map.fwd", "vel_map.bwd")
    got = _port_sharded_steps(True)
    for k, s in enumerate(got, start=1):
        flat = convert.state_to_numpy(s)
        assert s.interp_overflow == 0 and s.slab_clamped == 0
        assert int(ref[k]["interp_overflow"]) == 0
        for key in keys:
            err, share = _field_errors(flat[key], ref[k][key])
            assert err <= FIDELITY and share <= FLIP_SHARE, (k, key, err,
                                                            share)
    assert float(ref[-1]["rho"].max()) > 0
    f32 = convert.state_to_numpy(_port_sharded_steps(False)[-1])
    worst = max(_field_errors(f32[key], ref[-1][key])[1] for key in keys)
    assert worst > 10 * FLIP_SHARE, worst


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------


def _port_2d():
    return grids.Grid2D(NI, NJ, H2), {
        k: (_t(v) if isinstance(v, np.ndarray) else v)
        for k, v in _inputs_2d().items()}


@pytest.mark.parametrize("kind", STAGE_KINDS_2D)
def test_2d_stages_match_jax_bf16(tmp_path_factory, kind):
    """The 2D stages in the bf16 mode against JAX's with bf16 windows, at
    SAMPLE_TOL of scale: semilag_2d and maccormack_2d (their traces,
    float32 in both, agree to round-off at these displacements), the
    BiMocq pull-back (blend 0.5), the correction and the accumulate; the
    float32 stages over 100 times off, the correction over 50 times (the
    module's docstring)."""
    want = _ref(tmp_path_factory, "stages_2d")
    g, d = _port_2d()
    f = {n: d[f"{kind}_{n}"] for n in ("semi", "init", "origin", "d",
                                       "d_prev", "change")}

    def run(bf16):
        return {
            "semilag": advect.semilag_2d(g, kind, f["semi"], d["u"], d["v"],
                                         None, d["cfldt"], DT2, bf16),
            "maccormack": advect.maccormack_2d(g, kind, f["semi"], d["u"],
                                               d["v"], d["cfldt"], DT2,
                                               bf16),
            "advect": mp.advect_bimocq_2d(
                g, kind, f["semi"], f["init"], f["origin"], f["d"],
                f["d_prev"], d["bwd"], d["bwd_prev"], 0.5, bf16),
            "correct": mp.correct_2d(g, kind, f["semi"], f["init"], f["d"],
                                     d["fwd"], d["bwd"], bf16),
            "accum": mp.accumulate_2d(g, kind, f["d"], f["change"], d["fwd"],
                                      2.0, bf16)}

    got, f32 = run(True), run(False)
    for stage in got:
        ref = want[f"{stage}_{kind}"]
        err = _scale_err(got[stage], ref)
        assert err <= SAMPLE_TOL, (stage, err)
        ratio = 50 if stage == "correct" else 100
        assert _scale_err(f32[stage], ref) >= ratio * SAMPLE_TOL, stage


def test_2d_maccormack_minmax_reads_float32():
    """MacCormack's clamp in the bf16 mode: the trace's foot samples read
    the rounded fields and its corner min/max the float32 ones (the JAX
    package's exact gathers of the unrounded field), in one trace: the
    min/max equal the float32 trace's bit for bit, the samples its
    samples of the rounded fields."""
    g, d = _port_2d()
    fields = [d["c_semi"], d["c_init"]]
    common = (d["u"], d["v"], g.h, advect.trace_substeps(d["cfldt"], -DT2),
              interp_fast.Lattice2D(g.shape_c, g.OFF_C))
    got = advect._semilag_2d_at(g, "c", fields, d["u"], d["v"], d["cfldt"],
                                DT2, minmax=True, bf16=True)
    f32 = interp_fast.bilerp_trace(*common, fields, g.OFF_C, minmax=True)
    rounded = interp_fast.bilerp_trace(
        *common, [f.to(torch.bfloat16).float() for f in fields], g.OFF_C,
        minmax=True)
    assert torch.equal(got.min, f32.min) and torch.equal(got.max, f32.max)
    assert torch.equal(got.samples, rounded.samples)
    assert not torch.equal(got.samples, f32.samples)
    with pytest.raises(ValueError, match="minmax_fields"):
        interp_fast.bilerp_trace(*common, [f.to(torch.bfloat16)
                                           for f in fields], g.OFF_C,
                                 minmax=True)


def _port_2d_steps(scheme, start, bf16):
    fields = _cfg_2d_fields(scheme)
    fields["engine_mode"] = dict(fast_interp=True, spectral_poisson=True,
                                 interp_bf16=bf16)
    cfg = convert.config_2d_from_dict(fields)
    assert bool(cfg.engine_mode.interp_bf16) == bf16
    solver = smoke2d.Smoke2D(cfg, device="cpu")
    st = convert.state_from_numpy(start, cfg, "cpu")
    out = []
    for _ in range(STEPS_2D):
        st = solver.step(st, DT2)
        out.append(convert.state_to_numpy(st))
    return out


@pytest.mark.parametrize("name", ["maccormack_2d", "bimocq_2d"])
def test_2d_steps_match_jax_bf16(tmp_path_factory, name):
    """2 whole 2D steps in the bf16 mode (MACCORMACK, and BIMOCQ with
    remap gaps 2 and 1) against JAX's with bf16 windows, from
    tests/test_torch_smoke2d.py's start at dt 0.25: each field within
    FIDELITY of its scale everywhere and FIELD_TOL on all but
    FLIP_SHARE_2D of its values, every counter equal; the port's float32
    steps miss FIELD_TOL at more than 5 times FLIP_SHARE_2D of some
    field's values."""
    scheme = Scheme.MACCORMACK if name == "maccormack_2d" else Scheme.BIMOCQ
    states = _states(_ref(tmp_path_factory, name), STEPS_2D)
    got = _port_2d_steps(scheme, states[0], True)
    keys = [k for k in ("u", "v", "rho", "T", "u_init", "v_init", "du", "dv",
                        "vel_map.fwd", "vel_map.bwd", "scalar_map.fwd",
                        "scalar_map.bwd") if k in states[0]]
    for k in range(1, STEPS_2D + 1):
        for key in keys:
            err, share = _field_errors(got[k - 1][key], states[k][key])
            assert err <= FIDELITY and share <= FLIP_SHARE_2D, (k, key, err,
                                                               share)
        for key in ("frame", "last_remeshing", "rho_last_remeshing",
                    "total_resample_count", "total_scalar_resample",
                    "interp_overflow"):
            assert int(got[k - 1][key]) == int(states[k][key]), (k, key)
    f32 = _port_2d_steps(scheme, states[0], False)[-1]
    worst = max(_field_errors(f32[key], states[-1][key])[1] for key in keys)
    assert worst > 5 * FLIP_SHARE_2D, worst


def test_2d_flip_step_rounds_nothing():
    """A FLIP step in the bf16 mode is the float32 step bit for bit: the
    particle transfers read float32 (the JAX package's exact sample2 on
    particle positions), and no field sample of the grid schemes runs."""
    states = {}
    for bf16 in (True, False):
        cfg = smoke2d.Smoke2DConfig(
            ni=NI, nj=NJ, L=1.0, scheme=Scheme.FLIP, alpha=0.2, beta=0.05,
            engine_mode=tconfig.EngineMode(interp_bf16=bf16 or None))
        solver = smoke2d.Smoke2D(cfg, device="cpu")
        st = convert.state_from_numpy(dict(
            convert.state_to_numpy(solver.init_state()), **_start_2d()),
            cfg, "cpu")
        st = solver.sample_particles_from_grid(st)
        for _ in range(2):
            st = solver.step(st, DT2)
        states[bf16] = convert.state_to_numpy(st)
    for key, val in states[False].items():
        np.testing.assert_array_equal(states[True][key], val, err_msg=key)


def test_convert_and_sim2d_carry_interp_bf16(tmp_path):
    """``convert.config_2d_from_dict`` carries a 2D interp_bf16 across (not
    where JAX's fast_interp is off); ``sim2d --interp-bf16`` runs the bf16
    mode on the CPU (MacCormack on the Taylor vortex, 1 frame): its
    samples read bfloat16 and its frame is written."""
    from gpufluidsimulation_tpu_torch import cli

    base = _cfg_2d_fields(Scheme.BIMOCQ)
    for fast, want in ((True, True), (None, True), (False, None)):
        cfg = convert.config_2d_from_dict(dict(base, engine_mode=dict(
            fast_interp=fast, interp_bf16=True)))
        assert cfg.engine_mode.interp_bf16 is want, fast
    seen = []
    orig = interp_fast.bilerp_trace_plain

    def spy(u, v, h, subs, start, fields=(), *a, **k):
        seen.extend(f.dtype for f in fields)
        return orig(u, v, h, subs, start, fields, *a, **k)

    interp_fast.bilerp_trace_plain = spy
    try:
        assert cli.main(["sim2d", "1", "0", "--frames", "1", "--device",
                         "cpu", "--interp-bf16", "--out",
                         str(tmp_path)]) == 0
    finally:
        interp_fast.bilerp_trace_plain = orig
    assert torch.bfloat16 in seen
    assert list(tmp_path.glob("*/*/vort_0000.bmp"))


for _name in ("sharded", "vol9", "stages_2d", "maccormack_2d", "bimocq_2d"):
    jax_oracle.prefetch(__file__, _name)


if __name__ == "__main__":
    # 8 virtual CPU devices, before jax is imported; in front of the
    # child's flags, since XLA stops reading them at their last token
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    jax_oracle.serve(_jax_run)
