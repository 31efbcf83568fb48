"""The port's sharded path (``parallel/``) against the JAX package's, and
against the port's own single-device functions.

Against JAX (one child process that the pytest-xdist workers share,
tests/jax_oracle.shared, with 8 virtual CPU devices), at the shapes and
tolerances of tests/test_sharding.py: ``laplacian_sharded`` (both
boundary conditions) and ``jacobi_smooth_sharded``, the sampled
``sample3_fast_sharded`` and ``sample3_multi_sharded`` (JAX's window
kernels in interpret mode), the halo-contract count on positions pushed
past the halo, and one whole ``sharded_step`` on 8 devices
(``fast_sampling=False``, 16^3, always reinit, 2 steps; the JAX package's
CPU defaults: the exact volume form and the Jacobi-smoothed MG-PCG)
within rtol 2e-4 and atol 2e-5.

Bit for bit against the port's own single-device functions: the halo
Laplacian and Jacobi, the sharded V-cycle, the slab marches from the
identity and from a displaced map, and whole sharded steps (dual and
prefilter forms, always and adaptive reinit, the spectral projection or
MG-PCG with ``EngineMode(rbgs=False)``, whose V-cycle smooths with the
same Jacobi as ``ShardedMGContext``). The port's sharded path runs on a
mesh of repeated CPU devices, in one process.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch import config, convert
from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
from gpufluidsimulation_tpu_torch.ops import poisson
from gpufluidsimulation_tpu_torch.parallel import (
    halo, sharded_interp, sharding)
from gpufluidsimulation_tpu_torch.parallel.sharding import (
    ShardedMGContext, make_mesh, shard_state, sharded_step)
from gpufluidsimulation_tpu_torch.scenes import scenes3d
from gpufluidsimulation_tpu_torch.solvers import smoke3d
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from tests import jax_oracle

STEP_FIELDS = ("u", "v", "w", "rho", "T")
CONTRACT_HALO = 8


def _mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _sample_inputs():
    """tests/test_sharding.py's sampler inputs: the single field (12, 16,
    64) at h 0.1 with off (0, 0.5, 0), smooth displacements reaching 2.5
    cells in z; the two fields (8, 16, 32) at h 0.05."""
    shape = (12, 16, 64)
    h, off = 0.1, (0.0, 0.5, 0.0)
    field = _rand(shape, 11)
    node = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32)
                                  for s in shape], indexing="ij"))
    disp = [np.cos(0.2 * node[0] + 0.3 * node[1] + 0.1 * node[2] + k)
            for k in range(3)]
    fast = dict(field=field, h=h, off=off, pos=[
        ((node[a] + off[a] + s * disp[a]) * h).astype(np.float32)
        for a, s in enumerate((1.1, 1.7, 2.5))])
    shape = (8, 16, 32)
    node = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32)
                                  for s in shape], indexing="ij"))
    h = 0.05
    multi = dict(fields=_rand((2,) + shape, 12), h=h,
                 offs=((0.0, 0.0, 0.0), (0.5, 0.0, 0.5)), pos=[
                     ((node[0] + 0.8 * np.sin(0.3 * node[2])) * h),
                     ((node[1] + 1.2 * np.cos(0.25 * node[0])) * h),
                     ((node[2] + 2.0 * np.sin(0.2 * node[1])) * h)])
    multi["pos"] = [p.astype(np.float32) for p in multi["pos"]]
    return fast, multi


def _contract_positions():
    """z positions of the (12, 16, 64) lattice at h 0.1 pushed up to 11
    cells, past the halo of 8 in part, and the dual form's 0.25 margin
    straddled: displacements on 7.75 and 8 exactly, and one ulp around."""
    shape = (12, 16, 64)
    k = np.arange(shape[2], dtype=np.float32)
    rng = np.random.default_rng(13)
    d = rng.uniform(-11.0, 11.0, shape).astype(np.float32)
    d.reshape(-1)[:8] = [7.75, -7.75, 8.0, -8.0, 7.7501, 8.0001, -8.0001,
                         0.0]
    return ((k + d) * np.float32(0.1)).astype(np.float32)


def _step_cfg(reinit="always"):
    from gpufluidsimulation_tpu.scenes.scenes3d import vortex_collision_config
    from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
    from gpufluidsimulation_tpu.solvers.smoke3d import Emitter3D

    cfg = vortex_collision_config(
        ni=16, nj=16, nk=16, scheme=JScheme.BIMOCQ, dt=0.01,
        emitters=(Emitter3D(center=(0.05, 0.1, 0.1), radius=0.03,
                            sign=1.0),),
        viscosity=0.0, proj_tol=1e-6, proj_max_iters=60)
    return dataclasses.replace(cfg, reinit_mode=reinit)


# ---------------------------------------------------------------------------
# The JAX child
# ---------------------------------------------------------------------------


def _jax_run(name):
    import jax
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.ops import interp_fast, poisson as jpoisson
    from gpufluidsimulation_tpu.parallel import halo as jhalo
    from gpufluidsimulation_tpu.parallel import sharded_interp as jsi
    from gpufluidsimulation_tpu.parallel.sharding import (
        make_mesh as jmesh, shard_state as jshard, sharded_step as jstep)
    from gpufluidsimulation_tpu.solvers.smoke3d import Smoke3D as JSmoke3D

    assert len(jax.devices()) >= 8
    out = {}
    p = _rand((6, 6, 16), 1)
    for bc in ("neumann", "dirichlet"):
        out[f"laplacian#{bc}"] = np.asarray(jhalo.laplacian_sharded(
            jnp.asarray(p), jmesh(8), bc))
    shape = (6, 6, 8)
    b = _rand(shape, 2)
    diag = np.asarray(jpoisson._diag(shape, "dirichlet"))
    out["jacobi"] = np.asarray(jhalo.jacobi_smooth_sharded(
        jnp.zeros(shape, jnp.float32), jnp.asarray(b), jmesh(4), "dirichlet",
        jnp.asarray(diag), iters=5))
    fast, multi = _sample_inputs()
    out["sample_fast"] = np.asarray(jsi.sample3_fast_sharded(
        jnp.asarray(fast["field"]), *map(jnp.asarray, fast["pos"]),
        fast["h"], fast["off"], jmesh(8), halo=8, interpret=True))
    out["sample_multi"] = np.asarray(jsi.sample3_multi_sharded(
        jnp.asarray(multi["fields"]), *map(jnp.asarray, multi["pos"]),
        multi["h"], multi["offs"], jmesh(4), halo=8, interpret=True))
    pz = jnp.asarray(_contract_positions())
    for dual in (False, True):
        with interp_fast.overflow_sink() as sink:
            jsi._halo_contract_count(pz, 0.1, (0.0, 0.5), CONTRACT_HALO,
                                     dual)
        out[f"contract#{dual}"] = np.asarray(sink[0])
    solver = JSmoke3D(_step_cfg())
    step = jstep(solver, jmesh(8), halo_smoother=True, fast_sampling=False)
    s = jshard(solver.init_state(), jmesh(8))
    for _ in range(2):
        s = step(s)
    for key in STEP_FIELDS + ("proj_iters",):
        out[f"step#{key}"] = np.asarray(getattr(s, key))
    out["step#vel_map.bwd"] = np.asarray(s.vel_map.bwd)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__,
                             "sharding")["sharding"]


# ---------------------------------------------------------------------------
# Against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
def test_laplacian_sharded_matches_jax_and_poisson(ref, bc):
    p = torch.from_numpy(_rand((6, 6, 16), 1))
    got = halo.laplacian_sharded(p, _mesh(8), bc)
    np.testing.assert_allclose(got.numpy(), ref[f"laplacian#{bc}"],
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got, poisson.laplacian(p, bc))


def test_jacobi_smooth_sharded_matches_jax_and_poisson(ref):
    shape = (6, 6, 8)
    b = torch.from_numpy(_rand(shape, 2))
    diag = torch.from_numpy(poisson._diag(shape, "dirichlet"))
    x0 = torch.zeros(shape)
    got = halo.jacobi_smooth_sharded(x0, b, _mesh(4), "dirichlet", diag, 5)
    np.testing.assert_allclose(got.numpy(), ref["jacobi"], rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(got, poisson.jacobi_smooth(x0, b, "dirichlet", diag,
                                                  5))


def test_sharded_samplers_match_jax(ref):
    """The slab launches against JAX's per-shard window kernels
    (interpret mode), at test_sharding.py's tolerance; and bit for bit
    against the port's whole-grid trilerp_sample (every displacement sits
    inside the halo)."""
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    fast, multi = _sample_inputs()
    pos = [torch.from_numpy(q) for q in fast["pos"]]
    field = torch.from_numpy(fast["field"])
    counts = []
    got = sharded_interp.sample3_fast_sharded(
        field, *pos, fast["h"], fast["off"], _mesh(8), halo=8, counts=counts)
    np.testing.assert_allclose(got.numpy(), ref["sample_fast"], rtol=1e-3,
                               atol=1e-4)
    assert torch.equal(got, interp_fast.trilerp_sample(
        field[None], *pos, fast["h"], (fast["off"],))[0])
    assert [int(c) for c in counts] == [0]
    pos = [torch.from_numpy(q) for q in multi["pos"]]
    fields = torch.from_numpy(multi["fields"])
    got = sharded_interp.sample3_multi_sharded(
        fields, *pos, multi["h"], multi["offs"], _mesh(4), halo=8)
    np.testing.assert_allclose(got.numpy(), ref["sample_multi"], rtol=1e-3,
                               atol=1e-4)
    assert torch.equal(got, interp_fast.trilerp_sample(
        fields, *pos, multi["h"], multi["offs"]))


@pytest.mark.parametrize("dual", [False, True], ids=["plain", "dual"])
def test_halo_contract_count_matches_jax(ref, dual):
    """Positions pushed past the halo: the same count as JAX's sink, and
    the sharded sampler reports it while its slab launches clamp those
    samples (the whole-grid samples differ there)."""
    pz = torch.from_numpy(_contract_positions())
    want = int(ref[f"contract#{dual}"])
    got = sharded_interp._halo_contract_count(pz, 0.1, (0.0, 0.5),
                                              CONTRACT_HALO, dual)
    assert int(got) == want > 0
    shape = pz.shape
    node = torch.meshgrid(*[torch.arange(s, dtype=torch.float32)
                            for s in shape[:2]] + [torch.zeros(1)],
                          indexing="ij")
    px = (node[0].expand(shape) * 0.1).contiguous()
    py = (node[1].expand(shape) * 0.1).contiguous()
    fields = torch.from_numpy(_rand((2,) + tuple(shape), 14))
    counts = []
    out = sharded_interp.sample3_multi_sharded(
        fields, px, py, pz, 0.1, ((0.0, 0.0, 0.0), (0.0, 0.0, 0.5)),
        _mesh(4), halo=CONTRACT_HALO, dual=dual, counts=counts)
    assert [int(c) for c in counts] == [want]
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    whole = interp_fast.trilerp_sample(
        fields, px, py, pz, 0.1, ((0.0, 0.0, 0.0), (0.0, 0.0, 0.5)),
        dual=dual)
    assert not torch.equal(out, whole)


def _port_cfg(jcfg, mode):
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    return dataclasses.replace(cfg, engine_mode=mode)


def test_sharded_step_matches_jax_on_8_devices(ref):
    """The whole step through sharded_step on 8 devices, fast sampling
    off, against JAX's: the exact volume form and MG-PCG whose V-cycle the
    halo Jacobi smooths, 2 steps at 16^3."""
    mode = config.EngineMode(volume_exact=True, spectral_poisson=False,
                             rbgs=False)
    solver = smoke3d.Smoke3D(_port_cfg(_step_cfg(), mode), device="cpu")
    mesh = _mesh(8)
    step = sharded_step(solver, mesh, halo_smoother=True,
                        fast_sampling=False)
    s = shard_state(solver.init_state(), mesh)
    for _ in range(2):
        s = step(s)
    for key in STEP_FIELDS:
        np.testing.assert_allclose(getattr(s, key).numpy(),
                                   ref[f"step#{key}"], rtol=2e-4, atol=2e-5,
                                   err_msg=key)
    np.testing.assert_allclose(s.vel_map.bwd.numpy(), ref["step#vel_map.bwd"],
                               rtol=1e-5, atol=1e-6)
    assert s.proj_iters == int(ref["step#proj_iters"])
    assert s.interp_overflow == 0


# ---------------------------------------------------------------------------
# Bit for bit against the port's single-device functions
# ---------------------------------------------------------------------------


def test_sharded_vcycle_equals_the_jacobi_vcycle():
    """ShardedMGContext on 16^3 over 4 slabs (levels 16, 8 and 4 planes:
    halo Jacobi on the first two, plain Jacobi on the coarsest) and on
    16x16x8 over 8 (every level plain) equals MGContext(rbgs=False)."""
    for shape, D in (((16, 16, 16), 4), ((16, 16, 8), 8)):
        for bc in ("dirichlet", "neumann"):
            r = torch.from_numpy(_rand(shape, 3))
            ctx = ShardedMGContext(shape, bc, _mesh(D))
            want = poisson.MGContext(shape, bc, "cpu", rbgs=False).v_cycle(r)
            assert torch.equal(ctx.v_cycle(r), want)


def _displaced_state(cfg):
    """A state after one single-device step, maps and velocities live."""
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    return solver, solver.step(solver.init_state())


@pytest.mark.parametrize("from_identity", [True, False],
                         ids=["identity", "displaced"])
def test_slab_marches_equal_the_single_device_march(from_identity):
    """update_mapping_3d_sharded against update_mapping_3d on 16x16x32
    over 4 slabs of 8 (halo 8) and 8 slabs of 4 (halo 4): both maps bit
    for bit, nothing counted."""
    cfg = scenes3d.vortex_collision_config(ni=16, nj=16, nk=32,
                                           scheme=Scheme.BIMOCQ, dt=0.02,
                                           reinit_mode="counter")
    solver, s = _displaced_state(cfg)
    g = solver.grid
    maxvel = smoke3d._max_velocity(s.u, s.v, s.w)
    cfldt = np.float32(np.float32(g.h) / maxvel)
    dt = float(np.float32(2.5) * cfldt)      # 3 CFL substeps
    maps = s.vel_map
    if from_identity:
        maps = mp.init_mapping(g, device="cpu")
    want = mp.update_mapping_3d(maps, g, s.u, s.v, s.w, cfldt, dt,
                                from_identity=from_identity)
    assert len(smoke3d.substeps(cfldt, dt)) == 3
    for D, hl in ((4, 8), (8, 4)):
        counts = []
        got = sharded_interp.update_mapping_3d_sharded(
            maps, g, s.u, s.v, s.w, cfldt, dt, _mesh(D), hl,
            from_identity=from_identity, counts=counts)
        assert torch.equal(got.bwd, want.bwd) and torch.equal(got.fwd,
                                                              want.fwd)
        assert [int(c) for c in counts] == [0]


# (reinit mode, blend, engine mode); the adaptive and counter cases
# reinitialize after every step (gaps 0), the counter case blends the
# level-2 pull-back in
CASES = {
    "dual-always-spectral": ("always", 1.0, config.EngineMode()),
    "dual-adaptive-spectral": ("adaptive", 1.0, config.EngineMode()),
    "prefilter-counter-blend-mgpcg": ("counter", 0.5, config.EngineMode(
        volume_dual=False, spectral_poisson=False, rbgs=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_the_single_device_step(case):
    """2 steps of sharded_step (fast sampling on: the marches and the u,
    v and cell-kind samples through the slab kernels; 4 slabs, halo 4;
    the halo-smoothed V-cycle with MG-PCG) against Smoke3D.step, every
    field, map and counter bit for bit."""
    reinit, blend, mode = CASES[case]
    jcfg = dataclasses.replace(_step_cfg(reinit), vel_reinit_gap=0,
                               scalar_reinit_gap=0, blend_coeff=blend)
    cfg = _port_cfg(jcfg, mode)
    solver = smoke3d.Smoke3D(cfg, device="cpu")
    want = solver.init_state()
    mesh = _mesh(4)
    step = sharded_step(solver, mesh, fast_sampling=True, halo=4)
    got = shard_state(solver.init_state(), mesh)
    for _ in range(2):
        want = solver.step(want)
        got = step(got)
    a, b = convert.state_to_numpy(got), convert.state_to_numpy(want)
    assert list(a) == list(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert got.interp_overflow == 0
    if reinit != "always":
        assert got.vel_map.reinit_count > 0
        assert got.vel_map.bwd_prev is not None


def test_step_checked_recomputes_a_frame_past_the_halo():
    """With a halo of 1 plane, samples leave the halo contract: the
    sharded step counts them into interp_overflow. With w moving 3 cells
    a step and a halo of 2, the forward march's nodes also leave their
    velocity slabs: the slab kernels count those they clamped into
    slab_clamped. In both, step_checked recomputes the frame with sharded
    sampling off, from the same input state: the single-device step's
    bits."""
    jcfg = dataclasses.replace(_step_cfg(), dt=0.05)
    cfg = _port_cfg(jcfg, config.EngineMode())
    plain = smoke3d.Smoke3D(cfg, device="cpu")
    state = plain.step(plain.init_state())
    fast = dataclasses.replace(state, w=torch.full_like(
        state.w, 3 * cfg.grid.h / cfg.dt))
    mesh = _mesh(4)
    for start, hl, clamps in ((state, 1, False), (fast, 2, True)):
        sharded = smoke3d.Smoke3D(dataclasses.replace(
            cfg, engine_mode=config.EngineMode(sharded_sampling=(mesh, hl))),
            device="cpu")
        past = sharded.step(start)
        assert past.interp_overflow > 0
        assert (past.slab_clamped > 0) == clamps
        got, retried = sharded.step_checked(start)
        want = plain.step(start)
        assert retried and got.interp_overflow == got.slab_clamped == 0
        for key in STEP_FIELDS:
            assert torch.equal(getattr(got, key), getattr(want, key)), key
        assert plain.step_checked(start)[1] is False


def test_vol9_under_a_mesh_raises():
    mesh = _mesh(4)
    mode = config.EngineMode(volume_vol9=True, sharded_sampling=(mesh, 4))
    with pytest.raises(ValueError, match="vol9.*not sharded"):
        mode.volume_mode
    # the exact and prefilter forms take precedence over vol9, as in JAX
    assert dataclasses.replace(mode, volume_exact=True).volume_mode == "exact"
    assert dataclasses.replace(mode, volume_dual=False).volume_mode == (
        "prefilter")
    assert dataclasses.replace(mode, sharded_sampling=()).volume_mode == "vol9"
    cfg = dataclasses.replace(
        scenes3d.vortex_collision_config(ni=16, nj=16, nk=16,
                                         scheme=Scheme.BIMOCQ),
        engine_mode=config.EngineMode(volume_vol9=True))
    step = sharded_step(smoke3d.Smoke3D(cfg, device="cpu"), mesh,
                        fast_sampling=True, halo=4)
    with pytest.raises(ValueError, match="vol9.*not sharded"):
        step(smoke3d.init_state(cfg, "cpu"))


def test_convert_carries_a_sharded_mode():
    """JAX's (mesh, halo) becomes (mesh size, halo): as many slabs on the
    device of the solver built from the config, with the same halo;
    under it fast_interp=False keeps the dual form (JAX samples with its
    window kernels there); () stays off; a mesh the port cannot build
    raises."""
    from gpufluidsimulation_tpu import config as jconfig
    from gpufluidsimulation_tpu.parallel.sharding import make_mesh as jmesh

    jmode = jconfig.EngineMode(fast_interp=False,
                               sharded_sampling=(jmesh(8), 4))
    mode = convert._engine_mode(vars(jmode))
    assert mode.sharded_sampling == (8, 4)
    assert mode.volume_mode == "dual" and mode.rbgs is False
    ss = sharded_interp.Sampling.of(mode, torch.device("cpu"))
    assert ss.halo == 4 and ss.mesh.size == 8
    assert set(ss.mesh.devices) == {torch.device("cpu")}
    off = convert._engine_mode(vars(dataclasses.replace(
        jmode, sharded_sampling=())))
    assert off.sharded_sampling == () and off.volume_mode == "exact"

    class NoMesh:
        size = 0

    with pytest.raises(NotImplementedError, match="sharded_sampling"):
        convert._engine_mode(dict(sharded_sampling=(NoMesh(), 4)))


def test_converted_sharded_config_steps_on_the_solvers_device():
    """A config converted from a sharded JAX mode builds its mesh on the
    device of the solver that runs it: its step equals the single-device
    step bit for bit, with the slab kernels' routing on."""
    cfg = _port_cfg(_step_cfg(), convert._engine_mode(
        dict(sharded_sampling=(make_mesh(4, devices=["cpu"] * 4), 4))))
    assert cfg.engine_mode.sharded_sampling == (4, 4)
    sharded = smoke3d.Smoke3D(cfg, device="cpu")
    plain = smoke3d.Smoke3D(dataclasses.replace(
        cfg, engine_mode=config.EngineMode()), device="cpu")
    got = sharded.step(sharded.init_state())
    want = plain.step(plain.init_state())
    a, b = convert.state_to_numpy(got), convert.state_to_numpy(want)
    for key in b:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_a_mesh_off_the_solvers_device_raises():
    """A mesh must live on the solver's device: a CPU solver under a mesh
    of cards, or of a card home, is refused when the solver is built and
    when a step routes its samples; make_mesh refuses a mix of device
    types."""
    cards = sharding.Mesh((torch.device("cuda", 0),) * 4)
    mixed = sharding.Mesh((torch.device("cpu"),) + cards.devices[1:])
    cfg = _step_cfg()
    for mesh in (cards, mixed):
        mode = config.EngineMode(sharded_sampling=(mesh, 4))
        with pytest.raises(ValueError, match="solver's device"):
            smoke3d.Smoke3D(_port_cfg(cfg, mode), device="cpu")
        with pytest.raises(ValueError, match="solver's device"):
            sharded_interp.Sampling.of(mode, torch.device("cpu"))
    solver = smoke3d.Smoke3D(_port_cfg(cfg, config.EngineMode()),
                             device="cpu")
    step = smoke3d._STEPS[solver.cfg.scheme]
    bad = dataclasses.replace(solver.cfg, engine_mode=config.EngineMode(
        sharded_sampling=(cards, 4)))
    with pytest.raises(ValueError, match="solver's device"):
        step(bad, solver.grid, solver.ctx, None, solver.init_state())
    with pytest.raises(ValueError, match="mix device types"):
        make_mesh(2, devices=["cpu", "cuda:0"])


def test_a_card_without_an_index_is_the_current_card(monkeypatch):
    """'cuda' resolves to the current card's 'cuda:i', so a mesh made of
    'cuda' slabs has the home that a solver on 'cuda' (or on the default
    device) runs on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    dev = config.resolve_device("cuda")
    assert dev == torch.device("cuda", 0) == config.resolve_device(None)
    mesh = make_mesh(4, devices=["cuda"] * 4)
    assert mesh.devices == (torch.device("cuda", 0),) * 4
    sharding.check_placement(mesh, dev, "test")


def test_make_mesh_needs_cards_or_devices():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices requested"):
            make_mesh(2)
    mesh = make_mesh(3, devices=["cpu"] * 5)
    assert mesh.size == 3 and mesh.home == torch.device("cpu")
    with pytest.raises(RuntimeError):
        make_mesh(3, devices=["cpu"])
    # a step whose solver is not on the mesh's home device is refused
    solver = smoke3d.Smoke3D(scenes3d.vortex_collision_config(
        ni=8, nj=8, nk=8, scheme=Scheme.BIMOCQ), device="cpu")
    with pytest.raises(ValueError):
        sharded_step(solver, dataclasses.replace(
            mesh, devices=(torch.device("meta"),) * 3))


jax_oracle.prefetch(__file__, "sharding")


if __name__ == "__main__":
    # 8 virtual CPU devices, before jax is imported; in front of the
    # child's flags, since XLA stops reading them at their last token,
    # which has no leading dashes
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    jax_oracle.serve(_jax_run)
