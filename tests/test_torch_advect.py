"""The port's map marches and extrema clamp against the JAX package.

The JAX side runs its production numerics on the CPU: the fused Pallas
DMC and RK3 kernels in interpret mode under
``EngineMode(fast_interp=True, interp_interpret=True)``. The port runs its
plain versions (CPU tensors). Both march the same float32 substep
schedule (3 substeps here). Tolerances: the window kernels work in
padded window-local coordinates and hat weights, the port in cell-lattice
grid coordinates with clamped trilerps; positions agree to float32
round-off of ~20-cell coordinates carried through 3 substeps, measured
up to 7e-7 world (6e-5 cells); the bound is 2e-6 world (1.6e-4 cells).
The non-identity map is displaced by at most 0.3 cells so that the JAX
window kernels stay inside their reach contract (beyond it they clip taps
and report it through interp_overflow; the port has no such clipping).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.core import grids as jgrids
from gpufluidsimulation_tpu.ops import advect as jadvect
from gpufluidsimulation_tpu_torch.core import grids, interp
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast

SHAPE = (16, 20, 24)
H = 0.2 / SHAPE[0]
DT = 8.0 / SHAPE[0]
FAST = config.EngineMode(fast_interp=True, interp_interpret=True)
POS_ATOL = 2e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The displacements' 1 - exp(-q) cancels for small q, so one ulp of
    exp moves them by up to ~4e-4 cells. With several threads, a process's
    first CPU torch.exp of a few thousand elements (split into chunks of
    2048 across the threads) now and then rounds the chunks of the other
    threads one ulp apart from every later call, after JAX has run in the
    process; one thread computes every call alike."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smooth(shape, seed, amp):
    rng = np.random.default_rng(seed)
    idx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(2):
        k = rng.uniform(0.5, 2.0, 3) * 2 * np.pi / np.array(shape)
        f += np.sin(sum(kk * ii for kk, ii in zip(k, idx))
                    + rng.uniform(0, 2 * np.pi))
    return (amp * f / 2).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup():
    jg = jgrids.Grid3D(*SHAPE, H)
    tg = grids.Grid3D(*SHAPE, H)
    vel = [_smooth(s, i, 0.06) for i, s in
           enumerate((jg.shape_u, jg.shape_v, jg.shape_w))]
    maxvel = max(float(np.abs(a).max()) for a in vel)
    cfldt = np.float32(np.float32(H) / np.float32(maxvel))
    ident = [np.asarray(p) for p in jg.node_coords("c")]
    # a developed map: identity displaced smoothly by up to 0.3 cells,
    # inside the JAX window kernels' reach contract
    maps = [(p + _smooth(p.shape, 10 + i, 0.3 * H)).astype(np.float32)
            for i, p in enumerate(ident)]
    return jg, tg, vel, cfldt, ident, maps


def test_substep_schedule_matches_while_loop():
    _, _, _, cfldt, _, _ = _setup()
    subs = advect.substeps(cfldt, DT)
    assert len(subs) == 3
    t = np.float32(0)
    for s in subs:
        t = np.float32(t + s)
    assert t >= np.float32(DT)
    # a cfldt that divides dt leaves no sliver substep
    assert len(advect.substeps(np.float32(0.25), 0.5)) == 2


@pytest.mark.parametrize("from_identity", [True, False])
def test_backward_map_matches_jax(from_identity):
    jg, tg, vel, cfldt, ident, maps = _setup()
    start = ident if from_identity else maps
    with config.engine_mode_scope(FAST):
        want = jadvect.update_backward_map_3d(
            jg, *(jnp.asarray(a) for a in vel),
            tuple(jnp.asarray(m) for m in start), jnp.float32(cfldt), DT,
            from_identity=from_identity)
    got = advect.update_backward_map_3d(
        tg, *map(_t, vel), tuple(map(_t, start)), cfldt, DT,
        from_identity=from_identity)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=POS_ATOL)
    moved = max(float(np.abs(a.numpy() - s).max()) for a, s in zip(got, start))
    assert moved > 0.5 * H     # the march really displaced the map


@pytest.mark.parametrize("from_identity", [True, False])
def test_forward_map_matches_jax(from_identity):
    jg, tg, vel, cfldt, ident, maps = _setup()
    start = ident if from_identity else maps
    with config.engine_mode_scope(FAST):
        want = jadvect.update_forward_map_3d(
            jg, *(jnp.asarray(a) for a in vel),
            tuple(jnp.asarray(m) for m in start), jnp.float32(cfldt), DT,
            from_identity=from_identity)
    got = advect.update_forward_map_3d(
        tg, *map(_t, vel), tuple(map(_t, start)), cfldt, DT,
        from_identity=from_identity)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=POS_ATOL)
    moved = max(float(np.abs(a.numpy() - s).max()) for a, s in zip(got, start))
    assert moved > 0.5 * H


def test_identity_peel_and_displacements_match_jax():
    """The XLA identity peel and the DMC displacements are the same float32
    arithmetic on both sides; 1 - exp(-q) cancels for small q, so an ulp
    of exp (XLA's and PyTorch's differ) grows to ~3e-5 relative in the
    displacement (measured 2.3e-5 cells): bounds 1e-4 cells, 1e-6 world."""
    jg, tg, vel, cfldt, _, _ = _setup()
    jvel = [jnp.asarray(a) for a in vel]
    want = jadvect.dmc_backward_identity_3d(jg, *jvel, jnp.float32(cfldt))
    got = advect.dmc_backward_identity_3d(tg, *map(_t, vel), cfldt)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    want = jadvect.dmc_displacements_3d(jg, *jvel, jnp.float32(cfldt))
    got = advect.dmc_displacements_3d(tg, *map(_t, vel), cfldt)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_dmc_step_matches_jax_exact_path():
    """One DMC substep of a displaced map against the JAX XLA step
    (exact gathers). That step writes the exponential update in world
    units as (1 - exp(-a*dt))*vel/a: the cancellation of 1 - exp for
    small a*dt rounds differently from the kernel's form, up to ~1e-3
    cells (measured 8.6e-6 world); bound 2e-5 world."""
    jg, tg, vel, cfldt, _, maps = _setup()
    with config.engine_mode_scope(config.EngineMode(fast_interp=False)):
        want = jadvect.dmc_backward_step_3d(
            jg, *(jnp.asarray(a) for a in vel),
            *(jnp.asarray(m) for m in maps), jnp.float32(cfldt))
    got = advect.dmc_backward_step_3d(tg, *map(_t, vel), *map(_t, maps),
                                      cfldt)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5)


def test_trace_rk3_step_matches_jax_exact_path():
    jg, tg, vel, cfldt, _, maps = _setup()
    dt = float(cfldt)
    with config.engine_mode_scope(config.EngineMode(fast_interp=False)):
        want = jadvect.trace_rk3_3d(*(jnp.asarray(a) for a in vel), H, dt,
                                    *(jnp.asarray(m) for m in maps))
    got = advect.trace_rk3_3d(tg, *map(_t, vel), dt, *map(_t, maps))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=POS_ATOL)


@pytest.mark.parametrize("shape", [SHAPE, (17, 20, 24)])
def test_clamp_extrema_neighborhood_matches_jax(shape):
    before = _smooth(shape, 5, 1.0) + np.random.default_rng(6).standard_normal(
        shape).astype(np.float32) * 0.1
    after = before + np.random.default_rng(7).standard_normal(
        shape).astype(np.float32) * 0.5
    want = jadvect.clamp_extrema_neighborhood(jnp.asarray(before),
                                              jnp.asarray(after))
    got = advect.clamp_extrema_neighborhood(_t(before), _t(after))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_marches_on_cpu_launch_no_kernel():
    _, tg, vel, cfldt, ident, _ = _setup()
    counts = (interp_fast.rk3_substep.launches,
              interp_fast.dmc_substep.launches)
    advect.update_backward_map_3d(tg, *map(_t, vel), tuple(map(_t, ident)),
                                  cfldt, DT, from_identity=True)
    advect.update_forward_map_3d(tg, *map(_t, vel), tuple(map(_t, ident)),
                                 cfldt, DT, from_identity=True)
    assert (interp_fast.rk3_substep.launches,
            interp_fast.dmc_substep.launches) == counts == (0, 0)


def _property_geometry():
    """The inputs of the JAX package's DMC property test
    (``tests/test_interp_fast.py::test_dmc_substep_property_random_geometry``)
    at the example it fails on: 28 x 10 x 128 cells, h 0.1, phase 0,
    substep 0.0625."""
    nx, ny, nz, h, phase = 28, 10, 128, 0.1, 0.0
    jg = jgrids.Grid3D(nx, ny, nz, h)
    i = np.arange(nx + 1)[:, None, None]
    j = np.arange(ny + 1)[None, :, None]
    k = np.arange(nz + 1)[None, None, :]
    u = np.broadcast_to(np.sin(2 * np.pi * j[:, :ny, :] / ny + phase)
                        * np.cos(2 * np.pi * k[..., :nz] / nz),
                        (nx + 1, ny, nz)).astype(np.float32)
    v = np.broadcast_to(np.cos(2 * np.pi * i[:nx] / nx + phase)
                        * np.sin(2 * np.pi * k[..., :nz] / nz),
                        (nx, ny + 1, nz)).astype(np.float32)
    w = np.broadcast_to(np.sin(2 * np.pi * i[:nx] / nx + phase)
                        * np.cos(2 * np.pi * j[:, :ny, :] / ny),
                        (nx, ny, nz + 1)).astype(np.float32)
    px, py, pz = jg.node_coords("c")
    maps = [px + 0.3 * h * jnp.sin(px / (nx * h) * 2 * np.pi + phase),
            py + 0.2 * h * jnp.cos(py / (ny * h) * 2 * np.pi),
            pz + 0.25 * h * jnp.sin(pz / (nz * h) * 2 * np.pi)]
    return jg, [np.ascontiguousarray(a) for a in (u, v, w)], [
        np.asarray(m) for m in maps], 0.0625


def test_dmc_step_at_the_jax_property_tests_failing_example():
    """The port's DMC substep where the JAX package's DMC property test
    fails. Against the JAX DMC kernel (interpret mode) it holds at
    POS_ATOL (measured 1.9e-6 world: 2 ulp of the 12.8 z coordinates).
    Against the JAX exact step run op by op (``jax.disable_jit()``) it
    holds at the exact-path bound 2e-5 world (measured 6.7e-6) on every
    cell whose upwind neighbour both pick alike. Phase 0 puts stagnation
    lines of v and w on the lattice (cos(2 pi 21/28) is -1.8e-16, not 0):
    there the op-by-op exact path's trilinear velocity at the cell centre
    (p/h is not exactly i, so its weights are not exactly 1/2) rounds to
    the other sign than the face average of the kernel and the port, takes
    the other upwind cell and moves the map by up to 0.1 cell. Those cells
    alone fail the property test; the jitted step agrees with the kernel
    there (measured 5.4e-4 world, inside the test's 2.5e-3)."""
    import jax

    from gpufluidsimulation_tpu.core import interp as jinterp
    from gpufluidsimulation_tpu.ops import interp_fast as jfast

    jg, vel, maps, sub = _property_geometry()
    h = jg.h
    tg = grids.Grid3D(*jg.shape_c, h)
    got = advect.dmc_backward_step_3d(tg, *map(_t, vel), *map(_t, maps), sub)
    got = [a.numpy() for a in got]
    u, v, w = (jnp.asarray(a) for a in vel)
    packed = jnp.stack([
        jnp.pad(u, ((0, 0), (0, 1), (0, 1)), mode="edge"),
        jnp.pad(v, ((0, 1), (0, 0), (0, 1)), mode="edge"),
        jnp.pad(w, ((0, 1), (0, 1), (0, 0)), mode="edge")])
    packed = jfast.pad_fields(packed, jg.shape_c, 2)
    kernel = jfast.dmc_substep_fast(packed, jnp.stack(maps), sub, h,
                                    jg.shape_c, Rr=2, interpret=True)
    for a, b in zip(got, kernel):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=POS_ATOL)
    with config.engine_mode_scope(config.EngineMode(fast_interp=False)):
        with jax.disable_jit():
            step = jadvect.dmc_backward_step_3d(jg, u, v, w, *(
                jnp.asarray(m) for m in maps), sub)
            centre = jinterp.mac_velocity_3d(u, v, w, *jg.node_coords("c"),
                                             h)
    # cells where the exact path's centre velocity takes another sign than
    # the face average
    faces = interp.mac_velocity_at_c_3d(*map(_t, vel))
    flipped = np.zeros(jg.shape_c, bool)
    for a, b in zip(faces, centre):
        flipped |= (a.numpy() > 0) != (np.asarray(b) > 0)
    assert flipped.any()
    off = 0.0
    for a, b, k in zip(got, step, kernel):
        b, k = np.asarray(b), np.asarray(k)
        np.testing.assert_allclose(a[~flipped], b[~flipped], rtol=0,
                                   atol=2e-5)
        off = max(off, float(np.abs(k - b)[flipped].max()))
    # where the signs differ the op-by-op step leaves the kernel by more
    # than the property test's tolerance (0.025 h)
    assert off > 0.025 * h
