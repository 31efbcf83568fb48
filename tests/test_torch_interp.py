"""The port's grid and samplers against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages. On CPU
tensors ``trilerp_sample`` runs its plain version (the CUDA kernel repeats
its operations in the same order; chip_smoke.py holds the two together on
the card). Tolerances are float32 round-off: the port computes grid
coordinates as p/h - off (the JAX gathers the same) and the dual corners
as g +- 1/4 in grid units (the JAX gathers as (p +- h/4)/h), so results
agree to a few ulp of the sampled values, bounded here by 2e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.bimocq import mapping as jmp
from gpufluidsimulation_tpu.core import grids as jgrids
from gpufluidsimulation_tpu.core import interp as jinterp
from gpufluidsimulation_tpu.ops import interp_fast as jfast
from gpufluidsimulation_tpu_torch.core import grids, interp
from gpufluidsimulation_tpu_torch.ops import interp_fast

SHAPE = (16, 20, 24)   # non-cube: catches axis mix-ups
H = 0.2 / SHAPE[0]


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


def _grids():
    return jgrids.Grid3D(*SHAPE, H), grids.Grid3D(*SHAPE, H)


def _t(a):
    return torch.from_numpy(np.array(a))


def _positions(jg, kind, seed, amp_cells):
    """`kind`'s node lattice displaced smoothly by up to amp_cells."""
    px, py, pz = (np.asarray(p) for p in jg.node_coords(kind))
    return [(p + _smooth(p.shape, seed + i, amp_cells * H)).astype(np.float32)
            for i, p in enumerate((px, py, pz))]


@pytest.mark.parametrize("kind", ["c", "u", "v", "w"])
def test_grid_matches_jax(kind):
    jg, tg = _grids()
    for a, b in zip(jg.node_coords(kind), tg.node_coords(kind)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jg.interior_mask(kind, 2, 3)),
                                  tg.interior_mask(kind, 2, 3).numpy())
    assert tuple(tg.zeros(kind).shape) == np.asarray(jg.zeros(kind)).shape
    assert tg.off_of(kind) == jg.off_of(kind)
    assert tg.dim_of(kind) == jg.dim_of(kind)


@pytest.mark.parametrize("kind", ["c", "u", "v", "w"])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
def test_trilerp_sample_matches_exact_gathers(kind, dual, channels):
    """Plain trilerp_sample against interp.sample3 and, in dual mode,
    mapping._dual_gather_3d; positions wander up to 3 cells and past
    the domain edge, so index clamping is exercised."""
    jg, _ = _grids()
    shape = jg.node_coords(kind)[0].shape
    fields = np.stack([_smooth(shape, 10 + c, 1.0 + 10 * c)
                       for c in range(channels)])
    pos = _positions(jg, kind, 20, 3.0)
    off = jg.off_of(kind)
    got = interp_fast.trilerp_sample(_t(fields), *map(_t, pos), H,
                                     (off,) * channels, dual=dual).numpy()
    assert interp_fast.trilerp_sample.launches == 0
    for c in range(channels):
        f = jnp.asarray(fields[c])
        jpos = [jnp.asarray(p) for p in pos]
        if dual:
            want = jmp._dual_gather_3d(jg, f, *jpos, off)
        else:
            want = jinterp.sample3(f, *jpos, H, off)
        scale = float(np.abs(fields[c]).max())
        np.testing.assert_allclose(got[c], np.asarray(want), rtol=0,
                                   atol=2e-6 * scale)


@pytest.mark.parametrize("kind", ["c", "u"])
def test_trilerp_sample_dual_matches_pallas(kind):
    """Plain trilerp_sample(dual) against the production Pallas samplers
    (sample3_multi for the 2-channel rho/T stage, sample3_fast for a
    velocity stage) in interpret mode, under a smooth displacement within
    their reach contract."""
    jg, _ = _grids()
    shape = jg.node_coords(kind)[0].shape
    channels = 2 if kind == "c" else 1
    fields = np.stack([_smooth(shape, 30 + c, 1.0 + 49 * c)
                       for c in range(channels)])
    pos = _positions(jg, kind, 40, 1.5)
    off = jg.off_of(kind)
    jpos = [jnp.asarray(p) for p in pos]
    if channels == 1:
        want = np.asarray(jfast.sample3_fast(
            jnp.asarray(fields[0]), *jpos, H, off, Rr=config.interp_rr(),
            interpret=True, dual=True))[None]
    else:
        want = np.asarray(jfast.sample3_multi(
            jnp.asarray(fields), *jpos, H, (off,) * channels,
            Rr=config.interp_rr(), interpret=True, dual=True))
    got = interp_fast.trilerp_sample(_t(fields), *map(_t, pos), H,
                                     (off,) * channels, dual=True).numpy()
    # the window kernel weights taps with hats 1-|t| in window-local
    # coordinates and renormalizes by their coverage: other roundings than
    # the clamped trilerp's, up to ~3e-6 of the field scale at 16^3
    for c in range(channels):
        scale = float(np.abs(fields[c]).max())
        np.testing.assert_allclose(got[c], want[c], rtol=0, atol=1e-5 * scale)


def test_mac_velocity_and_clamp_match_jax():
    jg, tg = _grids()
    u = _smooth(jg.shape_u, 1, 0.06)
    v = _smooth(jg.shape_v, 2, 0.06)
    w = _smooth(jg.shape_w, 3, 0.06)
    pos = _positions(jg, "c", 50, 2.0)
    want = jinterp.mac_velocity_3d(*(jnp.asarray(a) for a in (u, v, w)),
                                   *(jnp.asarray(p) for p in pos), H)
    got = interp.mac_velocity_3d(*map(_t, (u, v, w)), *map(_t, pos), H)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6 * 0.06)
    for a, b in zip(interp.mac_velocity_at_c_3d(*map(_t, (u, v, w))),
                    jinterp.mac_velocity_at_c_3d(
                        *(jnp.asarray(x) for x in (u, v, w)))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(interp.clamp_pos_3d(*map(_t, pos), H, *SHAPE, 1.0, 2.0),
                    jinterp.clamp_pos_3d(*(jnp.asarray(p) for p in pos), H,
                                         *SHAPE, 1.0, 2.0)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
