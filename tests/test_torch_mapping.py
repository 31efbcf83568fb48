"""The port's BiMocq pull-back against the JAX package.

``bimocq_advect_3d`` runs in the dual volume form on both sides: the JAX
package's production numerics (Pallas samplers in interpret mode under
``EngineMode(fast_interp=True, interp_interpret=True)``) and the port's
plain ``trilerp_sample``. Maps are the identity displaced smoothly by up
to 0.3 cells, inside the window kernels' reach contract. Tolerance: the
window kernels' hat weights round differently from the clamped trilerp
(see test_torch_interp), ~3e-6 of the field scale per sampling stage;
three stages and the 27-point clamp give a bound of 2e-5 of the scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.bimocq import mapping as jmp
from gpufluidsimulation_tpu.core import grids as jgrids
from gpufluidsimulation_tpu_torch.bimocq import mapping
from gpufluidsimulation_tpu_torch.core import grids
from gpufluidsimulation_tpu_torch.ops import interp_fast

SHAPE = (16, 20, 24)
H = 0.2 / SHAPE[0]
FAST = config.EngineMode(fast_interp=True, interp_interpret=True)


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


def _maps(seed):
    jg = jgrids.Grid3D(*SHAPE, H)
    ident = [np.asarray(p) for p in jg.node_coords("c")]
    return np.stack([(p + _smooth(p.shape, seed + i, 0.3 * H))
                     for i, p in enumerate(ident)]).astype(np.float32)


def _fields(kind, n, seed):
    tg = grids.Grid3D(*SHAPE, H)
    shape = tg.shape_of(kind)
    scales = (1.0, 50.0) if kind == "c" else (0.06,)
    out = []
    for c in range(n):
        f = _smooth(shape, seed + c, scales[c])
        # a sharp blob edge, like an emitter's, for the 27-point clamp
        f[4:9, 5:11, 6:13] += scales[c]
        out.append(f)
    return out


@pytest.mark.parametrize("kind", ["c", "u", "v", "w"])
def test_bimocq_advect_dual_matches_jax(kind):
    jg = jgrids.Grid3D(*SHAPE, H)
    tg = grids.Grid3D(*SHAPE, H)
    n = 2 if kind == "c" else 1
    cur = _fields(kind, n, 1)
    init = _fields(kind, n, 11)
    bwd, fwd = _maps(20), _maps(30)
    with config.engine_mode_scope(FAST):
        assert jmp._volume_mode() == "dual"
        want = jmp.bimocq_advect_3d(
            jg, kind, [jnp.asarray(f) for f in cur],
            [jnp.asarray(f) for f in init], [None] * n, jnp.asarray(bwd),
            None, jnp.asarray(fwd), None)
    launches = interp_fast.trilerp_sample.launches
    got = mapping.bimocq_advect_3d(
        tg, kind, [_t(f) for f in cur], [_t(f) for f in init], [None] * n,
        _t(bwd), None, _t(fwd), None)
    assert interp_fast.trilerp_sample.launches == launches == 0
    for c in range(n):
        scale = float(np.abs(init[c]).max())
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want[c]),
                                   rtol=0, atol=2e-5 * scale)
        assert float(np.abs(got[c].numpy() - cur[c]).max()) > 0.01 * scale


@pytest.mark.parametrize("kind", ["c", "u", "v", "w"])
@pytest.mark.parametrize("clamp", [(1.0, 1.0), (0.0, 0.0)])
def test_map_at_lattice_matches_jax(kind, clamp):
    jg = jgrids.Grid3D(*SHAPE, H)
    tg = grids.Grid3D(*SHAPE, H)
    maps = _maps(40)
    want = jmp.map_at_lattice_3d(jg, jnp.asarray(maps), kind, *clamp)
    got = mapping.map_at_lattice_3d(tg, _t(maps), kind, *clamp)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["c", "u"])
def test_accumulate_identity_matches_jax(kind):
    """The post-reinit accumulate: base + prefiltered change on the band
    (the same float32 stencil on both sides)."""
    jg = jgrids.Grid3D(*SHAPE, H)
    tg = grids.Grid3D(*SHAPE, H)
    base, change = _fields(kind, 2, 50) if kind == "c" else (
        _fields(kind, 1, 50)[0], _fields(kind, 1, 60)[0])
    ident = jmp.identity_map_3d(jg)
    with config.engine_mode_scope(FAST):
        (want,) = jmp.accumulate_multi_3d(
            jg, kind, [(jnp.asarray(base), [(jnp.asarray(change), 1.0)])],
            ident, identity=True)
    (got,) = mapping.accumulate_multi_3d(
        tg, kind, [(_t(base), [(_t(change), 1.0)])],
        mapping.identity_map_3d(tg), identity=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * float(np.abs(base).max()))
    np.testing.assert_allclose(
        mapping.volume_prefilter_3d(_t(change)).numpy(),
        np.asarray(jmp.volume_prefilter_3d(jnp.asarray(change))), rtol=0,
        atol=1e-6 * float(np.abs(change).max()))


def test_mapping_state_lifecycle_matches_jax():
    jg = jgrids.Grid3D(*SHAPE, H)
    tg = grids.Grid3D(*SHAPE, H)
    np.testing.assert_array_equal(mapping.identity_map_3d(tg).numpy(),
                                  np.asarray(jmp.identity_map_3d(jg)))
    m = mapping.init_mapping(tg, with_prev=False)
    assert m.bwd_prev is None and m.reinit_count == 0
    m = mapping.reinitialize(m, tg)
    assert m.reinit_count == 1 and m.bwd_prev is None
    alias = mapping.reinitialize(mapping.init_mapping(tg, with_maps=False), tg)
    assert alias.fwd is None and alias.reinit_count == 1
    for a, b in (((2, 2, 2), (3, 3, 3)), ((1, 2, 1), (2, 2, 2))):
        np.testing.assert_array_equal(
            mapping._band3(SHAPE, a, b).numpy(),
            np.asarray(jmp._band3(SHAPE, a, b)))


def test_unported_blend_raises():
    """A blend below 1 and a non-identity accumulate are ported now (held
    against JAX in tests/test_torch_bimocq_full.py); what raises is a
    blend without the level-2 map or the prev fields it blends in."""
    tg = grids.Grid3D(*SHAPE, H)
    f = _t(_fields("c", 1, 1)[0])
    ident = mapping.identity_map_3d(tg)
    (out,) = mapping.bimocq_advect_3d(tg, "c", [f], [f], [f], ident, ident,
                                      ident, 0.5)
    assert out.shape == f.shape and bool(torch.isfinite(out).all())
    (acc,) = mapping.accumulate_multi_3d(tg, "c", [(f, [(f, 1.0)])], ident)
    assert acc.shape == f.shape
    with pytest.raises(ValueError):
        mapping.bimocq_advect_3d(tg, "c", [f], [f], [f], ident, None,
                                 ident, 0.5)
    with pytest.raises(ValueError):
        mapping.bimocq_advect_3d(tg, "c", [f], [f], [None], ident, ident,
                                 ident, 0.5)
