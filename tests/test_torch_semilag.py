"""The port's semi-Lagrangian transport against JAX.

``semilag_kinds_3d`` per lattice kind (c, u, v, w) on numpy-seeded fields
at 16x20x24 and CFL ~2.6 (3 substeps; backward in time for every kind,
forward for one), against the JAX function with exact gathers
(``fast_interp=False``, which the port's kernels match). The production
path (the Pallas window kernels in interpret mode) is held through the
solver in tests/test_torch_semilag_step.py.

Tolerance: 1e-4 of each field's scale (measured <= 6e-6), inside the 2e-3
fidelity bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.core.grids import Grid3D as JGrid3D
from gpufluidsimulation_tpu.ops import advect as jadvect
from gpufluidsimulation_tpu_torch.core.grids import Grid3D
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

NI, NJ, NK = 16, 20, 24
H = 0.2 / NI
DT = 0.5
KINDS = ("c", "u", "v", "w")


def _smooth(shape, seed, amp):
    rng = np.random.default_rng(seed)
    idx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(3):
        k = rng.uniform(0.5, 2.5, 3) * 2 * np.pi / np.array(shape)
        f += np.sin(sum(kk * ii for kk, ii in zip(k, idx))
                    + rng.uniform(0, 2 * np.pi))
    return (amp * f / np.abs(f).max()).astype(np.float32)


def _velocity(shape_c, amp=0.065):
    ni, nj, nk = shape_c
    return (_smooth((ni + 1, nj, nk), 1, amp), _smooth((ni, nj + 1, nk), 2, amp),
            _smooth((ni, nj, nk + 1), 3, amp))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", KINDS)
def test_interior_mask_hi_add_dim_matches_jax(kind):
    jg, tg = JGrid3D(NI, NJ, NK, H), Grid3D(NI, NJ, NK, H)
    for lo, hi in ((2, 3), (1, 2)):
        np.testing.assert_array_equal(
            np.asarray(jg.interior_mask(kind, lo, hi, hi_add_dim=True)),
            tg.interior_mask(kind, lo, hi, hi_add_dim=True).numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_cropped_positions_and_pad_plane(kind):
    tg = Grid3D(NI, NJ, NK, H)
    pos, ax = advect._cropped_positions(tg, kind)
    jpx, jpy, jpz, jax_ = jadvect._cropped_positions(JGrid3D(NI, NJ, NK, H),
                                                     kind)
    assert ax == jax_ and pos.shape == (3, NI, NJ, NK)
    for a, b in zip(pos, (jpx, jpy, jpz)):
        np.testing.assert_allclose(a.numpy() * H, np.asarray(b), rtol=0,
                                   atol=1e-7)
    src = _t(_smooth(tg.shape_of(kind), 4, 1.0))
    crop = torch.zeros(NI, NJ, NK)
    out = advect._pad_plane(crop, src, ax)
    assert out.shape == src.shape
    if ax is not None:
        last = out.narrow(ax, src.shape[ax] - 1, 1)
        assert torch.equal(last, src.narrow(ax, src.shape[ax] - 1, 1))
        assert float(out.narrow(ax, 0, src.shape[ax] - 1).abs().max()) == 0


@pytest.mark.parametrize("kind,sign", [
    ("c", -1.0), ("u", -1.0), ("v", -1.0), ("w", -1.0), ("u", 1.0)])
def test_semilag_kinds_match_jax_exact(kind, sign):
    jg, tg = JGrid3D(NI, NJ, NK, H), Grid3D(NI, NJ, NK, H)
    u, v, w = _velocity((NI, NJ, NK))
    maxvel = max(float(np.abs(a).max()) for a in (u, v, w))
    cfldt = np.float32(np.float32(H) / np.float32(maxvel))
    shape = tg.shape_of(kind)
    fields = [_smooth(shape, 10, 1.0), _smooth(shape, 11, 50.0)]
    with config.engine_mode_scope(config.EngineMode(fast_interp=False)):
        (want,) = jadvect.semilag_kinds_3d(
            jg, [(kind, [jnp.asarray(f) for f in fields])], jnp.asarray(u),
            jnp.asarray(v), jnp.asarray(w), cfldt, sign * DT)
    before = (interp_fast.trilerp_sample.launches,
              interp_fast.rk3_substep.launches)
    (got,) = advect.semilag_kinds_3d(
        tg, [(kind, [_t(f) for f in fields])], _t(u), _t(v), _t(w), cfldt,
        sign * DT)
    assert (interp_fast.trilerp_sample.launches,
            interp_fast.rk3_substep.launches) == before == (0, 0)
    assert len(advect.substeps(cfldt, DT)) == 3
    for a, b, f in zip(got, want, fields):
        scale = float(np.abs(f).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4 * scale)
        # outside the update band the source is kept
        mask = tg.interior_mask(kind, 2, 3, hi_add_dim=True).numpy()
        np.testing.assert_array_equal(a.numpy()[~mask], f[~mask])
        assert np.abs(a.numpy()[mask] - f[mask]).max() > 0.05 * scale
    single = advect.semilag_3d(tg, kind, _t(fields[0]), _t(u), _t(v), _t(w),
                               cfldt, sign * DT)
    assert torch.equal(single, got[0])
