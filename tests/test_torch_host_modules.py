"""The port's host-side modules that no solver calls, against the JAX
package's: ``ops/pcg.py`` (MIC(0)-PCG), ``ops/forces.diffuse_2d`` and
``core/interp.sample3_cubic``.

``pcg`` is numpy in float64 in both packages: on the cases of
tests/test_pcg.py the solution, residual, iteration count and success
flag are identical, as are the operator and the MIC(0) factor; the port
takes CPU tensors as well. ``diffuse_2d`` (plain torch against JAX's XLA
loop) within 1e-6 of the field's scale. ``sample3_cubic`` on the case of
tests/test_interp.py (a tricubic polynomial at interior points: exact to
2e-4, as there) and at points near and outside the faces, where taps
clamp, within 1e-6 of scale of JAX's. JAX runs in this process on the
CPU.
"""

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.ops import forces, pcg


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags_box(shape, open_top=False, obstacle=None):
    """tests/test_pcg.py's box: solid walls, an optional open top (AIR)
    and an optional OBJECT block."""
    from gpufluidsimulation_tpu.ops.poisson import AIR, FLUID, OBJECT, SOLID

    f = np.full(shape, FLUID, np.int32)
    f[0], f[-1] = SOLID, SOLID
    f[:, 0], f[:, -1] = SOLID, (AIR if open_top else SOLID)
    if len(shape) == 3:
        f[:, :, 0], f[:, :, -1] = SOLID, SOLID
    if obstacle:
        f[obstacle] = OBJECT
    return f


# (shape, open top, obstacle, tolerance factor, max iterations, rhs seed,
# mean-free rhs): the three cases of tests/test_pcg.py
PCG_CASES = {
    "closed-10-obstacle": ((10, 10, 10), False, np.s_[4:6, 4:6, 4:6], 1e-10,
                           200, 3, True),
    "open-10-obstacle": ((10, 10, 10), True, np.s_[4:6, 4:6, 4:6], 1e-10,
                         200, 3, False),
    "open-12": ((12, 12, 12), True, None, 1e-8, 300, 7, False),
    "2d-16": ((16, 16), True, None, 1e-9, 200, 11, False),
}


@pytest.mark.parametrize("case", list(PCG_CASES))
def test_pcg_matches_jax(case):
    from gpufluidsimulation_tpu.ops import pcg as jpcg

    shape, open_top, obstacle, tol, iters, seed, mean_free = PCG_CASES[case]
    flags = _flags_box(shape, open_top, obstacle)
    fluid = flags == pcg.FLUID
    rhs = np.where(fluid, np.random.default_rng(seed).standard_normal(shape),
                   0.0)
    if mean_free:
        rhs -= rhs[fluid].mean() * fluid
    results = []
    for mod, f, b in ((jpcg, flags, rhs), (pcg, flags, rhs),
                      (pcg, torch.from_numpy(flags), torch.from_numpy(rhs))):
        solver = mod.PCGSolver()
        solver.set_solver_parameters(tolerance_factor=tol,
                                     max_iterations=iters)
        results.append(solver.solve(f, b))
    want = results[0]
    assert want[3], want[1:]
    for got in results[1:]:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    np.testing.assert_array_equal(pcg.form_mic0(flags),
                                  jpcg.form_mic0(flags))
    x = want[0]
    np.testing.assert_array_equal(pcg.apply_poisson(x, flags),
                                  jpcg.apply_poisson(x, flags))
    with pytest.raises(ValueError):
        pcg.PCGSolver().solve(torch.from_numpy(flags).to("meta"), rhs)


@pytest.mark.parametrize("shape,nu,dt,iters",
                         [((24, 40), 0.01, 0.1, 20), ((37, 29), 1.0, 0.5, 7)])
def test_diffuse_2d_matches_jax(shape, nu, dt, iters):
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.ops import forces as jforces

    field = np.random.default_rng(5).standard_normal(shape).astype(
        np.float32)
    h = 1.0 / shape[0]
    want = np.asarray(jforces.diffuse_2d(jnp.asarray(field), nu, dt, h,
                                         iters))
    got = forces.diffuse_2d(torch.from_numpy(field), nu, dt, h, iters)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * scale
    # the solve moved the field: the coefficient is not negligible
    assert float(np.abs(want - field).max()) > 1e-2 * scale


def _cubic_case():
    """tests/test_interp.py's tricubic polynomial on 12^3 at h 0.1."""
    n = 12
    i = np.arange(n)[:, None, None] * np.ones((1, n, n))
    j = np.arange(n)[None, :, None] * np.ones((n, 1, n))
    k = np.arange(n)[None, None, :] * np.ones((n, n, 1))
    field = (0.02 * i**3 - 0.05 * j**2 * i + 0.3 * k + 0.1 * j
             - 0.01 * k**3).astype(np.float32)
    return field, n


def test_sample3_cubic_matches_jax_inside():
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.core import interp as jinterp

    field, n = _cubic_case()
    h = 0.1
    pts = np.random.default_rng(1234).uniform(2.0, n - 3.0, size=(3, 50))
    pts = pts.astype(np.float32)
    pos = [p * np.float32(h) for p in pts]
    want = np.asarray(jinterp.sample3_cubic(jnp.asarray(field),
                                            *map(jnp.asarray, pos), h,
                                            (0, 0, 0)))
    got = interp.sample3_cubic(torch.from_numpy(field),
                               *map(torch.from_numpy, pos), h,
                               (0, 0, 0)).numpy()
    poly = (0.02 * pts[0]**3 - 0.05 * pts[1]**2 * pts[0] + 0.3 * pts[2]
            + 0.1 * pts[1] - 0.01 * pts[2]**3)
    np.testing.assert_allclose(got, poly, rtol=2e-4, atol=2e-4)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-6 * scale


@pytest.mark.parametrize("off", [(0.0, 0.0, 0.0), (0.5, 0.0, -0.5)])
def test_sample3_cubic_matches_jax_at_the_faces(off):
    """Points from 2 cells outside to 2 inside every face, on (13, 9, 11):
    the taps clamp to the field on every side."""
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.core import interp as jinterp

    shape = (13, 9, 11)
    h = 0.05
    rng = np.random.default_rng(21)
    field = rng.standard_normal(shape).astype(np.float32)
    pos = [rng.uniform(-2.0, s + 2.0, 400).astype(np.float32)
           * np.float32(h) for s in shape]
    want = np.asarray(jinterp.sample3_cubic(jnp.asarray(field),
                                            *map(jnp.asarray, pos), h, off))
    got = interp.sample3_cubic(torch.from_numpy(field),
                               *map(torch.from_numpy, pos), h, off).numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-6 * scale
