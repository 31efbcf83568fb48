"""The port's forces and spectral projection against the JAX package.

Inputs are made with numpy from a seed. The viscosity solve is compared
with the JAX XLA loop (``pallas_diffuse=False``; the Pallas kernel sums
neighbours in the same order) and must agree to float32 ulps. The
projection is compared with ``poisson.project_3d`` under
``spectral_poisson=True``: the dense transforms sum in another order on
each side (numpy-built float32 matrices, XLA vs PyTorch contractions), so
velocities agree to ~1e-6 of their scale and the relative residuals, both
~1e-6, to 1e-6 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.ops import forces as jforces
from gpufluidsimulation_tpu.ops import poisson as jpoisson
from gpufluidsimulation_tpu.ops import spectral as jspectral
from gpufluidsimulation_tpu_torch.ops import forces, poisson, spectral
from gpufluidsimulation_tpu_torch.ops import stencil_kernels

SHAPE = (16, 20, 24)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _vel(seed):
    ni, nj, nk = SHAPE
    return (_rand((ni + 1, nj, nk), seed, 0.05),
            _rand((ni, nj + 1, nk), seed + 1, 0.05),
            _rand((ni, nj, nk + 1), seed + 2, 0.05))


@pytest.mark.parametrize("coef", [0.3, 2.5e-3])
def test_diffuse_matches_jax(coef):
    x = _rand((SHAPE[0] + 1, SHAPE[1], SHAPE[2]), 1)
    with config.engine_mode_scope(config.EngineMode(pallas_diffuse=False)):
        want = np.asarray(jforces.diffuse_3d(jnp.asarray(x), 20, coef))
    launches = stencil_kernels.jacobi_diffuse.launches
    got = forces.diffuse_3d(_t(x), 20, coef).numpy()
    assert stencil_kernels.jacobi_diffuse.launches == launches == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0], x[0])      # boundary ring held


def test_diffuse_matches_pallas_interpret():
    x = _rand(SHAPE, 2)
    with config.engine_mode_scope(config.EngineMode(
            pallas_diffuse=True, interp_interpret=True)):
        want = np.asarray(jforces.diffuse_3d(jnp.asarray(x), 20, 0.3))
    got = forces.diffuse_3d(_t(x), 20, 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("alpha,beta", [(0.0, 0.0), (0.1, 0.02)])
def test_buoyancy_matches_jax(alpha, beta):
    ni, nj, nk = SHAPE
    v = _rand((ni, nj + 1, nk), 3)
    rho = np.abs(_rand(SHAPE, 4))
    T = np.abs(_rand(SHAPE, 5, 50.0))
    want = jforces.buoyancy_3d(jnp.asarray(v), jnp.asarray(rho),
                               jnp.asarray(T), alpha, beta, 0.5)
    got = forces.buoyancy_3d(_t(v), _t(rho), _t(T), alpha, beta, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_spectral_context_matches_jax(bc):
    jctx = jspectral.SpectralContext(SHAPE, bc)
    tctx = spectral.get_context(SHAPE, bc)
    for a, b in zip(jctx.fwd + jctx.inv, tctx.fwd + tctx.inv):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    b = _rand(SHAPE, 9)
    if bc == "neumann":
        b = b - b.mean()
    want = np.asarray(jctx.solve(jnp.asarray(b)))
    got = tctx.solve(_t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
@pytest.mark.parametrize("tol", [1e-4, 1e-9])
def test_project_matches_jax(bc, tol):
    """tol=1e-4 is met by the direct solve (iters 1); tol=1e-9 forces the
    one refinement pass (iters 2)."""
    u, v, w = _vel(10)
    ctx = jpoisson.MGContext(SHAPE, bc)
    with config.engine_mode_scope(config.EngineMode(spectral_poisson=True)):
        ju, jv, jw, jp, jit, jres, jhist = jpoisson.project_3d(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), ctx, tol, 30)
    tu, tv, tw, tp, it, res, hist = poisson.project_3d(
        _t(u), _t(v), _t(w), bc, tol, 30)
    assert it == int(jit) == (1 if tol == 1e-4 else 2)
    for a, b in ((tu, ju), (tv, jv), (tw, jw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6 * 0.05 * 10)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jp)).max()))
    assert float(res) < 1e-5
    np.testing.assert_allclose(float(res), float(jres), rtol=0, atol=1e-6)
    np.testing.assert_allclose(hist.numpy()[2:], np.asarray(jhist)[2:])
    assert (hist.numpy()[1] == -1.0) == (float(jhist[1]) == -1.0)
    # the projected field is discretely divergence-free (Neumann: up to
    # the uniform incompatible part, the mean the solve projects out)
    div = poisson.divergence_3d(tu, tv, tw)
    div = div - div.mean() if bc == "neumann" else div
    assert float(div.abs().max()) < 1e-5 * float(
        poisson.divergence_3d(_t(u), _t(v), _t(w)).abs().max())


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_laplacian_matches_jax(bc):
    p = _rand(SHAPE, 12)
    np.testing.assert_allclose(
        poisson.laplacian(_t(p), bc).numpy(),
        np.asarray(jpoisson.laplacian(jnp.asarray(p), bc)), rtol=0, atol=1e-5)
