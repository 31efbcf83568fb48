"""The port's prefilter volume form against the JAX package.

* ``volume_prefilter_plain`` (and its wrapper on the CPU) against the JAX
  package's XLA ``mapping.volume_prefilter_3d`` and its Pallas
  ``interp_fast.volume_prefilter_fast`` in interpret mode, on a cell and
  a face lattice of a non-cubic grid, C = 1 and C = 2: within 1e-6 of
  each field's scale (the same float32 stencil in the same order).
* The prefilter form of ``bimocq_advect_3d`` (kinds v and c, with and
  without a blend) against the JAX function under
  ``EngineMode(fast_interp=True, interp_interpret=True,
  volume_dual=False)`` at 16x20x24: within 1e-5 of scale (the JAX window
  sampler rounds ~6e-6 of the sampled field's scale).
* One whole-step run: BiMocq 'always' with blend 0.5 in the prefilter
  form, 3 steps at 16^3, within 1e-4 of each field's scale with equal
  ``proj_iters`` and reinit counters (tests/test_torch_bimocq_full.py's
  comparison).

The stage-level JAX references are computed in one child process per
test session (tests/jax_oracle.py); the whole-step run has a child of its
own that feeds exactly one test. The torch work runs with one thread.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.bimocq import mapping as jmp
from gpufluidsimulation_tpu.core import grids as jgrids
from gpufluidsimulation_tpu.ops import interp_fast as jif
from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
from gpufluidsimulation_tpu_torch.core import grids
from gpufluidsimulation_tpu_torch.ops import interp_fast
from tests import jax_oracle
from tests import test_torch_bimocq_full as full

PREFILTER = config.EngineMode(fast_interp=True, interp_interpret=True,
                              volume_dual=False)
SHAPE = (16, 20, 24)
H = 0.2 / SHAPE[0]
# the prefilter's inputs: (label, shape, channels)
FILTER_CASES = [("cell", (20, 12, 28), 1), ("cell", (20, 12, 28), 2),
                ("face", (21, 12, 28), 1), ("face", (21, 12, 28), 2)]
ADVECT_CASES = [("v", None), ("v", 0.6), ("c", None), ("c", 0.6)]
# whole steps: (reinit, blend, steps, dt)
STEP_RUN = ("always", 0.5, 3, 0.25)
STAGES = ("filters", "advect")
jax_oracle.prefetch(__file__, *STAGES)
jax_oracle.prefetch(__file__, "steps")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__, *STAGES)


def _filter_input(shape, C):
    rng = np.random.default_rng(sum(shape) + C)
    return np.stack([(1.0, 50.0)[c] * rng.random(shape).astype(np.float32)
                     for c in range(C)])


def _advect_inputs(kind, blend):
    n = 2 if kind == "c" else 1
    cur, init, prev = (full._fields_at(SHAPE, H, kind, n, s)
                       for s in (1, 11, 21))
    maps = [full._maps_at(SHAPE, H, s) for s in (20, 30, 40)]
    return cur, init, prev, maps


# ---------------------------------------------------------------------------
# The JAX side (run in the child process)
# ---------------------------------------------------------------------------


def _jax_stage(name):
    out = {}
    if name == "filters":
        for label, shape, C in FILTER_CASES:
            f = _filter_input(shape, C)
            for c in range(C):
                key = f"{label}{C}_{c}"
                out[f"xla_{key}"] = np.asarray(
                    jmp.volume_prefilter_3d(jnp.asarray(f[c])))
                out[f"pallas_{key}"] = np.asarray(jif.volume_prefilter_fast(
                    jnp.asarray(f[c]), interpret=True))
        return out
    jg = jgrids.Grid3D(*SHAPE, H)
    for kind, blend in ADVECT_CASES:
        cur, init, prev, (bwd, fwd, bwd_prev) = _advect_inputs(kind, blend)
        with config.engine_mode_scope(PREFILTER):
            assert jmp._volume_mode() == "prefilter"
            got = jmp.bimocq_advect_3d(
                jg, kind, *([jnp.asarray(f) for f in fs]
                            for fs in (cur, init, prev)),
                jnp.asarray(bwd), jnp.asarray(bwd_prev), jnp.asarray(fwd),
                blend)
        for c, g in enumerate(got):
            out[f"{kind}_{blend}_{c}"] = np.asarray(g)
    return out


def _jax_run(name):
    if name in STAGES:
        return _jax_stage(name)
    reinit, blend, steps, dt = STEP_RUN
    return full._jax_states(PREFILTER, reinit, blend, steps, dt, eager=True)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


# the whole-step test first: it is the file's longest, and the workers
# take tests in file order
def test_bimocq_prefilter_always_step_matches_jax(tmp_path_factory):
    """BiMocq 'always', blend 0.5 (the prev tier and the accumulates
    live), prefilter volume form: 3 whole steps at 16^3."""
    reinit, blend, steps, dt = STEP_RUN
    run = jax_oracle.shared(tmp_path_factory, __file__, "steps")["steps"]
    before = interp_fast.volume_prefilter.launches
    cfg, states = full._compare_states(run, PREFILTER, reinit, blend, steps,
                                       dt)
    assert cfg.engine_mode.volume_mode == "prefilter"
    assert interp_fast.volume_prefilter.launches == before


@pytest.mark.parametrize("label,shape,C", FILTER_CASES,
                         ids=[f"{lab}-C{C}" for lab, _, C in FILTER_CASES])
def test_volume_prefilter_matches_jax(stages, label, shape, C):
    f = _filter_input(shape, C)
    got = interp_fast.volume_prefilter_plain(torch.from_numpy(f))
    before = interp_fast.volume_prefilter.launches
    wrapped = interp_fast.volume_prefilter(torch.from_numpy(f))
    assert interp_fast.volume_prefilter.launches == before
    assert torch.equal(wrapped, got)
    want = stages["filters"]
    for c in range(C):
        key = f"{label}{C}_{c}"
        scale = float(np.abs(f[c]).max())
        for impl in ("xla", "pallas"):
            np.testing.assert_allclose(got[c].numpy(), want[f"{impl}_{key}"],
                                       rtol=0, atol=1e-6 * scale,
                                       err_msg=f"{impl} {key}")
        np.testing.assert_array_equal(
            mp.volume_prefilter_3d(torch.from_numpy(f[c])).numpy(),
            got[c].numpy())


@pytest.mark.parametrize("kind,blend", ADVECT_CASES)
def test_prefilter_bimocq_advect_matches_jax(stages, kind, blend):
    tg = grids.Grid3D(*SHAPE, H)
    cur, init, prev, (bwd, fwd, bwd_prev) = _advect_inputs(kind, blend)
    t = full._t
    before = interp_fast.volume_prefilter.launches
    got = mp.bimocq_advect_3d(
        tg, kind, *([t(f) for f in fs] for fs in (cur, init, prev)), t(bwd),
        t(bwd_prev), t(fwd), blend, mode="prefilter")
    assert interp_fast.volume_prefilter.launches == before
    dual = mp.bimocq_advect_3d(
        tg, kind, *([t(f) for f in fs] for fs in (cur, init, prev)), t(bwd),
        t(bwd_prev), t(fwd), blend)
    want = stages["advect"]
    for c in range(len(init)):
        scale = float(np.abs(init[c]).max())
        np.testing.assert_allclose(got[c].numpy(), want[f"{kind}_{blend}_{c}"],
                                   rtol=0, atol=1e-5 * scale)
        # the prefilter form is another function than the dual form
        assert float((got[c] - dual[c]).abs().max()) > 1e-4 * scale


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
