"""The port's MacCormack transport against JAX.

``maccormack_multi_3d`` (the trace clamp) and ``maccormack_kinds_3d``
(both clamps, every lattice kind) on numpy-seeded fields with a sharp blob
at 16x20x24 and CFL ~2.6 (3 substeps), against the JAX functions with
exact gathers (``EngineMode(fast_interp=False)``), whose trace clamp is
the 8-corner min/max that ``minmax_sample`` computes. The backward semilag
stage traces with +dt, the port's only positive-dt trace; it is pinned on
its own against JAX.

The JAX functions run in a child process with a single-threaded XLA
(tests/jax_oracle.py). Tolerance: 1e-5 of each field's scale. The port
repeats the JAX arithmetic op for op; what differs is float32 rounding
(XLA's and PyTorch's CPU kernels), measured at <= 3.5e-6 of scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.core import interp as jinterp
from gpufluidsimulation_tpu.core.grids import Grid3D as JGrid3D
from gpufluidsimulation_tpu.ops import advect as jadvect
from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.core.grids import Grid3D
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from tests import jax_oracle

NI, NJ, NK = 16, 20, 24
H = 0.2 / NI
DT = 0.5
EXACT = config.EngineMode(fast_interp=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU work in these tests is small tensors, and under the
    tier-1 suite's six workers torch's intra-op pool spends more CPU
    waiting for its threads than computing: one thread for each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _velocity():
    return (_smooth((NI + 1, NJ, NK), 1, 0.065),
            _smooth((NI, NJ + 1, NK), 2, 0.065),
            _smooth((NI, NJ, NK + 1), 3, 0.065))


def _fields(kind, seed, n):
    shape = Grid3D(NI, NJ, NK, H).shape_of(kind)
    out = []
    for c in range(n):
        f = _smooth(shape, seed + c, (1.0, 50.0)[c])
        f[5:10, 6:12, 7:15] += (1.0, 50.0)[c]    # an emitter-like edge
        out.append(f)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfldt(u, v, w):
    maxvel = max(float(np.abs(a).max()) for a in (u, v, w))
    return np.float32(np.float32(H) / np.float32(maxvel))


def _close(got, want, scale, rel=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=rel * scale)


# the groups of the maccormack_kinds_3d call: every kind, both clamps
KIND_GROUPS = (("c", 20, 2, "trace"), ("u", 30, 1, "neighborhood"),
               ("v", 40, 1, "trace"), ("w", 50, 1, "neighborhood"))


def _jax_ops(name):
    """The JAX functions' results on this file's inputs (run in a child
    process, tests/jax_oracle.py): maccormack_multi_3d on the c and w
    kinds,
    one maccormack_kinds_3d call over KIND_GROUPS, and the +dt semilag
    stage on the c and w lattices."""
    del name
    jg = JGrid3D(NI, NJ, NK, H)
    u, v, w = (jnp.asarray(a) for a in _velocity())
    cfldt = _cfldt(*_velocity())
    out = {}
    with config.engine_mode_scope(EXACT):
        for kind in ("c", "w"):
            res = jadvect.maccormack_multi_3d(
                jg, kind, [jnp.asarray(f) for f in _fields(kind, 10, 2)],
                u, v, w, cfldt, DT)
            out.update({f"multi_{kind}_{i}": r for i, r in enumerate(res)})
        res = jadvect.maccormack_kinds_3d(
            jg, [(k, [jnp.asarray(f) for f in _fields(k, seed, n)], cl)
                 for k, seed, n, cl in KIND_GROUPS], u, v, w, cfldt, DT)
        out.update({f"kinds_{g}_{i}": r for g, rs in enumerate(res)
                    for i, r in enumerate(rs)})
        for kind in ("c", "w"):
            (res,) = jadvect.semilag_multi_3d(
                jg, kind, [jnp.asarray(_fields(kind, 60, 1)[0])], u, v, w,
                cfldt, DT)
            out[f"forward_{kind}"] = res
    return out


def test_maccormack_ops_match_jax(tmp_path):
    """maccormack_multi_3d (the trace clamp) on the c and w kinds; one
    maccormack_kinds_3d call over every kind with both clamps, whose trace
    clamp must replace some nodes by its fallback and keep others; and the
    backward stage's +dt semilag trace (trace_3d takes the sign of dt)."""
    want = jax_oracle.run(__file__, tmp_path, "ops")["ops"]
    tg = Grid3D(NI, NJ, NK, H)
    u, v, w = (_t(a) for a in _velocity())
    cfldt = _cfldt(*_velocity())
    assert len(advect.substeps(cfldt, DT)) == 3
    counts = (interp_fast.minmax_sample.launches,
              interp_fast.trilerp_sample.launches)
    for kind in ("c", "w"):
        fields = _fields(kind, 10, 2)
        got = advect.maccormack_multi_3d(tg, kind, [_t(f) for f in fields],
                                         u, v, w, cfldt, DT)
        for i, (a, f) in enumerate(zip(got, fields)):
            _close(a, want[f"multi_{kind}_{i}"], float(np.abs(f).max()))
        single = advect.maccormack_3d(tg, kind, _t(fields[0]), u, v, w,
                                      cfldt, DT)
        assert torch.equal(single, got[0])
    assert (interp_fast.minmax_sample.launches,
            interp_fast.trilerp_sample.launches) == counts == (0, 0)

    groups = [(k, _fields(k, seed, n), cl) for k, seed, n, cl in KIND_GROUPS]
    got = advect.maccormack_kinds_3d(
        tg, [(k, [_t(f) for f in fs], cl) for k, fs, cl in groups],
        u, v, w, cfldt, DT)
    for g, ((_, fields, _), g_out) in enumerate(zip(groups, got)):
        for i, (a, f) in enumerate(zip(g_out, fields)):
            _close(a, want[f"kinds_{g}_{i}"], float(np.abs(f).max()))
    # the trace clamp fired: its result differs from the unclamped
    # MacCormack correction on some nodes of the c group
    src = _t(groups[0][1][0])
    fw = advect.semilag_multi_3d(tg, "c", [src], u, v, w, cfldt, -DT)
    bk = advect.semilag_multi_3d(tg, "c", fw, u, v, w, cfldt, DT)
    changed = (got[0][0] != fw[0] + 0.5 * (src - bk[0])).float().mean()
    assert 0.0 < float(changed) < 0.5
    with pytest.raises(ValueError):
        advect.maccormack_kinds_3d(tg, [("c", [src], "x")], u, v, w, cfldt,
                                   DT)

    for kind in ("c", "w"):
        (f,) = _fields(kind, 60, 1)
        (fwd,) = advect.semilag_multi_3d(tg, kind, [_t(f)], u, v, w, cfldt,
                                         DT)
        _close(fwd, want[f"forward_{kind}"], float(np.abs(f).max()))
        (back,) = advect.semilag_multi_3d(tg, kind, [_t(f)], u, v, w, cfldt,
                                          -DT)
        assert float((fwd - back).abs().max()) > 0.05 * float(np.abs(f).max())


def test_midpoint_velocity_through_the_mac_pack_matches_jax():
    """Both midpoint stages sample the edge-padded MAC pack with one C=3
    trilerp: at the lattice and at displaced positions (some outside the
    domain) it equals the JAX package's per-component MAC sampler."""
    u, v, w = _velocity()
    packed = interp.mac_pack_3d(_t(u), _t(v), _t(w))
    assert packed.shape == (3, NI + 1, NJ + 1, NK + 1)
    tg = Grid3D(NI, NJ, NK, H)
    pos, _ = advect._cropped_positions(tg, "u", "cpu")
    px, py, pz = pos * H
    rng = np.random.default_rng(1)
    for shift in (0.0, 2.5 * H):
        q = [p + shift * torch.from_numpy(rng.uniform(-1, 1, p.shape)
                                          .astype(np.float32))
             for p in (px, py, pz)]
        got = interp_fast.trilerp_sample(packed, *q, H, interp.MAC_OFFS)
        want = jinterp.mac_velocity_3d(jnp.asarray(u), jnp.asarray(v),
                                       jnp.asarray(w),
                                       *(jnp.asarray(x.numpy()) for x in q), H)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8)


if __name__ == "__main__":
    jax_oracle.serve(_jax_ops)
