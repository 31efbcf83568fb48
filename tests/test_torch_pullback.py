"""The port's fused multi-kind pull-back against the JAX package.

* ``mapping._pullback_stage`` (one ``pullback_sample`` launch across all
  kinds) against the JAX package's ``_pullback_stage`` in interpret mode,
  and ``interp_fast.sample3_pullback`` against its JAX namesake on the
  evaluated extent, for kinds (u, v, w) and (c, c), clamps (1, 1) and
  (0, 0), through a map with a 0.4 h wobble and one with a 1.5 h wobble,
  both clipped in part. On the 16x12x20 grid the JAX block grid (16 x 16
  x 128 multiples of the cell lattice) ends at the cell count in x only,
  so u's last face plane is zero in both packages and v's and w's are
  sampled. Tolerance: 1e-5 of each field's scale (the JAX kernel's hat
  loops weigh taps in window coordinates ~130 cells from the origin,
  whose rounding moves a sample by up to ~6e-6 of the scale here).
* ``pullback_sample_plain`` against the port's own per-kind chain
  (``map_at_lattice_3d`` + ``trilerp_sample_plain``), within 1e-5 of
  scale (the clip is in grid units in one and in world units in the
  other), and its argument checks.
* ``bimocq_advect_multi_3d`` with blend 0.7: the prefilter branch against
  JAX's fast path in interpret mode with the prefilter pinned, at rtol =
  atol = 5e-5 as the JAX package's own test, and against the port's
  per-kind ``bimocq_advect_3d(mode="prefilter")``; the exact branch
  against JAX's exact path run op by op (``jax.disable_jit``).

The JAX references are computed in one child process per test session,
shared by the workers (tests/jax_oracle.shared).
"""

import jax
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

SHAPE = (16, 12, 20)
H = 0.2 / SHAPE[0]
KIND_SETS = (("u", "v", "w"), ("c", "c"))
CLAMPS = (1.0, 0.0)
MAP_AMPS = {"wobble": 0.4, "wide": 1.5}
BLEND = 0.7
NAMES = ("stages", "multi")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__, *NAMES)


def _maps(seed, amp):
    return full._maps_at(SHAPE, H, seed, amp)


def _stage_fields(kinds):
    """A smooth field of each kind with a raised box; for (c, c) rho and T
    (scales 1 and 50)."""
    if kinds == ("c", "c"):
        return full._fields_at(SHAPE, H, "c", 2, 70)
    return [full._fields_at(SHAPE, H, k, 1, 70 + i)[0]
            for i, k in enumerate(kinds)]


def _multi_inputs():
    kinds = KIND_SETS[0]
    cur, init, prev = ([full._fields_at(SHAPE, H, k, 1, s + i)[0]
                        for i, k in enumerate(kinds)] for s in (1, 11, 21))
    bwd, fwd, bwd_prev = (_maps(s, a) for s, a in ((20, 0.4), (30, 0.4),
                                                   (40, 0.2)))
    return kinds, cur, init, prev, bwd, fwd, bwd_prev


def _tag(kinds, amp, clamp):
    return f"{''.join(kinds)}_{amp}_{clamp}"


# ---------------------------------------------------------------------------
# The JAX side (run in the child process)
# ---------------------------------------------------------------------------


def _jax_multi(jg, args, blend):
    kinds, cur, init, prev, bwd, fwd, bwd_prev = args
    got = jmp.bimocq_advect_multi_3d(
        jg, kinds, *([jnp.asarray(f) for f in fs] for fs in (cur, init, prev)),
        jnp.asarray(bwd), jnp.asarray(bwd_prev), jnp.asarray(fwd), blend)
    return [np.asarray(g) for g in got]


def _jax_run(name):
    jg = jgrids.Grid3D(*SHAPE, H)
    out = {}
    prev_fast, prev_int = config._FORCED, config._INTERPRET
    prev_dual = config._VOLUME_DUAL
    try:
        config.set_fast_interp(True)
        config.set_interp_interpret(True)
        config.set_volume_dual(False)
        if name == "stages":
            for kinds in KIND_SETS:
                fields = [jnp.asarray(f) for f in _stage_fields(kinds)]
                dims = tuple(jg.dim_of(k) for k in kinds)
                for label, amp in MAP_AMPS.items():
                    maps = jnp.asarray(_maps(50, amp))
                    for clamp in CLAMPS:
                        tag = _tag(kinds, label, clamp)
                        outs = jmp._pullback_stage(jg, maps, fields, kinds,
                                                   clamp, clamp)
                        for c, o in enumerate(outs):
                            out[f"{tag}_{c}"] = np.asarray(o)
                        out[f"{tag}_padded"] = np.asarray(jif.sample3_pullback(
                            maps, fields, dims, H, SHAPE, clamp, clamp,
                            interpret=True))
            return out
        args = _multi_inputs()
        for c, g in enumerate(_jax_multi(jg, args, jnp.float32(BLEND))):
            out[f"prefilter_{c}"] = g
        config.set_fast_interp(False)
        with jax.disable_jit():
            for c, g in enumerate(_jax_multi(jg, args, jnp.float32(BLEND))):
                out[f"exact_{c}"] = g
        return out
    finally:
        config.set_fast_interp(prev_fast)
        config.set_interp_interpret(prev_int)
        config.set_volume_dual(prev_dual)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _port_multi(mode, blend=BLEND):
    kinds, cur, init, prev, bwd, fwd, bwd_prev = _multi_inputs()
    t = full._t
    return mp.bimocq_advect_multi_3d(
        grids.Grid3D(*SHAPE, H), kinds,
        *([t(f) for f in fs] for fs in (cur, init, prev)), t(bwd),
        t(bwd_prev), t(fwd), blend, mode=mode)


# the first test asks for the file's one JAX child: the workers take tests
# in file order
def test_multi_prefilter_matches_jax_and_per_kind(oracle):
    """The fused prefilter branch against JAX's, and against the port's
    per-kind prefilter form on the same inputs."""
    kinds, cur, init, prev, bwd, fwd, bwd_prev = _multi_inputs()
    tg, t = grids.Grid3D(*SHAPE, H), full._t
    before = interp_fast.pullback_sample.launches
    got = _port_multi("prefilter")
    assert interp_fast.pullback_sample.launches == before
    assert [tuple(g.shape) for g in got] == [tg.shape_of(k) for k in kinds]
    for c, kind in enumerate(kinds):
        np.testing.assert_allclose(got[c].numpy(),
                                   oracle["multi"][f"prefilter_{c}"],
                                   rtol=5e-5, atol=5e-5, err_msg=kind)
        (per_kind,) = mp.bimocq_advect_3d(
            tg, kind, [t(cur[c])], [t(init[c])], [t(prev[c])], t(bwd),
            t(bwd_prev), t(fwd), BLEND, mode="prefilter")
        np.testing.assert_allclose(got[c].numpy(), per_kind.numpy(),
                                   rtol=5e-5, atol=5e-5, err_msg=kind)
        # one kind alone (its own, smaller extent) gives the same bits
        (alone,) = mp.bimocq_advect_multi_3d(
            tg, (kind,), [t(cur[c])], [t(init[c])], [t(prev[c])], t(bwd),
            t(bwd_prev), t(fwd), BLEND)
        assert torch.equal(alone, got[c])
    # every mode but "exact" is the fused prefilter branch
    for mode in ("dual", "vol9"):
        for g, o in zip(_port_multi(mode), got):
            assert torch.equal(g, o)


def test_multi_exact_matches_jax(oracle):
    got = _port_multi("exact")
    for c, kind in enumerate(KIND_SETS[0]):
        np.testing.assert_allclose(got[c].numpy(),
                                   oracle["multi"][f"exact_{c}"],
                                   rtol=5e-5, atol=5e-5, err_msg=kind)
    # the exact form is another function than the prefilter form
    fused = _port_multi("prefilter")
    assert max(float((a - b).abs().max()) for a, b in zip(got, fused)) > 1e-3
    with pytest.raises(ValueError):
        _port_multi("exact", blend=None)
    with pytest.raises(ValueError):
        _port_multi("prefilter", blend=None)
    with pytest.raises(ValueError):
        _port_multi("nine")


@pytest.mark.parametrize("clamp", CLAMPS)
@pytest.mark.parametrize("label", list(MAP_AMPS))
@pytest.mark.parametrize("kinds", KIND_SETS, ids=["".join(k)
                                                  for k in KIND_SETS])
def test_pullback_stage_matches_jax(oracle, kinds, label, clamp):
    tg = grids.Grid3D(*SHAPE, H)
    fields = [torch.from_numpy(f) for f in _stage_fields(kinds)]
    maps = torch.from_numpy(_maps(50, MAP_AMPS[label]))
    dims = tuple(tg.dim_of(k) for k in kinds)
    want = oracle["stages"]
    tag = _tag(kinds, label, clamp)
    # the clip is exercised: some nodes of every kind clipped, not all
    for d in dims:
        pos = interp_fast.pullback_positions(maps, d, H, SHAPE, SHAPE)
        clipped = torch.zeros(SHAPE, dtype=torch.bool)
        for p, n in zip(pos, SHAPE):
            clipped |= (p < clamp) | (p > n - clamp)
        assert 0.0 < float(clipped.float().mean()) < 1.0
    before = interp_fast.pullback_sample.launches
    got = mp._pullback_stage(tg, maps, fields, kinds, clamp, clamp)
    padded = interp_fast.sample3_pullback(maps, fields, dims, H, SHAPE,
                                          clamp, clamp)
    assert interp_fast.pullback_sample.launches == before
    ext = tuple(padded.shape[1:])
    assert ext == ((16, 13, 21) if kinds[0] == "u" else SHAPE)
    jpad = want[f"{tag}_padded"][:, :ext[0], :ext[1], :ext[2]]
    for c, (kind, f) in enumerate(zip(kinds, fields)):
        scale = float(f.abs().max())
        w = want[f"{tag}_{c}"]
        assert got[c].shape == f.shape == w.shape
        np.testing.assert_allclose(got[c].numpy(), w, rtol=0,
                                   atol=1e-5 * scale, err_msg=kind)
        np.testing.assert_allclose(padded[c].numpy(), jpad[c], rtol=0,
                                   atol=1e-5 * scale, err_msg=kind)
        inside = padded[c][tuple(slice(0, n) for n in f.shape)]
        assert torch.equal(got[c][tuple(slice(0, n) for n in inside.shape)],
                           inside)
        if kind == "u":
            # past the block grid: zero in both packages
            assert not np.any(w[-1]) and not torch.any(got[c][-1])
        elif kind in "vw":
            # inside it: sampled in both
            assert np.any(np.take(w, -1, axis="uvw".index(kind)))


@pytest.mark.parametrize("clamp", CLAMPS)
@pytest.mark.parametrize("kinds", KIND_SETS, ids=["".join(k)
                                                  for k in KIND_SETS])
def test_pullback_plain_matches_per_kind_chain(kinds, clamp):
    """The fused plain version against map_at_lattice_3d + the plain
    trilinear sampler, kind by kind, on each kind's cell-lattice part."""
    tg = grids.Grid3D(*SHAPE, H)
    fields = [torch.from_numpy(f) for f in _stage_fields(kinds)]
    maps = torch.from_numpy(_maps(60, MAP_AMPS["wide"]))
    dims = tuple(tg.dim_of(k) for k in kinds)
    got = interp_fast.pullback_sample_plain(maps, fields, dims, H, SHAPE,
                                            clamp, clamp)
    assert torch.equal(got, interp_fast.pullback_sample(
        maps, fields, dims, H, SHAPE, clamp, clamp))
    for c, (kind, f) in enumerate(zip(kinds, fields)):
        pos = mp.map_at_lattice_3d(tg, maps, kind, clamp, clamp)
        want = interp_fast.trilerp_sample_plain(f[None], *pos, H,
                                                (tg.off_of(kind),))[0]
        sl = tuple(slice(0, min(a, b)) for a, b in zip(got.shape[1:],
                                                       want.shape))
        np.testing.assert_allclose(got[c][sl].numpy(), want[sl].numpy(),
                                   rtol=0, atol=1e-5 * float(f.abs().max()),
                                   err_msg=kind)


def test_pullback_sample_argument_checks():
    tg = grids.Grid3D(*SHAPE, H)
    maps = torch.from_numpy(_maps(50, 0.4))
    u, v, w = (tg.zeros(k) for k in "uvw")
    dims = tuple(tg.dim_of(k) for k in "uvw")

    def call(fields, dims, maps=maps):
        return interp_fast.pullback_sample(maps, fields, dims, H, SHAPE, 1.0,
                                           1.0)

    assert call([u, v, w], dims).shape == (3, 16, 13, 21)
    with pytest.raises(ValueError):          # C > 4
        call([u, v, w, u, v], dims + dims[:2])
    with pytest.raises(ValueError):          # no field
        call([], ())
    with pytest.raises(ValueError):          # a wrong field shape
        call([u, w, w], dims)
    with pytest.raises(ValueError):          # a wrong dims length
        call([u, v, w], dims[:2])
    with pytest.raises(ValueError):          # not a kind's staggering
        call([u, v, w], ((1, 1, 0),) + dims[1:])
    with pytest.raises(ValueError):          # a wrong map shape
        call([u, v, w], dims, maps=maps[:, :-1])


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
