"""The port's 2D BiMocq mapping against the JAX package's 2D
``bimocq.mapping``.

On a (24, 40) grid (h = 1/24): the map marches from the identity, the
two-level pull-back of each kind at blend 1 and 0.5, the correction with
its 9-point clamp, the accumulate at coefficients 1 and 2, the distortion
estimate, the 5-point volume stencil and the band tables, through maps
displaced smoothly by up to 3 cells from the identity and fields with
no symmetry. The JAX references run op by op under
``EngineMode(fast_interp=False)`` in one child process shared by the
workers (tests/jax_oracle.shared). Bound: 1e-6 of each result's scale.
The multi-field forms the solver calls (rho with T through the same
maps, two changes in one accumulate) are held bit for bit against the
single-field ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
from gpufluidsimulation_tpu_torch.core.grids import Grid2D
from tests import jax_oracle

NI, NJ = 24, 40
H = 1.0 / NI
DT = np.float32(0.5)
KINDS = ("c", "u", "v")


@pytest.fixture(autouse=True)
def _one_torch_thread():
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
        k = rng.uniform(0.5, 2.0, len(shape)) * 2 * np.pi / np.array(shape)
        f += np.sin(sum(kk * ii for kk, ii in zip(k, idx))
                    + rng.uniform(0, 2 * np.pi))
    return (amp * f / 2).astype(np.float32)


def _inputs():
    g = Grid2D(NI, NJ, H)
    px, py = (c.numpy() for c in g.node_coords("c"))

    def wobbled(seed):
        return np.stack([px + _smooth(px.shape, seed, 3.0 * H),
                         py + _smooth(py.shape, seed + 1, 3.0 * H)]).astype(
            np.float32)

    d = dict(u=_smooth(g.shape_u, 1, 0.2), v=_smooth(g.shape_v, 2, 0.2),
             bwd=wobbled(30), bwd_prev=wobbled(32), fwd=wobbled(34))
    mv = np.float32(np.float32(max(d["u"].max(), d["v"].max()))
                    + np.float32(1e-5))
    d["cfldt"] = np.float32(np.float32(H) / mv)
    for i, kind in enumerate(KINDS):
        shape = g.shape_of(kind)
        for j, name in enumerate(("semi", "init", "origin", "d", "d_prev",
                                  "change")):
            d[f"{kind}_{name}"] = _smooth(shape, 100 + 10 * i + j,
                                          1.0 + 2 * j)
    return d


def _jax_run(name):
    import jax
    import jax.numpy as jnp

    from gpufluidsimulation_tpu import config as jconfig
    from gpufluidsimulation_tpu.bimocq import mapping as jm
    from gpufluidsimulation_tpu.core.grids import Grid2D as JGrid2D

    assert name == "mapping2d"
    d = {k: jnp.asarray(v) for k, v in _inputs().items()}
    g = JGrid2D(NI, NJ, H)
    out = {}
    with jconfig.engine_mode_scope(jconfig.EngineMode(fast_interp=False)), \
            jax.disable_jit():
        m = jm.update_mapping_2d(jm.init_mapping(g, 2), g, d["u"], d["v"],
                                 d["cfldt"], jnp.float32(DT))
        out["march_fwd"], out["march_bwd"] = m.fwd, m.bwd
        re = jm.reinitialize(m, g)
        out["re_bwd_prev"], out["re_fwd"] = re.bwd_prev, re.fwd
        for kind in KINDS:
            f = {n: d[f"{kind}_{n}"] for n in ("semi", "init", "origin", "d",
                                               "d_prev", "change")}
            for blend in (1.0, 0.5):
                out[f"advect_{kind}_{blend}"] = jm.advect_bimocq_2d(
                    g, kind, f["semi"], f["init"], f["origin"], f["d"],
                    f["d_prev"], d["bwd"], d["bwd_prev"], blend)
            out[f"correct_{kind}"] = jm.correct_2d(
                g, kind, f["semi"], f["init"], f["d"], d["fwd"], d["bwd"])
            for coeff in (1.0, 2.0):
                out[f"accum_{kind}_{coeff}"] = jm.accumulate_2d(
                    g, kind, f["d"], f["change"], d["fwd"], coeff)
            out[f"vol_{kind}"] = jm._volume_eval_2d(
                g, kind, lambda px, py: px * py - 0.5 * px)
        out["distortion"] = jm.estimate_distortion_2d(g, d["bwd"], d["fwd"])
    return {k: np.asarray(val) for k, val in out.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__,
                             "mapping2d")["mapping2d"]


def _port():
    return Grid2D(NI, NJ, H), {k: (torch.from_numpy(v)
                                   if isinstance(v, np.ndarray) else v)
                               for k, v in _inputs().items()}


def _close(got, want, tol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, scale)


def _fields(d, kind):
    return {n: d[f"{kind}_{n}"] for n in ("semi", "init", "origin", "d",
                                          "d_prev", "change")}


def test_map_marches_and_reinit_match_jax(ref):
    g, d = _port()
    m0 = mp.init_mapping(g)
    assert m0.fwd.shape == (2, NI, NJ) and m0.bwd_prev is not None
    np.testing.assert_array_equal(m0.fwd.numpy(),
                                  mp.identity_map_2d(g).numpy())
    m = mp.update_mapping_2d(m0, g, d["u"], d["v"], d["cfldt"], DT)
    _close(m.fwd, ref["march_fwd"])
    _close(m.bwd, ref["march_bwd"])
    re = mp.reinitialize(m, g)
    assert re.reinit_count == 1
    np.testing.assert_array_equal(re.bwd_prev.numpy(), m.bwd.numpy())
    np.testing.assert_array_equal(re.fwd.numpy(), ref["re_fwd"])


@pytest.mark.parametrize("kind", KINDS)
def test_pullback_correct_accumulate_match_jax(ref, kind):
    g, d = _port()
    f = _fields(d, kind)
    for blend in (1.0, 0.5):
        _close(mp.advect_bimocq_2d(g, kind, f["semi"], f["init"],
                                   f["origin"], f["d"], f["d_prev"],
                                   d["bwd"], d["bwd_prev"], blend),
               ref[f"advect_{kind}_{blend}"])
    _close(mp.correct_2d(g, kind, f["semi"], f["init"], f["d"], d["fwd"],
                         d["bwd"]), ref[f"correct_{kind}"])
    for coeff in (1.0, 2.0):
        _close(mp.accumulate_2d(g, kind, f["d"], f["change"], d["fwd"],
                                coeff), ref[f"accum_{kind}_{coeff}"])
    _close(mp._volume_eval_2d(g, kind, lambda px, py: px * py - 0.5 * px),
           ref[f"vol_{kind}"])


def test_distortion_matches_jax(ref):
    g, d = _port()
    got = mp.estimate_distortion_2d(g, d["bwd"], d["fwd"])
    assert got.dim() == 0
    _close(got, ref["distortion"])
    assert float(got) > 2 * H


def test_band_tables_match_jax():
    from gpufluidsimulation_tpu.bimocq import mapping as jm

    for table in ("_BANDS_2D_ADVECT", "_BANDS_2D_CORRECT", "_BANDS_2D_ACCUM"):
        assert getattr(mp, table) == getattr(jm, table)
    assert mp._VOL2 == tuple(jm._VOL2)
    for shape in ((25, 40), (24, 41)):
        for a, b in (((1, 0), (2, 1)), ((2, 2), (3, 3))):
            np.testing.assert_array_equal(mp._band2(shape, a, b).numpy(),
                                          np.asarray(jm._band2(shape, a, b)))


@pytest.mark.parametrize("blend", [1.0, 0.5])
def test_multi_field_forms_are_each_fields(blend):
    """rho and T through the same maps in one call give each one's
    single-field result; an accumulate of two changes adds them in
    order."""
    g, d = _port()
    a, b = _fields(d, "c"), _fields(d, "u")
    b = {k: v[:NI] for k, v in b.items()}      # a second cell field
    both = mp.advect_bimocq_multi_2d(
        g, "c", [a["semi"], b["semi"]], [a["init"], b["init"]],
        [a["origin"], b["origin"]], [a["d"], b["d"]],
        [a["d_prev"], b["d_prev"]], d["bwd"], d["bwd_prev"], blend)
    for f, got in zip((a, b), both):
        want = mp.advect_bimocq_2d(g, "c", f["semi"], f["init"], f["origin"],
                                   f["d"], f["d_prev"], d["bwd"],
                                   d["bwd_prev"], blend)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    both = mp.correct_multi_2d(g, "c", [a["semi"], b["semi"]],
                               [a["init"], b["init"]], [a["d"], b["d"]],
                               d["fwd"], d["bwd"])
    for f, got in zip((a, b), both):
        want = mp.correct_2d(g, "c", f["semi"], f["init"], f["d"], d["fwd"],
                             d["bwd"])
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    (got,) = mp.accumulate_multi_2d(
        g, "c", [(a["d"], [(a["change"], 1.0), (b["change"], blend)])],
        d["fwd"])
    want = mp.accumulate_2d(g, "c", mp.accumulate_2d(
        g, "c", a["d"], a["change"], d["fwd"], 1.0), b["change"], d["fwd"],
        blend)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert dataclasses.is_dataclass(mp.init_mapping(g))


jax_oracle.prefetch(__file__, "mapping2d")


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
