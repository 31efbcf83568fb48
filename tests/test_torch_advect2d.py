"""The port's 2D advection against the JAX package's 2D ``ops.advect``.

On a (24, 40) grid (h = 1/24) with seeded smooth velocities of amplitude
0.2 and no symmetry: the RK3 step, the CFL-substepped trace both ways,
the semi-Lagrangian, MacCormack and BFECC transport of each kind with
its corner clamp, the 9-point neighbourhood clamp, one DMC substep and
both map marches (dt 0.5: three substeps, the last a partial one). The
JAX references run op by op (``jax.disable_jit``) under
``EngineMode(fast_interp=False)`` in one child process shared by the
workers (tests/jax_oracle.shared): jitted, the JAX package's exact DMC
substep differs from its own op-by-op form at band-edge nodes (ROADMAP
§3 item 3(g)), which one test locates. Bound: 1e-6 of each result's
scale.

The port computes once what the JAX package computes twice with the
same inputs (the MacCormack and BFECC clamp's backtrace and fallback,
the DMC march's velocity and slopes): those shortcuts are held here bit
for bit against the long way round.
"""

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core.grids import Grid2D
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
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
    """Velocities, one field of each kind, a displaced map, the float32
    CFL substep and world positions to trace."""
    u = _smooth((NI + 1, NJ), 1, 0.2)
    v = _smooth((NI, NJ + 1), 2, 0.2)
    mv = np.float32(np.float32(max(u.max(), v.max())) + np.float32(1e-5))
    cfldt = np.float32(np.float32(H) / mv)
    g = Grid2D(NI, NJ, H)
    fields = {k: _smooth(g.shape_of(k), 10 + i, 1.0 + i)
              for i, k in enumerate(KINDS)}
    px, py = (c.numpy() for c in g.node_coords("c"))
    maps = np.stack([px + _smooth(px.shape, 20, 0.5 * H),
                     py + _smooth(py.shape, 21, 0.5 * H)]).astype(np.float32)
    return dict(u=u, v=v, cfldt=cfldt, fields=fields, maps=maps)


def _jax_run(name):
    import jax
    import jax.numpy as jnp

    from gpufluidsimulation_tpu import config as jconfig
    from gpufluidsimulation_tpu.core.grids import Grid2D as JGrid2D
    from gpufluidsimulation_tpu.ops import advect as ja

    assert name == "advect2d"
    d = _inputs()
    g = JGrid2D(NI, NJ, H)
    u, v = jnp.asarray(d["u"]), jnp.asarray(d["v"])
    cfldt, dt = jnp.float32(d["cfldt"]), jnp.float32(DT)
    out = {}
    with jconfig.engine_mode_scope(jconfig.EngineMode(fast_interp=False)), \
            jax.disable_jit():
        px, py = g.node_coords("u")
        out["rk3"] = jnp.stack(ja.trace_rk3_2d(u, v, H, jnp.float32(-0.3),
                                               px, py))
        for sign in (1, -1):
            out[f"trace{sign}"] = jnp.stack(ja.trace_2d(
                u, v, H, cfldt, sign * dt, px, py))
        for kind in KINDS:
            f = jnp.asarray(d["fields"][kind])
            out[f"semilag_{kind}"] = ja.semilag_2d(g, kind, f, u, v, None,
                                                   cfldt, dt)
            out[f"maccormack_{kind}"] = ja.maccormack_2d(g, kind, f, u, v,
                                                         cfldt, dt)
            out[f"bfecc_{kind}"] = ja.bfecc_2d(g, kind, f, u, v, cfldt, dt)
            dst = f + 0.3 * jnp.sin(7.0 * f)
            out[f"clamp_{kind}"] = ja._maccormack_clamp_2d(
                g, kind, f, dst, u, v, cfldt, dt)
            out[f"neigh_{kind}"] = ja.clamp_extrema_neighborhood(f, dst)
        m = jnp.asarray(d["maps"])
        out["dmc1"] = jnp.stack(ja.dmc_backward_step_2d(g, u, v, m[0], m[1],
                                                        cfldt))
        out["bwd"] = jnp.stack(ja.update_backward_map_2d(
            g, u, v, (m[0], m[1]), cfldt, dt))
        out["fwd"] = jnp.stack(ja.update_forward_map_2d(
            g, u, v, (m[0], m[1]), cfldt, dt))
        ident = g.node_coords("c")
        out["dmc1_ident"] = jnp.stack(ja.dmc_backward_step_2d(
            g, u, v, *ident, cfldt))
    with jconfig.engine_mode_scope(jconfig.EngineMode(fast_interp=False)):
        out["dmc1_ident_jit"] = jnp.stack(jax.jit(
            lambda u_, v_, s_: ja.dmc_backward_step_2d(g, u_, v_, *ident,
                                                       s_))(u, v, cfldt))
    return {k: np.asarray(val) for k, val in out.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__,
                             "advect2d")["advect2d"]


def _port():
    d = _inputs()
    t = {k: torch.from_numpy(d[k]) for k in ("u", "v", "maps")}
    t["fields"] = {k: torch.from_numpy(f) for k, f in d["fields"].items()}
    return Grid2D(NI, NJ, H), t, d["cfldt"]


def _close(got, want, tol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, scale)


def test_traces_match_jax(ref):
    g, t, cfldt = _port()
    px, py = g.node_coords("u")
    _close(torch.stack(advect.trace_rk3_2d(t["u"], t["v"], H, -0.3, px,
                                           py)), ref["rk3"])
    for sign in (1, -1):
        _close(torch.stack(advect.trace_2d(t["u"], t["v"], H, cfldt,
                                           sign * DT, px, py)),
               ref[f"trace{sign}"])
    assert len(advect.substeps(cfldt, DT)) == 3


@pytest.mark.parametrize("kind", KINDS)
def test_transport_and_clamps_match_jax(ref, kind):
    g, t, cfldt = _port()
    u, v, f = t["u"], t["v"], t["fields"][kind]
    _close(advect.semilag_2d(g, kind, f, u, v, None, cfldt, DT),
           ref[f"semilag_{kind}"])
    mac = advect.maccormack_2d(g, kind, f, u, v, cfldt, DT)
    _close(mac, ref[f"maccormack_{kind}"])
    _close(advect.bfecc_2d(g, kind, f, u, v, cfldt, DT), ref[f"bfecc_{kind}"])
    dst = f + 0.3 * torch.sin(7.0 * f)
    _close(advect._maccormack_clamp_2d(g, kind, f, dst, u, v, cfldt, DT),
           ref[f"clamp_{kind}"])
    _close(advect.clamp_extrema_neighborhood(f, dst), ref[f"neigh_{kind}"])
    # MacCormack's clamp at the forward stage's own trace and fallback is
    # the standalone clamp's result
    fwd = advect.semilag_2d(g, kind, f, u, v, None, cfldt, DT)
    back = advect.semilag_2d(g, kind, fwd, u, v, None, cfldt, -DT)
    np.testing.assert_array_equal(
        mac.numpy(), advect._maccormack_clamp_2d(
            g, kind, f, fwd + 0.5 * (f - back), u, v, cfldt, DT).numpy())


def test_multi_field_transport_is_each_fields():
    g, t, cfldt = _port()
    u, v = t["u"], t["v"]
    a, b = t["fields"]["c"], 3.0 * t["fields"]["c"] - 1.0
    for multi, single in ((advect.semilag_multi_2d, None),
                          (advect.maccormack_multi_2d, advect.maccormack_2d),
                          (advect.bfecc_multi_2d, advect.bfecc_2d)):
        both = multi(g, "c", [a, b], u, v, cfldt, DT)
        for f, got in zip((a, b), both):
            want = (advect.semilag_2d(g, "c", f, u, v, None, cfldt, DT)
                    if single is None else single(g, "c", f, u, v, cfldt,
                                                  DT))
            np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_dmc_and_map_marches_match_jax(ref):
    g, t, cfldt = _port()
    u, v, m = t["u"], t["v"], t["maps"]
    _close(torch.stack(advect.dmc_backward_step_2d(g, u, v, m[0], m[1],
                                                   cfldt)), ref["dmc1"])
    bwd = torch.stack(advect.update_backward_map_2d(g, u, v, (m[0], m[1]),
                                                    cfldt, DT))
    _close(bwd, ref["bwd"])
    _close(torch.stack(advect.update_forward_map_2d(g, u, v, (m[0], m[1]),
                                                    cfldt, DT)), ref["fwd"])
    # the march's shared velocity and slopes give the substeps' own maps
    mx, my = m[0], m[1]
    for sub in advect.substeps(cfldt, DT):
        mx, my = advect.dmc_backward_step_2d(g, u, v, mx, my, sub)
    np.testing.assert_array_equal(bwd.numpy(), torch.stack([mx, my]).numpy())
    assert interp_fast.bilerp_sample.launches == 0


def test_dmc_step_from_the_identity_and_the_jitted_jax_step(ref):
    """ROADMAP §3 item 3(g): one DMC substep from the identity map. The
    port agrees with the JAX step run op by op; wherever the jitted JAX
    step leaves round-off of it, the node lies next to a wall, where the
    upwind MAC sample sits on its band's edge."""
    g, t, cfldt = _port()
    ident = g.node_coords("c")
    _close(torch.stack(advect.dmc_backward_step_2d(g, t["u"], t["v"],
                                                   *ident, cfldt)),
           ref["dmc1_ident"])
    off = np.abs(ref["dmc1_ident_jit"].astype(np.float64)
                 - ref["dmc1_ident"]).max(axis=0) > 1e-5
    for i, j in np.argwhere(off):
        assert i in (1, NI - 2) or j in (1, NJ - 2), (i, j)


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
