"""Checkpoints cross between the port and the JAX package, both ways, with
no JAX step.

For BiMocq under per-frame reinitialization at blend 1 (the dieted state:
no prev tier, no ``vel_map.bwd_prev``, a counter-only scalar map) and
under counter reinitialization at blend 0.5 (every leaf), a JAX state is
made by filling the leaves of the JAX ``init_state`` with seeded numpy
values on a 6x8x10 grid.

* JAX ``save_state``, then the port's ``load_state``: the loaded state's
  ``convert.state_to_numpy`` equals the JAX leaves, and ``substeps`` is 0.
* The port's ``save_state``, then JAX ``load_state``: it succeeds, the
  arrays are equal, and the file's key set, dtypes and shapes are those
  the JAX package writes for the same state.
* A checkpoint of the other configuration, or of another grid, is refused
  in both packages with the missing/unexpected-field or shape message.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu.io_utils import checkpoint as jcheckpoint
from gpufluidsimulation_tpu.scenes import scenes3d as jscenes
from gpufluidsimulation_tpu.solvers import smoke3d as jsmoke
from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme
from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.io_utils import checkpoint
from gpufluidsimulation_tpu_torch.solvers import smoke3d
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

CONFIGS = {
    "always": dict(reinit_mode="always", blend_coeff=1.0),
    "counter_blend": dict(reinit_mode="counter", blend_coeff=0.5),
}


def _jax_cfg(name, ni=6):
    return jscenes.vortex_collision_config(
        ni=ni, nj=8, nk=10, scheme=JScheme.BIMOCQ, proj_max_iters=12,
        **CONFIGS[name])


def _seeded_jax_state(jcfg, seed):
    """JAX init_state(jcfg) with every leaf replaced by seeded values of
    its own shape and dtype."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jsmoke.init_state(jcfg))
    new = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.integer):
            new.append(rng.integers(-40, 40, a.shape).astype(a.dtype))
        else:
            new.append(rng.standard_normal(a.shape).astype(a.dtype))
    return jax.tree_util.tree_unflatten(treedef, new)


def _jax_arrays(path):
    """{key without 'f:.': array} of a checkpoint file."""
    with np.load(path) as z:
        return {k[3:]: z[k] for k in z.files if k.startswith("f:")}


def _port(jcfg):
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    return smoke3d.Smoke3D(cfg, device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, name):
    jcfg = _jax_cfg(name)
    jstate = _seeded_jax_state(jcfg, seed=1)
    path = jcheckpoint.save_state(str(tmp_path / "jax.npz"), jstate)
    solver = _port(jcfg)
    template = dataclasses.replace(solver.init_state(), substeps=3,
                                   slab_clamped=3)
    st = checkpoint.load_state(path, template)
    assert st.substeps == 0 and st.slab_clamped == 0
    assert isinstance(st.frame, int) and isinstance(st.cfl, float)
    got = convert.state_to_numpy(st)
    got.pop("substeps")
    got.pop("slab_clamped")
    want = _jax_arrays(path)
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    assert all(t.device.type == "cpu" for t in (st.u, st.vel_map.bwd))
    # the loaded state steps
    assert solver.step(st).frame == int(want["frame"]) + 1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_checkpoint_loads_in_jax(tmp_path, name):
    jcfg = _jax_cfg(name)
    jstate = _seeded_jax_state(jcfg, seed=2)
    jpath = jcheckpoint.save_state(str(tmp_path / "jax.npz"), jstate)
    solver = _port(jcfg)
    st = checkpoint.load_state(jpath, solver.init_state())
    st = dataclasses.replace(st, substeps=2)       # never written
    path = checkpoint.save_state(str(tmp_path / "sub" / "port.npz"), st)
    loaded = jcheckpoint.load_state(path, jsmoke.init_state(jcfg))
    with np.load(path) as mine, np.load(jpath) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for key in theirs.files:
            assert mine[key].dtype == theirs[key].dtype, key
            assert mine[key].shape == theirs[key].shape, key
            np.testing.assert_array_equal(mine[key], theirs[key],
                                          err_msg=key)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(loaded)[0],
                          jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(kp))
    if name == "always":
        with np.load(path) as z:
            assert "f:.scalar_map.reinit_count" in z.files
            assert not any("prev" in k or k.startswith("f:.scalar_map.fwd")
                           for k in z.files)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_other_config_is_refused(tmp_path, direction):
    always, counter = _jax_cfg("always"), _jax_cfg("counter_blend")
    if direction == "jax_to_port":
        path = jcheckpoint.save_state(
            str(tmp_path / "a.npz"), _seeded_jax_state(always, 3))
        with pytest.raises(ValueError, match="missing fields.*prev"):
            checkpoint.load_state(path, _port(counter).init_state())
        path = jcheckpoint.save_state(
            str(tmp_path / "c.npz"), _seeded_jax_state(counter, 3))
        with pytest.raises(ValueError, match="unexpected fields.*prev"):
            checkpoint.load_state(path, _port(always).init_state())
        with pytest.raises(ValueError, match="shape"):
            checkpoint.load_state(
                path, _port(_jax_cfg("counter_blend", ni=7)).init_state())
    else:
        path = checkpoint.save_state(str(tmp_path / "a.npz"),
                                     _port(always).init_state())
        with pytest.raises(ValueError, match="missing fields.*prev"):
            jcheckpoint.load_state(path, jsmoke.init_state(counter))
        path = checkpoint.save_state(str(tmp_path / "c.npz"),
                                     _port(counter).init_state())
        with pytest.raises(ValueError, match="unexpected fields.*prev"):
            jcheckpoint.load_state(path, jsmoke.init_state(always))


def test_unversioned_checkpoint_is_refused(tmp_path):
    path = tmp_path / "v1.npz"
    np.savez(path, leaf_0=np.zeros(3))
    solver = _port(_jax_cfg("always"))
    with pytest.raises(ValueError, match="predates the keyed format"):
        checkpoint.load_state(str(path), solver.init_state())


def test_state_leaves_follow_the_jax_key_order():
    """convert.state_leaves walks the fields in the JAX pytree's order."""
    for name in CONFIGS:
        jcfg = _jax_cfg(name)
        jkeys, _, _ = jcheckpoint._path_keys(jsmoke.init_state(jcfg))
        keys = ["f:." + k for k, _ in convert.state_leaves(
            _port(jcfg).init_state()) if k not in checkpoint._PORT_ONLY]
        assert keys == jkeys
        assert all(isinstance(v, (torch.Tensor, int, float))
                   for _, v in convert.state_leaves(
                       _port(jcfg).init_state()))
