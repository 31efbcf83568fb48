"""Checkpoint and resume of the full solver state, in the JAX package's
format v2, both ways: a checkpoint the JAX package wrote resumes here, and
one written here loads in ``gpufluidsimulation_tpu.io_utils.checkpoint.
load_state``.

Format v2 is one compressed NPZ whose arrays are keyed by the state's
pytree path in the JAX package (``f:.u``, ``f:.vel_map.bwd``,
``f:.scalar_map.reinit_count``, ``f:.frame``, ...) beside a
``__gfs_ckpt_version__`` marker. The JAX state drops ``None`` leaves, and
so does the port's (``convert.state_leaves``): under the dieted
always/blend-1 state neither writes the prev tier, ``vel_map.bwd_prev``
or the scalar maps. Fields are float32 arrays, counters int32 0-d arrays
and ``cfl`` a float32 0-d array, as the JAX state holds them. The port's
own diagnostics ``substeps`` and ``slab_clamped`` have no JAX leaf: they
are not written, and a loaded state starts with 0. A checkpoint written
under another configuration is refused with an error that names the
missing and unexpected fields, or the field whose shape differs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gpufluidsimulation_tpu_torch import convert

_VERSION = 2
_PORT_ONLY = ("substeps", "slab_clamped")


def _keyed_leaves(state):
    """(path key, value) of every leaf the JAX state would hold."""
    return [("f:." + key, val) for key, val in convert.state_leaves(state)
            if key not in _PORT_ONLY]


def _shape(val):
    return tuple(val.shape) if isinstance(val, torch.Tensor) else ()


def save_state(path: str, state) -> str:
    """Write `state` to `path` (one device-to-host copy a field)."""
    arrays = {}
    host = convert.state_to_numpy(state)
    for key, _ in _keyed_leaves(state):
        arrays[key] = np.asarray(host[key[3:]])
    arrays["__gfs_ckpt_version__"] = np.int64(_VERSION)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def load_state(path: str, template):
    """Restore into the structure of `template` (a state of the same
    configuration, e.g. ``Smoke3D.init_state()``); each field lands on
    its template field's device."""
    leaves = _keyed_leaves(template)
    keys = [k for k, _ in leaves]
    with np.load(path, allow_pickle=False) as z:
        if "__gfs_ckpt_version__" not in z.files:
            raise ValueError(
                f"checkpoint {path!r} predates the keyed format "
                f"(v{_VERSION}): it was written with flat leaf indices "
                "against an older state layout and cannot be safely "
                "restored — re-save from a current run")
        saved = {k for k in z.files if k.startswith("f:")}
        missing = [k for k in keys if k not in saved]
        extra = sorted(saved - set(keys))
        if missing or extra:
            raise ValueError(
                "checkpoint/config mismatch: "
                + (f"missing fields {missing[:8]} " if missing else "")
                + (f"unexpected fields {extra[:8]}" if extra else "")
            )
        arrays = {}
        for k, ref in leaves:
            arr = z[k]
            if arr.shape != _shape(ref):
                raise ValueError(
                    f"checkpoint field {k} shape {arr.shape} != template "
                    f"{_shape(ref)} — resolution/config mismatch"
                )
            arrays[k[3:]] = arr
    arrays.update(dict.fromkeys(_PORT_ONLY, 0))
    return convert.fill_state(template, arrays)
