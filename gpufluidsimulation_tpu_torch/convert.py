"""Carry solver state and configuration across from plain numpy values.

The port never sees a JAX object: callers flatten the JAX package's state
into numpy arrays under flat keys (``u``, ``rho``, ``vel_map.fwd``,
``vel_map.bwd``, ``frame``, ...) and its config into plain field values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpufluidsimulation_tpu_torch.bimocq.mapping import MappingState
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from gpufluidsimulation_tpu_torch.solvers.smoke3d import (
    Emitter3D,
    Smoke3DConfig,
    Smoke3DState,
    init_state,
)

_INT_KEYS = ("frame", "vel_last_reinit", "scalar_last_reinit", "proj_iters",
             "interp_overflow", "substeps")
_FLOAT_KEYS = ("cfl",)
_MAP_KEYS = ("fwd", "bwd", "bwd_prev")


def _tensor(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def state_from_numpy(arrays: dict, cfg: Smoke3DConfig, device) -> Smoke3DState:
    """Build a state from flat numpy arrays; keys the dict lacks keep
    ``init_state``'s values, and ``None`` leaves of the dieted state stay
    ``None``."""
    s = init_state(cfg, device)
    kw = {}
    for f in dataclasses.fields(s):
        name = f.name
        cur = getattr(s, name)
        if isinstance(cur, MappingState):
            mkw = {}
            for k in _MAP_KEYS:
                key = f"{name}.{k}"
                if key in arrays and getattr(cur, k) is not None:
                    mkw[k] = _tensor(arrays[key], device)
            key = f"{name}.reinit_count"
            if key in arrays:
                mkw["reinit_count"] = int(arrays[key])
            kw[name] = dataclasses.replace(cur, **mkw)
        elif name in arrays:
            if name in _INT_KEYS:
                kw[name] = int(arrays[name])
            elif name in _FLOAT_KEYS:
                kw[name] = float(arrays[name])
            elif cur is not None:
                kw[name] = _tensor(arrays[name], device)
    return dataclasses.replace(s, **kw)


def state_to_numpy(state: Smoke3DState) -> dict:
    """Flat numpy arrays of every non-None leaf of `state`."""
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if val is None:
            continue
        if isinstance(val, MappingState):
            for k in _MAP_KEYS:
                m = getattr(val, k)
                if m is not None:
                    out[f"{f.name}.{k}"] = m.detach().cpu().numpy()
            out[f"{f.name}.reinit_count"] = np.int32(val.reinit_count)
        elif isinstance(val, torch.Tensor):
            out[f.name] = val.detach().cpu().numpy()
        elif f.name in _FLOAT_KEYS:
            out[f.name] = np.float32(val)
        else:
            out[f.name] = np.int32(val)
    return out


_EMITTER_KEYS = {f.name for f in dataclasses.fields(Emitter3D)}


def _emitter(e) -> Emitter3D:
    d = dict(e) if isinstance(e, dict) else dict(vars(e))
    for extra in ("sdf_grid", "trans", "emit_velocity"):
        if d.pop(extra, None) is not None:
            raise NotImplementedError(
                f"emitter {extra} is not ported (analytic spheres only)")
    unknown = set(d) - _EMITTER_KEYS
    if unknown:
        raise ValueError(f"unknown emitter fields {sorted(unknown)}")
    d["center"] = tuple(float(c) for c in d["center"])
    return Emitter3D(**d)


def config_from_dict(d: dict) -> Smoke3DConfig:
    """The port's config from the JAX config's plain field values
    (``dataclasses.asdict`` of it, or the same keys by hand). The JAX
    package's ``engine_mode`` is dropped: the port has one mode."""
    d = dict(d)
    d.pop("engine_mode", None)
    known = {f.name for f in dataclasses.fields(Smoke3DConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown config fields {sorted(unknown)}")
    if "scheme" in d:
        d["scheme"] = Scheme(int(d["scheme"]))
    if "emitters" in d:
        d["emitters"] = tuple(_emitter(e) for e in d["emitters"])
    if "boundaries" in d:
        d["boundaries"] = tuple(d["boundaries"])
    return Smoke3DConfig(**d)
