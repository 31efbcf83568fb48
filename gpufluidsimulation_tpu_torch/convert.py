"""Carry solver state and configuration across from plain numpy values.

The port never sees a JAX object: callers flatten the JAX package's state
into numpy arrays under flat keys (``u``, ``rho``, ``vel_map.fwd``,
``vel_map.bwd``, ``frame``, ...) and its config into plain field values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpufluidsimulation_tpu_torch import config
from gpufluidsimulation_tpu_torch.bimocq.mapping import MappingState
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from gpufluidsimulation_tpu_torch.solvers.smoke3d import (
    Boundary3D,
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


_BOUNDARY_KEYS = {f.name for f in dataclasses.fields(Boundary3D)}


def _boundary(b, trans=None) -> Boundary3D:
    """A boundary from its plain field values. A callable ``trans`` of the
    JAX package (a closure over ``jax.numpy``) is never carried across:
    pass the port's own as `trans`, or the field must be None."""
    d = dict(b) if isinstance(b, dict) else dict(vars(b))
    if d.pop("sdf_grid", None) is not None or d.get("kind") == "voxel":
        raise NotImplementedError(
            "voxel boundaries are not ported (analytic sphere and box only)")
    their_trans = d.pop("trans", None)
    if their_trans is not None and trans is None:
        raise ValueError(
            "boundary trans is a callable of the other package: pass the "
            "port's own through boundary_trans")
    unknown = set(d) - _BOUNDARY_KEYS
    if unknown:
        raise ValueError(f"unknown boundary fields {sorted(unknown)}")
    for key in ("center", "velocity", "half_extents"):
        if key in d:
            d[key] = tuple(float(c) for c in d[key])
    return Boundary3D(trans=trans, **d)


# EngineMode fields of the JAX package whose value changes nothing the port
# computes: interpret mode, the Pallas-vs-XLA viscosity (one function), the
# window sampler's geometry (the kernels gather exactly), and the 2D
# particle transfers.
_MODE_IGNORED = ("interp_interpret", "pallas_diffuse", "interp_rr",
                 "particle_dense")
# ... and the one value of each other field that the port implements
_MODE_REQUIRED = {"interp_bf16": False, "sharded_sampling": ()}


def _engine_mode(m):
    """The port's EngineMode from the JAX mode's plain fields: carries
    ``spectral_poisson``, ``volume_dual`` and ``volume_vol9`` across, maps
    the JAX package's exact volume form (``fast_interp=False`` or
    ``volume_exact=True``) to ``volume_exact=True`` and its window
    sampler without adaptive taps (``interp_adaptive=False``, which
    leaves the JAX package the prefilter form) to ``volume_dual=False``,
    accepts fields that do not change the result, and raises for a value
    the port cannot honour: the red-black smoother off (which
    ``fast_interp=False`` implies unless ``rbgs`` is given), bf16 windows
    and sharded sampling."""
    if m is None or isinstance(m, config.EngineMode):
        return m
    d = dict(m) if isinstance(m, dict) else dict(vars(m))
    spectral = d.pop("spectral_poisson", None)
    fast = d.pop("fast_interp", None)
    exact = bool(d.pop("volume_exact", None)) or fast is False
    rbgs = d.pop("rbgs", None)
    if rbgs is False or (rbgs is None and fast is False):
        raise NotImplementedError("engine_mode.rbgs=False is not ported "
                                  "(the Jacobi-smoothed V-cycle)")
    for key in _MODE_IGNORED:
        d.pop(key, None)
    dual = d.pop("volume_dual", None)
    vol9 = d.pop("volume_vol9", None)
    if d.pop("interp_adaptive", None) is False:
        dual = False
    if exact:      # the volume form is exact whatever these say
        dual = vol9 = None
    for key, allowed in _MODE_REQUIRED.items():
        val = d.pop(key, None)
        if val is not None and val != allowed:
            raise NotImplementedError(
                f"engine_mode.{key}={val!r} is not ported")
    if d:
        raise ValueError(f"unknown engine_mode fields {sorted(d)}")
    return config.EngineMode(spectral_poisson=spectral,
                             volume_exact=True if exact else None,
                             volume_dual=dual, volume_vol9=vol9)


def config_from_dict(d: dict, boundary_trans=()) -> Smoke3DConfig:
    """The port's config from the JAX config's plain field values
    (``dataclasses.asdict`` of it, or the same keys by hand).
    ``engine_mode`` keeps its projection and its volume form;
    `boundary_trans` gives the port's own ``trans(frame)`` for each
    boundary that moves by one (None for the others)."""
    d = dict(d)
    d["engine_mode"] = _engine_mode(d.get("engine_mode"))
    known = {f.name for f in dataclasses.fields(Smoke3DConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown config fields {sorted(unknown)}")
    if "scheme" in d:
        d["scheme"] = Scheme(int(d["scheme"]))
    if "emitters" in d:
        d["emitters"] = tuple(_emitter(e) for e in d["emitters"])
    if "boundaries" in d:
        trans = tuple(boundary_trans) + (None,) * len(d["boundaries"])
        d["boundaries"] = tuple(_boundary(b, t)
                                for b, t in zip(d["boundaries"], trans))
    return Smoke3DConfig(**d)
