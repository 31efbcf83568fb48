"""Small helpers over the port's state dataclasses."""

from __future__ import annotations

import dataclasses

import torch


def fresh_buffers(tree):
    """`tree` with every tensor leaf copied into a buffer of its own,
    through nested dataclasses: scene inits alias fields (u == u_init ==
    u_origin), and a later in-place write to one must not reach the
    others."""
    if torch.is_tensor(tree):
        return tree.clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: fresh_buffers(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree
