"""GPipe-style pipeline parallelism over a mesh axis (designed for "pod")
— counterpart of ``repro/runtime/pipeline_parallel.py``.

Stage ``s`` holds slice ``s`` of the stage params (stacked on a leading
stage axis) on the ``s``-th mesh device along ``axis`` (the other mesh
coordinates 0), and every stage applies the same ``stage_fn``: the
pattern units of ``LMModel`` satisfy this (``transformer.PatternUnit``
through ``torch.func.functional_call``).

The schedule is the reference's skewed one: ``n_micro + n_stages - 1``
ticks; at tick ``t`` stage 0 takes microbatch ``t``, stage ``s`` works on
what stage ``s - 1`` handed it at the end of tick ``t - 1``, the last
stage emits microbatch ``t - (n_stages - 1)``, and the handoff (the
reference's ``ppermute``) is a copy of each stage's output to the next
stage's mesh device.  The reference's stages compute during the bubble
on values it throws away; here a stage with nothing to work on skips
the tick.  One process drives every stage, so within a tick the stages
run one after another, in stage order; stages on one card share its
stream.  Bubble fraction is (S-1)/(M+S-1), reported by
:func:`bubble_fraction`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import _leaves, _rebuild
from repro_torch.runtime.mesh_rules import PartitionSpec


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _stage_devices(mesh, axis: str):
    """The mesh device of each stage: coordinate ``s`` along ``axis``,
    0 along the others."""
    out = []
    for s in range(mesh.shape[axis]):
        index = 0
        for name in mesh.axis_names:
            index = index * mesh.shape[name] + (s if name == axis else 0)
        out.append(mesh.devices[index])
    return out


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   *, mesh, axis: str = "pod", params_specs=None,
                   micro_spec: Optional[PartitionSpec] = None
                   ) -> torch.Tensor:
    """Run a pipelined stack.

    stage_fn(params_slice, x) -> x, applied by every stage.
    stage_params: a tree of tensors with leading dim == n_stages.
    x_micro: (n_micro, B_micro, ...) microbatched input, whole on every
    stage (the reference's replicated ``micro_spec``).
    ``params_specs`` (a tree of ``PartitionSpec``) and ``micro_spec``
    are the reference's: the schedule runs the params split over
    ``axis`` on their leading dim and the microbatches whole, and refuses
    other layouts.

    Returns (n_micro, B_micro, ...) outputs on ``x_micro``'s device.
    """
    n_stages = mesh.shape[axis]
    n_micro = x_micro.shape[0]
    if micro_spec is not None and any(e is not None for e in micro_spec):
        raise ValueError(f"micro_spec {micro_spec!r}: the microbatches "
                         f"enter whole (every entry None)")
    if params_specs is not None:
        for path, spec in _leaves(params_specs):
            if tuple(spec)[:1] != (axis,) or any(
                    e is not None for e in tuple(spec)[1:]):
                raise ValueError(f"params_specs {path}: {spec!r}; the "
                                 f"stages split the leading dim over "
                                 f"{axis!r} only")
    leaves = list(_leaves(stage_params))
    for path, p in leaves:
        if p.shape[0] != n_stages:
            raise ValueError(f"stage_params {path}: leading dim "
                             f"{p.shape[0]} for {n_stages} stages")
    devices = _stage_devices(mesh, axis)
    params = [_rebuild(stage_params, iter(p[s].to(devices[s])
                                          for _, p in leaves))
              for s in range(n_stages)]

    outs = torch.empty_like(x_micro)
    held = [None] * n_stages            # what each stage works on this tick
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:
            held[0] = x_micro[t].to(devices[0])
        done = [None if h is None else stage_fn(params[s], h)
                for s, h in enumerate(held)]
        if t >= n_stages - 1:
            outs[t - (n_stages - 1)].copy_(done[-1])
        # the handoff: each stage's output to the next stage's device
        held = [None] + [None if y is None else y.to(devices[s + 1])
                         for s, y in enumerate(done[:-1])]
    return outs
