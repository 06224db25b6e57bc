"""Elastic resharding: place a tree on a mesh, or move it to another —
counterpart of ``repro/checkpoint/reshard.py``.

Checkpoints are stored as full (unsharded) host arrays, so elasticity is
a matter of building the *new* mesh's shardings from the same
logical-axis spec tree and placing the leaves; the logical annotations
(``LMModel.logical_axes``) are mesh-independent by construction.

The reference takes ``NamedSharding`` and ``device_put`` from JAX.  Here
a :class:`NamedSharding` lays a ``runtime.mesh_rules.PartitionSpec``
over the port's ``core.distributed.Mesh`` and says which piece of a
tensor each mesh device holds (:meth:`NamedSharding.indices`, the
counterpart of ``devices_indices_map``), and a :class:`ShardedTensor`
holds one piece per mesh device, on that device.  A dim that does not
divide by its mesh axes is refused with a ``ValueError`` naming the leaf
and the axes, where the reference's ``shard_shape`` (and ``jit``) refuse
it: nothing is padded.  :func:`reshard_tree` moves a live tree between
two meshes piece by piece: each new piece is copied from the old pieces
that overlap it, with no round trip through disk and no full copy.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.manager import _leaves, _rebuild
from repro_torch.models.common import LogicalAxes
from repro_torch.runtime.mesh_rules import AxisRules, PartitionSpec

Index = Tuple[slice, ...]


class NamedSharding:
    """``spec`` over ``mesh``: dim ``i`` split over the mesh axes of entry
    ``i`` (their product of pieces, the first axis major), every piece
    repeated over the mesh axes that split no dim."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def _axes(self, ndim: int, name: str = "") -> List[Tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"{name or 'a tensor'}: {self.spec!r} has more "
                             f"entries than its {ndim} dims")
        out = []
        for entry in tuple(self.spec) + (None,) * (ndim - len(self.spec)):
            axes = () if entry is None else \
                (entry,) if isinstance(entry, str) else tuple(entry)
            for a in axes:
                if a not in self.mesh.shape:
                    raise ValueError(f"{name or 'a tensor'}: mesh axis "
                                     f"{a!r} is not one of "
                                     f"{self.mesh.axis_names}")
            out.append(axes)
        return out

    def shard_shape(self, global_shape: Sequence[int],
                    name: str = "") -> Tuple[int, ...]:
        """The shape of each piece; a ``ValueError`` naming ``name`` and the
        mesh axes where a dim does not divide by them."""
        out = []
        for i, (n, axes) in enumerate(zip(global_shape,
                                          self._axes(len(global_shape),
                                                     name))):
            ways = math.prod(self.mesh.shape[a] for a in axes)
            if n % ways:
                raise ValueError(
                    f"{name or 'a tensor'} of shape {tuple(global_shape)}: "
                    f"dim {i} ({n}) does not divide over mesh axes {axes} "
                    f"({ways} ways) of {self.spec!r}")
            out.append(n // ways)
        return tuple(out)

    def indices(self, global_shape: Sequence[int],
                name: str = "") -> Tuple[Index, ...]:
        """The piece of each mesh device, in the mesh's device order: one
        slice per dim."""
        piece = self.shard_shape(global_shape, name)
        axes = self._axes(len(global_shape), name)
        out = []
        for i in range(self.mesh.size):
            at = self.mesh.coords(i)
            idx = []
            for size, dim_axes in zip(piece, axes):
                k = 0
                for a in dim_axes:
                    k = k * self.mesh.shape[a] + at[a]
                idx.append(slice(k * size, (k + 1) * size))
            out.append(tuple(idx))
        return tuple(out)


class ShardedTensor:
    """A tensor of ``shape`` as one piece per mesh device of ``sharding``
    (``pieces[i]`` on ``sharding.mesh.devices[i]``)."""

    def __init__(self, sharding: NamedSharding, shape: Sequence[int],
                 pieces: Sequence[torch.Tensor]):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.pieces = list(pieces)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @classmethod
    def from_full(cls, full: torch.Tensor, sharding: NamedSharding,
                  name: str = "") -> "ShardedTensor":
        """``full`` cut into the pieces of ``sharding``, each copied to its
        mesh device."""
        pieces = []
        for dev, idx in zip(sharding.mesh.devices,
                            sharding.indices(full.shape, name)):
            part = full[idx]
            pieces.append(torch.empty(part.shape, dtype=full.dtype,
                                      device=dev).copy_(part))
        return cls(sharding, full.shape, pieces)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, on ``device`` (None: the first piece's)."""
        device = self.pieces[0].device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for idx, piece in _distinct(self.sharding.indices(self.shape),
                                    self.pieces):
            out[idx].copy_(piece)
        return out

    def moved(self, sharding: NamedSharding,
              name: str = "") -> "ShardedTensor":
        """This tensor on ``sharding``: each new piece filled from the old
        pieces that overlap it, copied to its device."""
        old = _distinct(self.sharding.indices(self.shape), self.pieces)
        pieces = []
        for dev, idx in zip(sharding.mesh.devices,
                            sharding.indices(self.shape, name)):
            piece = torch.empty(tuple(s.stop - s.start for s in idx),
                                dtype=self.dtype, device=dev)
            for src_idx, src in old:
                both = [(max(a.start, b.start), min(a.stop, b.stop))
                        for a, b in zip(idx, src_idx)]
                if any(lo >= hi for lo, hi in both):
                    continue
                dst = tuple(slice(lo - a.start, hi - a.start)
                            for (lo, hi), a in zip(both, idx))
                got = tuple(slice(lo - b.start, hi - b.start)
                            for (lo, hi), b in zip(both, src_idx))
                piece[dst].copy_(src[got])
            pieces.append(piece)
        return ShardedTensor(sharding, self.shape, pieces)


def _distinct(indices, pieces) -> List[Tuple[Index, torch.Tensor]]:
    """One (index, piece) per distinct index: the first replica."""
    seen = {}
    for idx, piece in zip(indices, pieces):
        seen.setdefault(tuple((s.start, s.stop) for s in idx), (idx, piece))
    return list(seen.values())


def _map(fn, tree, *others):
    """``fn(path, leaf, *other leaves)`` over the leaves of ``tree`` (and
    of trees of its structure), in the structure of ``tree``."""
    flat = [list(_leaves(t)) for t in (tree,) + others]
    out = [fn(path, leaf, *(o[i][1] for o in flat[1:]))
           for i, (path, leaf) in enumerate(flat[0])]
    return _rebuild(tree, iter(out))


def shardings_from_specs(mesh, rules: AxisRules, spec_tree: Any) -> Any:
    """``LogicalAxes`` spec tree -> :class:`NamedSharding` tree for
    ``mesh``."""
    def one(path, spec):
        names = spec.names if isinstance(spec, LogicalAxes) else tuple(spec)
        return NamedSharding(mesh, rules.pspec(names))
    return _map(one, spec_tree)


def _place(path: str, leaf, sharding: Optional[NamedSharding]):
    """One leaf (a tensor or a :class:`ShardedTensor`) on ``sharding``."""
    if sharding is None:
        return leaf
    if isinstance(leaf, ShardedTensor):
        return leaf.moved(sharding, path)
    return ShardedTensor.from_full(leaf, sharding, path)


def reshard_tree(tree: Any, new_shardings: Any) -> Any:
    """Move a live tree onto new shardings (possibly a different mesh):
    a tensor leaf is cut into pieces, a :class:`ShardedTensor` moved piece
    by piece."""
    return _map(_place, tree, new_shardings)


__all__ = ["NamedSharding", "ShardedTensor", "reshard_tree",
           "shardings_from_specs"]
