"""Logical-axis sharding rules — counterpart of
``repro/runtime/mesh_rules.py``.

One table maps model-space axis names to mesh axes, so every arch/shape
cell shares the same annotation code:

  batch     — global batch               -> ("pod", "data")  [all shapes]
  seq       — sequence (activations)     -> None (kept local)
  cache_seq — KV-cache sequence          -> None; ("pod","data") for long_500k
              (sequence-parallel cache, batch=1)
  heads     — attention query heads      -> "model"
  kv_heads  — attention KV heads         -> "model"
  d_model   — embedding dim (params)     -> "data" (FSDP / ZeRO-3 axis)
  d_ff      — MLP hidden (params)        -> "model" (TP)
  vocab     — vocabulary                 -> "model"
  experts   — MoE expert dim             -> "model" in EP mode, else None
  unit      — scanned layer-stack dim    -> None
  none      — explicitly unsharded

A rule set turns a parameter's logical axes (``LMModel.logical_axes``)
into a :class:`PartitionSpec`, which ``checkpoint/reshard.NamedSharding``
lays over the port's ``Mesh``.  :func:`shard` is the reference's
``with_sharding_constraint`` by logical names: one process holds the whole
tensor, and a constraint never changes a value, so it returns its input,
after resolving the names (an unknown one raises ``KeyError``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or
    a tuple of them (the dim split over their product, the first
    major); a tuple whose entries equal ``jax.sharding.PartitionSpec``'s."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AxisRules:
    table: dict

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None or logical == "none":
            return None
        if logical not in self.table:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.table[logical]

    def pspec(self, logical_axes: Tuple[Optional[str], ...]) -> P:
        used = set()
        out = []
        for name in logical_axes:
            axes = self.mesh_axes(name)
            # A mesh axis may appear at most once in a PartitionSpec; later
            # occurrences degrade to replicated (e.g. d_model x d_ff when both
            # map somewhere already used).
            if axes is None:
                out.append(None)
                continue
            tup = (axes,) if isinstance(axes, str) else tuple(axes)
            tup = tuple(a for a in tup if a not in used)
            used.update(tup)
            if not tup:
                out.append(None)
            elif len(tup) == 1:
                out.append(tup[0])
            else:
                out.append(tup)
        return P(*out)


def default_rules(multi_pod: bool, *, seq_parallel_cache: bool = False,
                  expert_parallel: bool = False,
                  shard_residual: bool = True,
                  fsdp_over_pod: bool = False) -> AxisRules:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    fsdp_axes = ("pod", "data") if (multi_pod and fsdp_over_pod) else "data"
    return AxisRules(table={
        "batch": batch_axes,
        "seq": None,
        "cache_seq": batch_axes if seq_parallel_cache else None,
        "heads": "model",
        "kv_heads": "model",
        "d_model": fsdp_axes,
        "d_ff": "model",
        "vocab": "model",
        "experts": "model" if expert_parallel else None,
        "unit": None,
        "mamba_inner": "model",
        "rwkv_heads": "model",
        # Megatron-style activation sharding at layer boundaries: d_model of
        # the residual stream over "model".
        "residual": "model" if shard_residual else None,
    })


# ---- thread-local rules context ---------------------------------------------

_ctx = threading.local()


def set_rules(rules: Optional[AxisRules]):
    _ctx.rules = rules


def get_rules() -> Optional[AxisRules]:
    return getattr(_ctx, "rules", None)


class use_rules:
    def __init__(self, rules: Optional[AxisRules]):
        self.rules = rules

    def __enter__(self):
        self.prev = get_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc):
        set_rules(self.prev)


def shard(x, *logical_axes: Optional[str]):
    """The reference's sharding constraint by logical axis names: ``x``
    as it is (module docstring); with rules set, the names are resolved
    first, so an unknown one raises ``KeyError``."""
    rules = get_rules()
    if rules is not None:
        rules.pspec(tuple(logical_axes))
    return x


def named_sharding(mesh, rules: AxisRules,
                   logical_axes: Tuple[Optional[str], ...]):
    """``checkpoint.reshard.NamedSharding`` of the logical axes on
    ``mesh`` (a ``core.distributed.Mesh``)."""
    from repro_torch.checkpoint.reshard import NamedSharding
    return NamedSharding(mesh, rules.pspec(logical_axes))
