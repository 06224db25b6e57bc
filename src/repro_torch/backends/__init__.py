"""Stencil backend registry — ``lower(program, plan)`` to an executable.

Importing this package registers the built-in backends: ``cuda``, its
``-pipelined`` and ``-temporal`` variant siblings, and
``torch-reference``.
"""

from repro_torch.backends.registry import (  # noqa: F401
    BackendTraits,
    LoweredStencil,
    available_backends,
    backend_traits,
    default_backend_name,
    get_backend,
    lower,
    pipelined_variant,
    register_backend,
    resolve_backend,
    variant_of,
)
from repro_torch.backends import cuda_backend as _cuda  # noqa: F401
from repro_torch.backends import torch_ref as _torch_ref  # noqa: F401

__all__ = [
    "BackendTraits",
    "LoweredStencil",
    "available_backends",
    "backend_traits",
    "default_backend_name",
    "get_backend",
    "lower",
    "pipelined_variant",
    "register_backend",
    "resolve_backend",
    "variant_of",
]
