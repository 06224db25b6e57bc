"""Production mesh construction — counterpart of ``repro/launch/mesh.py``.

Single pod : (data=16, model=16)           = 256 mesh devices
Multi-pod  : (pod=2, data=16, model=16)    = 512 mesh devices

A mesh is the port's ``core.distributed.Mesh`` over
``core.distributed.visible_devices(device)``: one mesh device per card,
or with ``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` N of them round-robin over
the visible cards (N CPU devices with ``device="cpu"``), the counterpart
of the reference's forced host device count.  ``device="meta"`` lays the
mesh over meta devices, so the dry run (``launch/dryrun``) allocates
nothing.  These are functions, not module constants: importing the
module touches no CUDA state.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.distributed import ENV_DEVICE_COUNT, Mesh, \
    visible_devices


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_local_mesh(shape, axes, device=device)


def make_local_mesh(shape=(2, 2), axes=("data", "model"), *,
                    device=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the first ``prod(shape)``
    visible devices (module docstring); a ``ValueError`` naming
    ``REPRO_TORCH_FORCE_DEVICE_COUNT`` where there are fewer."""
    n = math.prod(shape)
    if device is not None and torch.device(device).type == "meta":
        return Mesh((torch.device("meta"),) * n, shape, axes)
    devices = visible_devices(device)
    if len(devices) < n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"devices, {len(devices)} visible (set "
                         f"{ENV_DEVICE_COUNT}={n} to lay {n} mesh devices "
                         f"over them)")
    return Mesh(devices[:n], shape, axes)
