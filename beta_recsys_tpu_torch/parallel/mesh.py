"""The ("data", "model") device mesh.

Counterpart of ``beta_recsys_tpu/parallel/mesh.py``. One process drives the
mesh: ``Mesh.devices[d][m]`` is the ``torch.device`` of the shard at data
index ``d`` and model index ``m``, and the sharded trainer runs each shard's
part of a step there. "data" shards batches; "model" row-shards the
embedding tables (replicated over "data").

A mesh needs as many devices as it has shards. ``make_mesh`` takes every
CUDA device by default and raises when there are too few; a mesh whose
shards repeat one device (all four on ``cuda:0``, or on the CPU in the tests)
exists only when the caller names those devices, as the JAX tests name
``jax_num_cpu_devices`` virtual devices.
"""

import torch

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A (n_data, n_model) grid of torch devices."""

    def __init__(self, devices):
        self.devices = [[_indexed(d) for d in row] for row in devices]
        self.shape = {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def size(self):
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]


def _indexed(device):
    """``cuda`` without an index is the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def default_devices(first=None):
    """Every CUDA device, ``first`` leading (default: the current one; raises
    without CUDA, as ``resolve_device`` does). A CPU ``first`` gives the one
    CPU device."""
    first = _indexed(resolve_device(first))
    if first.type != "cuda":
        return [first]
    others = [torch.device("cuda", i) for i in range(torch.cuda.device_count()) if i != first.index]
    return [first, *others]


def make_mesh(n_data=None, n_model=1, devices=None):
    """A ("data", "model") mesh over the given devices (default: every CUDA
    device). ``n_data=None`` puts every device the model axis leaves on the
    data axis. Raises when the mesh needs more devices than it is given."""
    devices = [_indexed(d) for d in (default_devices() if devices is None else devices)]
    n = len(devices)
    if n_data is None:
        n_data = max(n // n_model, 1)
    used = n_data * n_model
    if used > n:
        raise ValueError(f"mesh {n_data}x{n_model} needs {used} devices, have {n}: {devices}")
    return Mesh([devices[d * n_model:(d + 1) * n_model] for d in range(n_data)])
