"""The device that new Functions, assembled tensors and solver state live on.

The default is the CUDA card; nothing probes for one, and nothing
carries on on the CPU when there is none.  The CPU is used only when the
caller asks for it with ``set_device("cpu")`` (the CPU tests do), and
there every kernel wrapper runs its plain PyTorch version.  Host-side
setup (meshes, dof numbering, tabulations) stays in numpy whatever the
device.
"""
from __future__ import annotations

import numpy as np
import torch

_device = [torch.device("cuda")]


def set_device(device):
    """Place everything created from now on on ``device`` (a
    ``torch.device`` or a string such as ``"cuda"``)."""
    _device[0] = torch.device(device)


def get_device():
    return _device[0]


def as_tensor(x, dtype=None):
    """``x`` (numpy array, tensor or scalar) as a tensor on the set device;
    float64 unless ``x`` already carries a torch dtype or ``dtype`` says
    otherwise."""
    if isinstance(x, torch.Tensor):
        return x.to(device=get_device(), dtype=dtype or x.dtype)
    a = np.asarray(x)
    if not a.flags.writeable:
        a = a.copy()          # torch tensors must not alias read-only data
    if dtype is None and a.dtype.kind in "biu":
        return torch.as_tensor(a, device=get_device())
    if dtype is None:
        dtype = torch.complex128 if a.dtype.kind == "c" else torch.float64
    return torch.as_tensor(a, dtype=dtype, device=get_device())


def to_numpy(x):
    """Host numpy copy of a tensor (or pass numpy/scalars through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
