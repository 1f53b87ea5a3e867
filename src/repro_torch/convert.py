"""Carry a localizer's state between ``repro`` and ``repro_torch``.

The system has no weights: what crosses between the two packages is the
per-robot state. ``state_from_numpy`` takes the numpy tree of a
``repro`` ``LocalizerState`` (``jax.device_get(state)``, or anything
with the same field names) and builds this package's state, the SLAM
keyframe window and marginalization prior (``ba``) included;
``state_to_numpy`` is its inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.backend.ba import BAState
from repro_torch.core.backend.msckf import MsckfState
from repro_torch.core.step import LocalizerState

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}
_NESTED = {"filt": MsckfState, "ba": BAState}


def _t(x, device) -> torch.Tensor:
    a = np.asarray(x)
    return torch.as_tensor(np.array(a, copy=True), dtype=_DTYPES[a.dtype],
                           device=device)


def state_from_numpy(tree, device=None) -> LocalizerState:
    """``repro`` state tree (numpy leaves) -> this package's state on
    ``device`` (CUDA by default)."""
    device = resolve_device(device)

    def field(k):
        sub = getattr(tree, k)
        if k in _NESTED:
            cls = _NESTED[k]
            return cls(*(_t(getattr(sub, f), device) for f in cls._fields))
        return _t(sub, device)

    return LocalizerState(*(field(k) for k in LocalizerState._fields))


def state_to_numpy(state: LocalizerState) -> LocalizerState:
    """This package's state -> the same NamedTuples holding numpy
    arrays (the field names ``repro``'s state uses)."""
    def np_(v):
        if isinstance(v, tuple):
            return type(v)(*(np_(x) for x in v))
        return v.cpu().numpy()

    return np_(state)
