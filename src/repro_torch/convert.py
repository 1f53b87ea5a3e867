"""Carry a localizer's state between ``repro`` and ``repro_torch``.

The system has no weights: what crosses between the two packages is the
per-robot state. ``state_from_numpy`` takes the numpy tree of a
``repro`` ``LocalizerState`` (``jax.device_get(state)``, or anything
with the same field names) and builds this package's state;
``state_to_numpy`` is its inverse for the same fields.

``repro``'s ``ba`` field (the SLAM keyframe window and marginalization
prior) is ignored: the SLAM slice is not ported yet and ``vio`` never
reads it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.backend.msckf import MsckfState
from repro_torch.core.step import LocalizerState

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}


def _t(x, device) -> torch.Tensor:
    a = np.asarray(x)
    return torch.as_tensor(np.array(a, copy=True), dtype=_DTYPES[a.dtype],
                           device=device)


def state_from_numpy(tree, device=None) -> LocalizerState:
    """``repro`` state tree (numpy leaves) -> this package's state on
    ``device`` (CUDA by default). The ``ba`` field is ignored."""
    device = resolve_device(device)
    f = tree.filt
    filt = MsckfState(*(_t(getattr(f, k), device)
                        for k in MsckfState._fields))
    rest = {k: _t(getattr(tree, k), device)
            for k in LocalizerState._fields if k != "filt"}
    return LocalizerState(filt=filt, **rest)


def state_to_numpy(state: LocalizerState) -> LocalizerState:
    """This package's state -> the same NamedTuples holding numpy
    arrays (the field names ``repro``'s state uses, without ``ba``)."""
    filt = MsckfState(*(v.cpu().numpy() for v in state.filt))
    return LocalizerState(filt, *(v.cpu().numpy() for v in state[1:]))
