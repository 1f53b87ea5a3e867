"""Tracking block: bag-of-words keyframe histograms.

BoW: random-hyperplane LSH over ORB descriptor space (a DBoW-style
vocabulary without the training corpus). SLAM frames record their word
histogram with every keyframe; place recognition, projection and PnP
(registration) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

N_BITS = 256


def make_vocab(vocab_size: int, seed: int = 7) -> np.ndarray:
    """Random-hyperplane codebook: log2(vocab) hyperplanes over {0,1}^256."""
    depth = int(np.ceil(np.log2(vocab_size)))
    rng = np.random.RandomState(seed)
    planes = rng.randn(depth, N_BITS).astype(np.float32)
    return planes


def bow_histogram(desc: torch.Tensor, valid: torch.Tensor,
                  planes: torch.Tensor) -> torch.Tensor:
    """(N,256) bool descriptors -> (V,) l2-normalized word histogram.
    The scatter adds 1.0s, so it is exact in any order."""
    depth = planes.shape[0]
    centered = desc.float() - 0.5
    bits = (centered @ planes.T) > 0                     # (N, depth)
    weights = 2 ** torch.arange(depth, dtype=torch.int64,
                                device=desc.device)
    words = (bits.long() * weights).sum(dim=1)
    hist = torch.zeros(2 ** depth, dtype=torch.float32, device=desc.device)
    hist.index_add_(0, words, valid.float())
    return hist / torch.clamp(torch.linalg.vector_norm(hist), min=1e-9)
