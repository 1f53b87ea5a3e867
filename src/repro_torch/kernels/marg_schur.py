"""Landmark-tiled Schur accumulation — the SLAM marginalization kernel.

The CUDA counterpart of ``repro/kernels/marg_schur.py`` (kernels in
``csrc/marg_schur.cu``). Marginalizing the landmark block of windowed BA
reduces to one landmark-indexed reduction

    Y = sum_m G_m A_m^{-1} G_m^T          (6K, 6K)
    y = sum_m G_m A_m^{-1} b_m            (6K,)

with G_m (6K, 3) stacking landmark m's coupling to every window pose
(pose-major: row 6k+i belongs to pose k). Two entries:

  ``accumulate_normal``  from the BA residual Jacobians r (K,M,2),
                         jx (K,M,2,6), jl (K,M,2,3): each landmark's
                         G/A/b blocks are assembled in the kernel (the
                         path ``ba.ba_round`` runs);
  ``accumulate``         from assembled g (M,D,3), a (M,3,3), b (M,3).

``accumulate_normal_ref`` and ``accumulate_ref`` are the plain PyTorch
versions. A wrapper takes its plain version for a CPU tensor, and for a
CUDA tensor launches its kernel or raises; ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

LAUNCHES = {"normal": 0, "schur": 0}


def _inv3x3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate: a (m, 3, 3) ->
    (m, 3, 3)."""
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
    c02 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c10 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c12 = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
    c20 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    c21 = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
    c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c10 + a[:, 0, 2] * c20
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj / det[:, None, None]


def _tile_terms(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Landmarks' contribution: g (m, D, 3), a (m, 3, 3), b (m, 3) ->
    (D, D), (D,)."""
    ga = torch.einsum("mdi,mij->mdj", g, _inv3x3(a))
    return (torch.einsum("mdi,mei->de", ga, g),
            torch.einsum("mdi,mi->d", ga, b))


def _normal_tile(r: torch.Tensor, jx: torch.Tensor, jl: torch.Tensor,
                 jitter: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normal-equation blocks per landmark: r (K,m,2), jx (K,m,2,6),
    jl (K,m,2,3) -> g (m, 6K, 3) pose-major, a (m, 3, 3), b (m, 3)."""
    k, m = jx.shape[0], jx.shape[1]
    hll = torch.einsum("kmri,kmrj->mij", jl, jl)
    hpl = torch.einsum("kmri,kmrj->kmij", jx, jl)
    bl = torch.einsum("kmri,kmr->mi", jl, r)
    g = hpl.permute(1, 0, 2, 3).reshape(m, 6 * k, 3)
    a = hll + jitter * torch.eye(3, dtype=hll.dtype, device=hll.device)[None]
    return g, a, bl


def accumulate_ref(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``accumulate``."""
    return _tile_terms(g, a, b)


def accumulate_normal_ref(r: torch.Tensor, jx: torch.Tensor,
                          jl: torch.Tensor, *, jitter: float = 1e-4
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``accumulate_normal``: the full normal-equation
    assembly, then the unblocked Schur reduction."""
    return _tile_terms(*_normal_tile(r, jx, jl, jitter))


def _require(t: torch.Tensor, name: str, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _outputs(d: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((d, d), dtype=torch.float32, device=device),
            torch.empty((d,), dtype=torch.float32, device=device))


def accumulate_normal(r: torch.Tensor, jx: torch.Tensor, jl: torch.Tensor,
                      *, jitter: float = 1e-4
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused normal-equation assembly + Schur accumulation: r (K,M,2),
    jx (K,M,2,6), jl (K,M,2,3) -> Y (6K,6K), y (6K,)."""
    if r.device.type == "cpu":
        return accumulate_normal_ref(r, jx, jl, jitter=jitter)
    if jx.dim() != 4:
        raise ValueError(f"jx must be (K, M, 2, 6), got {tuple(jx.shape)}")
    k, m = jx.shape[0], jx.shape[1]
    _require(r, "r", (k, m, 2))
    _require(jx, "jx", (k, m, 2, 6))
    _require(jl, "jl", (k, m, 2, 3))
    if r.device != jx.device or jl.device != jx.device:
        raise ValueError("r, jx and jl must be on one device")
    lib = _build.lib()
    if not 1 <= k <= lib.marg_max_k():
        raise ValueError(f"accumulate_normal takes 1 <= K <= "
                         f"{lib.marg_max_k()} window poses, got K={k}")
    Y, y = _outputs(6 * k, r.device)
    err = lib.marg_normal_launch(
        _build.ptr(r), _build.ptr(jx), _build.ptr(jl), k, m, float(jitter),
        _build.ptr(Y), _build.ptr(y), _build.stream())
    _build.check(err, "accumulate_normal")
    LAUNCHES["normal"] += 1
    return Y, y


def accumulate(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Y = sum_m g_m a_m^{-1} g_m^T, y = sum_m g_m a_m^{-1} b_m from
    g (M,D,3), a (M,3,3), b (M,3)."""
    if g.device.type == "cpu":
        return accumulate_ref(g, a, b)
    if g.dim() != 3 or g.shape[2] != 3:
        raise ValueError(f"g must be (M, D, 3), got {tuple(g.shape)}")
    m, d = g.shape[0], g.shape[1]
    _require(g, "g", (m, d, 3))
    _require(a, "a", (m, 3, 3))
    _require(b, "b", (m, 3))
    if a.device != g.device or b.device != g.device:
        raise ValueError("g, a and b must be on one device")
    lib = _build.lib()
    if not 1 <= d <= 6 * lib.marg_max_k():
        raise ValueError(f"accumulate takes 1 <= D <= "
                         f"{6 * lib.marg_max_k()} rows of g, got D={d}")
    Y, y = _outputs(d, g.device)
    err = lib.marg_schur_launch(
        _build.ptr(g), _build.ptr(a), _build.ptr(b), d, m, _build.ptr(Y),
        _build.ptr(y), _build.stream())
    _build.check(err, "accumulate")
    LAUNCHES["schur"] += 1
    return Y, y
