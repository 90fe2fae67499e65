"""FLoRIST's efficient SVD pipeline (port of ``repro.core.svd``; paper §3,
Eqs. 1–4).

Given client adapters ``B_k ∈ R^{m×r_k}``, ``A_k ∈ R^{r_k×n}`` and weights
``w_k = n_k / N``:

    B_stack = [B_1 | ... | B_K]              (m × r),  r = Σ r_k
    A_stack = [w_1 A_1 ; ... ; w_K A_K]      (r × n)
    ΔW      = B_stack A_stack                 (never formed)

    B_stack = U_B S_B V_Bᵀ,  A_stack = U_A S_A V_Aᵀ          (thin SVDs)
    Q = V_Bᵀ U_A,  P = S_B Q S_A ∈ R^{r×r}                    (Eq. 2)
    SVD(P) = U_P S_P V_Pᵀ  →  singular values of ΔW are S_P   (exact)
    B_g = (U_B U_P)[:, :p] S_P[:p,:p],  A_g = (V_Pᵀ V_Aᵀ)[:p, :]   (Eq. 3)

with ``p`` from the energy threshold (Eq. 6):
    p = min { p : Σ_{i≤p} σ_i² / Σ_i σ_i² ≥ τ }.

Two thin-SVD backends: ``svd`` (LAPACK / cuSOLVER divide and conquer) and
``gram`` (eigh of the r×r Gram matrix, whose Gram product is the
``adapter_gram`` kernel on the card).  The reference's ``vmap`` becomes a
leading batch axis: every function here takes one matrix or a stack of
them, and the ``*_batched`` cores are the same functions on stacks.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops


class SVDResult(NamedTuple):
    u: torch.Tensor
    s: torch.Tensor
    vt: torch.Tensor


def thin_svd(x: torch.Tensor, method: str = "svd") -> SVDResult:
    """Thin SVD of x (..., m, n), any aspect.  method: 'svd' | 'gram'."""
    if method == "svd":
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        return SVDResult(u, s, vt)
    if method == "gram":
        return gram_svd(x)
    raise ValueError(method)


def _gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """xᵀx in fp32 over the last two axes: the ``adapter_gram`` wrapper (one
    kernel launch for the whole stack on the card)."""
    return kops.adapter_gram(x)


def gram_svd(x: torch.Tensor) -> SVDResult:
    """Thin SVD via the Gram trick, over x (..., m, n).

    Tall x (m ≥ n): eigh(xᵀx) = V diag(s²) Vᵀ, U = x V / s; wide x is
    transposed.  Columns whose σ falls below σ_max·√(n·eps) (the route's
    resolution limit; rank-deficient stacks) get a zero U column instead of
    noise, which leaves U S Vᵀ unchanged to within the tolerance.
    """
    m, n = x.shape[-2:]
    if m < n:
        r = gram_svd(x.mT)
        return SVDResult(r.vt.mT, r.s, r.u.mT)
    g = _gram_matrix(x)                                # (..., n, n)
    w, v = torch.linalg.eigh(g)                        # ascending
    w = w.flip(-1)
    v = v.flip(-1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    eps = torch.finfo(s.dtype).eps
    tol = s[..., :1] * (eps * n) ** 0.5                # (..., 1)
    u = torch.where(s[..., None, :] > tol[..., None],
                    (x @ v) / torch.maximum(s, tol)[..., None, :],
                    torch.zeros((), dtype=s.dtype, device=s.device))
    return SVDResult(u, s, v.mT)


def energy_rank_traced(s: torch.Tensor, tau: float) -> torch.Tensor:
    """Smallest p with Σ_{i≤p} σ_i² / Σ σ_i² ≥ τ, over the last axis, as
    int32: fp32 cumulative energy and an fp32 τ, ``searchsorted`` from the
    left, as the reference."""
    e = torch.cumsum(s.float() ** 2, dim=-1)
    frac = e / torch.clamp(e[..., -1:], min=1e-30)
    t = torch.full(frac.shape[:-1] + (1,), tau, dtype=torch.float32,
                   device=s.device)
    p = torch.searchsorted(frac.contiguous(), t, right=False)[..., 0] + 1
    return torch.clamp(p, max=s.shape[-1]).to(torch.int32)


def energy_rank(s: torch.Tensor, tau: float) -> int:
    """Host-side energy rank of one spectrum (same fp32 semantics)."""
    return int(energy_rank_traced(s, tau))


def knee_rank_traced(s: torch.Tensor) -> torch.Tensor:
    """Knee-point rank over the last axis: the largest distance of the
    cumulative-energy curve above the chord from (0, 0) to (r, 1); int32 in
    [1, r]."""
    e = torch.cumsum(s.float() ** 2, dim=-1)
    frac = e / torch.clamp(e[..., -1:], min=1e-30)
    r = s.shape[-1]
    x = torch.arange(1, r + 1, dtype=torch.float32, device=s.device) / r
    p = torch.argmax(frac - x, dim=-1) + 1
    return torch.clamp(p, 1, r).to(torch.int32)


def knee_rank(s: torch.Tensor) -> int:
    """Host wrapper of :func:`knee_rank_traced` for one spectrum."""
    return int(knee_rank_traced(s))


def stack_adapters(Bs: Sequence[torch.Tensor], As: Sequence[torch.Tensor],
                   weights: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted stacking (the weights fold into A_stack)."""
    B_stack = torch.cat(list(Bs), dim=-1)                       # (m, r)
    A_stack = torch.cat([w * A for w, A in zip(weights, As)], dim=-2)
    return B_stack, A_stack


class FloristOut(NamedTuple):
    B_g: torch.Tensor         # (m, p), includes the S_P scaling
    A_g: torch.Tensor         # (p, n)
    spectrum: torch.Tensor    # full S_P (r,)
    p: int


def _rank(sp: torch.Tensor, tau, max_rank: int) -> torch.Tensor:
    p = knee_rank_traced(sp) if tau == "auto" else energy_rank_traced(sp, tau)
    return torch.clamp(p, max=max_rank) if max_rank else p


def _core(B_stack, A_stack, svd_method: str):
    f32 = torch.float32
    ub, sb, vbt = thin_svd(B_stack.to(f32), svd_method)
    ua, sa, vat = thin_svd(A_stack.to(f32), svd_method)
    q = vbt @ ua                                               # (..., r, r)
    p_core = (sb[..., :, None] * q) * sa[..., None, :]         # P = S_B Q S_A
    up, sp, vpt = thin_svd(p_core, "svd")                      # r×r: always LAPACK-size
    return ub @ up, sp, vpt @ vat


def florist_core_stacked(B_stack: torch.Tensor, A_stack: torch.Tensor, tau,
                         svd_method: str = "svd",
                         max_rank: int = 0) -> FloristOut:
    """The pipeline on one pre-stacked pair (B_stack (m, r), A_stack (r, n)
    with the weights folded into A_stack); concretely truncated outputs."""
    UB, sp, VA = _core(B_stack, A_stack, svd_method)
    p = int(_rank(sp, tau, max_rank))
    return FloristOut(UB[:, :p] * sp[None, :p], VA[:p, :], sp, p)


def florist_core(Bs: Sequence[torch.Tensor], As: Sequence[torch.Tensor],
                 weights: Sequence[float], tau, svd_method: str = "svd",
                 max_rank: int = 0) -> FloristOut:
    """The full pipeline for one weight matrix (Alg. 1, server block).
    tau: float in (0, 1], or "auto" for knee-point rank selection."""
    B_stack, A_stack = stack_adapters(Bs, As, weights)
    return florist_core_stacked(B_stack, A_stack, tau, svd_method, max_rank)


def florist_core_padded(B_stack: torch.Tensor, A_stack: torch.Tensor, tau,
                        svd_method: str = "svd", max_rank: int = 0):
    """Fixed-shape variant over (..., m, r) / (..., r, n): full-rank outputs
    with columns ≥ p zeroed (the same ΔW).  Returns (B_g (..., m, r),
    A_g (..., r, n), spectrum (..., r), p int32 (...))."""
    UB, sp, VA = _core(B_stack, A_stack, svd_method)
    p = _rank(sp, tau, max_rank)
    keep = torch.arange(sp.shape[-1], device=sp.device) < p[..., None]
    B_g = UB * torch.where(keep, sp, torch.zeros_like(sp))[..., None, :]
    A_g = VA * keep[..., :, None]
    return B_g, A_g, sp, p


def florist_core_batched(B_stacks: torch.Tensor, A_stacks: torch.Tensor, tau,
                         svd_method: str = "svd", max_rank: int = 0):
    """The pipeline for a whole stack of layers (or a bucket of
    equal-shaped leaves × layers) in one pass of batched calls.
    B_stacks: (L, m, r), A_stacks: (L, r, n), weights folded in.  Returns
    (B_g (L, m, r) zero past each layer's p, A_g (L, r, n), spectra (L, r),
    ranks (L,) int32)."""
    return florist_core_padded(B_stacks, A_stacks, tau, svd_method,
                               int(max_rank))


def florist_core_delta_padded(M: torch.Tensor, tau, svd_method: str = "svd",
                              max_rank: int = 0):
    """The core on an accumulated update ΔW = Σ_k w_k B_k A_k (..., m, n):
    one thin SVD of M, the same threshold / knee / cap.  Returns (B_g
    (..., m, q), A_g (..., q, n), spectrum (..., q), p int32), q = min(m, n),
    columns ≥ p zeroed."""
    u, s, vt = thin_svd(M.float(), svd_method)
    p = _rank(s, tau, max_rank)
    keep = torch.arange(s.shape[-1], device=s.device) < p[..., None]
    B_g = u * torch.where(keep, s, torch.zeros_like(s))[..., None, :]
    A_g = vt * keep[..., :, None]
    return B_g, A_g, s, p


def florist_core_delta_batched(Ms: torch.Tensor, tau, svd_method: str = "svd",
                               max_rank: int = 0):
    """Delta core over a layer stack Ms (L, m, n)."""
    return florist_core_delta_padded(Ms, tau, svd_method, int(max_rank))


def reconstruction_error(Bs, As, weights, B_g, A_g) -> float:
    """‖ΔW − B_g A_g‖_F (forms ΔW once; small shapes)."""
    dw = sum(w * (B @ A) for w, B, A in zip(weights, Bs, As))
    return float(torch.linalg.norm(dw - B_g @ A_g))


def eckart_young_bound(spectrum: torch.Tensor, p: int) -> float:
    """(Σ_{i>p} σ_i²)^{1/2}, the paper's Eq. 5 bound."""
    return float(torch.sqrt(torch.sum(spectrum[p:].float() ** 2)))
