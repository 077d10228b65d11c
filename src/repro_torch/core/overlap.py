"""Overlap estimation heuristics (paper §4.2) in torch, the JAX package's
``repro.core.overlap`` on the rates' device.

Three heuristics score the overlap of two hyperball partitions
``P_i = (pivot p_i, radius r_i)`` with a rate in [0, 1]:

* VBM (Volume-Based, Defs. 7-9): n-ball intersection volume from
  hyperspherical-cap volumes, ``V_cap = 1/2 V_ball(r) I_{sin^2 theta}((n+1)/2,
  1/2)`` for ``theta <= pi/2`` and ``V_ball - 1/2 V_ball I_{sin^2 theta}``
  otherwise, all in log space.  torch has no regularized incomplete beta
  function, so ``betainc`` below is JAX's own algorithm written in torch.
* DBM (Distance-Based, Def. 10): ``(h1 + h2) / d(p1, p2)`` from the cap
  heights.
* OBM (Object-Based, Def. 11): ``|A| / (|P1| + |P2|)`` with ``A`` the objects
  inside both balls.

Degenerate cases shared by all three: rate 0 if ``d >= r1 + r2``
(disjoint), 1 if ``d <= |r1 - r2|`` (containment).

Each function takes f32 tensors (a Python float where the JAX package's
host-side caller passes one: it is evaluated in float64 first and rounded to
f32, as JAX's weak typing does).  The rates run on the device the pivots lie
on; the distances and the OBM co-membership product are plain torch with
TF32 off (``kernels/ref.no_tf32``), as in the JAX package they are plain
matrix products outside any kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core.metric import pairwise

Tensor = torch.Tensor

_EPS = 1e-12
_F32 = torch.float32


def _f32(v, device=None) -> Tensor:
    if isinstance(v, Tensor):
        return v
    return torch.tensor(v, dtype=_F32, device=device)


# ---------------------------------------------------------------------------
# The regularized incomplete beta function (JAX's algorithm)
# ---------------------------------------------------------------------------


def _betainc_numerator(it: int, a: Tensor, b: Tensor, x: Tensor) -> Tensor:
    """Partial numerator ``it`` of the continued fraction (DLMF 8.17.23); the
    first is one."""
    if it == 1:
        return torch.ones_like(x)
    m = float((it - 1) // 2)
    if it % 2 == 0:
        if m == 0:
            return -(a + b) * x / (a + 1.0)
        return -(a + m) * (a + b + m) * x / ((a + 2.0 * m) * (a + 2.0 * m + 1.0))
    return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))


def _lentz(a: Tensor, b: Tensor, x: Tensor, *, iterations: int, small: float) -> Tensor:
    """The modified Lentz-Thompson-Barnett evaluation JAX uses: every element
    iterates until all have converged (|delta - 1| < small) or the cap."""
    h = torch.full_like(x, small)  # the 0th partial denominator is 0 < small
    c, d = h, torch.zeros_like(x)
    it = 1
    unconverged = True
    while it < iterations and unconverged:
        num = _betainc_numerator(it, a, b, x)
        c = 1.0 + num / c
        c = torch.where(torch.abs(c) < small, small, c)
        d = 1.0 + num * d
        d = torch.where(torch.abs(d) < small, small, d)
        d = torch.reciprocal(d)
        delta = c * d
        h = h * delta
        it += 1
        unconverged = bool(torch.any(torch.abs(delta - 1.0) >= small))
    return h


def betainc(a, b, x) -> Tensor:
    """Regularized incomplete beta ``I_x(a, b)`` in f32, elementwise.

    JAX's ``regularized_incomplete_beta_impl``: the continued fraction of
    DLMF 8.17.22, switched by the symmetry ``I_x(a, b) = 1 - I_{1-x}(b, a)``
    (DLMF 8.17.4) to the side where it converges fast, up to 200 terms, with
    JAX's special cases (x = 0 or 1, a or b = 0 or inf, nan outside the
    domain).  Each term is a handful of torch ops on the whole array and one
    host sync; the overlap rates call it on (C, C) arrays only.
    """
    x = _f32(x)
    a, b, x = torch.broadcast_tensors(_f32(a, x.device), _f32(b, x.device), x)
    eps = float(np.finfo(np.float32).eps)
    small = eps / 2
    inf = math.inf
    a_is_zero = (a == 0) | (b == inf)
    b_is_zero = (b == 0) | (a == inf)
    x_is_zero, x_is_one = x == 0, x == 1
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = (
        (a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_is_zero & b_is_zero)
        | torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    )
    fast = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1.0 - x)
    cf = _lentz(a, b, x, iterations=200, small=small)
    very_small = float(np.finfo(np.float32).tiny) * 2
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(
        a < very_small,
        torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a,
    )
    result = cf * factor
    result = torch.where(fast, result, 1.0 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, math.nan, result)


# ---------------------------------------------------------------------------
# Hyperball geometry (Definitions 8 & 9)
# ---------------------------------------------------------------------------


def ball_log_volume(n_dim, r) -> Tensor:
    """log V of an n-ball of radius r (Def. 8), -inf for r == 0."""
    r = _f32(r)
    n = _f32(float(n_dim), r.device)
    logr = torch.log(torch.clamp_min(r, _EPS))
    log_pi = torch.log(_f32(math.pi, r.device))
    return 0.5 * n * log_pi - torch.lgamma(0.5 * n + 1.0) + n * logr


def cap_cos_theta(r_i, r_j, d) -> Tensor:
    """cos(theta_i) of the cap cut into ball i by ball j (Def. 9, Eq. 12)."""
    denom = torch.clamp_min(_f32(2.0 * r_i * d), _EPS)
    return torch.clamp(_f32(r_i**2 + d**2 - r_j**2) / denom, -1.0, 1.0)


def cap_height(r_i, cos_theta_i) -> Tensor:
    """h_i = r_i (1 - cos(theta_i))  (Def. 9, Eq. 11)."""
    return _f32(r_i) * (1.0 - cos_theta_i)


def cap_log_volume(n_dim, r, cos_theta) -> Tensor:
    """log volume of the hyperspherical cap with polar angle theta (Def. 9),
    theta > pi/2 included (the complement of the opposite cap, in log space:
    the raw volumes overflow f32 at n ~ 20, their ratio never does)."""
    n = _f32(float(n_dim), cos_theta.device)
    sin2 = torch.clamp(1.0 - cos_theta**2, 0.0, 1.0)
    reg = betainc(0.5 * (n + 1.0), 0.5, sin2)
    log_ball = ball_log_volume(n_dim, r)
    log_half_ball = log_ball + torch.log(_f32(0.5, cos_theta.device))
    log_small = log_half_ball + torch.log(torch.clamp_min(reg, _EPS))
    ratio = torch.exp(torch.clamp_max(log_small - log_ball, 0.0))
    log_big = log_ball + torch.log1p(-torch.clamp_max(ratio, 1.0 - _EPS))
    return torch.where(cos_theta >= 0.0, log_small, log_big)


def intersection_log_volume(n_dim, r1, r2, d) -> Tensor:
    """log of the lens volume (Def. 7, Eq. 6), for the partial-overlap case."""
    c1 = cap_cos_theta(r1, r2, d)
    c2 = cap_cos_theta(r2, r1, d)
    return torch.logaddexp(cap_log_volume(n_dim, r1, c1), cap_log_volume(n_dim, r2, c2))


# ---------------------------------------------------------------------------
# Rates (Defs. 7, 10, 11), then pairwise matrices
# ---------------------------------------------------------------------------


def _select_cases(d: Tensor, r1: Tensor, r2: Tensor, partial: Tensor) -> Tensor:
    disjoint = d >= (r1 + r2)
    contained = d <= torch.abs(r1 - r2)
    return torch.where(disjoint, 0.0, torch.where(contained, 1.0, partial))


def vbm_rate(r1: Tensor, r2: Tensor, d: Tensor, n_dim: int) -> Tensor:
    """Volume rate V (Def. 7, Eq. 7): lens volume / (V1 + V2)."""
    log_lens = intersection_log_volume(n_dim, r1, r2, d)
    log_tot = torch.logaddexp(ball_log_volume(n_dim, r1), ball_log_volume(n_dim, r2))
    partial = torch.exp(torch.clamp(log_lens - log_tot, -80.0, 0.0))
    return _select_cases(d, r1, r2, partial)


def dbm_rate(r1: Tensor, r2: Tensor, d: Tensor) -> Tensor:
    """Distance rate D (Def. 10): (h1 + h2) / d."""
    h1 = cap_height(r1, cap_cos_theta(r1, r2, d))
    h2 = cap_height(r2, cap_cos_theta(r2, r1, d))
    partial = (h1 + h2) / torch.clamp_min(d, _EPS)
    return torch.clamp(_select_cases(d, r1, r2, partial), 0.0, 1.0)


def obm_rate(n_shared, n1, n2, r1, r2, d) -> Tensor:
    """Object rate A (Def. 11): |A| / (|P1| + |P2|)."""
    partial = n_shared / torch.clamp_min(n1 + n2, 1.0)
    return _select_cases(d, r1, r2, partial)


def _off_diagonal(rates: Tensor) -> Tensor:
    c = rates.shape[0]
    return rates * (1.0 - torch.eye(c, dtype=rates.dtype, device=rates.device))


def overlap_matrix_geometric(pivots: Tensor, radii: Tensor, *, n_dim: int, method: str) -> Tensor:
    """(C, C) overlap-rate matrix for VBM / DBM.  Diagonal forced to 0."""
    d = pairwise(pivots, pivots, metric="l2", use_kernel=False)
    r1 = radii[:, None]
    r2 = radii[None, :]
    if method == "vbm":
        rates = vbm_rate(r1, r2, d, n_dim)
    elif method == "dbm":
        rates = dbm_rate(r1, r2, d)
    else:
        raise ValueError(f"geometric overlap method {method!r}")
    return _off_diagonal(rates)


def ball_membership(x: Tensor, pivots: Tensor, radii: Tensor) -> Tensor:
    """(N, C) bool: object n lies inside ball c."""
    d = pairwise(x, pivots, metric="l2", use_kernel=False)
    return d <= radii[None, :]


def overlap_matrix_objects(x: Tensor, assign: Tensor, pivots: Tensor, radii: Tensor) -> Tensor:
    """(C, C) OBM rate matrix (Def. 11) from data ``x`` and the partition
    assignment ``assign`` (N,)."""
    c = pivots.shape[0]
    member = ball_membership(x, pivots, radii).to(_F32)  # (N, C)
    shared = member.T @ member  # (C, C) co-membership counts, exact in f32
    counts = torch.zeros((c,), dtype=_F32, device=x.device)
    counts.index_add_(0, assign.long(), torch.ones_like(assign, dtype=_F32))
    d = pairwise(pivots, pivots, metric="l2", use_kernel=False)
    rates = obm_rate(shared, counts[:, None], counts[None, :], radii[:, None], radii[None, :], d)
    return _off_diagonal(rates)


def max_neighbor_rate(rates: Tensor) -> Tensor:
    """(I,) worst off-diagonal overlap rate per partition: the scalar each
    partition is judged by against (xi_min, xi_max)."""
    return torch.max(_off_diagonal(rates), dim=1).values


# ---------------------------------------------------------------------------
# Overlap-method registry: VBM/DBM/OBM are entries, not special cases
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OverlapMethod:
    """One registered overlap heuristic.

    ``matrix_fn(pivots, radii, *, x=None, assign=None) -> (C, C)`` rate
    matrix in [0, 1] with a zero diagonal, as torch tensors on the pivots'
    device.  ``needs_objects`` marks methods defined over the objects (the
    paper's OBM): callers then supply the dataset ``x`` and the partition
    ``assign``, and cost accounting charges the per-object membership pass.
    """

    name: str
    matrix_fn: Callable[..., Tensor]
    needs_objects: bool = False


_REGISTRY: dict[str, OverlapMethod] = {}


def register_overlap_method(
    name: str,
    matrix_fn: Callable[..., Tensor],
    *,
    needs_objects: bool = False,
    overwrite: bool = False,
) -> OverlapMethod:
    """Register an overlap heuristic under ``name`` (see OverlapMethod)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"overlap method {name!r} is already registered; pass "
            "overwrite=True to replace it"
        )
    entry = OverlapMethod(name=name, matrix_fn=matrix_fn, needs_objects=needs_objects)
    _REGISTRY[name] = entry
    return entry


def unregister_overlap_method(name: str) -> None:
    _REGISTRY.pop(name, None)


def available_overlap_methods() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_overlap_method(name: str) -> OverlapMethod:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown overlap method {name!r}; registered methods: "
            f"{', '.join(available_overlap_methods())} "
            "(repro_torch.core.overlap.register_overlap_method to add one)"
        ) from None


def _vbm_matrix(pivots: Tensor, radii: Tensor, *, x=None, assign=None) -> Tensor:
    return overlap_matrix_geometric(pivots, radii, n_dim=int(pivots.shape[-1]), method="vbm")


def _dbm_matrix(pivots: Tensor, radii: Tensor, *, x=None, assign=None) -> Tensor:
    return overlap_matrix_geometric(pivots, radii, n_dim=int(pivots.shape[-1]), method="dbm")


def _obm_matrix(pivots: Tensor, radii: Tensor, *, x=None, assign=None) -> Tensor:
    return overlap_matrix_objects(x, assign, pivots, radii)


register_overlap_method("vbm", _vbm_matrix)
register_overlap_method("dbm", _dbm_matrix)
register_overlap_method("obm", _obm_matrix, needs_objects=True)


def overlap_matrix(
    method: str,
    pivots: Tensor,
    radii: Tensor,
    *,
    x: Tensor | None = None,
    assign: Tensor | None = None,
) -> Tensor:
    """Resolve ``method`` through the registry -> (C, C) rate matrix."""
    entry = get_overlap_method(method)
    if entry.needs_objects and (x is None or assign is None):
        raise ValueError(
            f"overlap method {method!r} is object-based and needs the dataset "
            "and partition assignment (pass x= and assign=)"
        )
    return entry.matrix_fn(pivots, radii, x=x, assign=assign)
