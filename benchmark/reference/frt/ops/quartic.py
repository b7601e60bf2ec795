"""Branch-free closed-form quartic solver (for the toroid).

The port of the JAX package's ops/quartic.py: the Graphics Gems algebra the
reference uses (src/libs/quartic/Roots3And4.c, Jochen Schwarze;
EQN_EPS = 1e-9) — depressed quartic, resolvent cubic, two quadratics —
with its exact special cases (r == 0 -> cubic + zero root; u/v negativity
-> no roots; the q-sign-dependent quadratic coefficients), written with
torch.where masks instead of early returns so it runs over ray batches.
Absent roots come back as +inf. The toroid intersector calls it in
float64 (float32 loses the resolvent cubic on grazing rays).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.frt.constants import QUARTIC_EPS


def _cbrt(x):
    """Real cube root, as C's cbrt: the sign of x kept (-0.0 stays -0.0),
    cbrt(+-inf) = +-inf, NaN propagates. torch has no cbrt, and
    |x| ** (1/3) alone is off by ulps; one Newton step on y^3 = |x|,
    written as y - (y - |x| / y^2) / 3 so that subnormal |x| keep their
    precision, brings it within one ulp of np.cbrt in float64."""
    a = x.abs()
    y = a ** (1.0 / 3.0)
    fin = (a > 0.0) & torch.isfinite(a)
    ys = torch.where(fin, y, 1.0)
    y = torch.where(fin, ys - (ys - a / (ys * ys)) / 3.0, y)
    return torch.copysign(y, x)


def _iszero(x):
    return x.abs() < QUARTIC_EPS


def solve_quadratic(c0, c1):
    """x^2 + c1 x + c0 = 0 -> (r1, r2), +inf where absent (SolveQuadric:
    D == 0 -> one root, D < 0 -> none)."""
    p = 0.5 * c1
    D = p * p - c0
    sq = torch.sqrt(D.clamp(min=0.0))
    dz = _iszero(D)
    r1 = torch.where(dz, -p, torch.where(D > 0.0, sq - p, torch.inf))
    r2 = torch.where(~dz & (D > 0.0), -sq - p, torch.inf)
    return r1, r2


def cubic_roots(c0, c1, c2, c3):
    """SolveCubic: (..., 3) roots, +inf where absent; slot 0 is the root
    the C code places first (s[0])."""
    A = c2 / c3
    B = c1 / c3
    C = c0 / c3
    sq_A = A * A
    p = (1.0 / 3.0) * (-(1.0 / 3.0) * sq_A + B)
    q = 0.5 * ((2.0 / 27.0) * A * sq_A - (1.0 / 3.0) * A * B + C)
    cb_p = p * p * p
    D = q * q + cb_p
    sub = (1.0 / 3.0) * A

    dz = _iszero(D)
    qz = _iszero(q)

    # D ~ 0
    u0 = _cbrt(-q)
    x0_dz = torch.where(qz, 0.0, 2.0 * u0)
    x1_dz = torch.where(qz, torch.inf, -u0)

    # D < 0: three real roots
    phi = (1.0 / 3.0) * torch.acos(
        (-q / torch.sqrt((-cb_p).clamp(min=1e-300))).clamp(-1.0, 1.0))
    t = 2.0 * torch.sqrt((-p).clamp(min=0.0))
    x0_tri = t * torch.cos(phi)
    x1_tri = -t * torch.cos(phi + math.pi / 3.0)
    x2_tri = -t * torch.cos(phi - math.pi / 3.0)

    # D > 0: one real root
    sqrt_D = torch.sqrt(D.clamp(min=0.0))
    x0_one = _cbrt(sqrt_D - q) - _cbrt(sqrt_D + q)

    three = ~dz & (D < 0.0)
    x0 = torch.where(dz, x0_dz, torch.where(three, x0_tri, x0_one))
    x1 = torch.where(dz, x1_dz, torch.where(three, x1_tri, torch.inf))
    x2 = torch.where(three, x2_tri, torch.inf)

    roots = torch.stack([x0, x1, x2], -1)
    return torch.where(torch.isfinite(roots), roots - sub[..., None], roots)


def solve_quartic(c0, c1, c2, c3, c4):
    """SolveQuartic: (..., 4) roots, +inf where absent (order unspecified)."""
    A = c3 / c4
    B = c2 / c4
    C = c1 / c4
    D = c0 / c4

    sq_A = A * A
    p = -0.375 * sq_A + B
    q = 0.125 * sq_A * A - 0.5 * A * B + C
    r = (-3.0 / 256.0) * sq_A * sq_A + 0.0625 * sq_A * B - 0.25 * A * C + D
    sub = 0.25 * A
    zero, one = torch.zeros_like(p), torch.ones_like(p)

    # r == 0: y (y^3 + p y + q) = 0
    rz = torch.cat([cubic_roots(q, p, zero, one), zero[..., None]], -1)

    # general: the resolvent cubic's s[0]
    z = cubic_roots(0.5 * r * p - 0.125 * q * q, -r, -0.5 * p, one)[..., 0]
    u = z * z - r
    v = 2.0 * z - p
    ok = (_iszero(u) | (u > 0.0)) & (_iszero(v) | (v > 0.0))
    su = torch.where(_iszero(u), 0.0, torch.sqrt(u.clamp(min=0.0)))
    sv = torch.where(_iszero(v), 0.0, torch.sqrt(v.clamp(min=0.0)))
    c1a = torch.where(q < 0.0, -sv, sv)
    g1a, g1b = solve_quadratic(z - su, c1a)
    g2a, g2b = solve_quadratic(z + su, -c1a)
    gen = torch.stack([torch.where(ok, g, torch.inf)
                       for g in (g1a, g1b, g2a, g2b)], -1)

    roots = torch.where(_iszero(r)[..., None], rz, gen)
    return torch.where(torch.isfinite(roots), roots - sub[..., None], roots)
