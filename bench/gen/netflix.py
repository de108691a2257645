"""Netflix-shaped rating triples, made on the device from ``--seed``.

Degrees.  Each side's degrees are one law read at its quantiles
``(i + 1/2) / n`` (as ``gen.zipf`` reads Zipf's), in z = the standard
normal quantile: log-normal below the median, from the stated minimum
at the bottom quantile to the median at z = 0; above it a rise from the
median to the stated maximum at the top quantile along a saturating
exponential in z, whose curvature is set so that the degrees add up to
the ratings count.  Read so, the law keeps the minimum, the median, the
mean and the maximum, and the maximum is one row's, with the next rows
below it (no pile-up at a cap).  The degrees sit on the ids in one fixed
layout, a random permutation a side drawn once from ``LAYOUT_SEED``.

Pairing.  The movies' degrees are exact; each movie draws that many
distinct users without replacement by an exponential race (the users
with the smallest keys ``Exp(1) / weight`` win), a block of movies at a
time on the device.  The weights are fitted so that each user's expected
draws meet its degree (``race_weights``): in the race a user of weight
``w`` enters a movie of threshold ``t`` with chance ``1 - exp(-w t)``
(Rosen's approximation of successive sampling), and the fit solves the
thresholds for the movies' degrees and the weights for the users' in
turn, by Newton steps in log space over the distinct degrees of each
side.  So the heaviest user lands in nearly every movie, as Netflix's
did, and the users' degrees are met in expectation.  A user no movie
drew (every Netflix user has a rating) then takes one rating, drawn at
random, of a user who keeps enough to lose one to each such user.

Ratings.  A planted rank-``d`` model, ``r = <U_u, V_m> + noise *
N(0, 1)`` with ``U``, ``V`` ~ N(0, 1/d) (as the port's
``apps.als.synthetic_netflix``), and the starting factors ``w0 = 0.1 *
N(0, 1)``, users first.

``--seed`` draws three streams: the pairing (``3 seed``), the factors
and the noise (``3 seed + 1``), and ``w0`` (``3 seed + 2``).
"""
from __future__ import annotations

import math

from . import generator

# the degrees' placement on the ids (users, then movies at + 1), the
# same for every seed
LAYOUT_SEED = 0
# race keys drawn at a time: a block of movies x every user
BLOCK_KEYS = 1 << 26
# ratings predicted at a time, in float64
BLOCK_RATINGS = 1 << 22
_BISECTIONS = 200
# alternating Newton steps of the race weights' fit (converged to float64
# rounding by about 15 at the published sizes), and a step's bound in log
# space
FIT_STEPS = 24
_FIT_STEP_MAX = 2.0


def _law(torch, z, minimum, median, maximum, k):
    """The law's real-valued degrees at the quantiles ``z`` (ascending),
    the upper half's curvature ``k``."""
    zt = float(z[-1])
    low = math.log(median / minimum) / zt
    u = (z / zt).clamp_min(0.0)
    h = u if abs(k) < 1e-12 else torch.expm1(-k * u) / math.expm1(-k)
    f = torch.where(z <= 0, math.log(median) + low * z,
                    math.log(median) + math.log(maximum / median) * h)
    return f.exp()


def degree_law(torch, n: int, minimum: int, median: float, maximum: int,
               total: int, device):
    """``[n]`` int64 degrees, ascending: the law through ``minimum``,
    ``median`` and ``maximum`` whose degrees add up to ``total``
    (whole-number rounding by largest remainders; the first row is
    ``minimum`` and the last ``maximum``)."""
    if n < 3 or not 1 <= minimum <= median <= maximum:
        raise ValueError(f"a law needs n >= 3 and 1 <= minimum <= median "
                         f"<= maximum, got {n}, {minimum}, {median}, "
                         f"{maximum}")
    z = torch.special.ndtri((torch.arange(n, dtype=torch.float64,
                                          device=device) + 0.5) / n)

    def mass(k):
        return float(_law(torch, z, minimum, median, maximum, k).sum())

    lo, hi = -20.0, 40.0
    if not mass(lo) <= total <= mass(hi):
        raise ValueError(f"no curvature gives {total} over {n} rows with "
                         f"min {minimum}, median {median}, max {maximum}")
    for _ in range(_BISECTIONS):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if mass(mid) < total else (lo, mid)
    real = _law(torch, z, minimum, median, maximum, (lo + hi) / 2)
    deg = real.floor().clamp(minimum, maximum).long()
    deg[0], deg[-1] = minimum, maximum
    short = total - int(deg.sum())
    if not 0 <= short < n - 1:
        raise ValueError(f"rounding left {short} of {total} over {n} rows")
    frac = (real - real.floor())[1:-1]
    up = torch.sort(frac, descending=True, stable=True).indices[:short] + 1
    deg[up] += 1
    return deg


def placed(torch, law, side: int, device):
    """The sorted ``law`` on the ids in the side's fixed layout."""
    n = law.shape[0]
    deg = torch.empty_like(law)
    perm = torch.randperm(n, generator=generator(torch, LAYOUT_SEED + side,
                                                 device), device=device)
    deg[perm] = law
    return deg


def degrees(torch, cfg, device):
    """``(users, movies)``: each side's degrees in its layout (the
    users' are the pairing's targets, the movies' exact)."""
    n = cfg["n_ratings"]
    out = []
    for side, (count, key) in enumerate((("n_users", "user_degrees"),
                                         ("n_movies", "movie_degrees"))):
        law = cfg[key]
        out.append(placed(torch, degree_law(
            torch, cfg[count], law["minimum"], law["median"],
            law["maximum"], n, device), side, device))
    return tuple(out)


def race_weights(torch, target, k):
    """float32 race weights ``[n_users]`` (the heaviest 1) under which
    each user's expected draws over movies of degrees ``k`` meet its
    ``target``: with ``x = log w`` a distinct user degree ``a`` and ``y =
    log t`` a distinct movie degree, ``sum_a c_a (1 - exp(-e^(x + y))) =
    k`` for each movie degree and ``sum_k e_k (1 - exp(-e^(x + y))) = a``
    for each user degree (``c``, ``e``: how many rows have it)."""
    f64 = torch.float64
    a, user_of = torch.unique(target, return_inverse=True)
    c = torch.bincount(user_of).to(f64)
    kk, e = torch.unique(k, return_counts=True)
    a, kk, e = a.to(f64), kk.to(f64), e.to(f64)
    x = a.log()
    y = kk.log() - float((c * a).sum().log())

    def chances(x, y):
        z = (x[None, :] + y[:, None]).exp()     # [movie degree, user degree]
        return -torch.expm1(-z), z * (-z).exp()
    for _ in range(FIT_STEPS):
        p, dp = chances(x, y)
        y = y - ((p @ c - kk) / (dp @ c).clamp_min(1e-300)).clamp(
            -_FIT_STEP_MAX, _FIT_STEP_MAX)
        p, dp = chances(x, y)
        x = x - ((e @ p - a) / (e @ dp).clamp_min(1e-300)).clamp(
            -_FIT_STEP_MAX, _FIT_STEP_MAX)
    return (x - x.max()).exp().float()[user_of]


def pairs(torch, cfg, seed: int, device):
    """``(users, movies)`` int64 ``[n_ratings]``, sorted by (user, movie),
    no pair twice: each movie's users drawn by the race."""
    n_users, n_movies = cfg["n_users"], cfg["n_movies"]
    target, k = degrees(torch, cfg, device)
    if int(k.max()) > n_users:
        raise ValueError("a movie has more ratings than there are users")
    weight = race_weights(torch, target, k)
    gen = generator(torch, 3 * seed, device)
    order = torch.sort(k, descending=True, stable=True).indices
    rows = max(1, BLOCK_KEYS // n_users)
    users, movies = [], []
    for b0 in range(0, n_movies, rows):
        ids = order[b0: b0 + rows]
        kb = k[ids]
        width = int(kb[0])
        keys = torch.empty((ids.shape[0], n_users), device=device)
        keys.exponential_(generator=gen).div_(weight)
        won = torch.topk(keys, width, dim=1, largest=False,
                         sorted=True).indices
        del keys
        take = torch.arange(width, device=device) < kb[:, None]
        users.append(won[take])
        movies.append(ids.repeat_interleave(kb))
        del won, take
    users = torch.cat(users)
    deg = torch.bincount(users, minlength=n_users)
    alone = (deg == 0).nonzero().squeeze(1)
    if alone.numel():
        donors = (deg[users] > alone.numel()).nonzero().squeeze(1)
        pick = torch.randperm(donors.numel(), generator=gen,
                              device=device)[: alone.numel()]
        users[donors[pick]] = alone
    key = torch.sort(users * n_movies + torch.cat(movies)).values
    return key // n_movies, key % n_movies


def netflix(torch, cfg, seed: int, device) -> dict:
    """The triples and the starting factors, on ``device``: ``users``,
    ``movies`` (int64), ``ratings`` (float32) ``[n_ratings]`` and ``w0``
    (float32 ``[n_users + n_movies, d]``)."""
    users, movies = pairs(torch, cfg, seed, device)
    d, f64 = cfg["d"], torch.float64
    gen = generator(torch, 3 * seed + 1, device)
    U = torch.randn((cfg["n_users"], d), generator=gen, dtype=f64,
                    device=device) / math.sqrt(d)
    V = torch.randn((cfg["n_movies"], d), generator=gen, dtype=f64,
                    device=device) / math.sqrt(d)
    noise = torch.randn(users.shape, generator=gen, dtype=f64, device=device)
    ratings = torch.empty(users.shape, dtype=torch.float32, device=device)
    for a in range(0, users.shape[0], BLOCK_RATINGS):
        b = a + BLOCK_RATINGS
        ratings[a:b] = ((U[users[a:b]] * V[movies[a:b]]).sum(1)
                        + cfg["noise"] * noise[a:b]).float()
    del U, V, noise
    w0 = torch.randn((cfg["n_users"] + cfg["n_movies"], d),
                     generator=generator(torch, 3 * seed + 2, device),
                     device=device) * 0.1
    return {"users": users, "movies": movies, "ratings": ratings, "w0": w0}
