"""MovieLens-20M surrogate: a frozen copy of the repository's generator.

The benchmark's dataset. It is built from the real dataset's published
marginals, and is deterministic for a seed, so every checkout makes the
same 20,000,263 ratings byte for byte. The code below is the generator of
``benchmarks/ml20m_surrogate.py`` as it stood when the benchmark was
defined (without its command line and its JSON-lines writer), so that a
later change there cannot move the benchmark's data.

Matched exactly (GroupLens ml-20m README and dataset summary):

- 20,000,263 ratings, 138,493 users, 26,744 movies;
- the rating-value histogram in half-star steps;
- every user has >= 20 ratings (GroupLens's inclusion filter);
- at most one rating per (user, movie) pair;
- timestamps span 1995-01-09 .. 2015-03-31, non-decreasing per user.

Matched approximately (fitted, because only summary figures are public):
item popularity (a clipped lognormal whose head title expects ~67k
ratings), user activity (20 + a lognormal excess, mean 144.4, clipped at
9,254), and a mild popularity-to-rating correlation repaired to the exact
histogram.
"""

import numpy as np

# The real ml-20m headline counts.
N_RATINGS = 20_000_263
N_USERS = 138_493
N_MOVIES = 26_744
TOP_MOVIE_COUNT = 67_310   # Pulp Fiction (movieId 296) in the real data
TOP_USER_COUNT = 9_254     # most active real user
TS_MIN = 789_652_009       # 1995-01-09 (first real rating)
TS_MAX = 1_427_784_002     # 2015-03-31 (last real rating)

#: value -> exact count; sums to N_RATINGS.
RATING_HISTOGRAM = {
    0.5: 239_125, 1.0: 680_732, 1.5: 279_252, 2.0: 1_430_997,
    2.5: 883_398, 3.0: 4_291_193, 3.5: 2_200_156, 4.0: 5_561_926,
    4.5: 1_534_824, 5.0: 2_898_660,
}
assert sum(RATING_HISTOGRAM.values()) == N_RATINGS


def _sizes_with_exact_total(raw: np.ndarray, total: int, lo: int,
                            hi: int, rng: np.random.Generator) -> np.ndarray:
    """Round positive draws to ints in [lo, hi] summing to exactly
    ``total`` (repair by +/-1 nudges on random rows with slack)."""
    sizes = np.clip(np.round(raw).astype(np.int64), lo, hi)
    diff = int(total - sizes.sum())
    step = 1 if diff > 0 else -1
    while diff != 0:
        k = min(abs(diff), len(sizes))
        idx = rng.choice(len(sizes), size=k, replace=False)
        room = (sizes[idx] < hi) if step > 0 else (sizes[idx] > lo)
        sizes[idx[room]] += step
        diff = int(total - sizes.sum())
    return sizes


def item_popularity(n_movies: int, total: int, top: int,
                    rng: np.random.Generator,
                    sizes: np.ndarray | None = None) -> np.ndarray:
    """Clipped-lognormal popularity weights, normalized so the head item
    expects ~``top`` ratings out of ``total``.

    The one-rating-per-(user,movie) constraint makes the head's expected
    count Σ_u [1-(1-p0)^{n_u}] rather than p0·total (each user can pick
    it at most once) — the same constraint the real data's 67,310 count
    lives under. Given ``sizes`` (per-user activity), p0 is solved by
    bisection so the head expects ``top`` *after* that saturation."""
    # sigma=2.6 gives median/mean ~ 1/30 (a long tail: ~quarter of
    # titles land under ~1/60 of the mean, matching the "<10 ratings"
    # published character at full scale)
    sigma = 2.6
    w = rng.lognormal(mean=0.0, sigma=sigma, size=n_movies)
    w = np.sort(w)[::-1]
    # pin the head share exactly: the top title expects ``top`` ratings,
    # the lognormal tail carries the rest (clipped so no tail title
    # expects more than the head, renormalized to compensate)
    p0 = min(top / total, 0.5)
    if sizes is not None and top < 0.98 * len(sizes):
        n_u = sizes.astype(np.float64)
        lo, hi = p0, min(64.0 * p0, 0.5)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            exp_head = float(np.sum(1.0 - np.power(1.0 - mid, n_u)))
            if exp_head < top:
                lo = mid
            else:
                hi = mid
        p0 = 0.5 * (lo + hi)
    tail = w[1:]
    for _ in range(16):
        p_tail = tail / tail.sum() * (1.0 - p0)
        if p_tail.max() <= p0 * (1.0 + 1e-9):
            break
        np.minimum(tail, tail.max() * 0.7, out=tail)
    p = np.concatenate([[p0], p_tail])
    return p / p.sum()


def generate(scale: float = 1.0, seed: int = 20):
    """Return (users, items, stars, ts, n_users, n_movies) int32/float32
    arrays. ``scale`` shrinks every marginal proportionally (counts in
    the histogram are scaled and repaired to the scaled total)."""
    rng = np.random.default_rng(seed)
    exact = abs(scale - 1.0) < 1e-9
    n_ratings = int(round(N_RATINGS * scale))
    n_users = max(int(round(N_USERS * scale)), 8)
    n_movies = max(int(round(N_MOVIES * scale)), 8)
    top_m = max(int(round(TOP_MOVIE_COUNT * scale)), 4)
    top_u = max(int(round(TOP_USER_COUNT * scale)), 4)
    min_per_user = 20 if exact else max(
        int(round(20 * min(1.0, n_ratings / (n_users * 20 * 2)))), 1)

    # --- user activity: 20 + lognormal excess, exact total ---
    mean_excess = n_ratings / n_users - min_per_user
    sig_u = 1.5
    mu_u = np.log(max(mean_excess, 1.0)) - sig_u * sig_u / 2.0
    raw = min_per_user + rng.lognormal(mu_u, sig_u, size=n_users)
    # one rating per pair caps activity at n_movies; at small --scale the
    # scaled top-user cap can fall below the mean, which would make the
    # exact-total repair unreachable — keep the cap above the mean
    hi = min(max(top_u, int(np.ceil(n_ratings / n_users)) + 2), n_movies)
    assert n_ratings <= n_users * n_movies, "more ratings than pairs"
    sizes = _sizes_with_exact_total(raw, n_ratings, min_per_user, hi, rng)

    # --- item popularity ---
    p = item_popularity(n_movies, n_ratings, top_m, rng, sizes=sizes)

    # --- draw items per user, no (user,item) repeats ---
    users = np.repeat(np.arange(n_users, dtype=np.int32), sizes)
    items = np.empty(n_ratings, dtype=np.int32)
    offs = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])

    heavy = np.flatnonzero(sizes > 500)
    light = np.flatnonzero(sizes <= 500)
    # heavy users: Gumbel top-n over the full weight vector (exact
    # weighted sampling without replacement)
    logp = np.log(p + 1e-300)
    for u in heavy:
        n = int(sizes[u])
        g = logp + rng.gumbel(size=n_movies)
        items[offs[u]:offs[u + 1]] = np.argpartition(g, -n)[-n:]
    # light users: global vectorized draw + per-user dedupe/resample
    if len(light):
        sel = np.concatenate([np.arange(offs[u], offs[u + 1])
                              for u in light]) if len(light) < n_users \
            else None
        idx = (np.flatnonzero(np.isin(users, light)) if sel is None
               else sel)
        need = idx
        check = idx  # first round must examine every light position
        for _round in range(30):
            items[need] = rng.choice(n_movies, size=len(need), p=p)
            # only rows of users owning a resampled position can have
            # gained a duplicate — checking all ~20M light positions
            # every round costs an O(n log n) argsort for a handful of
            # collisions after round 1
            key = users[check].astype(np.int64) * n_movies + items[check]
            order = np.argsort(key, kind="stable")
            dup = np.zeros(len(check), dtype=bool)
            dup[order[1:]] = key[order[1:]] == key[order[:-1]]
            need = check[dup]
            if len(need) == 0:
                break
            hot = np.isin(users[idx], np.unique(users[need]))
            check = idx[hot]
        if len(need):  # final repair: uniform over the user's unseen
            for j in need:
                u = users[j]
                have = set(items[offs[u]:offs[u + 1]].tolist())
                for cand in rng.permutation(n_movies):
                    if int(cand) not in have:
                        items[j] = cand
                        break

    # --- rating values: exact histogram, popularity-correlated ---
    vals_sorted = np.concatenate([
        np.full(c if exact else int(round(c * scale)), v,
                dtype=np.float32)
        for v, c in sorted(RATING_HISTOGRAM.items())])
    # repair scaled histogram to the exact total
    if len(vals_sorted) != n_ratings:
        if len(vals_sorted) > n_ratings:
            vals_sorted = vals_sorted[
                rng.choice(len(vals_sorted), n_ratings, replace=False)]
            vals_sorted = np.sort(vals_sorted)
        else:
            extra = rng.choice(
                np.array(sorted(RATING_HISTOGRAM), dtype=np.float32),
                n_ratings - len(vals_sorted),
                p=np.array([RATING_HISTOGRAM[v] for v in
                            sorted(RATING_HISTOGRAM)], dtype=np.float64)
                / N_RATINGS)
            vals_sorted = np.sort(np.concatenate([vals_sorted, extra]))
    # popularity-correlated assignment: rank ratings by item popularity
    # + noise, hand the sorted values out along that order (higher value
    # -> more popular titles, mildly)
    pop_rank = p[items] + rng.normal(scale=p.mean() * 8.0,
                                     size=n_ratings)
    order = np.argsort(pop_rank, kind="stable")
    stars = np.empty(n_ratings, dtype=np.float32)
    stars[order] = vals_sorted  # ascending value onto ascending pop

    # --- timestamps: per-user non-decreasing, uniform overall ---
    ts = rng.integers(TS_MIN, TS_MAX, size=n_ratings,
                      dtype=np.int64)
    for u in range(n_users):  # sort within each user's slice
        s, e = offs[u], offs[u + 1]
        ts[s:e] = np.sort(ts[s:e])

    return users, items, stars, ts, n_users, n_movies


def verify_marginals(users, items, stars, ts, n_users, n_movies,
                     scale=1.0):
    """Assert the documented exact marginals actually hold (the strict
    published-constant checks apply only at exactly scale=1.0)."""
    exact = abs(scale - 1.0) < 1e-9
    n = len(users)
    uc = np.bincount(users, minlength=n_users)
    assert uc.min() >= (20 if exact else 1), uc.min()
    key = users.astype(np.int64) * n_movies + items
    assert len(np.unique(key)) == n, "duplicate (user,item) pair"
    if exact:
        assert n == N_RATINGS
        hist = {float(v): int(c) for v, c in
                zip(*np.unique(stars, return_counts=True))}
        assert hist == RATING_HISTOGRAM, "histogram mismatch"
    assert ts.min() >= TS_MIN and ts.max() <= TS_MAX
    return {
        "n_ratings": n, "n_users": n_users, "n_movies": n_movies,
        "top_item_count": int(np.bincount(items).max()),
        "top_user_count": int(uc.max()),
        "mean_per_user": round(float(uc.mean()), 1),
        "items_under_10": int((np.bincount(
            items, minlength=n_movies) < 10).sum()),
    }
