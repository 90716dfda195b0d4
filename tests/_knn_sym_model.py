"""A numpy model of kernel K1's symmetric route (csrc/knn.cu, route "sym"),
for tests/test_torch_knn_sym.py.  Numpy only: the card's machine has no
jax.

The route, at a tile width T (the kernel's is 128; the model takes any):
row block b, rows [T b, T b + T), walks the column tiles t >= b in the
kernel's order (``walk``: the diagonal tile, then a stride coprime with
the walk's length) and offers each tile's columns to its rows' own lists,
the diagonal tile's self pairs masked.  Every tile t > b is also merged,
transposed, into the lists of its rows T t + c, which the rows of block b
are offered to.  Only the upper block triangle of the distances is read:
d(r, c) with block(r) <= block(c), for both merges.

Blocks run in any order and take a tile's transposed lists one at a time
(its lock), so the model interleaves the blocks' steps in an order drawn
from a seed.  A step is two events: before its product a block reads its
columns' filters (each transposed list's kth as it is then), and later,
under the lock, it merges: a column with a row that beats its filter
(MinLex) is merged, its rows ballotted against the list's kth as it is then
and the survivors offered in ascending row order by the kernel's insertion
(tile_common.cuh ``offer``, MinLex).  At the end each row's own list and
transposed list are merged into their k least: knn_wide.cuh's ``merge``,
in the order of its Asc key, (distance with -0.0 folded into +0.0, id)."""

import numpy as np

EMPTY_ID = -1


def better(v, i, w, j):
    """tile_common.cuh MinLex: (v, i) strictly before (w, j)."""
    return v < w or (v == w and i < j)


def offer(vals, ids, v, i):
    """tile::offer: insert (v, i) after every entry before or equal to it,
    if it beats the kth; the last entry drops out."""
    if not better(v, i, vals[-1], ids[-1]):
        return
    pos = sum(not better(v, i, a, b) for a, b in zip(vals, ids))
    vals[pos + 1:] = vals[pos:-1].copy()
    ids[pos + 1:] = ids[pos:-1].copy()
    vals[pos], ids[pos] = v, i


def walk(b, n_tiles):
    """Block b's tiles in the kernel's order: b + (s g mod L), s = 0 .. L -
    1, L = n_tiles - b, g the first integer from float32(0.618034) L (at
    least 1) coprime with L."""
    length = n_tiles - b
    g = max(1, int(np.float32(0.618034) * np.float32(length)))
    while np.gcd(g, length) != 1:
        g += 1
    return [b + s * g % length for s in range(length)]


def interleave(steps, rng):
    """Each block's events in its own order, the blocks interleaved at
    random: a list of (block, event index)."""
    left = {b: n for b, n in enumerate(steps) if n}
    at = dict.fromkeys(left, 0)
    order = []
    while left:
        b = int(rng.choice(sorted(left)))
        order.append((b, at[b]))
        at[b] += 1
        left[b] -= 1
        if not left[b]:
            del left[b]
    return order


def sym_lists(dist, k, tile, seed=0, empty=2.0):
    """Each row's k nearest under the symmetric route: dist [n, n] the
    masked distances (self and d > eps at ``empty``), symmetric; returns
    (d [n, k], i [n, k] int32), missing entries (empty, -1)."""
    n = dist.shape[0]
    nt = -(-n // tile)
    own_d = np.full((n, k), empty, dist.dtype)
    own_i = np.full((n, k), EMPTY_ID, np.int32)
    tr_d, tr_i = own_d.copy(), own_i.copy()
    walks = [walk(b, nt) for b in range(nt)]
    for r in range(n):                      # the own walks
        for t in walks[r // tile]:
            for c in range(t * tile, min(n, t * tile + tile)):
                offer(own_d[r], own_i[r], dist[r, c], c)
    rng = np.random.default_rng(seed)
    filters = {}
    for b, e in interleave([2 * (nt - 1 - b) for b in range(nt)], rng):
        t = walks[b][1 + e // 2]
        rows = range(t * tile, min(n, t * tile + tile))
        if e % 2 == 0:                      # the filters, before the product
            filters[b] = [(tr_d[j, -1], tr_i[j, -1]) for j in rows]
            continue
        for (fv, fi), j in zip(filters.pop(b), rows):   # under the lock
            cand = range(b * tile, b * tile + tile)
            if not any(better(dist[r, j], r, fv, fi) for r in cand):
                continue
            kv, ki = tr_d[j, -1], tr_i[j, -1]
            for r in [r for r in cand if better(dist[r, j], r, kv, ki)]:
                offer(tr_d[j], tr_i[j], dist[r, j], r)
    d = np.concatenate([own_d, tr_d], axis=1)
    i = np.concatenate([own_i, tr_i], axis=1)
    # The final merge in the Asc key's order: the distance (numpy's sort
    # ranks -0.0 and +0.0 alike), then the id; own entries before equal
    # transposed ones (only empty entries are equal).
    order = np.array([np.lexsort((i[r], d[r]))[:k] for r in range(n)],
                     dtype=np.int64).reshape(n, k)
    return (np.take_along_axis(d, order, axis=1),
            np.take_along_axis(i, order, axis=1))
