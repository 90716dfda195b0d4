"""A numpy model of kernel K6's wide route (csrc/ivf_scan.cu, lists past
256), shared by tests/test_torch_ivf_wide.py (against the plain version on
the CPU) and tests/test_torch_gpu_ivf.py (against the kernel's merge
counts on the card).  Numpy only: the card's machine has no jax.

The route: a block walks its probes' real-row tiles (each probed cluster's
first ``tiles[c]`` 64-row tiles, in the probe table's order) in steps of
256 rows, a step's tiles crossing probe boundaries, the last step padded.
Each query keeps a filter, its list's kth as of its last merge, the strict
MaxLex compare; per step its survivors go, as descending keys, onto a
staging row of SROW keys, and a staging row holding more than SROW - 256
keys (it could not take the next step) is sorted and merged into the
query's list in one pass; what is left at the end of the walk too.

The key helpers are csrc/knn_wide.cuh's descending key, as
tests/test_torch_scan_wide.py writes them."""

import numpy as np

NEG = np.float32(-3e38)
TILE, STEP, SROW = 64, 256, 512
M32 = np.uint64(0xFFFFFFFF)


def order_key(v):
    """select.cuh's order_key: -0.0 folded into +0.0, NaN key 0."""
    v = np.asarray(v, np.float32)
    b = v.view(np.uint32).copy()
    b[v == 0] = 0
    b = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    b[np.isnan(v)] = 0
    return b


def dkey(s, ids):
    """The descending key: ~order_key(s) << 32 | id << 1 | (s is -0.0)."""
    s = np.atleast_1d(np.asarray(s, np.float32))
    ids = np.atleast_1d(np.asarray(ids, np.int64)).astype(np.uint64)
    hi = (~order_key(s)).astype(np.uint64)
    neg0 = (s.view(np.uint32) == 0x80000000).astype(np.uint64)
    return (hi << np.uint64(32)) | (((ids << np.uint64(1)) & M32) | neg0)


def unkey(k):
    """(scores, ids) of descending keys: the score's own bits back."""
    k = np.atleast_1d(np.asarray(k, np.uint64))
    hi = (~(k >> np.uint64(32)) & M32).astype(np.uint32)
    bits = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi).astype(np.uint32)
    lo = (k & M32).astype(np.uint32)
    bits = np.where(lo & 1, np.uint32(0x80000000), bits).astype(np.uint32)
    return bits.view(np.float32), (lo >> 1).astype(np.int32)


def better(v, i, tv, ti):
    """tile_common.cuh MaxLex: (v, i) strictly beats (tv, ti); NaN never."""
    return (v > tv) | ((v == tv) & (i < ti))


def merge(lv, li, sk):
    """merge_into's result in place: the k least of the list's keys and
    the sorted staged keys sk, a list entry before an equal staged key."""
    k = len(lv)
    sv, si = unkey(sk)
    allv = np.concatenate([lv, sv])
    alli = np.concatenate([li, si])
    order = np.argsort(np.concatenate([dkey(lv, li), sk]), kind="stable")
    lv[:], li[:] = allv[order[:k]], alli[order[:k]]


def walk(probe_row, tiles, cap):
    """The slab rows of a block's walk in order, padded with -1 to whole
    steps of 256 rows."""
    parts = [c * cap + np.arange(TILE * int(tiles[c])) for c in probe_row]
    rows = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return np.concatenate([rows, np.full((-len(rows)) % STEP, -1)])


def wide_list(scores, ids, k):
    """One query's list over its walk: scores [W] (float32, -3e38 on
    padding rows) and ids [W] (-1 on padding) in walk order, W a multiple
    of 256.  Returns (scores [k], ids [k], merges)."""
    lv, li = np.full(k, NEG, np.float32), np.full(k, -1, np.int32)
    tv, ti = NEG, np.int32(-1)
    staged, merges = [], 0

    def flush():
        nonlocal staged, tv, ti, merges
        merge(lv, li, np.sort(np.array(staged, np.uint64)))
        staged, merges = [], merges + 1
        if better(lv[-1], li[-1], tv, ti):
            tv, ti = lv[-1], li[-1]

    for s0 in range(0, len(scores), STEP):
        v, i = scores[s0:s0 + STEP], ids[s0:s0 + STEP]
        keep = better(v, i, tv, ti)
        staged += list(dkey(v[keep], i[keep]))
        assert len(staged) <= SROW
        if len(staged) > SROW - STEP:
            flush()
    if staged:
        flush()
    return lv, li, merges


def blend(cos, lam, lamq, tau):
    """ivf_scan_plain's float32 scores, op by op: tau * cos + (1 - tau) *
    (1 / (1 + |lam - lamq|))."""
    f32 = np.float32
    tau = f32(tau)
    prox = f32(1.0) / (f32(1.0) + np.abs(lam - lamq))
    return tau * cos + (f32(1.0) - tau) * prox


def scan(slabs, lam, ids, qn, lamq, probe, tau, k, qb, cap, tiles):
    """The wide route's lists of every query: (scores [Q, k], ids [Q, k],
    merges [Q]).  slabs [K cap, F], qn [Q, F] float32 (the products summed
    in float64 and rounded: exact on data whose products are), the rest as
    ivf_scan's arguments in numpy.  A zero product sum is +0.0, as the
    kernel's fmaf chain from +0.0 gives it."""
    n_blocks = probe.shape[0]
    out_s = np.zeros((n_blocks * qb, k), np.float32)
    out_i = np.zeros((n_blocks * qb, k), np.int32)
    merges = np.zeros(n_blocks * qb, np.int64)
    for b in range(n_blocks):
        rows = walk(probe[b], tiles, cap)
        real = rows >= 0
        safe = np.where(real, rows, 0)
        row_ids = np.where(real, ids[safe], -1).astype(np.int32)
        for q in range(b * qb, (b + 1) * qb):
            cos = (slabs[safe].astype(np.float64)
                   @ qn[q].astype(np.float64) + 0.0).astype(np.float32)
            with np.errstate(invalid="ignore"):
                s = blend(cos, lam[safe], lamq[q], tau)
            s = np.where(row_ids >= 0, s, NEG).astype(np.float32)
            out_s[q], out_i[q], merges[q] = wide_list(s, row_ids, k)
    return out_s, out_i, merges
