"""The fp32 product shared by K1, K1t and K2 (``csrc/ffma_tile.cuh``): its
shared-memory plan, its swizzle and the choice of its loader, mirrored in
Python for the wrappers and the CPU tests.

``loader_name`` is the one place that picks the loader: ``"tma"`` (the
operands staged by TMA into a ring on mbarriers) for float32 rows where
every row is a multiple of 16 bytes and every base 16-byte aligned, else
``"regs"`` (the register-staged loader).  bf16 rows have no TMA ring here:
where TMA could read them, K2 takes its tensor-core route
(``csrc/tc_scan.cuh``), so only ragged or unaligned bf16 rows reach this
product.  The wrappers pass the choice to the C launchers,
which raise when a tensor map fails to encode; nothing falls back.
``plan`` mirrors ``regtile::plan``, and ``route_plan`` the shared memory of
each kernel that takes the product, so that a test can hold every route
within a block's 232,448 bytes at every k.
"""

from __future__ import annotations

# csrc/ffma_tile.cuh
TILE = 128
THREADS = 256
WARPS = THREADS // 32
ROW_BYTES = 128
BOX_BYTES = TILE * ROW_BYTES
STAGE_BYTES = 2 * BOX_BYTES
MIN_STAGES = 2
MAX_STAGES = 4
CARRY_MIN_STAGES = 3
REG_STAGES = 2
RES_LD = TILE + 8
RES_BYTES = TILE * RES_LD * 4
BAR_BYTES = 2 * MAX_STAGES * 8
SMEM_LIMIT = 232_448
MAX_NARROW = 128
# csrc/knn_wide.cuh: a row's buffer of keys, a warp's sorted keys, and the
# rows' state (six int arrays of TILE and a flag).
WIDE_BUF = 128
WIDE_SCRATCH = 1024
WIDE_ROWS_BYTES = 6 * TILE * 4 + 4
# csrc/knn_t.cu: the column stride of its transposed tile, and the longest
# list with two owners a row.
T_LD = TILE + 4
HALVES_MAX_K = 64


def loader_name(f: int, itemsize: int, *addresses: int) -> str:
    """"tma" when rows of ``f`` float32 elements (``itemsize`` 4) are a
    multiple of 16 bytes and every base address is 16-byte aligned (TMA's
    rules), else "regs"."""
    if itemsize == 4 and f > 0 and (f * itemsize) % 16 == 0 and all(
            int(a) % 16 == 0 for a in addresses):
        return "tma"
    return "regs"


def loader_of(*tensors) -> str:
    """``loader_name`` for tensors of one row width and type."""
    t0 = tensors[0]
    return loader_name(t0.shape[-1], t0.element_size(),
                       *(t.data_ptr() for t in tensors))


def swizzle_chunk(row: int, chunk: int) -> int:
    """The 16-byte chunk at which a stage row stores its chunk ``chunk``
    (the 128-byte swizzle TMA writes)."""
    return chunk ^ (row % 8)


def plan(epi_bytes: int, rest_bytes: int, tma: bool) -> dict:
    """regtile::plan: the deepest carry ring (3 or 4 stages) that fits, else
    the deepest drain ring (4 to 2); the register-staged loader: 2 stages,
    drain.  Returns {"stages", "carry", "bytes"}; stages 0 when nothing
    fits."""
    def at(s, carry):
        ring = s * STAGE_BYTES
        region = ring + epi_bytes if carry else max(ring, epi_bytes)
        bars = -(-region // 16) * 16
        return {"stages": s, "carry": int(carry),
                "bytes": bars + BAR_BYTES + rest_bytes}

    none = {"stages": 0, "carry": 0, "bytes": 0}
    if not tma:
        p = at(REG_STAGES, False)
        return p if p["bytes"] <= SMEM_LIMIT else none
    for s in range(MAX_STAGES, CARRY_MIN_STAGES - 1, -1):
        if at(s, True)["bytes"] <= SMEM_LIMIT:
            return at(s, True)
    for s in range(MAX_STAGES, MIN_STAGES - 1, -1):
        if at(s, False)["bytes"] <= SMEM_LIMIT:
            return at(s, False)
    return none


ROUTES = ("knn", "knn_sym", "knn_wide", "knn_t", "scan_topk",
          "scan_topk_wide")


def route_plan(route: str, k: int, tma: bool) -> dict:
    """``plan`` for one kernel with lists of k: K1's narrow walk ("knn") and
    symmetric route ("knn_sym"), the wide route (K1's, K1t's and K2's past
    128: "knn_wide", "scan_topk_wide"), K1t's owners ("knn_t") and K2's
    narrow kernel ("scan_topk"), as the C launchers size them (the
    libraries export the same: knn_plan, knn_t_plan, scan_topk_plan)."""
    if route in ("knn_wide", "scan_topk_wide") or k > MAX_NARROW:
        epi = max(RES_BYTES, WARPS * WIDE_SCRATCH * 8)
        return plan(epi, TILE * WIDE_BUF * 8 + WIDE_ROWS_BYTES + TILE * 4,
                    tma)
    if route == "knn":
        return plan(RES_BYTES, TILE * k * 8 + 2 * TILE * 4, tma)
    if route == "knn_sym":
        return plan(RES_BYTES, TILE * k * 8 + 2 * TILE * 4 + WARPS * k * 8
                    + TILE * 12 + 16, tma)
    if route == "knn_t":
        owners = 2 * TILE if k <= HALVES_MAX_K else TILE
        return plan(TILE * T_LD * 4, owners * k * 8, tma)
    if route == "scan_topk":
        return plan(RES_BYTES, TILE * k * 8 + TILE * 4, tma)
    raise ValueError(f"unknown route {route!r}")
