"""The tensor-core scan of K2 over bf16 rows and K7 (``csrc/tc_scan.cuh``):
its shared-memory plan, mirrored in Python for the wrappers and the CPU
tests.

``plan`` mirrors ``tcscan::tc_plan``: from F, k and the element size
alone, whether the block's 128 queries stay resident in shared memory or
ride each ring slot beside the corpus stage (``stream``, allowed only on
K2's route), whether its 128 lists are narrow (in shared memory) or wide
(staged, sorted and merged in device memory), how deep the ring is, and
whether the two warpgroups take turns on the tensor cores.  The C
launchers compute the same plan and export it (``scan_topk_tc_plan``,
``scan_int8_tc_wide``); the wrappers raise when the two disagree.
"""

from __future__ import annotations

# csrc/tc_scan.cuh
QB = 128                 # queries a block
NB = 128                 # items a tile
WARPS = 8                # consumer warps
ROW_BYTES = 128          # a stage: one 128-byte row of every operand row
A_STAGE_BYTES = QB * ROW_BYTES
B_STAGE_BYTES = NB * ROW_BYTES
BUF = 256                # survivors a warp buffers (narrow lists)
MAX_STAGES = 6
SMEM_LIMIT = 232_448
NARROW_MAX = 256         # tile_common.cuh MAX_NARROW
# csrc/knn_wide.cuh: keys a wide list's query stages; a WideRow's bytes.
SROW = 512
WIDE_ROW_BYTES = 12


def layout_bytes(nk: int, stages: int, wide: bool, list_bytes: int,
                 stream: bool) -> int:
    """tcscan::tc_layout's total: the resident queries (none when
    streamed), the ring, the warps' buffers, the lists and the
    barriers."""
    warp_buf = SROW * 8 if wide else BUF * 8
    slot = A_STAGE_BYTES + B_STAGE_BYTES if stream else B_STAGE_BYTES
    ring = 0 if stream else nk * A_STAGE_BYTES
    return (ring + stages * slot + WARPS * warp_buf + list_bytes
            + (1 + 2 * stages) * 8)


def list_bytes(wide: bool, k: int) -> int:
    """128 narrow lists of k, or 128 wide lists' rows."""
    return QB * WIDE_ROW_BYTES if wide else QB * k * 8


def stages_of(f: int, itemsize: int) -> int:
    """The 128-byte feature stages of a row of f elements."""
    return -(-f * itemsize // ROW_BYTES)


def plan(f: int, k: int, itemsize: int, may_stream: bool) -> dict:
    """tcscan::tc_plan at f features of ``itemsize`` bytes with lists of k:
    {"stream", "wide", "stages", "turns", "bytes"}; bytes past SMEM_LIMIT
    when nothing fits."""
    nk = stages_of(f, itemsize)
    stream = may_stream and layout_bytes(
        nk, 2, True, list_bytes(True, k), False) > SMEM_LIMIT
    wide = k > NARROW_MAX or layout_bytes(
        nk, 2, False, list_bytes(False, k), stream) > SMEM_LIMIT
    lists = list_bytes(wide, k)
    stages = MAX_STAGES
    while stages > 2 and layout_bytes(nk, stages, wide, lists,
                                      stream) > SMEM_LIMIT:
        stages -= 1
    return {"stream": stream, "wide": wide, "stages": stages,
            "turns": stages >= nk,
            "bytes": layout_bytes(nk, stages, wide, lists, stream)}
