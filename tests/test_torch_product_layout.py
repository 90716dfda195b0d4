"""The fp32 product of K1, K1t and K2 (csrc/ffma_tile.cuh) on the CPU: its
Python mirror (ops/cuda/ffma_tile.py) against the header's constants and
its plan (the header's ``regtile::plan`` compiled with g++ beside the
mirror), every route's shared memory within a block's 232,448 bytes at
every k <= 128, the swizzled reads free of bank conflicts, and the loader
chosen from F and alignment alone."""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch.ops.cuda import ffma_tile as ft
from pyarrowspace_tpu_torch.ops.cuda import tc_scan
from pyarrowspace_tpu_torch.ops.cuda.subtile_max import tensor_core_route

CSRC = Path(ft.__file__).resolve().parents[2] / "csrc"
HEADER = (CSRC / "ffma_tile.cuh").read_text()


def _constants(text: str) -> dict:
    """The header's namespace-scope ``constexpr int NAME = expr;`` values,
    each expression evaluated over the names before it."""
    out = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                 flags=re.M):
        expr = expr.split("//")[0].replace("/", "//").replace("regtile::", "")
        try:
            out[name] = eval(expr, {}, dict(out))  # noqa: S307
        except (NameError, SyntaxError):
            pass   # not a plain integer expression (a ternary, a sizeof)
    return out


def test_mirror_constants_equal_the_header():
    c = _constants(HEADER)
    for name in ("TILE", "THREADS", "WARPS", "ROW_BYTES", "BOX_BYTES",
                 "STAGE_BYTES", "MIN_STAGES", "MAX_STAGES",
                 "CARRY_MIN_STAGES", "REG_STAGES", "RES_LD", "RES_BYTES",
                 "BAR_BYTES", "SMEM_LIMIT", "MAX_NARROW"):
        assert c[name] == getattr(ft, name), name
    wide = _constants((CSRC / "knn_wide.cuh").read_text())
    assert wide["BUF"] == ft.WIDE_BUF and wide["SCRATCH"] == ft.WIDE_SCRATCH
    # knn_wide.cuh's Rows: six int arrays of TILE and one flag.
    rows = re.search(r"struct Rows \{(.*?)\};",
                     (CSRC / "knn_wide.cuh").read_text(), re.S).group(1)
    assert len(re.findall(r"\[regtile::TILE\];", rows)) == 6
    assert len(re.findall(r"^\s*int \w+;", rows, re.M)) == 1
    assert ft.WIDE_ROWS_BYTES == 6 * ft.TILE * 4 + 4
    knn_t = (CSRC / "knn_t.cu").read_text()
    assert "constexpr int T_LD = regtile::TILE + 4;" in knn_t
    assert f"constexpr int HALVES_MAX_K = {ft.HALVES_MAX_K};" in knn_t


def test_swizzle_is_the_tma_128_byte_pattern():
    """wgmma_tile.cuh's swizzle_offset, which TMA's SWIZZLE_128B writes and
    the register-staged loader copies: chunk c of row r at c ^ (r % 8)."""
    wg = (CSRC / "wgmma_tile.cuh").read_text()
    assert "r * ROW_BYTES + ((c ^ (r & 7)) << 4)" in wg
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in wg
    for r in range(16):
        assert sorted(ft.swizzle_chunk(r, c) for c in range(8)) == \
            list(range(8))


def _compiled_plan(tmp_path):
    """The header's Plan and plan() compiled with g++ on a grid of (epi,
    rest, tma): {(epi, rest, tma): (stages, carry, bytes)}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    consts = "\n".join(m.group(0) for m in re.finditer(
        r"^constexpr int \w+ = [^;]+;", HEADER, flags=re.M))
    struct = re.search(r"struct Plan \{.*?\};", HEADER, re.S).group(0)
    start = HEADER.index("inline Plan plan(")
    depth, end = 0, None
    for i in range(HEADER.index("{", start), len(HEADER)):
        depth += {"{": 1, "}": -1}.get(HEADER[i], 0)
        if depth == 0:
            end = i + 1
            break
    fn = HEADER[start:end]
    src = tmp_path / "plan.cc"
    src.write_text(
        "#include <cstddef>\n#include <cstdio>\nnamespace regtile {\n"
        f"{consts}\n{struct}\n{fn}\n}}\n"
        "int main() {\n"
        "  const int epis[] = {65536, 67584, 69632, 100000};\n"
        "  for (int e : epis) for (int r = 0; r <= 240000; r += 997)\n"
        "    for (int t = 0; t < 2; ++t) {\n"
        "      regtile::Plan p = regtile::plan(e, (size_t)r, t != 0);\n"
        "      std::printf(\"%d %d %d %d %d %d\\n\", e, r, t, p.stages,"
        " p.carry, p.bytes);\n    }\n}\n")
    exe = tmp_path / "plan"
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout.split("\n")
    res = {}
    for line in out:
        if line.strip():
            e, r, t, s, c, b = map(int, line.split())
            res[(e, r, t)] = (s, c, b)
    return res


def test_mirror_plan_equals_the_header(tmp_path):
    got = _compiled_plan(tmp_path)
    assert len(got) > 1000
    for (e, r, t), (s, c, b) in got.items():
        p = ft.plan(e, r, bool(t))
        if s == 0:
            assert p["stages"] == 0
        else:
            assert (p["stages"], p["carry"], p["bytes"]) == (s, c, b)


@pytest.mark.parametrize("route", ft.ROUTES)
@pytest.mark.parametrize("tma", [True, False])
def test_every_route_fits_at_every_k(route, tma):
    """Every route (K1 narrow at 2 and 4 words, sym, wide, K1t, K2 over f32
    rows, and over ragged bf16 rows on the register-staged loader: one
    plan, the stage's bytes are the type's 128-byte rows)
    fits a block's 232,448 bytes at every k <= 128, with at least 2
    stages, at least 3 when the next tile loads during the epilogue."""
    for k in range(1, 129):
        p = ft.route_plan(route, k, tma)
        assert ft.MIN_STAGES <= p["stages"] <= ft.MAX_STAGES, (k, p)
        assert p["bytes"] <= ft.SMEM_LIMIT, (k, p)
        if p["carry"]:
            assert tma and p["stages"] >= ft.CARRY_MIN_STAGES
        if not tma:
            assert p["stages"] == ft.REG_STAGES and not p["carry"]


@pytest.mark.parametrize("route,k,want", [
    ("knn_sym", 25, (4, 1)),        # the build
    ("knn", 25, (4, 1)),            # K1 on a row range
    ("scan_topk", 15, (4, 1)),      # exact serving
    ("knn_t", 25, (3, 1)),          # K1t: two owners' lists of 25
    ("knn", 64, (4, 0)),
    ("knn", 128, (3, 0)),
    ("knn_sym", 128, (2, 0)),       # the tightest: 140,816 bytes of rest
    ("knn_wide", 200, (2, 0)),      # 128 KB of row buffers
    ("scan_topk_wide", 1024, (2, 0)),
])
def test_plan_at_the_main_path_shapes(route, k, want):
    p = ft.route_plan(route, k, True)
    assert (p["stages"], p["carry"]) == want, p


def _thread_xy(tid):
    return ((tid >> 5) & 1) * 8 + (tid & 7), (tid >> 6) * 4 + ((tid >> 3) & 3)


def _warp_addresses(warp, kq, itemsize, operand):
    """The byte address each lane of a warp reads for features kq .. kq + 3
    of its first row (i = j = 0) of A (rows ty) or B (rows tx)."""
    byte = kq * itemsize
    chunk, within = byte >> 4, byte & 15
    out = []
    for lane in range(32):
        tx, ty = _thread_xy(32 * warp + lane)
        row = ty if operand == "a" else tx
        out.append(row * ft.ROW_BYTES + ft.swizzle_chunk(row, chunk) * 16
                   + within)
    return out


@pytest.mark.parametrize("itemsize", [4, 2])
def test_swizzled_reads_are_conflict_free(itemsize):
    """The 8 tx rows a warp reads land on 8 distinct 16-byte chunks (no two
    distinct addresses on one bank), the 4 ty rows are broadcasts: 4
    distinct addresses, each read by 8 lanes.  At every kq of a slab, for
    every warp and every i, j (rows + 16 i keep their swizzle)."""
    width = 4 * itemsize                      # bytes a lane reads
    slab = ft.ROW_BYTES // itemsize
    for warp in range(ft.WARPS):
        for kq in range(0, slab, 4):
            for operand, rows in (("b", 8), ("a", 4)):
                addr = _warp_addresses(warp, kq, itemsize, operand)
                distinct = sorted(set(addr))
                assert len(distinct) == rows
                assert all(addr.count(a) == 32 // rows for a in distinct)
                chunks = {a // 16 % 8 for a in distinct}
                assert len(chunks) == rows
                banks = [(a // 4 + w) % 32 for a in distinct
                         for w in range(width // 4)]
                assert len(set(banks)) == len(banks)
                for shift in (16, 32, 112):   # rows + 16 i, + 16 j
                    moved = [a + shift * ft.ROW_BYTES for a in distinct]
                    assert {a // 16 % 8 for a in moved} == chunks


def test_register_loader_stores_are_conflict_free():
    """The register-staged loader's 16-byte stores: each quarter-warp (one
    row, chunks 0..7) covers 8 distinct bank groups."""
    for tid0 in range(0, ft.THREADS, 8):
        row = tid0 >> 3
        groups = {(row * ft.ROW_BYTES + ft.swizzle_chunk(row, c) * 16) // 16
                  % 8 for c in range(8)}
        assert groups == set(range(8))


@pytest.mark.parametrize("f", [1, 3, 4, 31, 32, 33, 384, 768, 1000])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_loader_from_f_and_alignment_alone(f, itemsize):
    """float32 rows TMA can read take the TMA ring; bf16 rows always the
    register-staged loader, since the bf16 rows TMA could read (F % 8 ==
    0) take K2's tensor-core route instead, whose plan fits at that F."""
    tma_ok = (f * itemsize) % 16 == 0
    want = "tma" if tma_ok and itemsize == 4 else "regs"
    assert ft.loader_name(f, itemsize, 0, 4096) == want
    assert ft.loader_name(f, itemsize, 8) == "regs"       # unaligned base
    assert ft.loader_name(f, itemsize, 16, 8) == "regs"
    if itemsize == 2 and tma_ok:
        assert tc_scan.plan(f, 15, 2, True)["bytes"] <= tc_scan.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loader_of_tensors(dtype):
    """The same shapes: float32 rows on TMA where aligned; bf16 rows on
    the register-staged loader, the aligned ones being the tensor-core
    route's (subtile_max.tensor_core_route)."""
    x = torch.zeros((64, 768), dtype=dtype)
    aligned = "tma" if dtype == torch.float32 else "regs"
    assert ft.loader_of(x) == aligned
    assert ft.loader_of(x, x[3:]) == aligned        # rows of 16-byte multiples
    assert tensor_core_route(x, x[3:]) is (dtype == torch.bfloat16)
    odd = torch.zeros((64, 33), dtype=dtype)
    assert ft.loader_of(odd) == "regs"
    assert not tensor_core_route(odd, odd)
    view = torch.zeros(64 * 8 + 1, dtype=dtype)[1:].view(64, 8)
    assert ft.loader_of(view) == "regs"             # an unaligned base
    assert not tensor_core_route(view, view)
    assert np.all([ft.loader_name(8, 4, 32 * i) == "tma" for i in range(4)])
