"""K2 over bfloat16 rows (ops/cuda/scan_topk.py) on the CPU: its routes,
its tensor-core plan, a model of its tensor-core merge, and its plain
version against the JAX package's Pallas kernel over the same bf16 rows.

On the card K2 takes its tensor-core route (csrc/tc_scan.cuh, K7's block
with scan_topk.cu's BlendTc) exactly where the predicate K3 and K5 take
holds (ops/cuda/subtile_max.py::tensor_core_route: both bf16, F % 8 == 0,
16-byte-aligned bases), else its SIMT route.  The route's plan (resident or
streamed queries, narrow or wide lists, the ring's depth, the turns) comes
from F and k alone; ops/cuda/tc_scan.py mirrors csrc/tc_scan.cuh's
tc_plan, which is compiled here with g++ beside the mirror.  Tolerances:
none on the route, the plans and the merge model (exact); the plain
version against the Pallas kernel in interpret mode, which sums the same
exact bf16 products in float32 in another order: ids equal, scores within
1e-6."""

import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyarrowspace_tpu.ops.pallas.scan_topk import lambda_search_pallas
from pyarrowspace_tpu_torch.ops.cuda import scan_int8, scan_topk, tc_scan
from pyarrowspace_tpu_torch.ops.cuda.subtile_max import tensor_core_route

CSRC = Path(scan_topk.__file__).resolve().parents[2] / "csrc"
TAU = 0.62
FS = [8, 64, 384, 392, 768, 1024]
KS = [1, 15, 64, 82, 128, 129, 200, 1024]


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(scan_topk, "sm_count", lambda index: 132)


# -- the route predicate ----------------------------------------------------------

def test_k2_routes_with_k3s_own_predicate():
    assert scan_topk.tensor_core_route is tensor_core_route


@pytest.mark.parametrize("xdt,f,want", [
    (torch.bfloat16, 8, True), (torch.bfloat16, 384, True),
    (torch.bfloat16, 392, True), (torch.bfloat16, 768, True),
    (torch.bfloat16, 1024, True), (torch.bfloat16, 100, False),
    (torch.bfloat16, 385, False), (torch.bfloat16, 33, False),
    (torch.float32, 384, False), (torch.float32, 64, False)])
def test_route_by_dtype_and_width(sms, xdt, f, want):
    """The queries rounded to the corpus's type, as lambda_search rounds
    them; float32 rows never take the tensor cores."""
    xu = torch.zeros((300, f), dtype=xdt)
    qs = torch.zeros((5, f)).to(xdt)
    assert tensor_core_route(xu, qs) is want
    route = scan_topk.route_of(xu, qs, 15)
    assert route.startswith("tc/") is want, route
    if not want:
        assert route.endswith(("/tma", "/regs")), route


@pytest.mark.parametrize("shift_x,shift_q", [(1, 0), (0, 1), (4, 0), (8, 8),
                                             (0, 16)])
def test_route_needs_16_byte_aligned_bases(sms, shift_x, shift_q):
    """A base 2 bytes off (one bf16) takes the SIMT route, on the
    register-staged loader (bf16 rows have no TMA ring there); 16 bytes off
    (8 values) stays on the tensor cores."""
    f = 64
    bx = torch.zeros(shift_x + 300 * f, dtype=torch.bfloat16)
    bq = torch.zeros(shift_q + 3 * f, dtype=torch.bfloat16)
    xu = bx[shift_x:].view(300, f)
    qs = bq[shift_q:].view(3, f)
    aligned = xu.data_ptr() % 16 == 0 and qs.data_ptr() % 16 == 0
    assert aligned is (shift_x % 8 == 0 and shift_q % 8 == 0)
    route = scan_topk.route_of(xu, qs, 15)
    assert route.startswith("tc/") is aligned
    if not aligned:
        assert route.endswith("/regs"), route


@pytest.mark.parametrize("n,q,k,want", [
    (313_841, 4096, 15, "tc/narrow/S4"), (313_841, 4096, 200, "tc/wide/S4"),
    (313_841, 1024, 1024, "tc/wide/S15"),
    (1_000_000, 16_384, 15, "tc/narrow/S1")])
def test_route_names_at_the_main_path_shapes(sms, n, q, k, want):
    """The tensor-core route's lists and splits (the wave rule of K7's
    tensor-core route: one block an SM); at F 768 the queries stream."""
    f = 768 if n == 1_000_000 else 384
    name = scan_topk.tc_route_name(n, q, k, f, torch.device("cpu"))
    assert name == want + ("/stream" if f == 768 else "")


# -- the plan ---------------------------------------------------------------------

def _block(text: str, start: str) -> str:
    """The brace-balanced definition that begins at ``start``."""
    i = text.index(start)
    depth, j = 0, text.index("{", i)
    while True:
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        j += 1
        if depth == 0:
            return text[i:j] + (";" if text[j:j + 1] == ";" else "")


def _constants(text: str, names) -> str:
    return "\n".join(re.search(rf"^constexpr (?:int|size_t) {n} = [^;]+;",
                               text, re.M).group(0) for n in names)


def test_mirror_constants_equal_the_header():
    hdr = (CSRC / "tc_scan.cuh").read_text()
    wg = (CSRC / "wgmma_tile.cuh").read_text()
    assert "constexpr int M = 64;" in wg
    assert "constexpr int ROW_BYTES = 128;" in wg
    assert "constexpr int THREADS = 128;" in wg
    assert f"constexpr int NB = {tc_scan.NB};" in hdr
    assert f"constexpr int BUF = {tc_scan.BUF};" in hdr
    assert f"constexpr int MAX_STAGES = {tc_scan.MAX_STAGES};" in hdr
    assert f"constexpr size_t SMEM_LIMIT = {tc_scan.SMEM_LIMIT};" in hdr
    wide = (CSRC / "knn_wide.cuh").read_text()
    assert f"constexpr int SROW = {tc_scan.SROW};" in wide
    row = re.search(r"struct WideRow \{(.*?)\};", wide, re.S).group(1)
    assert len(re.findall(r"^\s*(?:int|float) \w+;", row, re.M)) == 3
    assert tc_scan.WIDE_ROW_BYTES == 12
    assert tc_scan.NARROW_MAX == 256
    assert "MAX_NARROW = 256;" in (CSRC / "tile_common.cuh").read_text()


def _compiled_plans(tmp_path, grid):
    """tcscan::tc_plan compiled with g++ from the headers' own text:
    {(f, k, itemsize, may_stream): (wide, stream, stages, turns, bytes)}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    hdr = (CSRC / "tc_scan.cuh").read_text()
    tile = (CSRC / "tile_common.cuh").read_text()
    wide = (CSRC / "knn_wide.cuh").read_text()
    body = "\n".join([
        _constants(hdr, ["QB", "NB", "CONSUMERS", "THREADS", "WARPS",
                         "A_STAGE_BYTES", "B_STAGE_BYTES", "BUF",
                         "MAX_STAGES", "SMEM_LIMIT"]),
        _block(hdr, "__host__ __device__ constexpr int slot_bytes("),
        _block(hdr, "struct TcLayout {"),
        _block(hdr, "inline TcLayout tc_layout("),
        _block(hdr, "inline size_t list_bytes("),
        _block(hdr, "struct TcPlan {"),
        _block(hdr, "inline TcPlan tc_plan(")])
    cases = "\n".join(f"  show({f}, {k}, {s}, {int(m)});"
                      for f, k, s, m in grid)
    src = tmp_path / "plan.cc"
    src.write_text(
        "#include <cstddef>\n#include <cstdint>\n#include <cstdio>\n"
        "#define __host__\n#define __device__\n"
        "namespace wg { constexpr int M = 64; constexpr int ROW_BYTES = 128;"
        " constexpr int THREADS = 128; }\n"
        "namespace tile {\n"
        + _constants(tile, ["MAX_NARROW"]) + "\n"
        + _block(tile, "inline int list_words(") + "\n}\n"
        "namespace knn_wide {\n" + _constants(wide, ["SROW"]) + "\n"
        + _block(wide, "struct WideRow {") + "\n}\n"
        "namespace tcscan {\nusing knn_wide::SROW;\n"
        "using knn_wide::WideRow;\n" + body + "\n}\n"
        "void show(int f, int k, int size, int m) {\n"
        "  const int nk = (f * size + 127) / 128;\n"
        "  const tcscan::TcPlan p = tcscan::tc_plan(nk, k, m != 0);\n"
        "  std::printf(\"%d %d %d %d %d %d %d %d %zu\\n\", f, k, size, m,"
        " (int)p.wide, (int)p.stream, p.lay.stages, (int)p.lay.turns,"
        " p.lay.total);\n}\n"
        "int main() {\n" + cases + "\n}\n")
    exe = tmp_path / "plan"
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    out = {}
    for line in subprocess.run([str(exe)], check=True, capture_output=True,
                               text=True).stdout.splitlines():
        f, k, s, m, w, st, stages, turns, total = map(int, line.split())
        out[(f, k, s, bool(m))] = {"wide": bool(w), "stream": bool(st),
                                   "stages": stages, "turns": bool(turns),
                                   "bytes": total}
    return out


def test_mirror_plan_equals_the_header(tmp_path):
    """Every plan of K2's route (bf16, queries may stream) and K7's (int8,
    resident) on a grid of F and k, compiled from tc_scan.cuh, equals
    tc_scan.plan."""
    grid = ([(f, k, 2, True) for f in range(8, 1100, 8)
             for k in (1, 15, 64, 65, 82, 83, 128, 129, 130, 131, 200, 256,
                       257, 1024)]
            + [(f, k, 1, False) for f in range(16, 1040, 16)
               for k in range(1, 300, 3)])
    got = _compiled_plans(tmp_path, grid)
    assert len(got) == len(grid)
    for (f, k, s, m), plan in got.items():
        assert tc_scan.plan(f, k, s, m) == plan, (f, k, s, m)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("f", FS)
def test_every_plan_fits(f, k):
    """K2's tensor-core plan at the F and k of the GPU tests fits a block's
    232,448 bytes with at least 2 stages; the queries stream exactly past
    640 features, the warpgroups take turns exactly when the ring holds a
    tile, and lists past 256 are wide."""
    p = tc_scan.plan(f, k, 2, True)
    assert p["bytes"] <= tc_scan.SMEM_LIMIT
    assert 2 <= p["stages"] <= tc_scan.MAX_STAGES
    assert p["stream"] is (f > 640)
    assert p["turns"] is (p["stages"] >= tc_scan.stages_of(f, 2))
    if k > 256:
        assert p["wide"]


@pytest.mark.parametrize("f,k,want", [
    (384, 15, (False, False, 6, True)),     # phase 11: resident, turns
    (384, 82, (False, False, 2, False)),    # the widest narrow list at 384
    (384, 83, (False, True, 6, True)),
    (384, 200, (False, True, 6, True)),
    (384, 1024, (False, True, 6, True)),
    (768, 15, (True, False, 6, False)),     # 1M x 768: streamed, in step
    (768, 200, (True, True, 6, False)),
    (8, 256, (False, True, 6, True))])
def test_plan_at_the_main_path_shapes(f, k, want):
    p = tc_scan.plan(f, k, 2, True)
    assert (p["stream"], p["wide"], p["stages"], p["turns"]) == want, p


def _k7_wide_before(k, f):
    """K7's rule as its wrapper stated it before the shared header: 128
    narrow lists beside the resident queries, two 16 KB stages and the
    warps' 16 KB of buffers."""
    nk = -(-f // 128)
    return k > 256 or (nk + 3) * 16_384 + 128 * k * 8 + 5 * 8 > 232_448


def test_k7_plans_stay_what_they_were():
    for f in range(16, 1040, 16):
        for k in range(1, 300):
            assert scan_int8.wide_lists(k, f, True) is _k7_wide_before(k, f)
            p = tc_scan.plan(f, k, 1, False)
            assert not p["stream"] and p["bytes"] <= tc_scan.SMEM_LIMIT


# -- a model of the tensor-core merge ----------------------------------------------

def _scores(xu, lam, qn, lam_q, tau):
    """The plain version's scores, the float32 blend of the bf16 products,
    with a score that enters no list (NaN, at or below -3e38) kept as
    it is."""
    cos = qn.to(torch.bfloat16).float() @ xu.float().T
    tau_t = torch.tensor(tau, dtype=torch.float32)
    prox = 1.0 / (1.0 + torch.abs(lam[None, :] - lam_q[:, None]))
    return (tau_t * cos + (1.0 - tau_t) * prox).numpy()


def _tc_model(score, k, splits, reverse=False):
    """The tensor-core kernel's narrow lists in numpy: per split, per
    128-item tile, a score is offered only if it reaches the query's kth as
    it stood before the tile (so never a NaN, and -3e38 only to be
    refused), in the kernel's order for a row (8 j + 2 c + h: j, then h,
    then the four lanes c; reversed when asked), under (score desc, id
    asc); the splits' lists then merged in split order by the Max rule
    (an entry goes after every entry better or equal)."""
    q, n = score.shape
    n_tiles = -(-n // 128)
    per = -(-n_tiles // splits)
    order = np.array([8 * j + 2 * c + h for j in range(16) for h in range(2)
                      for c in range(4)])
    if reverse:
        order = order[::-1]
    empty = (np.float32(-3.0e38), -1)
    out_i = np.full((q, k), -1, np.int32)
    out_s = np.full((q, k), np.float32(-3.0e38), np.float32)
    for r in range(q):
        parts = []
        for sp in range(splits):
            vals = [empty] * k
            for t in range(sp * per, min(n_tiles, (sp + 1) * per)):
                kth = vals[-1][0]
                for c in order + 128 * t:
                    if c >= n or not score[r, c] >= kth:
                        continue
                    v, w = score[r, c], vals[-1]
                    if v > w[0] or (v == w[0] and c < w[1]):
                        vals = sorted(vals[:-1] + [(v, int(c))],
                                      key=lambda e: (-e[0], e[1]))
            parts.append(vals)
        run = [empty] * k
        for part in parts:
            for v, i in part:
                if not v > run[-1][0]:
                    break
                pos = sum(1 for e in run if not v > e[0])
                run = run[:pos] + [(v, i)] + run[pos:-1]
        out_i[r] = [e[1] for e in run]
        out_s[r] = [e[0] for e in run]
    return out_i, out_s


def _case(seed, n, q, f):
    rng = np.random.default_rng(seed)
    xu = rng.standard_normal((n, f)).astype(np.float32)
    xu /= np.linalg.norm(xu, axis=1, keepdims=True)
    qn = rng.standard_normal((q, f)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    return (torch.from_numpy(xu).bfloat16(),
            torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)),
            torch.from_numpy(qn),
            torch.from_numpy(rng.uniform(0, 1, q).astype(np.float32)))


def _held(xu, lam, qn, lam_q, tau, k, splits, reverse=False):
    i_m, s_m = _tc_model(_scores(xu, lam, qn, lam_q, tau), k, splits,
                         reverse)
    i_p, s_p = scan_topk.scan_plain(xu, lam, qn, lam_q, tau, k)
    np.testing.assert_array_equal(i_m, i_p.numpy())
    np.testing.assert_array_equal(s_m.view(np.int32),
                                  s_p.numpy().view(np.int32))
    return i_p, s_p


@pytest.mark.parametrize("n,k,splits,reverse", [
    (700, 15, 1, False), (700, 60, 3, False), (1000, 7, 8, True),
    (300, 82, 2, True)])
def test_tc_merge_model_equals_plain(n, k, splits, reverse):
    xu, lam, qn, lam_q = _case(n + k, n, 5, 40)
    _held(xu, lam, qn, lam_q, TAU, k, splits, reverse)


def test_tc_merge_model_ties():
    """Duplicated bf16 rows with equal lambdas tie exactly at the kth slot:
    the smallest ids win, whatever order the tile offers them in and
    whichever split holds them."""
    xu, _, qn, _ = _case(3, 40, 4, 32)
    xu = xu.repeat(20, 1)
    lam, lam_q = torch.full((800,), 0.25), torch.full((4,), 0.25)
    for splits, reverse in ((1, False), (3, True), (7, False)):
        i_p, _ = _held(xu, lam, qn, lam_q, TAU, 30, splits, reverse)
        assert (i_p >= 0).all()


def test_tc_merge_model_nan_lambdas():
    """+inf lambdas on items and on query 1: NaN scores (inf - inf) enter
    no list; query 1's other items score tau * cos."""
    xu, lam, qn, lam_q = _case(9, 261, 4, 48)
    lam[[0, 5, 130, 260]] = float("inf")
    lam_q[1] = float("inf")
    i_p, s_p = _held(xu, lam, qn, lam_q, TAU, 100, 2)
    assert not torch.isnan(s_p).any()
    assert not set(i_p[1].tolist()) & {0, 5, 130, 260}


def test_tc_merge_model_scores_at_the_floor():
    """tau 3.3e38: tau * cos and (1 - tau) * prox run to +-3e38 and past
    (to +-inf); every score at or below -3e38 stays out, and a list short
    of k such scores ends in (-3e38, -1)."""
    xu, lam, qn, lam_q = _case(4, 300, 3, 16)
    score = _scores(xu, lam, qn, lam_q, 3.3e38)
    low = ~(score > np.float32(-3.0e38))
    assert low.any() and (~low).any()
    k = int((~low).sum(axis=1).max()) + 5
    i_p, s_p = _held(xu, lam, qn, lam_q, 3.3e38, k, 2)
    assert (i_p[:, -5:] == -1).all()
    assert (s_p[:, -5:] == np.float32(-3.0e38)).all()


# -- the plain version against the TPU kernel over bf16 rows ---------------------

@pytest.mark.parametrize("n,q,f,topk", [(300, 7, 24, 10), (1000, 33, 64, 15),
                                        (700, 20, 72, 200), (130, 5, 16, 64)])
def test_plain_matches_pallas_interpret_bf16(n, q, f, topk):
    """The same bf16 rows into lambda_search_pallas (interpret mode: bf16
    x bf16 products, float32 sums, as on the MXU) and into the port on the
    CPU (scan_plain: the queries rounded to bf16, the products summed in a
    float32 matmul).  Both sum the same exact products in float32 in
    another order: ids equal, scores within 1e-6."""
    rng = np.random.default_rng(n + f)
    xu = rng.normal(size=(n, f)).astype(np.float32)
    xu /= np.linalg.norm(xu, axis=1, keepdims=True)
    qn = rng.normal(size=(q, f)).astype(np.float32) + 0.4
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    lam = rng.uniform(0, 1, n).astype(np.float32)
    lam_q = rng.uniform(0.1, 0.3, q).astype(np.float32)
    xb = torch.from_numpy(xu).bfloat16()
    i_ref, s_ref = lambda_search_pallas(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(lam), jnp.asarray(qn), jnp.asarray(lam_q), TAU, topk,
        col_tile=128, interpret=True)
    i, s = scan_topk.lambda_search(xb, torch.from_numpy(lam),
                                   torch.from_numpy(qn),
                                   torch.from_numpy(lam_q), TAU, topk)
    assert s.dtype == torch.float32 and i.shape == (q, min(topk, n))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref, np.float32),
                               rtol=0, atol=1e-6)
