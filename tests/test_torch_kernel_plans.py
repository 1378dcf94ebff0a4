"""The launch plans of K3 ``twotower_score``, K4 ``topk_min`` and K5
``l2dist``, and the build key of the CUDA sources, on the CPU.

Each wrapper module's ``plan`` mirrors the ``make_plan`` of its CUDA source
(``csrc/twotower_score.cu``, ``csrc/topk.cu``, ``csrc/l2dist.cu``): which
path a call takes from the shapes and the alignment, the query tile and
grid of K3 from B and the SM count, K4's block size and shared memory from
C and k, K5's 1-D grid.  On the card ``tests/test_torch_kernels_cuda.py``
holds each plan against the one the built source computes.  Nothing here
needs a card or ``nvcc``.
"""
import importlib
import shutil

import pytest

from repro_torch.kernels import _build

TT = importlib.import_module("repro_torch.kernels.twotower_score")
TK = importlib.import_module("repro_torch.kernels.topk")
L2 = importlib.import_module("repro_torch.kernels.l2dist")

SMEM_PER_BLOCK = 232448  # 227 KB a block may opt into


@pytest.mark.parametrize("B,H,d,n_sm,tb,grid,gp_log,ri,threads", [
    # the search: 313 tiles of 32 rows, in whole clusters of 4 blocks
    (10000, 64, 128, 132, 32, 316, 4, 4, 128),
    # a serve request: 64 tiles of 16
    (1024, 64, 128, 132, 16, 64, 4, 2, 128),
    (1, 64, 128, 132, 16, 4, 4, 2, 128),
    # 128 hubs: 8 warps side by side over the 32 hub groups
    (1024, 128, 128, 132, 16, 64, 5, 2, 256),
    (100000, 128, 128, 132, 64, 132, 5, 8, 256),
    (100000, 64, 128, 132, 64, 264, 4, 8, 128),
    (10000, 64, 128, 16, 64, 32, 4, 8, 128),
    (40, 8, 4, 132, 16, 4, 1, 1, 128),
    (12, 12, 36, 132, 16, 4, 2, 1, 128),
])
def test_twotower_resident_plan(B, H, d, n_sm, tb, grid, gp_log, ri, threads):
    p = TT.plan(B, H, d, n_sm=n_sm)
    assert p["path"] == "resident"
    assert (p["tb"], p["grid"], p["gp_log"], p["ri"], p["threads"]) == (
        tb, grid, gp_log, ri, threads)
    # a 1,056-byte head (3 mbarriers, 128 hub scales, 2 x 64 query-row
    # scales), then the hubs (4 slots a group of 4 hubs, 2^gp_log groups)
    # and two stages of tb query rows, all at a stride of 4 (mod 8) floats
    stride = d + 4 if d % 8 == 0 else d
    assert p["smem"] == 1056 + (4 * 2 ** gp_log + 2 * tb) * stride * 4
    assert stride % 8 == 4 and p["smem"] <= SMEM_PER_BLOCK
    # whole clusters of 4, at most one short of a tile for every block
    assert p["grid"] % 4 == 0 and p["grid"] - 4 < -(-B // tb) or B > tb * p["grid"]


@pytest.mark.parametrize("B,H,d,aligned", [
    (1024, 129, 128, True), (1024, 512, 128, True), (1024, 130, 128, True),
    (1024, 64, 7, True), (1024, 64, 33, True), (1024, 64, 512, True),
    (1024, 64, 132, True), (1024, 64, 128, False), (5, 3, 7, True),
])
def test_twotower_other_shapes_take_the_tiled_path(B, H, d, aligned):
    p = TT.plan(B, H, d, aligned=aligned)
    assert p["path"] == "tiled" and p["smem"] == 0
    assert p["grid"] == -(-B // 64) * -(-H // 64)


def test_twotower_tile_halves_until_two_tiles_a_sm():
    tbs = [TT.plan(B, 64, 128)["tb"] for B in (1, 1024, 8416, 8417, 16832, 16833)]
    assert tbs == [16, 16, 16, 32, 32, 64]
    # the largest resident footprint still fits a block
    assert TT.plan(10 ** 6, 128, 128)["smem"] <= SMEM_PER_BLOCK


@pytest.mark.parametrize("Q,C,d,bf16,aligned,path", [
    (1024, 8192, 128, False, True, "sgemm"),
    (1024, 65536, 128, False, True, "sgemm"),
    (1024, 8192, 128, True, True, "sgemm"),
    (5, 3, 12, False, True, "sgemm"),
    (5, 3, 12, True, True, "tiled"),
    (130, 129, 127, False, True, "tiled"),
    (64, 200, 960, True, True, "sgemm"),
    (1024, 8192, 128, False, False, "tiled"),
])
def test_l2dist_plan(Q, C, d, bf16, aligned, path):
    p = L2.plan(Q, C, d, bf16=bf16, aligned=aligned)
    assert p["path"] == path
    t = 128 if path == "sgemm" else 64
    assert (p["tile_q"], p["tile_c"]) == (t, t)
    assert p["grid"] == -(-Q // t) * -(-C // t)
    # three stages of two 128-row chunks of 32 (rows of 36 floats or 40
    # bf16) and the 256 norms
    want = 3 * 2 * 128 * (80 if bf16 else 144) + 1024 if path == "sgemm" else 0
    assert p["smem"] == want <= SMEM_PER_BLOCK


def test_l2dist_has_no_column_tile_limit():
    """The first design's grid took C / 64 column tiles in grid.y, so it
    refused C > 65,535 * 64 = 4,194,240; the 1-D grid takes any C up to
    2^31 - 1 tiles in all."""
    assert L2.plan(1024, 4_194_241, 128)["grid"] == 8 * 32_768
    assert L2.plan(1, 2**31 - 1, 128)["grid"] == 16_777_216
    assert L2.plan(1, 2**31 - 1, 127)["grid"] == 33_554_432
    assert L2.plan(2**31 - 1, 2**31 - 1, 128)["grid"] == -1


@pytest.mark.parametrize("B,C,k,path,threads,smem", [
    # the kernel API path: 1,024 rows of 65,536 at k = 10, 256 of 1024 at 32
    (1024, 65536, 10, "select", 128, 9216),
    (256, 1024, 32, "select", 128, 9216),
    # the select path's cap, and the pass path beyond it (rows of up to
    # 10,240 keys staged in 40 KB of shared memory, wider rows not)
    (256, 1024, 33, "passes", 256, 4096),
    (64, 10240, 33, "passes", 256, 40960),
    (64, 10241, 33, "passes", 256, 0),
    (2, 65536, 64, "passes", 256, 0),
    # narrow rows take fewer threads: at most four elements a thread
    (64, 130, 10, "select", 64, 4608),
    (64, 128, 32, "select", 32, 2304),
    (64, 129, 32, "select", 64, 4608),
    (33, 9, 9, "select", 32, 2304),
    (100, 1, 1, "select", 32, 2304),
    (5, 513, 1, "select", 128, 9216),
    (1, 1_000_000, 32, "select", 128, 9216),
    (7, 40, 40, "passes", 256, 160),
])
def test_topk_plan(B, C, k, path, threads, smem):
    assert TK.plan(B, C, k) == {"path": path, "threads": threads,
                                "smem": smem, "grid": B}
    if path == "select":  # a list slot a thread, 256 buffered keys a warp
        assert smem == 8 * threads + 8 * 256 * threads // 32


def test_topk_select_block_grows_with_the_row_up_to_128():
    got = [TK.plan(8, C, 10)["threads"]
           for C in (1, 128, 129, 256, 257, 512, 513, 1024, 1025, 10**6)]
    assert got == [32, 32, 64, 64, 128, 128, 128, 128, 128, 128]
    for k in range(1, 34):
        assert TK.plan(8, 1024, k)["path"] == ("select" if k <= 32 else "passes")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


def test_build_key_covers_the_included_header(csrc_copy):
    """A source's library is keyed by the source and every header it
    includes: a changed ``async_copy.cuh`` rebuilds the three sources that
    include it, and not ``topk.cu``."""
    names = ("gather_dist", "l2dist", "twotower_score", "topk")
    before = {n: _build._target(n) for n in names}
    hdr = csrc_copy / "async_copy.cuh"
    hdr.write_text(hdr.read_text() + "\n// changed\n")
    after = {n: _build._target(n) for n in names}
    for n in ("gather_dist", "l2dist", "twotower_score"):
        assert b'#include "async_copy.cuh"' in (csrc_copy / f"{n}.cu").read_bytes()
        assert after[n] != before[n], n
    assert after["topk"] == before["topk"]


def test_source_bytes_follows_includes_once(tmp_path):
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n// a\n')
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n// b\n')
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n'
                                   '  #  include "b.cuh"\n')
    got = _build.source_bytes(tmp_path / "k.cu")
    assert got.count(b"// a") == 1 and got.count(b"// b") == 1
    assert got.startswith((tmp_path / "k.cu").read_bytes())
