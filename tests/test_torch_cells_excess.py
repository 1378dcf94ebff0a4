"""Phase 16's 4×4 cells that pin the sharded cells' excess over ``repro``
(``chip_smoke.py``'s ``TRAIN44_CELLS`` and ``DECODE44_CELLS``): the
reduced mistral-large-123b train step at 4 rows in 2 microbatches (2 rows,
which do not divide the 4-way "data" axis: each row's sequence folded into
4 rows), the reduced seamless-m4t-medium train step at a vocabulary of
16,386 (which does not divide the 4-way "model" axis: the head and the
cross entropy on each rank's own block of it), the reduced qwen2.5-32b
train step at 10 query and 2 KV heads (10 over the 4-way "model" axis,
production's 40 over 16: each rank its own block of heads), and the
reduced rwkv6-1.6b, zamba2-1.2b and seamless-m4t-medium decode steps (the
recurrent states and the attention over a cache split on its sequence).
``repro``'s side is compiled on 16 placeholder devices on
``make_host_mesh((4, 4))`` (``tests/_subproc.py``), the port's runs
``CELL44_PRICING`` on a fake 16-rank group on the CPU, whose DTensor
replaces all-to-all by all-gather + chunk (collective bytes run high
here).  Each port figure is held to ``TRAIN44_TEMP_RATIO`` /
``TRAIN44_COLL_RATIO`` (1.5×; a decode cell's own ``coll_ratio``) of
``repro``'s and each of ``repro``'s figures to the smoke's constant, since
the card's machine has no JAX.
"""
import json
import os
import sys

import pytest

from tests._subproc import SRC, run_with_devices
from tests.test_torch_cells import REPRO_TRAIN44, last_json, run_port

sys.path.insert(0, os.path.dirname(SRC))
import chip_smoke  # noqa: E402

TRAIN = ("mistral-large-123b", "seamless-m4t-medium", "qwen2.5-32b")
DECODE = ("rwkv6-1.6b", "zamba2-1.2b", "seamless-m4t-medium")


def _both(job: dict):
    c = json.dumps(job)
    ref = last_json(run_with_devices(
        f"import sys; sys.argv[1:] = [{c!r}]\n" + REPRO_TRAIN44,
        n_devices=16))
    got = last_json(run_port(
        f"import sys; sys.argv[1:] = [{c!r}, 'cpu']\n"
        + chip_smoke.CELL44_PRICING))
    return ref, got


@pytest.fixture(scope="module", params=TRAIN)
def train44(request):
    arch = request.param
    return (arch, chip_smoke.TRAIN44_CELLS[arch],
            *_both(chip_smoke.cell44_jobs()[f"train44:{arch}"]))


@pytest.fixture(scope="module", params=DECODE)
def decode44(request):
    arch = request.param
    return (arch, chip_smoke.DECODE44_CELLS[arch],
            *_both(chip_smoke.cell44_jobs()[f"decode44:{arch}"]))


def test_new_train_cell_4x4_temp_within_1_5x_of_repros(train44):
    """The train step's temp bytes a device at most 1.5× ``repro``'s, its
    arguments equal.  At the parent (this CPU's torch 2.13): mistral
    2,194,052 against ``repro``'s 2,072,200 (1.06×: the layers' inputs the
    remat held whole are not live at this CPU's peak, nor at the reduced
    cell's 2 layers; the card's torch 2.11 read 88.5 GiB for the full cell,
    PR 24's final sweep, which is the check that failed before the
    repair; ``tests/test_torch_excess_values.py`` holds the layout on gloo
    ranks), seamless 105,234,876 against 100,232,736 (1.05×; the full
    cell read 299.4 GiB on the card; ``tests/test_torch_excess_values.py``
    holds the cross entropy to one float32 row chunk, which the parent
    fails)."""
    arch, c, ref, got = train44
    print(arch, "port", got["temp_size_in_bytes"], "repro",
          ref["temp_size_in_bytes"])
    assert got["argument_size_in_bytes"] == ref["argument_size_in_bytes"]
    assert got["temp_size_in_bytes"] <= \
        chip_smoke.TRAIN44_TEMP_RATIO * ref["temp_size_in_bytes"]


def test_new_train_cell_4x4_collectives_and_dots_near_repros(train44):
    """Collective bytes at most 1.5× ``repro``'s and dot FLOPs at most
    1.1× (the cell's ``dot_ratio``): the work XLA splits across a
    replicated operand is split here too (ROADMAP C21).  The parent ran
    mistral's replicated rows whole on every "data" rank, seamless's
    whole-vocabulary head on every "model" rank and qwen2.5-32b's 10 heads
    on every "model" rank (on this CPU: mistral 3.45×, seamless 1.54×;
    this tree 0.86×, 0.72×, 0.56×)."""
    arch, c, ref, got = train44
    print(arch, "port", got["collective_bytes"], got["dot_flops"], "repro",
          ref["collective_bytes"], ref["dot_flops"])
    assert got["collective_bytes"] <= \
        chip_smoke.TRAIN44_COLL_RATIO * ref["collective_bytes"]
    assert got["dot_flops"] <= c["dot_ratio"] * ref["dot_flops"]
    assert c["dot_ratio"] == 1.1


def test_new_train_cell_4x4_whole_vocabulary_only_where_repro_has_it(
        train44):
    """mistral's and qwen2.5-32b's cells make no op of the whole
    vocabulary; seamless's vocabulary does not divide "model", so its
    weights hold it whole (as ``repro``'s rules lay them out: the
    optimizer, the FSDP gathers, the lookup's gradient), but no activation
    does: every op of the vocabulary's width is shaped as a weight (the
    parent's logits, cross entropy and head gradient held it whole)."""
    arch, c, _, got = train44
    assert bool(c.get("whole_vocab")) == (arch == "seamless-m4t-medium")
    assert bool(got["whole_vocab_ops"]) == bool(c.get("whole_vocab"))
    assert got["vocab_act_ops"] == []


def test_new_train_cell_4x4_repro_is_the_smokes_constant(train44):
    """``repro``'s compiled temp bytes, collective bytes and dot FLOPs are
    the constants phase 16 holds the card's run to."""
    _, c, ref, _ = train44
    assert ref["temp_size_in_bytes"] == c["repro_temp"]
    assert ref["collective_bytes"] == c["repro_coll"]
    assert ref["dot_flops"] == c["repro_dot"]


def test_new_decode_cell_4x4_collectives_within_1_5x_of_repros(decode44):
    """The decode step's collective bytes a device at most 1.5× ``repro``'s
    (rwkv6 and zamba2: 1.1×, their ``coll_ratio``) and no op of the whole
    vocabulary.  With each layer's state gathered, rwkv6 read 1,879,104
    against 570,128 on this CPU (3.30×: the (B, H, hd, hd) state), zamba2
    1,762,048 against 529,424 (3.33×: the Mamba state and the shared
    attention's scores), seamless 739,392 against 462,352 (1.60×: the
    self- and cross-attention's scores); with the states on shards but
    the tensor-parallel weights' FSDP shards gathered for the token's few
    rows, rwkv6 1.42×, zamba2 1.34× (ROADMAP C24)."""
    arch, c, ref, got = decode44
    print(arch, "port", got["collective_bytes"], got["collectives"],
          "repro", ref["collective_bytes"])
    assert got["whole_vocab_ops"] == []
    assert c.get("coll_ratio") == (
        1.1 if arch in ("rwkv6-1.6b", "zamba2-1.2b") else None)
    assert got["collective_bytes"] <= c.get(
        "coll_ratio", chip_smoke.TRAIN44_COLL_RATIO) * ref["collective_bytes"]


def test_new_decode_cell_4x4_repro_is_the_smokes_constant(decode44):
    """``repro``'s compiled collective bytes are phase 16's constant."""
    _, c, ref, _ = decode44
    assert ref["collective_bytes"] == c["repro_coll"]
