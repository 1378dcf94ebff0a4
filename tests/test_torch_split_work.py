"""The work a mesh axis does not divide is split over its ranks, and the
values stay the single-device port's (``repro_torch.models.common``:
``fold_rows``, ``column_split`` / ``row_split``): on 4 gloo ranks, in
float64, the reduced models' loss and every parameter's gradient equal one
process's within 1e-12, and no rank's matrix product runs the whole of
what the axis was to split.

* rows: the reduced mistral-large-123b at 3 rows of 8 positions on a
  (2, 2) mesh (3 rows do not divide "data"): each row's sequence folded
  into 2 rows, every product on a rank's own 4 positions of every row
  (the parent ran all 24 tokens on both "data" ranks); a dropping MoE
  is not folded (its dispatch groups are the rows);
* vocabulary: the reduced llama3-8b and seamless-m4t-medium at a
  vocabulary of 37 on (2, 2) ("model" does not divide it): the head's
  products on a rank's own 19 or 18 columns (the parent: all 37);
* heads: the reduced qwen2.5-32b at 10 query and 2 KV heads on a (1, 4)
  mesh (blocks of 3, 3, 3 and 1 heads, two of them across a KV group) and
  at 3 query heads and 1 KV head (blocks of 1, 1, 1 and none), and the
  three splits at once on (2, 2).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.distributed.sharding import ShardingCtx
from tests._torch_ranks import run_ranks, split_work_rank

CASES = {
    "rows": ("mistral-large-123b", {}, 3, 8, (2, 2)),
    "vocab": ("llama3-8b", {"vocab_size": 37}, 4, 8, (2, 2)),
    "vocab_encdec": ("seamless-m4t-medium", {"vocab_size": 37}, 4, 8,
                     (2, 2)),
    "heads": ("qwen2.5-32b", {"num_heads": 10, "num_kv_heads": 2}, 2, 8,
              (1, 4)),
    "heads_none": ("qwen2.5-32b", {"num_heads": 3, "num_kv_heads": 1}, 2,
                   8, (1, 4)),
    "all_three": ("qwen2.5-32b", {"num_heads": 5, "num_kv_heads": 1,
                                  "vocab_size": 37}, 3, 8, (2, 2)),
}


def _single(arch, over, rows, seq):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model import build_model, make_inputs

    cfg = get_reduced(arch).with_(param_dtype="float64",
                                  compute_dtype="float64", **over)
    model = build_model(cfg)
    params = {n: p.requires_grad_(True) for n, p in
              model.init(torch.Generator().manual_seed(0)).items()}
    batch = make_inputs(cfg, ShapeSpec("t", "train", seq, rows), seed=0,
                        device="cpu")
    loss, _ = model.loss(params, batch)
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return cfg, float(loss.detach()), {n: g.numpy()
                                       for n, g in zip(names, grads)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(split_work_rank, 4, tmp_path_factory.mktemp("split"),
                     CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_loss_and_grads_are_the_single_devices(ranks, case):
    """The loss and every gradient on every rank within 1e-12 (relative,
    float64) of one process's: the splits change the order of the sums
    over ranks, nothing else."""
    arch, over, rows, seq, _ = CASES[case]
    _, want, want_g = _single(arch, over, rows, seq)
    for out in ranks:
        loss, grads, _ = out[case]
        assert abs(loss - want) <= 1e-12 * abs(want)
        assert sorted(grads) == sorted(want_g)
        for n, g in grads.items():
            np.testing.assert_allclose(g, want_g[n], rtol=1e-12,
                                       atol=1e-12 * np.abs(want_g[n]).max(),
                                       err_msg=n)


def _products(ranks, case, rank):
    return ranks[rank][case][2]


def test_rows_split_over_their_positions(ranks):
    """No product on a "data" rank takes more than its own 3 × 4 tokens of
    the 3 × 8 against a (d, ·) weight or its transpose (the backward's
    weight gradient contracts the 12 tokens)."""
    from repro_torch.configs import get_reduced

    d = get_reduced("mistral-large-123b").d_model
    for r in range(4):
        mms = [m for m in _products(ranks, "rows", r) if len(m[0]) == 2]
        assert mms
        for a, b in mms:
            if d in (a[1], b[0]):  # tokens x d against a weight's d rows
                assert a[0] <= 3 * 4, (a, b)


@pytest.mark.parametrize("case", ["vocab", "vocab_encdec", "all_three"])
def test_vocabulary_split_over_its_columns(ranks, case):
    """The head's product on each "model" rank makes its own 19 or 18 of
    the 37 columns; none makes all 37."""
    for r in range(4):
        cols = [b[1] for a, b in _products(ranks, case, r)
                if len(b) == 2 and b[1] in (18, 19, 37)]
        assert cols and 37 not in cols, cols


@pytest.mark.parametrize("case,blocks", [("heads", (3, 3, 3, 1)),
                                         ("heads_none", (1, 1, 1, 0))])
def test_heads_split_over_their_blocks(ranks, case, blocks):
    """The q projection on "model" rank r makes its own block of heads'
    columns (head_dim 32 each): 3, 3, 3 and 1 of 10, or 1, 1, 1 and none
    of 3; no rank makes every head's."""
    from repro_torch.configs import get_reduced

    cfg = get_reduced("qwen2.5-32b")
    H = CASES[case][1]["num_heads"]
    for r, n in enumerate(blocks):
        cols = {b[1] for a, b in _products(ranks, case, r)
                if len(b) == 2 and b[0] == cfg.d_model and b[1] % 32 == 0}
        assert n * 32 in cols and H * 32 not in cols, (r, cols)


class _FoldSeen(ShardingCtx):
    """No mesh; records each ``sequence_fold`` asked for."""

    def __init__(self):
        super().__init__(None, None)
        self.asked = 0

    def sequence_fold(self, x):
        self.asked += 1
        return self


@pytest.mark.parametrize("impl,folds", [("dense", 1), ("dropping", 0)])
def test_dropping_moe_is_not_folded(impl, folds):
    """The reduced mixtral-8x22b's loss asks for the sequence fold with the
    dense dispatch and not with the capacity dispatch, whose groups are
    the rows: folded, its tokens would fall into other groups, each with
    its own capacity, and other tokens be dropped."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model import build_model, make_inputs

    cfg = get_reduced("mixtral-8x22b")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, impl=impl))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_inputs(cfg, ShapeSpec("t", "train", 8, 3), seed=0,
                        device="cpu")
    ctx = _FoldSeen()
    with torch.no_grad():
        loss, _ = model.loss(params, batch, ctx)
    assert torch.isfinite(loss) and ctx.asked == folds
