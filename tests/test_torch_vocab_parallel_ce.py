"""The vocab-parallel cross entropy and embedding lookup
(``repro_torch.models.common``): logits that are a DTensor sharded on the
vocabulary over a ("data", "model") mesh, on 2 and 4 gloo ranks
(``tests/_torch_ranks.py``), against one process's plain
``cross_entropy`` / ``next_token_ce`` on the whole tensors; a table sharded
on the vocabulary and on ``embed`` against ``table[tokens]``.  The labels hold -1 (masked) and ids on both edges of every
vocabulary shard; one case has a vocabulary the shards split unevenly.
The loss and the logits' gradient hold to 1e-6 relative in float32 and
1e-12 in float64, on every rank, and no op of the loss or its backward
makes a local tensor of the whole vocabulary or of another rank's rows."""
import numpy as np
import pytest
import torch

from repro_torch.models.common import cross_entropy, next_token_ce
from tests._torch_ranks import run_ranks, vocab_parallel_ce_rank

TOL = {"float32": 1e-6, "float64": 1e-12}


def _case(dtype: str, V: int, seed: int):
    rng = np.random.default_rng(seed)
    B, S = 4, 9
    logits = (3.0 * rng.standard_normal((B, S, V))).astype(dtype)
    labels = rng.integers(0, V, (B, S)).astype(np.int64)
    half = -(-V // 2)  # the "model" dimension's first shard: [0, half)
    edges = [0, half - 1, half, V - 1]
    labels[:, 1:5] = edges
    labels[0, 2] = labels[3, 6] = labels[1, 8] = -1
    return logits, labels


CASES = {f"{dt}-V{V}": _case(dt, V, seed)
         for seed, (dt, V) in enumerate([("float32", 16), ("float64", 16),
                                         ("float32", 15), ("float64", 15)])}


def _embed_case(dtype: str, V: int, seed: int):
    """A (V, 6) table, (4, 9) tokens with every shard edge and a repeated
    id, and a cotangent for the rows."""
    rng = np.random.default_rng(100 + seed)
    table = rng.standard_normal((V, 6)).astype(dtype)
    tokens = rng.integers(0, V, (4, 9)).astype(np.int64)
    half = -(-V // 2)
    tokens[:, 1:5] = [0, half - 1, half, V - 1]
    tokens[2, 7] = tokens[0, 0]
    cot = rng.standard_normal((4, 9, 6)).astype(dtype)
    return table, tokens, cot


EMBEDS = {f"{dt}-V{V}": _embed_case(dt, V, seed)
          for seed, (dt, V) in enumerate([("float32", 16), ("float64", 16),
                                          ("float32", 15), ("float64", 15)])}


def _plain(logits, labels, loss_name):
    lg = torch.from_numpy(logits).requires_grad_(True)
    lb = torch.from_numpy(labels)
    if loss_name == "next_token_ce":
        loss = next_token_ce(lg, lb)
    else:
        loss = cross_entropy(lg, torch.clamp_min(lb, 0))
    loss.backward()
    return loss.detach().numpy(), lg.grad.numpy()


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, run_ranks(vocab_parallel_ce_rank, world,
                            tmp_path_factory.mktemp(f"vpce{world}"), CASES,
                            EMBEDS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_vocab_parallel_ce_is_one_process_ce(ranks, case):
    world, outs = ranks
    logits, labels = CASES[case]
    tol = TOL[case.split("-")[0]]
    V = logits.shape[-1]
    for loss_name in ("next_token_ce", "cross_entropy"):
        want_loss, want_grad = _plain(logits, labels, loss_name)
        for rank, out in enumerate(outs):
            loss, grad, local, shapes = out[(case, loss_name)]
            assert local[-1] == (-(-V // 2) if rank % 2 == 0 else V // 2)
            # no rank holds the whole vocabulary or more than its own rows
            assert shapes and all(s[-1] != V for s in shapes if s), \
                (world, rank, loss_name)
            assert all(len(s) < 2 or s[0] <= local[0] for s in shapes), \
                (world, rank, loss_name)
            assert loss.dtype == want_loss.dtype
            assert abs(float(loss) - float(want_loss)) <= \
                tol * abs(float(want_loss)), (world, rank, loss_name)
            err = np.abs(grad - want_grad).max() / np.abs(want_grad).max()
            assert err <= tol, (world, rank, loss_name, err)


@pytest.mark.parametrize("case", sorted(EMBEDS))
def test_vocab_parallel_embedding_is_one_process_lookup(ranks, case):
    """``embed_rows`` on the loss path: the rows equal ``table[tokens]``
    exactly, the table's gradient (accumulated over repeated ids, summed
    over the row shards) one process's within the tolerance, and no rank
    makes a buffer of the whole vocabulary's rows."""
    world, outs = ranks
    table, tokens, cot = EMBEDS[case]
    tol = TOL[case.split("-")[0]]
    V = table.shape[0]
    emb = torch.from_numpy(table).requires_grad_(True)
    want = emb[torch.from_numpy(tokens)]
    (want * torch.from_numpy(cot)).sum().backward()
    for rank, out in enumerate(outs):
        rows, grad, local, shapes = out[(case, "embed_rows")]
        assert local[0] == (-(-V // 2) if rank % 2 == 0 else V // 2)
        np.testing.assert_array_equal(rows, want.detach().numpy())
        err = np.abs(grad - emb.grad.numpy()).max() / \
            np.abs(emb.grad.numpy()).max()
        assert err <= tol, (world, rank, err)
        assert shapes and all(s[0] != V for s in shapes if s), (world, rank)
