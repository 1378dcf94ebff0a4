"""Attention's and the recurrent scans' carried state, built from the
sharded input itself (``repro_torch.models.common.batch_local``): on 4
gloo ranks, a ("data", "model") mesh of (2, 2), ``blockwise_attention``,
``wkv6_chunked`` and ``ssd_chunked`` take batch-sharded inputs laid out as
the sharded train cells lay them out (queries and the scans' r / k / v and
x sharded over the heads, keys and values replicated over them; one case
with a single KV head) and make no all-gather, forward or backward, and
their outputs and gradients equal the plain call's in float64.

At the parent, the attention's state was a plain ``torch.zeros`` at the
global batch and its keys and values stayed replicated over the heads the
queries were sharded on: the call all-gathered K and V to the global
batch.
"""
import numpy as np
import pytest
import torch

from repro_torch.models.common import blockwise_attention
from repro_torch.models.rwkv import wkv6_chunked
from repro_torch.models.ssm import ssd_chunked
from tests._torch_ranks import batch_local_state_rank, run_ranks

B, S = 4, 24
BATCH_HEADS = ((0, 0), (1, 2))  # rows over "data", heads over "model"
BATCH = ((0, 0),)


def _cases():
    rng = np.random.default_rng(7)

    def n(*shape):
        return rng.standard_normal(shape)

    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    logw = -np.exp(0.5 * n(B, S, 2, 4))
    return {
        "attention": ("blockwise_attention",
                      [n(B, S, 4, 8), n(B, S, 2, 8), n(B, S, 2, 8), pos, pos],
                      [BATCH_HEADS, BATCH, BATCH, BATCH, BATCH],
                      dict(causal=True, chunk=8, q_chunk=16)),
        # one KV head for four query heads: each rank's two read it
        "attention_mqa": ("blockwise_attention",
                          [n(B, S, 4, 8), n(B, S, 1, 8), n(B, S, 1, 8), pos,
                           pos],
                          [BATCH_HEADS, BATCH, BATCH, BATCH, BATCH],
                          dict(causal=True, chunk=8, q_chunk=16)),
        "wkv6": ("wkv6_chunked",
                 [n(B, S, 2, 4), n(B, S, 2, 4), n(B, S, 2, 4), logw,
                  n(2, 4)],
                 [BATCH_HEADS, BATCH_HEADS, BATCH_HEADS, BATCH, ()],
                 dict(chunk=8)),
        "ssd": ("ssd_chunked",
                [n(B, S, 2, 4), np.log1p(np.exp(n(B, S, 2))),
                 -np.exp(n(2)), n(B, S, 4), n(B, S, 4)],
                [BATCH_HEADS, BATCH, (), BATCH, BATCH],
                dict(chunk=8)),
    }


CASES = _cases()
FNS = {"blockwise_attention": blockwise_attention,
       "wkv6_chunked": wkv6_chunked, "ssd_chunked": ssd_chunked}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return run_ranks(batch_local_state_rank, 4,
                     tmp_path_factory.mktemp("batch_local"), CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_sharded_state_gathers_nothing(sharded, case):
    """The call all-gathers nothing; its backward gathers only gradients
    smaller than the sharded input (those of arguments replicated over the
    heads that each head's scan reads: dt, A, logw, u, as GSPMD's would)."""
    first = CASES[case][1][0]
    for rank, out in enumerate(sharded):
        assert out[case][1] == [], (rank, out[case][1])
        assert all(np.prod(o) < first.size for _, o in out[case][3]), \
            (rank, out[case][3])


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_sharded_call_is_the_plain_call(sharded, case):
    """The outputs and every floating argument's gradient of the outputs'
    summed squares equal the plain call's, 1e-12 in float64."""
    fn, arrays, _, kw = CASES[case]
    args = [torch.from_numpy(a).requires_grad_(a.dtype.kind == "f")
            for a in arrays]
    want = FNS[fn](*args, **kw)
    want = want if isinstance(want, tuple) else (want,)
    sum((w * w).sum() for w in want).backward()
    for out in sharded:
        got, _, grads, _ = out[case]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w.detach().numpy(), rtol=1e-12,
                                       atol=1e-12)
        for g, a in zip(grads, args):
            if a.grad is None:
                assert g is None
            else:
                np.testing.assert_allclose(g, a.grad.numpy(), rtol=1e-12,
                                           atol=1e-12)
