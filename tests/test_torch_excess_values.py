"""The repairs of the sharded cells' excess over ``repro`` keep every
value (``repro_torch.models.common``, ``rwkv``, ``ssm``):

* the whole-vocabulary cross entropy (``_WholeVocabNLL``, the plain
  branch of ``cross_entropy``) gives the loss and the logits' gradient of
  the formula it replaces, bit for bit, on CPU tensors (float32, float64
  and bf16 logits; masked and unmasked; one row chunk and many); on 4 gloo
  ranks, logits sharded over their rows and whole on the vocabulary, no op
  makes a float32 tensor of the vocabulary's width with more rows than one
  chunk (the parent made the whole float32 copy, and its exponentials);
* ``rms_norm`` without a gradient on a DTensor, in runs of positions of
  one length (``norm_runs``), is the whole-input formula bit for bit on 4
  gloo ranks, and so is ``norm_runs`` on CPU tensors and (marked
  ``cuda``) on the card;
* ``wkv6_step``, ``ssd_decode_step`` and ``decode_attention`` on a decode
  cell's DTensors (4 gloo ranks) run on each rank's shards: the recurrent
  states never move (the parent gathered them, as it gathered the
  attention's scores), and the outputs equal the plain call's, bit for bit
  where each rank holds whole rows of the cache's sequence, within 1e-12
  in float64 where the sequence is split (``repro``'s max / sum
  all-reduce);
* ``remat`` of a decoder whose rows fell back to replicated over "data":
  the rows folded into the sequence (``fold_rows``), so the checkpoint
  holds each rank's own positions: on 4 gloo ranks the reduced
  mistral-large-123b's loss and every gradient equal the run without
  remat bit for bit, and neither the forward nor the backward gathers a
  layer input (held whole over "data", each input was gathered back from
  its sequence shard in the backward).
"""
import numpy as np
import pytest
import torch

from repro_torch.models import common
from repro_torch.models.rwkv import wkv6_step
from repro_torch.models.ssm import ssd_decode_step
from tests._torch_ranks import (
    decode_model_rank,
    decode_step_rank,
    held_remat_rank,
    rms_norm_rank,
    run_ranks,
    whole_vocab_ce_rank,
)


# ---------------------------------------------- the whole-vocabulary CE
def _formula(logits, labels, mask=None):
    """The plain branch as it was: the logits cast to the accumulation
    dtype, ``logsumexp`` less the gathered gold logit, the masked mean."""
    at = common.acc_dtype(logits.dtype)
    lf = logits.to(at)
    nll = torch.logsumexp(lf, dim=-1) \
        - torch.gather(lf, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(at)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


@pytest.mark.parametrize("chunk", [1 << 28, 3 * 61 * 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_whole_vocab_ce_is_the_formula_bit_for_bit(monkeypatch, dtype,
                                                   masked, chunk):
    """``cross_entropy`` and ``next_token_ce`` on (3, 17, 61) logits: the
    loss and the logits' gradient equal the formula's exactly, in one row
    chunk and in chunks of 3 rows (6 of a batch row's 17)."""
    monkeypatch.setattr(common, "CE_CHUNK_BYTES", chunk)
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    logits = torch.from_numpy(4.0 * rng.standard_normal((3, 17, 61))).to(dt)
    labels = torch.from_numpy(rng.integers(0, 61, (3, 18)))
    labels[0, 5] = labels[2, 11] = -1
    mask = torch.from_numpy((rng.random((3, 17)) > 0.3).astype(np.float32)) \
        if masked else None
    for ours, theirs in (
            (lambda t: common.cross_entropy(t, labels[:, 1:].clamp_min(0),
                                            mask),
             lambda t: _formula(t, labels[:, 1:].clamp_min(0), mask)),
            (lambda t: common.next_token_ce(
                torch.cat([t, t[:, :1]], dim=1), labels),
             lambda t: _formula(torch.cat([t, t[:, :1]], dim=1)[:, :-1],
                                labels[:, 1:].clamp_min(0),
                                (labels[:, 1:] >= 0).float()))):
        a = logits.clone().requires_grad_(True)
        b = logits.clone().requires_grad_(True)
        got, want = ours(a), theirs(b)
        got.backward()
        want.backward()
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert a.grad.dtype == dt and torch.equal(a.grad, b.grad)


def _rms_formula(x, w, eps):
    """``rms_norm`` as it was: the whole input cast to the accumulation
    dtype at once."""
    at = common.acc_dtype(x.dtype)
    xf = x.to(at)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.to(at))).to(x.dtype)


@pytest.mark.parametrize("shape", [(3, 77, 96), (2, 5, 7, 96), (300, 96)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32",
                                   "float64"])
def test_rms_norm_in_runs_of_positions_is_the_formula(monkeypatch, dtype,
                                                      shape):
    """``norm_runs`` at every run length that divides the positions (77:
    1, 7, 11; 7: 1; 300: 1 … 150) equals the whole-input formula bit for
    bit; ``rms_norm`` on a plain tensor past ``NORM_CHUNK_BYTES`` (here 5
    rows of the accumulation dtype) is that formula, without a gradient
    and with one (output and gradient)."""
    monkeypatch.setattr(common, "NORM_CHUNK_BYTES", 96 * 8 * 5)
    rng = np.random.default_rng(2)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(3.0 * rng.standard_normal(shape)).to(dt)
    w = torch.from_numpy(0.1 * rng.standard_normal(96)).float()
    want = _rms_formula(x, w, 1e-6)
    S = shape[-2]
    for step in (n for n in range(1, S) if S % n == 0):
        got = common.norm_runs(x, w, 1e-6, step)
        assert got.dtype == dt and torch.equal(got, want), step
    with torch.no_grad():
        assert torch.equal(common.rms_norm(x, w, 1e-6), want)
    xa, xb = (x.clone().requires_grad_(True) for _ in range(2))
    ga, gb = common.rms_norm(xa, w, 1e-6), _rms_formula(xb, w, 1e-6)
    ga.sum().backward()
    gb.sum().backward()
    assert torch.equal(ga, gb) and torch.equal(xa.grad, xb.grad)


NORM_D = 96
NORM_RUN_ROWS = 5  # NORM_CHUNK_BYTES on the ranks: 5 float32 rows of d


@pytest.fixture(scope="module")
def rms_norm_ranks(tmp_path_factory):
    rng = np.random.default_rng(9)
    cases = {}
    for name, (B, S, dtype, pending) in {
            "bf16": (2, 21, "bfloat16", False),
            "f32": (2, 35, "float32", False),
            "bf16_pending": (4, 20, "bfloat16", True)}.items():
        x = (3.0 * rng.standard_normal((B, S, NORM_D))).astype(np.float32)
        w = (0.1 * rng.standard_normal(NORM_D)).astype(np.float32)
        cases[name] = (x, w, dtype, pending)
    return cases, run_ranks(rms_norm_rank, 4,
                            tmp_path_factory.mktemp("rms_norm"), cases,
                            NORM_RUN_ROWS * NORM_D * 4)


@pytest.mark.parametrize("case", ["bf16", "f32", "bf16_pending"])
def test_rms_norm_on_row_sharded_ranks_is_the_formula(rms_norm_ranks, case):
    """On 4 gloo ranks, a DTensor sharded over its rows on "data" (each
    rank's piece 1 row of 21 or 35 positions or 2 rows of 20, whole over
    "model" or a pending sum over it), ``NORM_CHUNK_BYTES`` at 5 float32
    positions of one row: ``rms_norm`` equals the whole-input formula bit
    for bit, in runs of 3, 5 and 2 positions.  From a bf16 input no op
    makes a float32 tensor of more than 5 positions (the formula casts all
    21 or 20)."""
    cases, ranks = rms_norm_ranks
    x, w, dtype, _ = cases[case]
    want = _rms_formula(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(w), 1e-6).double().numpy()
    for out in ranks:
        got, outs = out[case]
        np.testing.assert_array_equal(got, want)
        if dtype == "bfloat16":
            wide = [s for s, dt in outs if dt == "torch.float32"
                    and len(s) == 3 and s[-1] == NORM_D]
            assert wide and max(s[1] for s in wide) <= NORM_RUN_ROWS, wide


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d,step", [(2, 8192, 6144, 2048),
                                        (1, 8192, 12288, 1024),
                                        (2, 4096, 2048, 512),
                                        (2, 64, 12288, 8)])
def test_norm_runs_on_the_card_are_the_formula(B, S, d, step):
    """On the card, whose reduction picks its thread layout from the
    number of rows it is given: bf16 (B, S, d) inputs normed in runs of
    ``step`` positions equal the whole-input formula bit for bit, at the
    run lengths a rank's piece of a prefill gets (2,048 positions of 2
    rows of 6,144 under ``NORM_CHUNK_BYTES``) and at a short one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(B * S + d)
    x = (3.0 * torch.randn(B, S, d, generator=g, device="cuda")).to(
        torch.bfloat16)
    w = 0.1 * torch.randn(d, generator=g, device="cuda")
    with torch.no_grad():
        got = common.norm_runs(x, w, 1e-6, step)
        want = _rms_formula(x, w, 1e-6)
    assert torch.equal(got, want)


CE_V = 37  # the vocabulary: odd, so no mesh dimension divides it
CE_CHUNK_ROWS = 3


@pytest.fixture(scope="module")
def whole_vocab_ranks(tmp_path_factory):
    rng = np.random.default_rng(5)
    cases = {}
    for name, (B, S) in {"rows4": (4, 9), "rows8": (8, 6)}.items():
        logits = (3.0 * rng.standard_normal((B, S, CE_V))).astype(np.float32)
        labels = rng.integers(0, CE_V, (B, S)).astype(np.int64)
        labels[0, 2] = labels[B - 1, S - 1] = -1
        cases[name] = (logits, labels)
    return cases, run_ranks(whole_vocab_ce_rank, 4,
                            tmp_path_factory.mktemp("whole_vocab"), cases,
                            CE_CHUNK_ROWS * CE_V * 4)


@pytest.mark.parametrize("case", ["rows4", "rows8"])
def test_whole_vocab_ce_on_ranks_keeps_one_chunk_of_float32(
        whole_vocab_ranks, case):
    """On 4 gloo ranks (bf16 logits sharded over their rows on "data",
    whole over "model"): the loss within 1e-6 of one process's (the mean's
    sum runs over the ranks) and the logits' gradient equal to it bit for
    bit; no op of the loss or its backward makes a float32 tensor of the
    vocabulary's width with more than ``CE_CHUNK_ROWS`` rows (the parent
    cast the rank's logits whole to float32)."""
    cases, ranks = whole_vocab_ranks
    logits, labels = cases[case]
    lg = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    lb = torch.from_numpy(labels)
    want = common.next_token_ce(lg, lb)
    want.backward()
    for out in ranks:
        loss, grad, outs = out[case]
        assert abs(loss - want.item()) <= 1e-6 * abs(want.item())
        np.testing.assert_array_equal(grad, lg.grad.float().numpy())
        wide = [s for s, dt in outs
                if dt == "torch.float32" and s and s[-1] == CE_V]
        assert wide and max(int(np.prod(s[:-1])) for s in wide) \
            <= CE_CHUNK_ROWS, wide


# ------------------------------------------------- the decode steps
B, H, HD, S_CACHE = 4, 4, 3, 10
ROWS = ((0, 0),)                 # rows over "data"
ROWS_HEADS = ((0, 0), (1, 1))    # rows over "data", heads (dim 1) over "model"


def _decode_cases():
    rng = np.random.default_rng(3)

    def n(*shape):
        return rng.standard_normal(shape)

    logw = -np.exp(0.5 * n(B, H, HD))
    pos_k = np.broadcast_to(np.arange(S_CACHE, dtype=np.int32),
                            (B, S_CACHE)).copy()
    pos_k[1, 7:] = -1                      # empty slots
    pos_k[2] = np.roll(pos_k[2], 3)        # a ring that has wrapped
    pos_q = np.array([[9], [6], [9], [4]], dtype=np.int32)
    seq = ((0, 0), (1, 1))               # the cache's sequence over "model"
    heads = ((0, 0), (1, 2))             # its heads over "model"
    wkv = [n(B, H, HD), n(B, H, HD), n(B, H, HD), logw, n(H, HD),
           n(B, H, HD, HD)]
    ssd = [n(B, H, HD), np.log1p(np.exp(n(B, H))), -np.exp(n(H)), n(B, 5),
           n(B, 5), n(B, H, HD, 5)]
    attn = [n(B, 1, 4, HD), n(B, S_CACHE, 2, HD), n(B, S_CACHE, 2, HD),
            pos_q, pos_k]
    return {
        # the decode cells' layout: the state's heads whole on every
        # "model" rank, the token's projections sharded on them
        "wkv6_state_rows": ("wkv6_step", wkv, [ROWS_HEADS] * 4 + [(), ROWS],
                            {}),
        "wkv6_state_rows_heads": ("wkv6_step", wkv,
                                  [ROWS_HEADS] * 4 + [((1, 0),), ROWS_HEADS],
                                  {}),
        "ssd_state_rows": ("ssd_decode_step", ssd,
                           [ROWS_HEADS, ROWS_HEADS, (), ROWS, ROWS, ROWS], {}),
        "ssd_state_rows_heads": ("ssd_decode_step", ssd,
                                 [ROWS_HEADS, ROWS_HEADS, ((1, 0),), ROWS,
                                  ROWS, ROWS_HEADS], {}),
        "attention_seq_split": ("decode_attention", attn,
                                [ROWS, seq, seq, ROWS, seq], {}),
        "attention_seq_split_window": ("decode_attention", attn,
                                       [ROWS, seq, seq, ROWS, seq],
                                       {"window": 4}),
        "attention_heads": ("decode_attention", attn,
                            [((0, 0), (1, 2)), heads, heads, ROWS, ROWS], {}),
    }


DECODE_CASES = _decode_cases()
DECODE_FNS = {"wkv6_step": wkv6_step, "ssd_decode_step": ssd_decode_step,
              "decode_attention": common.decode_attention}


@pytest.fixture(scope="module")
def decode_ranks(tmp_path_factory):
    return run_ranks(decode_step_rank, 4, tmp_path_factory.mktemp("decode"),
                     DECODE_CASES)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_step_on_shards_is_the_plain_call(decode_ranks, case):
    """Each output equals the plain call's on the whole tensors (float64):
    bit for bit, but where the cache's sequence is split over "model"
    (the softmax's sum and the value product's sum run over the ranks),
    within 1e-12."""
    fn, arrays, _, kw = DECODE_CASES[case]
    want = DECODE_FNS[fn](*map(torch.from_numpy, arrays), **kw)
    want = want if isinstance(want, tuple) else (want,)
    for out in decode_ranks:
        got, _, _ = out[case]
        for g, w in zip(got, want):
            if "seq_split" in case:
                np.testing.assert_allclose(g, w.numpy(), rtol=1e-12,
                                           atol=1e-12)
            else:
                np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_step_moves_no_state_and_no_scores(decode_ranks, case):
    """No all-gather moves a recurrent state or the attention's scores:
    the steps gather at most the token's own inputs (a (B, H, hd) row's
    worth) and leave the new state laid out as the old one (the parent
    left it on the token's head shards, for the cache's layout to gather
    it back: the decode cells' (B, H, hd, hd) gathers), the attention
    gathers nothing (the parent gathered the (B, Hkv, G, S) scores)."""
    for out in decode_ranks:
        _, gathers, (new, old) = out[case]
        outs = [int(np.prod(o)) for _, o in gathers]
        if case.startswith("attention"):
            assert outs == [], gathers
        else:
            assert all(o <= B * H * HD for o in outs), gathers
            assert new == old


# ------------------------------------------- a decode step on the mesh
MODEL_DECODE = {"rwkv6": ("rwkv6-1.6b", 8, 16),
                "zamba2": ("zamba2-1.2b", 8, 16),
                "llama3": ("llama3-8b", 8, 16),
                "seamless": ("seamless-m4t-medium", 8, 16)}


@pytest.fixture(scope="module")
def model_decode(tmp_path_factory):
    return run_ranks(decode_model_rank, 4,
                     tmp_path_factory.mktemp("model_decode"), MODEL_DECODE)


@pytest.mark.parametrize("case", sorted(MODEL_DECODE))
def test_decode_step_with_spread_rows_is_the_plain_call(model_decode, case):
    """A whole decode step of the reduced rwkv6-1.6b and zamba2-1.2b (its
    input products take the token's rows spread over the weights' rows,
    ``DecodeRows.spread``), llama3-8b and seamless-m4t-medium (each rank
    makes its block of the KV projections' columns, ``cut_columns``) on 4
    gloo ranks, float64, laid out as the decode cells lay them out, gives
    one process's logits and every new cache entry within 1e-12."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model import build_model, make_cache, make_inputs

    arch, rows, seq = MODEL_DECODE[case]
    cfg = get_reduced(arch).with_(param_dtype="float64",
                                  compute_dtype="float64")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = make_inputs(cfg, ShapeSpec("d", "decode", seq, rows), seed=1,
                         device="cpu")["tokens"]
    cache = make_cache(cfg, rows, seq, filled=seq // 2, device="cpu")
    g = torch.Generator().manual_seed(2)
    cache = {k: v if v.dtype == torch.int32 else
             torch.randn(v.shape, generator=g, dtype=v.dtype)
             for k, v in cache.items()}
    t = torch.full((rows,), seq // 2, dtype=torch.int32)
    with torch.no_grad():
        logits, new = model.decode(params, tokens, cache, t)
    for out in model_decode:
        got_logits, got = out[case]
        np.testing.assert_allclose(got_logits, logits.numpy(), rtol=1e-12,
                                   atol=1e-12)
        assert sorted(got) == sorted(new)
        for k, v in new.items():
            np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=k)


# --------------------------------------------------- the held remat
HELD_ARCH = "mistral-large-123b"


@pytest.fixture(scope="module")
def held_remat(tmp_path_factory):
    # 3 rows do not divide the 2-way "data" axis; 8 positions do
    return run_ranks(held_remat_rank, 4, tmp_path_factory.mktemp("remat"),
                     HELD_ARCH, 3, 8)


def test_held_remat_is_plain_remat_bit_for_bit(held_remat):
    """The loss and every parameter's gradient with remat on (the layer
    inputs held as each rank's own folded positions) equal those with
    remat off, on every rank, bit for bit."""
    for out in held_remat:
        loss_on, grads_on, _ = out[True]
        loss_off, grads_off, _ = out[False]
        assert loss_on == loss_off
        assert sorted(grads_on) == sorted(grads_off)
        for n in grads_on:
            np.testing.assert_array_equal(grads_on[n], grads_off[n], n)


def test_held_remat_gathers_each_layer_input_in_the_backward(held_remat):
    """With remat on or off, the forward all-gathers no layer input (a
    (·, ·, d) activation of the 3 × 8 tokens) and the backward one only,
    whatever the layer count: the embedding's gradient back to its whole
    rows, where the fold began.  Each rank holds and recomputes its own 3 ×
    4 positions, and attention gathers only the keys and values.  Held as
    sequence shards of the whole (3, 8, d) inputs instead, the backward
    gathered each one back, one a layer (2 layers)."""
    from repro_torch.configs import get_reduced

    d = get_reduced(HELD_ARCH).d_model
    for out in held_remat:
        for remat in (True, False):
            fwd, bwd = ([g for g in phase if len(g[1]) == 3
                         and g[1][-1] == d and g[1][0] * g[1][1] >= 3 * 4]
                        for phase in out[remat][2])
            assert fwd == [] and len(bwd) == 1, (fwd, bwd)
