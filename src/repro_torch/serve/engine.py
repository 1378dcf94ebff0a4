"""Serving engine: batched prefill → decode generation with KV caches.

The port's counterpart of ``repro.serve.engine``.  One prefill and one
decode step a token for the whole batch, the decode loop on the host.
Greedy decoding or temperature sampling; per-request stop handling via a
done mask.

The weights are cast to the compute dtype once, here (``repro`` casts them
at every use, which gives the same bits), so a bfloat16 model keeps both
its float32 parameters and that bfloat16 copy resident, unless it is
handed weights already in that form (``DecoderLM.init_compute``), which
it keeps as they are.

Observability: ``generate`` wraps the prefill and the decode loop in
``span``s (a traced prefill waits for the card before its span closes) and
reports requests / generated tokens / tokens-per-second into the default
metrics registry.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NULL_CTX, ShardingCtx
from repro_torch.models.model import build_model
from repro_torch.obs import LATENCY_BUCKETS, get_registry, get_tracer, span


@dataclass
class GenerationResult:
    """Shape contract (identical whether or not EOS fired early):

      tokens       (B, steps) — ``steps`` decode steps were executed for the
                   whole batch; requests that hit EOS before step ``steps``
                   are right-padded with 0 from the step after their EOS.
      logits_last  (B, vocab) float32 — logits produced by the final decode
                   step (the distribution over the hypothetical next token),
                   on every path.
      steps        number of decode steps executed, ``1 ≤ steps ≤ max_new``;
                   < max_new only when every request hit EOS early.
    """

    tokens: np.ndarray      # (B, steps) generated ids
    logits_last: np.ndarray
    steps: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """``ServeEngine(cfg, params, ctx, device=)``: ``params`` is the model's
    parameter dict (tensors or numpy arrays), moved to ``device``; ``ctx``
    the sharding context prefill and decode run under."""

    def __init__(self, cfg: ModelConfig, params, ctx: ShardingCtx = NULL_CTX,
                 *, device="cuda"):
        self.cfg = cfg
        self.ctx = ctx
        self.device = torch.device(device)
        self.model = build_model(cfg)
        self.params = {n: torch.as_tensor(p, device=self.device)
                       for n, p in params.items()}
        self.compute_params = self.model.compute_params(self.params)

    def resident_bytes(self) -> Dict[str, int]:
        """Bytes of the parameters and of their compute-dtype copy (the
        tensors of the latter that are not the parameters themselves)."""
        own = {p.data_ptr() for p in self.params.values()}
        params = sum(p.numel() * p.element_size() for p in self.params.values())
        copy = sum(p.numel() * p.element_size()
                   for p in self.compute_params.values()
                   if p.data_ptr() not in own)
        return {"params": params, "compute_copy": copy,
                "total": params + copy}

    def generate(
        self,
        batch: Dict[str, object],
        max_new_tokens: int = 32,
        *,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
    ) -> GenerationResult:
        """Greedy decoding (argmax, ties to the lowest id) or, with
        ``temperature > 0``, Gumbel-max sampling from a ``torch.Generator``
        seeded by ``seed`` (deterministic per seed, not ``jax.random``'s
        draws)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, prompt_len = tokens.shape
        tracing = get_tracer().enabled
        with torch.no_grad():
            t_start = time.perf_counter()
            with span("serve.prefill", batch=B, prompt_len=prompt_len):
                logits, cache = self.model.prefill(
                    self.compute_params, {"tokens": tokens}, self.ctx,
                    capacity=prompt_len + max_new_tokens,
                )
                if tracing:  # sync only when the span is real
                    _sync(self.device)
            t_prefill = time.perf_counter() - t_start
            t = torch.full((B,), prompt_len, dtype=torch.int32,
                           device=self.device)
            gen = None
            if temperature > 0:
                gen = torch.Generator(device=self.device).manual_seed(seed)
            done = np.zeros(B, bool)
            out = np.zeros((B, max_new_tokens), np.int32)
            steps = 0
            t0 = time.perf_counter()
            with span("serve.decode", batch=B, max_new=max_new_tokens):
                for i in range(max_new_tokens):
                    if gen is not None:
                        u = torch.rand(logits.shape, generator=gen,
                                       device=self.device)
                        gumbel = -torch.log(-torch.log(
                            torch.clamp_min(u, torch.finfo(u.dtype).tiny)))
                        tok = torch.argmax(
                            logits.to(torch.float32) / temperature + gumbel,
                            dim=-1)
                    else:
                        tok = torch.argmax(logits, dim=-1)
                    tok = tok.to(torch.int32)
                    tok_np = tok.cpu().numpy()
                    out[:, i] = np.where(done, 0, tok_np)
                    if eos_id is not None:
                        done |= tok_np == eos_id
                    # the final decode always runs so logits_last is the
                    # post-last-token distribution on every path
                    logits, cache = self.model.decode(
                        self.compute_params, tok[:, None], cache, t + i,
                        self.ctx)
                    steps = i + 1
                    if done.all():
                        break
                logits_last = logits.to(torch.float32).cpu().numpy()
            dt = time.perf_counter() - t0
        n_tok = int(B * steps)
        reg = get_registry()
        if reg.enabled:
            reg.counter("serve.requests", "generate() requests").inc(B)
            reg.counter("serve.tokens", "decoded tokens").inc(n_tok)
            reg.histogram(
                "serve.prefill_seconds", "prefill latency", LATENCY_BUCKETS
            ).observe(t_prefill)
            reg.histogram(
                "serve.decode_seconds", "decode-loop latency", LATENCY_BUCKETS
            ).observe(dt)
            if dt > 0:
                reg.gauge(
                    "serve.tokens_per_sec", "decode throughput (last batch)"
                ).set(n_tok / dt)
        return GenerationResult(out[:, :steps], logits_last, steps)
