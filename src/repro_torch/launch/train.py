"""End-to-end training entry point (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch gemma-2b --reduced --steps 100
    python -m repro_torch.launch.train --arch gemma-2b --reduced --steps 200 \
        --ckpt-dir /tmp/run1 --ckpt-every 50   # restartable
    python -m repro_torch.launch.train --arch seamless-m4t-medium \
        --steps 12 --batch 8 --seq 512 --micro 2   # full width, on the card

Runs on the card (``--device cuda``, the default) unless asked for the
CPU.  Data is the counter-based ``TokenPipeline``; the audio family's
frame embeddings and the VLM's patch embeddings are drawn per step from
``default_rng(step)``, as ``repro``'s launcher draws them.  ``main(argv)``
returns the run's record: losses, grad norms, step seconds (host clock
around each step, which ends when its loss reaches the host) and the
final state; a program that drives it may pass ``init_state(model, optim,
device) -> state`` in place of the draw from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.fault import FaultTolerantRunner, RunnerConfig
from repro_torch.models.model import build_model
from repro_torch.obs import get_tracer
from repro_torch.train.loop import (
    instrument_step,
    make_train_state,
    make_train_step,
    train_state_structure,
)
from repro_torch.train.optim import adamw


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a chrome://tracing JSONL of train steps")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card)")
    return ap.parse_args(argv)


def optimizer_for(args):
    """AdamW at ``--lr``, warmed up over a tenth of the steps (at most 50),
    then cosine-decayed to the last step, as ``repro``'s launcher sets it."""
    return adamw(lr=args.lr, warmup=min(50, args.steps // 10 + 1),
                 total_steps=args.steps)


def batch_fn_for(cfg, pipe: TokenPipeline, batch: int, seq: int):
    """``step -> batch``: the pipeline's tokens and labels, plus the VLM's
    patches or the audio family's frames (float32, ``default_rng(step)``)."""
    def batch_fn(step):
        b = pipe.batch(step)
        if cfg.family == "vlm":
            rng = np.random.default_rng(step)
            b["patches"] = rng.standard_normal(
                (batch, cfg.num_patches, cfg.patch_dim)).astype(np.float32)
        if cfg.family == "audio":
            rng = np.random.default_rng(step)
            b["frames"] = rng.standard_normal(
                (batch, seq, cfg.d_model)).astype(np.float32)
        return b

    return batch_fn


def main(argv=None, *, init_state=None) -> dict:
    args = parse_args(argv)
    if args.trace:
        get_tracer().start(args.trace)
    device = torch.device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    optim = optimizer_for(args)
    step_fn = instrument_step(
        make_train_step(model, optim, num_microbatches=args.micro))
    pipe = TokenPipeline(
        DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))
    batch_fn = batch_fn_for(cfg, pipe, args.batch, args.seq)
    seconds = []

    def timed_step(state, batch):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])  # waits for the device
        seconds.append(time.perf_counter() - t0)
        return state, metrics

    def first_state():
        if init_state is not None:
            return init_state(model, optim, device)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return make_train_state(model, optim, gen, device=device)

    losses, gnorms = [], []

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {gnorms[-1]:.3f}", flush=True)

    t0 = time.time()
    restarts = 0
    if args.ckpt_dir:
        runner = FaultTolerantRunner(
            RunnerConfig(args.ckpt_dir, ckpt_every=args.ckpt_every),
            timed_step, batch_fn, first_state, device=device,
            structure=train_state_structure(model, optim))
        state, step = runner.run(args.steps, on_metrics=on_metrics)
        restarts = runner.restarts
    else:
        state = first_state()
        for step in range(args.steps):
            state, metrics = timed_step(state, batch_fn(step))
            on_metrics(step, metrics)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} it/s); loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")
    if args.trace:
        get_tracer().stop()
        print(f"trace -> {args.trace} (open in chrome://tracing)")
    return {"arch": cfg.name, "device": str(device), "steps": args.steps,
            "batch": args.batch, "seq": args.seq, "micro": args.micro,
            "losses": losses, "grad_norms": gnorms, "step_seconds": seconds,
            "restarts": restarts, "seconds": dt, "state": state}


if __name__ == "__main__":
    main()
