"""LM training on the PyTorch port: any assigned arch (reduced config) with
the full substrate: deterministic data pipeline, AdamW, microbatched
gradient accumulation, fault-tolerant runner with checkpoints.

    PYTHONPATH=src python examples/train_lm_torch.py --arch llama3-8b --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

Injects a crash at ``--crash-at`` to demonstrate checkpoint/restart: the
runner restores the last checkpoint and replays the steps since, and the
run ends on the same state as one without the crash.  The sizes default
to ``examples/train_lm.py``'s; ``--ckpt-every`` moves the checkpoints.
The last line is ``RESULT`` and the figures as JSON.
"""
import argparse
import json
import shutil
import tempfile

import torch

from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.fault import FaultTolerantRunner, RunnerConfig
from repro_torch.models.model import build_model
from repro_torch.train.loop import (
    make_train_state,
    make_train_step,
    train_state_structure,
)
from repro_torch.train.optim import adamw


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--crash-at", type=int, default=120)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_reduced(args.arch)
    model = build_model(cfg)
    optim = adamw(lr=1e-3, warmup=20, total_steps=args.steps)
    step_fn = make_train_step(model, optim, num_microbatches=args.micro)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, args.seq, args.batch))
    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_torch_")
    log_every = max(1, args.steps // 10)

    losses = {}

    def on_metrics(step, m):
        losses[step] = float(m["loss"])  # a replayed step overwrites itself
        if step % log_every == 0:
            print(f"  step {step:4d}  loss {losses[step]:.4f}", flush=True)

    def first_state():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return make_train_state(model, optim, gen, device=dev)

    runner = FaultTolerantRunner(
        RunnerConfig(ckpt_dir, ckpt_every=args.ckpt_every, max_restarts=3),
        step_fn, pipe.batch, first_state, device=dev,
        structure=train_state_structure(model, optim),
    )
    print(f"training {args.arch} (reduced) for {args.steps} steps; "
          f"injected crash at step {args.crash_at}")
    try:
        state, step = runner.run(
            args.steps, fail_at={args.crash_at: 1}, on_metrics=on_metrics
        )
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    curve = [losses[s] for s in sorted(losses)]
    print(f"done at step {step}; restarts survived: {runner.restarts}")
    print(f"loss {curve[0]:.3f} -> {curve[-1]:.3f}")
    print(f"straggler report: {runner.straggler_report()}")
    digest = float(sum(p.double().sum() for p in state["params"].values()))
    out = {"arch": cfg.name, "steps": args.steps, "final_step": int(step),
           "restarts": runner.restarts, "losses": curve,
           "params_sum": digest}
    print("RESULT", json.dumps(out))
    return out


if __name__ == "__main__":
    main()
