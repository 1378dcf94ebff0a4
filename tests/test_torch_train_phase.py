"""Phase 14 of ``chip_smoke.py`` (the enc-dec family and the training
path), rehearsed on the CPU.

Each of its five checks runs with ``dev="cpu"``, ``torch.cuda``'s
synchronize and memory calls and the device profiler stubbed out, and
small sizes: (a) the reduced seamless-m4t-medium generating 4 tokens
after 8 prompt tokens and 24 frames; (b) ``launch.train.main`` on the
reduced model for 4 steps of 2 × 16 with 2 microbatches; (c) the step
semantics at 4 × 16; (d) two families' float64 gradients (the CPU against
itself); (e) the fault-tolerant resume in a spawned process.  Every check
raises as on the card; what they return is checked here for shape and
consistency, not for time.
"""
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.models.model import build_model
from repro_torch.train.optim import adamw

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ARCH = "seamless-m4t-medium"


def _stub(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(chip_smoke, "profile_call",
                        lambda torch, fn, wall_s: fn() or {
                            "wall_s": wall_s, "device_busy_s": None,
                            "kernel_launches": 0})


def test_encdec_checks_rehearsal(monkeypatch):
    _stub(monkeypatch)
    cfg = get_reduced(ARCH)
    out = chip_smoke.encdec_checks(torch, np, "cpu", cfg, batch=2,
                                   frames_len=24, prompt_len=8, new=4)
    assert out["params"] == 919_040
    assert out["checks"]["prefill_decode_rel_err_64"] <= 1e-12
    assert out["checks"]["prefill_decode_rel_err_64_attn_scaled"] <= 1e-12
    assert out["checks"]["prefill_decode_rel_err_32"] <= 1e-4
    assert len(out["generation"]["tokens_first_row"]) == 4
    step = out["decode_step"]
    # weights: the decoder's and lm_head's float32 (compute dtype) bytes
    n_dec = sum(int(np.prod(s.shape))
                for n, s in build_model(cfg).param_table().items()
                if n.startswith("dec/") or n in ("lm_head", "final_norm"))
    assert step["weight_bytes"] == 4 * n_dec
    assert step["cross_kv_bytes"] == 2 * 2 * 2 * 24 * 128 * 4
    assert step["bytes"] > step["weight_bytes"] and step["bound_by"] == "bytes"


def test_train_entry_rehearsal(monkeypatch):
    _stub(monkeypatch)
    rec = chip_smoke.train_entry(torch, np, [
        "--arch", ARCH, "--reduced", "--steps", "4", "--batch", "2",
        "--seq", "16", "--micro", "2", "--lr", "3e-3", "--device", "cpu"])
    assert len(rec["losses"]) == len(rec["step_seconds"]) == 4
    assert rec["losses"][-1] < rec["losses"][0]
    assert rec["tokens_per_s"] > 0 and 0 < rec["mfu"]
    assert rec["model_flops_per_step"] > 0 and "state" not in rec
    # the attention-scaled start: the seed's draw, wq / wk times sqrt(H / d)
    cfg = get_reduced(ARCH)
    model = build_model(cfg)
    init = chip_smoke.attention_scaled_init(torch, cfg)
    st = init(model, adamw(), "cpu")
    drawn = model.init(torch.Generator().manual_seed(0))
    f = float(np.sqrt(cfg.num_heads / cfg.d_model))
    for n, w in drawn.items():
        want = w * f if n in chip_smoke.ENCDEC_ATTN else w
        assert torch.equal(st["params"][n], want), n
    rec = chip_smoke.train_entry(torch, np, [
        "--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
        "--seq", "16", "--device", "cpu"], init)
    assert len(rec["losses"]) == 2


def test_step_semantics_and_backward_rehearsal(monkeypatch):
    _stub(monkeypatch)
    out = chip_smoke.step_semantics(torch, "cpu", get_reduced(ARCH),
                                    batch=4, seq=16)
    assert out["loss"]["rel"] <= 1e-4 and out["grad_rel_micro"] <= 1e-4
    assert out["grad_rel_remat"] == 0.0  # the same bits on the CPU
    back = chip_smoke.family_backward(torch, "cpu",
                                      ("qwen2-moe-a2.7b", ARCH), seq=16)
    for arch in ("qwen2-moe-a2.7b", ARCH):
        assert back[arch]["worst_rel"] == 0.0 and back[arch]["leaves"] > 10


def test_fault_resume_rehearsal():
    out = chip_smoke.fault_resume(torch, "cpu")
    assert out["restarts"] == [0, 2] and out["bit_equal"]
    assert out["nondeterministic_ops"] == [] and out["leaves"] > 50
