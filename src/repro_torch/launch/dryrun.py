"""Multi-pod dry run of every cell (counterpart of ``repro.launch.dryrun``).

For every (architecture × input shape × mesh) cell:
    init_fake_world(mesh size)          # a "fake" process group, rank 0
    cell  = build_cell(...)             # specs + shardings
    trace = lower_cell(cell)            # rank 0's ops on fake local shards
    print(trace.memory_analysis())      # proves it fits
    print(trace.cost_analysis())        # FLOPs/bytes for the roofline

``repro`` compiles for 512 placeholder host devices; the port stands up a
fake process group of the mesh's size (256 or 512 ranks, this process rank
0), whose collectives move nothing, before it builds the mesh, and runs
the cell on fake tensors (``launch.cells.lower_cell``), priced by
``launch.trace_analysis``.  Everything is dumped as JSON for the
roofline, with a gz sidecar of the op record for re-analysis.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch gate-anns --shape search_1b
    python -m repro_torch.launch.dryrun --all            # every cell, subprocesses
Options: --multi-pod, --both-meshes, --jobs N (--all: N cells at once),
         --out DIR,
         --profile {train,prefill,decode,long}, --micro N (train
         microbatches override), --tag, --set key=value,
         --device {cuda,cpu} (the fake tensors' device, cuda by default:
         with no card the run stops unless cpu is asked for; on a CPU
         mesh DTensor swaps all-to-all for all-gather + chunk)
"""
import argparse
import gzip
import json
import os
import subprocess
import sys
import time
import traceback


def init_fake_world(n: int) -> None:
    """A "fake" process group of ``n`` ranks in this process, as rank 0:
    meshes of ``n`` ranks build, and collectives run but move nothing."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    try:
        dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                                world_size=n)
    except (ValueError, RuntimeError, AssertionError):
        # the "fake" backend registers itself when its module is imported
        import torch.testing._internal.distributed.fake_pg  # noqa: F401

        dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                                world_size=n)


def check_device(device: str) -> str:
    """``device`` itself; raises when it is ``cuda`` and no card is
    present (the dry run never falls back to the CPU by itself)."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the dry run's fake tensors default to cuda, and no card is "
            "present: pass --device cpu (device='cpu') to dry-run on the "
            "CPU, where DTensor swaps all-to-all for all-gather + chunk")
    return device


def _apply_overrides(cfg, sets):
    """--set key=value config overrides (int/float/str/bool inferred);
    ``moe.<field>`` targets the nested MoESpec."""
    import dataclasses

    def parse(v):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        if v in ("true", "True", "false", "False"):
            return v.lower() == "true"
        return v

    kw, moe_kw = {}, {}
    for s in sets or []:
        k, v = s.split("=", 1)
        if k.startswith("moe."):
            moe_kw[k[4:]] = parse(v)
        else:
            kw[k] = parse(v)
    if moe_kw:
        kw["moe"] = dataclasses.replace(cfg.moe, **moe_kw)
    return cfg.with_(**kw) if kw else cfg


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             micro=None, profile_kind=None, sets=None, tag: str = "",
             device: str = "cuda") -> dict:
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.distributed.sharding import make_profile
    from repro_torch.launch import gate_cell
    from repro_torch.launch.cells import build_cell, lower_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import product_flops

    check_device(device)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": mesh.size(),
        "device": device,
        "ok": False,
    }
    t0 = time.time()
    try:
        if arch == "gate-anns":
            cell = gate_cell.build_gate_cell(shape_name, mesh, sets=sets)
            rec["model_flops"] = gate_cell.gate_model_flops(
                shape_name, mesh.size()
            )
        else:
            cfg = _apply_overrides(get_config(arch), sets)
            shape = SHAPES[shape_name]
            ok, why = shape_applicable(cfg, shape)
            if not ok:
                rec["skipped"] = why
                rec["ok"] = True
                return rec
            profile = make_profile(profile_kind) if profile_kind else None
            cell = build_cell(
                cfg, shape, mesh, num_microbatches=micro, profile=profile
            )
            rec["model_flops"] = product_flops(cfg, shape)
        traced = lower_cell(cell)
        rec["lower_s"] = round(time.time() - t0, 2)
        mem = traced.memory_analysis()
        print(mem)
        for f in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes",
        ):
            rec[f] = int(getattr(mem, f, -1))
        t2 = time.time()
        rec["hlo"] = traced.cost_analysis()
        rec["analyze_s"] = round(time.time() - t2, 2)
        print({k: rec["hlo"][k] for k in ("dot_flops", "collective_bytes",
                                          "hbm_bytes_fused")})
        # sidecar: the op record for offline re-analysis (the roofline
        # re-prices it without re-running the cell)
        side = os.path.join(
            out_dir, f"{arch}__{shape_name}__{mesh_name}{tag}.trace.json.gz"
        )
        with gzip.open(side, "wt") as f:
            json.dump(traced.to_json(), f, separators=(",", ":"))
        rec["fallbacks"] = cell.fallbacks + traced.fallbacks
        rec["peaks"] = traced.peaks
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=20)
    finally:
        rec["total_s"] = round(time.time() - t0, 2)
    return rec


def all_cells():
    from repro_torch.configs import ARCH_NAMES, LM_SHAPES
    from repro_torch.launch import gate_cell

    for arch in ARCH_NAMES:
        for shape in LM_SHAPES:
            yield arch, shape.name
    for shape_name in gate_cell.GATE_SHAPES:
        yield "gate-anns", shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--profile", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells run at once, a subprocess each")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (default cuda, which "
                         "needs a card)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (moe.impl=dropping, "
                         "attn_chunk=512, ...); repeatable")
    args = ap.parse_args(argv)
    check_device(args.device)

    os.makedirs(args.out, exist_ok=True)

    if args.all:
        # one subprocess per cell: isolates memory + failures, and each
        # process holds one fake process group
        cmds = []
        for arch, shape in all_cells():
            for mp in ([False, True] if args.both_meshes else [args.multi_pod]):
                mesh_name = "2x16x16" if mp else "16x16"
                path = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_name}{args.tag}.json"
                )
                if os.path.exists(path):
                    continue
                cmd = [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--out", args.out,
                ]
                if mp:
                    cmd.append("--multi-pod")
                if args.tag:
                    cmd += ["--tag", args.tag]
                for kv in getattr(args, "set"):
                    cmd += ["--set", kv]
                cmd += ["--device", args.device]
                cmds.append((f"{arch} {shape} {mesh_name}", cmd))

        def one(item):
            name, cmd = item
            r = subprocess.run(cmd, capture_output=True, text=True)
            last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() \
                else ""
            print(f"=== {name}\n{last}", flush=True)
            if r.returncode != 0:
                print(r.stdout[-2000:], r.stderr[-2000:], flush=True)
            return r.returncode != 0

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
            failures = sum(pool.map(one, cmds))
        sys.exit(1 if failures else 0)

    rec = run_cell(
        args.arch, args.shape, args.multi_pod, args.out,
        micro=args.micro, profile_kind=args.profile,
        sets=getattr(args, "set"), tag=args.tag, device=args.device,
    )
    mesh_name = rec["mesh"]
    path = os.path.join(
        args.out, f"{args.arch}__{args.shape}__{mesh_name}{args.tag}.json"
    )
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec.get("ok") else "FAIL"
    if rec.get("skipped"):
        status = "SKIP"
    print(
        f"[{status}] {args.arch} {args.shape} {mesh_name} "
        f"({rec.get('total_s')}s) -> {path}"
    )
    if not rec.get("ok"):
        print(rec.get("error"))
        print(rec.get("traceback", "")[-3000:])
        sys.exit(1)


if __name__ == "__main__":
    main()
