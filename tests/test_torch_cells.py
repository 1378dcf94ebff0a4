"""Cell assembly (``repro_torch.launch.cells``, ``gate_cell``) and the
parameter specs against ``repro``'s.

``repro``'s side runs in a subprocess with placeholder JAX devices
(``tests/_subproc.py``) built on ``make_host_mesh`` (Auto axes); the
port's in a subprocess of its own on a "fake" process group of the same
size (a process holds one default group).  Sharding specs are compared as
the mesh axes of each tensor dimension, leaf by leaf; byte counts exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ARCH_NAMES, get_config
from tests._subproc import SRC, run_with_devices


def run_port(code: str, timeout: int = 300) -> str:
    """``code`` in a fresh interpreter on the port's path (no JAX flags)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


def last_json(out: str):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("JSON ")][-1][5:])


# ----------------------------------------------------------- param specs
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_repro_at_full_size(arch):
    import jax.numpy as jnp

    from repro.configs import get_config as repro_config
    from repro.models.model import build_model as repro_build
    from repro_torch.models.model import build_model

    ref = repro_build(repro_config(arch)).param_specs()
    got = build_model(get_config(arch)).param_specs()
    assert sorted(got) == sorted(ref)
    for n, s in ref.items():
        assert tuple(got[n].shape) == tuple(s.shape), n
        assert str(got[n].dtype).split(".")[-1] == jnp.dtype(s.dtype).name, n


def test_train_state_specs_read_param_specs():
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import train_state_specs
    from repro_torch.train.optim import adamw

    model = build_model(get_config("gemma-2b"))
    st = train_state_specs(model, adamw())
    assert st["params"] == model.param_specs()
    assert {n: s.shape for n, s in st["opt"]["m"].items()} == {
        n: s.shape for n, s in model.param_specs().items()}


# -------------------------------------------- cells on the 16x16 mesh
REPRO_CELLS = """
import json
import jax
from repro.configs import ARCH_NAMES, LM_SHAPES, get_config, shape_applicable
from repro.launch.cells import build_cell
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh((16, 16))
def spec(s):
    return [list(e) if isinstance(e, tuple) else ([] if e is None else [e])
            for e in s.spec]
out = {}
for arch in ARCH_NAMES:
    for shape in LM_SHAPES:
        cfg = get_config(arch)
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            out[f"{arch}:{shape.name}"] = {"skipped": why}
            continue
        cell = build_cell(cfg, shape, mesh)
        leaves = {}
        for i, tree in enumerate((cell.in_shardings, cell.out_shardings)):
            flat = jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: x is None
                or isinstance(x, jax.sharding.NamedSharding))[0]
            for path, sh in flat:
                if sh is not None:
                    leaves[f"{i}{jax.tree_util.keystr(path)}"] = spec(sh)
        out[f"{arch}:{shape.name}"] = {"leaves": leaves,
                                       "fallbacks": cell.fallbacks}
print("JSON", json.dumps(out))
"""

PORT_CELLS = """
import json
from torch.distributed.tensor import Shard
from repro_torch.launch.dryrun import init_fake_world
init_fake_world(256)
from repro_torch.configs import ARCH_NAMES, LM_SHAPES, get_config, shape_applicable
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh
mesh = make_production_mesh(device="cpu")
names = mesh.mesh_dim_names
def walk(shard, path, out):
    if shard is None:
        return
    if isinstance(shard, tuple) and len(shard) == 2 and hasattr(
            shard[0], "mesh_dim_names"):
        pl = shard[1]
        nd = max([p.dim + 1 for p in pl if isinstance(p, Shard)] or [0])
        out[path] = [[names[i] for i, p in enumerate(pl)
                      if isinstance(p, Shard) and p.dim == d]
                     for d in range(nd)]
        return
    items = shard.items() if isinstance(shard, dict) else enumerate(shard)
    for k, s in items:
        walk(s, path + (f"['{k}']" if isinstance(shard, dict) else f"[{k}]"),
             out)
out = {}
for arch in ARCH_NAMES:
    for shape in LM_SHAPES:
        cfg = get_config(arch)
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            out[f"{arch}:{shape.name}"] = {"skipped": why}
            continue
        cell = build_cell(cfg, shape, mesh)
        leaves = {}
        walk(cell.in_shardings, "0", leaves)
        walk(cell.out_shardings, "1", leaves)
        out[f"{arch}:{shape.name}"] = {"leaves": leaves,
                                       "fallbacks": cell.fallbacks}
print("JSON", json.dumps(out))
"""


@pytest.fixture(scope="module")
def production_cells():
    ref = last_json(run_with_devices(REPRO_CELLS, n_devices=256, timeout=600))
    got = last_json(run_port(PORT_CELLS, timeout=600))
    return ref, got


def _trim(spec):
    while spec and spec[-1] == []:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cells_on_the_16x16_mesh_shard_as_repro(production_cells, arch):
    """Every (arch, shape) cell: the same skips, the same leaves, the same
    mesh axes on every dimension of every leaf, the same fallbacks."""
    ref, got = production_cells
    keys = [k for k in ref if k.startswith(arch + ":")]
    assert len(keys) == 4 and sorted(keys) == sorted(
        k for k in got if k.startswith(arch + ":"))
    for k in keys:
        a, b = ref[k], got[k]
        assert a.get("skipped") == b.get("skipped"), k
        if "skipped" in a:
            continue
        assert b["fallbacks"] == a["fallbacks"], k
        assert sorted(b["leaves"]) == sorted(a["leaves"]), k
        for leaf, spec in a["leaves"].items():
            assert _trim(b["leaves"][leaf]) == _trim(spec), (k, leaf)


# ------------------------------------------------------------ gate cells
@pytest.mark.parametrize("n_devices", [256, 512])
@pytest.mark.parametrize("shape", ["search_1b", "search_rag"])
def test_gate_model_flops_match_repro(shape, n_devices):
    from repro.launch import gate_cell as ref
    from repro_torch.launch import gate_cell

    assert dataclasses.asdict(gate_cell.GATE_SHAPES[shape]) == \
        dataclasses.asdict(ref.GATE_SHAPES[shape])
    assert gate_cell.gate_model_flops(shape, n_devices) == \
        ref.gate_model_flops(shape, n_devices)


# ------------------------------------------- small cells, traced on 2x2
SMALL = ("train_4k", "prefill_32k", "decode_32k", "gate")

REPRO_SMALL = """
import dataclasses, json
from repro.configs import get_reduced
from repro.configs.base import ShapeSpec
from repro.launch import gate_cell
from repro.launch.cells import build_cell, lower_cell
from repro.launch.hlo_analysis import analyze_compiled
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh((2, 2))
cfg = get_reduced("llama3-8b")
gs = gate_cell.GATE_SHAPES["search_1b"]
gate_cell.GATE_SHAPES["tiny"] = dataclasses.replace(
    gs, name="tiny", n_total=4096, d=32, R=8, batch=16, beam_width=8,
    num_hops=8, k=4)
out = {}
for name in %r:
    if name == "gate":
        cell = gate_cell.build_gate_cell("tiny", mesh)
    else:
        kind = name.split("_")[0]
        cell = build_cell(cfg, ShapeSpec(name, kind, 128, 8), mesh,
                          num_microbatches=2)
    with mesh:
        compiled = lower_cell(cell).compile()
    h = analyze_compiled(compiled)
    out[name] = {
        "argument_size_in_bytes":
            compiled.memory_analysis().argument_size_in_bytes,
        "dot_flops": h["dot_flops"], "collective_bytes": h["collective_bytes"],
        "collectives": h["collectives"]}
print("JSON", json.dumps(out))
""" % (SMALL,)

PORT_SMALL = """
import dataclasses, json
from repro_torch.launch.dryrun import init_fake_world
init_fake_world(4)
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import gate_cell
from repro_torch.launch.cells import build_cell, lower_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import roofline_row
from repro_torch.models.model import model_flops_per_step
mesh = make_host_mesh((2, 2), device="cpu")
cfg = get_reduced("llama3-8b")
gs = gate_cell.GATE_SHAPES["search_1b"]
gate_cell.GATE_SHAPES["tiny"] = dataclasses.replace(
    gs, name="tiny", n_total=4096, d=32, R=8, batch=16, beam_width=8,
    num_hops=8, k=4)
out = {}
for name in %r:
    if name == "gate":
        cell = gate_cell.build_gate_cell("tiny", mesh)
        mf = gate_cell.gate_model_flops("tiny", 4)
    else:
        kind = name.split("_")[0]
        shape = ShapeSpec(name, kind, 128, 8)
        cell = build_cell(cfg, shape, mesh, num_microbatches=2)
        mf = model_flops_per_step(cfg, shape)
    tr = lower_cell(cell)
    mem = tr.memory_analysis()
    rec = {"arch": "x", "shape": name, "mesh": "2x2", "n_devices": 4,
           "model_flops": mf, "hlo": tr.cost_analysis(),
           **dataclasses.asdict(mem)}
    row = roofline_row(rec)
    out[name] = {"argument_size_in_bytes": mem.argument_size_in_bytes,
                 "dot_flops": rec["hlo"]["dot_flops"],
                 "collective_bytes": rec["hlo"]["collective_bytes"],
                 "collectives": rec["hlo"]["collectives"],
                 "useful_ratio": row["useful_ratio"],
                 "fallbacks": cell.fallbacks + tr.fallbacks}
print("JSON", json.dumps(out))
""" % (SMALL,)


@pytest.fixture(scope="module")
def small_cells():
    ref = last_json(run_with_devices(REPRO_SMALL, n_devices=4, timeout=600))
    got = last_json(run_port(PORT_SMALL, timeout=600))
    return ref, got


@pytest.mark.parametrize("name", SMALL)
def test_small_cells_hold_repros_argument_bytes(small_cells, name):
    """The reduced llama3-8b cells (seq 128, batch 8, 2 microbatches) and
    the tiny gate cell on a (2, 2) mesh: argument bytes a device equal
    ``repro``'s compiled ``argument_size_in_bytes`` exactly; the traced
    FLOPs cover the useful ones (useful_ratio ≤ 1).  FLOPs and collective
    bytes are printed beside ``repro``'s HLO counts, not gated: GSPMD and
    DTensor choose different collectives, and ``mesh_all_gather`` gathers
    one mesh dimension at a time."""
    ref, got = small_cells
    a, b = ref[name], got[name]
    print(name, "port", b["dot_flops"], b["collective_bytes"],
          b["collectives"], "repro", a["dot_flops"], a["collective_bytes"],
          a["collectives"], "fallbacks", b["fallbacks"])
    assert b["argument_size_in_bytes"] == a["argument_size_in_bytes"]
    if name == "prefill_32k":
        # prefill computes logits at the last position only, while the
        # analytic count charges the LM head (2·d·V a token) at every one:
        # in both packages the traced FLOPs fall short of it by that head
        from repro_torch.configs import get_reduced

        cfg = get_reduced("llama3-8b")
        head = 2.0 * cfg.d_model * cfg.vocab_size * 8 * 127 / 4
        assert b["dot_flops"] == a["dot_flops"]
        assert b["dot_flops"] >= b["dot_flops"] * b["useful_ratio"] - head
    else:
        assert 0 < b["useful_ratio"] <= 1.0


# ------------------------------------ the sharded train steps on 4x4
REPRO_TRAIN44 = """
import json, sys
from repro.configs import get_reduced
from repro.configs.base import ShapeSpec
from repro.launch.cells import build_cell, lower_cell
from repro.launch.hlo_analysis import analyze_compiled
from repro.launch.mesh import make_host_mesh
c = json.loads(sys.argv[1])
mesh = make_host_mesh(tuple(c["mesh"]))
cfg = get_reduced(c["arch"])
if c["vocab_size"]:
    cfg = cfg.with_(vocab_size=c["vocab_size"])
cell = build_cell(cfg, ShapeSpec("train_4k", "train", c["seq"], c["batch"]),
                  mesh, num_microbatches=c["micro"])
with mesh:
    compiled = lower_cell(cell).compile()
m = compiled.memory_analysis()
print("JSON", json.dumps({
    "temp_size_in_bytes": m.temp_size_in_bytes,
    "argument_size_in_bytes": m.argument_size_in_bytes,
    "collective_bytes": analyze_compiled(compiled)["collective_bytes"]}))
"""
TRAIN44_ARCHS = ("llama3-8b", "zamba2-1.2b")


@pytest.fixture(scope="module", params=TRAIN44_ARCHS)
def train44(request):
    """One of ``chip_smoke.py``'s phase-16 train cells (16 x 128 tokens in
    2 microbatches on a 4x4 mesh: the reduced llama3-8b at vocab 16,384,
    the reduced zamba2-1.2b): ``repro`` compiled on 16 placeholder devices
    on ``make_host_mesh((4, 4))``, the port's ``TRAIN44_PRICING`` on a fake
    16-rank group."""
    sys.path.insert(0, os.path.dirname(SRC))
    import chip_smoke

    arch = request.param
    c = json.dumps({"arch": arch,
                    "vocab_size": chip_smoke.TRAIN44_CELLS[arch]["vocab_size"],
                    **chip_smoke.TRAIN44_SHAPE})
    ref = last_json(run_with_devices(
        f"import sys; sys.argv[1:] = [{c!r}]\n" + REPRO_TRAIN44,
        n_devices=16))
    got = last_json(run_port(
        f"import sys; sys.argv[1:] = [{c!r}, 'cpu']\n"
        + chip_smoke.TRAIN44_PRICING))
    return chip_smoke, arch, ref, got


def test_train_cell_4x4_temp_within_1_5x_of_repros(train44):
    """The port's sharded train step allocates at most 1.5x the temp
    bytes a device of ``repro``'s compiled step (the vocab-parallel cross
    entropy and embedding keep each rank at its own rows and vocabulary
    shard; each layer gathers its weights' FSDP shards), with the
    arguments equal."""
    smoke, arch, ref, got = train44
    print(arch, "port", got["temp_size_in_bytes"], got["collective_bytes"],
          "repro", ref["temp_size_in_bytes"], ref["collective_bytes"])
    assert got["argument_size_in_bytes"] == ref["argument_size_in_bytes"]
    assert got["temp_size_in_bytes"] <= \
        smoke.TRAIN44_TEMP_RATIO * ref["temp_size_in_bytes"]
    assert smoke.TRAIN44_TEMP_RATIO == 1.5


def test_train_cell_4x4_holds_no_whole_vocabulary(train44):
    """No op of the cell's record makes a buffer whose last dimension is
    the whole vocabulary (16,384 for llama3-8b)."""
    _, _, _, got = train44
    assert got["whole_vocab_ops"] == []


def test_train_cell_4x4_repro_temp_is_the_smokes_constant(train44):
    """The card's machine has no JAX, so phase 16 holds the port to
    constants: ``repro``'s compiled temp bytes for each cell, pinned
    here."""
    smoke, arch, ref, _ = train44
    assert ref["temp_size_in_bytes"] == smoke.TRAIN44_CELLS[arch]["repro_temp"]
