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
from repro_torch.launch.roofline import product_flops, roofline_row
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
        mf = product_flops(cfg, shape)
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
        # each layer's FSDP shards gathered at use, as the loss path
        # gathers them (each rank's own heads and MLP columns): the port's
        # products are ``repro``'s, FLOP for FLOP
        assert b["dot_flops"] == a["dot_flops"]
    assert 0 < b["useful_ratio"] <= 1.0


# ------------------------------------ the sharded train steps on 4x4
REPRO_TRAIN44 = """
import dataclasses, json, sys
from repro.configs import get_reduced
from repro.configs.base import ShapeSpec
from repro.launch.cells import build_cell, lower_cell
from repro.launch.hlo_analysis import analyze_compiled
from repro.launch.mesh import make_host_mesh
c = json.loads(sys.argv[1])
mesh = make_host_mesh(tuple(c["mesh"]))
cfg = get_reduced(c["arch"]).with_(**c.get("config", {}))
if c.get("moe"):
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **c["moe"]))
if c["vocab_size"]:
    cfg = cfg.with_(vocab_size=c["vocab_size"])
kind = c.get("kind", "train")
cell = build_cell(cfg, ShapeSpec(f"{kind}_44", kind, c["seq"], c["batch"]),
                  mesh, num_microbatches=c.get("micro"))
with mesh:
    compiled = lower_cell(cell).compile()
m = compiled.memory_analysis()
h = analyze_compiled(compiled)
print("JSON", json.dumps({
    "temp_size_in_bytes": m.temp_size_in_bytes,
    "argument_size_in_bytes": m.argument_size_in_bytes,
    "collective_bytes": h["collective_bytes"],
    "dot_flops": h["dot_flops"]}))
"""
TRAIN44_ARCHS = ("llama3-8b", "zamba2-1.2b", "rwkv6-1.6b",
                 "qwen2-moe-a2.7b")


@pytest.fixture(scope="module", params=TRAIN44_ARCHS)
def train44(request):
    """One of ``chip_smoke.py``'s phase-16 train cells (16 x 128 tokens in
    2 microbatches on a 4x4 mesh: the reduced llama3-8b at vocab 16,384,
    the reduced zamba2-1.2b and rwkv6-1.6b, the reduced qwen2-moe-a2.7b's
    dropping dispatch at vocab 16,384): ``repro`` compiled on 16
    placeholder devices on ``make_host_mesh((4, 4))``, the port's
    ``CELL44_PRICING`` on a fake 16-rank group."""
    sys.path.insert(0, os.path.dirname(SRC))
    import chip_smoke

    arch = request.param
    c = json.dumps(chip_smoke.cell44_jobs()[f"train44:{arch}"])
    ref = last_json(run_with_devices(
        f"import sys; sys.argv[1:] = [{c!r}]\n" + REPRO_TRAIN44,
        n_devices=16))
    got = last_json(run_port(
        f"import sys; sys.argv[1:] = [{c!r}, 'cpu']\n"
        + chip_smoke.CELL44_PRICING))
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
    """No op of the cell's record makes a buffer with the whole vocabulary
    as a dimension (16,384 for llama3-8b; the reduced configs' own as the
    last dimension, where other dimensions share its size)."""
    _, _, _, got = train44
    assert got["whole_vocab_ops"] == []


def test_train_cell_4x4_collectives_and_dots_near_repros(train44):
    """The cell's collective bytes a device at most 1.5x ``repro``'s
    compiled ones and its dot FLOPs at most the cell's ``dot_ratio`` times
    (1.1x; zamba2-1.2b 1.5x, whose reduced widths make the Mamba backward
    the CPU's torch runs whole on every "model" rank a large share; rwkv6's
    decay LoRA runs on the heads the scan reads, where its 1.124x on this
    CPU ran it whole: ROADMAP C15).  At the parent the attention's
    K / V and the scans' inputs were gathered to the global batch and the
    time and Mamba mixes' pending sums settled as sequence shards: llama3
    41.5 MB against 33.7 (dots 1.18x), rwkv6 40.1 MB against 20.4 (dots
    1.39x), zamba2 115.9 MB against 25.6 (this CPU's DTensor, which swaps
    all-to-all for all-gather + chunk)."""
    smoke, arch, ref, got = train44
    c = smoke.TRAIN44_CELLS[arch]
    print(arch, "port", got["collective_bytes"], got["dot_flops"],
          "repro", ref["collective_bytes"], ref["dot_flops"])
    assert got["collective_bytes"] <= \
        smoke.TRAIN44_COLL_RATIO * ref["collective_bytes"]
    assert got["dot_flops"] <= c["dot_ratio"] * ref["dot_flops"]
    assert smoke.TRAIN44_COLL_RATIO == 1.5
    assert c["dot_ratio"] == {"zamba2-1.2b": 1.5}.get(arch, 1.1)


def test_train_cell_4x4_replicates_no_op_of_the_dispatch(train44):
    """No op of a train cell is rescued by ``ReplicateFallback`` (its
    fallbacks hold no ``op/`` entry): qwen2-moe's dropping dispatch sorts,
    scatters and combines each "data" rank's own group on plain tensors,
    where at the parent its sort's ``searchsorted`` and its scatter had no
    DTensor strategy and the cell died (``IndexError`` from the handler of
    the scatter's message-less ``AssertionError``)."""
    _, arch, _, got = train44
    assert not [f for f in got["fallbacks"] if f.startswith("op/")], \
        got["fallbacks"]


def test_train_cell_4x4_repro_temp_is_the_smokes_constant(train44):
    """The card's machine has no JAX, so phase 16 holds the port to
    constants: ``repro``'s compiled temp bytes, collective bytes and dot
    FLOPs for each cell, pinned here."""
    smoke, arch, ref, _ = train44
    c = smoke.TRAIN44_CELLS[arch]
    assert ref["temp_size_in_bytes"] == c["repro_temp"]
    assert ref["collective_bytes"] == c["repro_coll"]
    assert ref["dot_flops"] == c["repro_dot"]


@pytest.fixture(scope="module")
def decode44():
    """``chip_smoke.py``'s phase-16 decode cell (the reduced llama3-8b at
    vocab 16,384, 16 rows of a 128-slot cache on a 4x4 mesh): ``repro``
    compiled on 16 placeholder devices, the port's ``CELL44_PRICING`` on a
    fake 16-rank group."""
    sys.path.insert(0, os.path.dirname(SRC))
    import chip_smoke

    c = json.dumps({"arch": "llama3-8b",
                    **chip_smoke.DECODE44_CELLS["llama3-8b"],
                    **chip_smoke.DECODE44_SHAPE})
    ref = last_json(run_with_devices(
        f"import sys; sys.argv[1:] = [{c!r}]\n" + REPRO_TRAIN44,
        n_devices=16))
    got = last_json(run_port(
        f"import sys; sys.argv[1:] = [{c!r}, 'cpu']\n"
        + chip_smoke.CELL44_PRICING))
    return chip_smoke, ref, got


def test_decode_cell_4x4_gathers_no_whole_table(decode44):
    """The decode step's lookup and LM head keep the vocabulary sharded:
    no op makes a buffer with the whole vocabulary as a dimension (at the
    parent, DTensor's lookup gathered the (16384, 32) table), and its
    collective bytes are at most 1.5x ``repro``'s compiled ones (the
    parent: the table and the caches gathered whole, 3.5x)."""
    smoke, ref, got = decode44
    print("port", got["collective_bytes"], got["collectives"],
          "repro", ref["collective_bytes"])
    assert got["whole_vocab_ops"] == []
    assert got["collective_bytes"] <= \
        smoke.TRAIN44_COLL_RATIO * ref["collective_bytes"]
    assert ref["collective_bytes"] == \
        smoke.DECODE44_CELLS["llama3-8b"]["repro_coll"]


# --------------------------- the dropping dispatch's cells, traced on 2x2
DROPPING_ARCHS = ("mixtral-8x22b", "qwen2-moe-a2.7b")

DROPPING_SMALL = """
import dataclasses, json
%s
mesh = make_host_mesh((2, 2)%s)
out = {}
for arch in %r:
    cfg = get_reduced(arch)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, impl="dropping"))
    cell = build_cell(cfg, ShapeSpec("train_4k", "train", 128, 8), mesh,
                      num_microbatches=2)
    out[arch] = {"fallbacks": cell.fallbacks, **lower(cell)}
print("JSON", json.dumps(out))
"""
REPRO_DROPPING = DROPPING_SMALL % ("""
from repro.configs import get_reduced
from repro.configs.base import ShapeSpec
from repro.launch.cells import build_cell, lower_cell
from repro.launch.hlo_analysis import analyze_compiled
from repro.launch.mesh import make_host_mesh
def lower(cell):
    with mesh:
        compiled = lower_cell(cell).compile()
    h = analyze_compiled(compiled)
    return {"argument_size_in_bytes":
                compiled.memory_analysis().argument_size_in_bytes,
            "dot_flops": h["dot_flops"],
            "collective_bytes": h["collective_bytes"]}""", "", DROPPING_ARCHS)
PORT_DROPPING = DROPPING_SMALL % ("""
from repro_torch.launch.dryrun import init_fake_world
init_fake_world(4)
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.cells import build_cell, lower_cell
from repro_torch.launch.mesh import make_host_mesh
def lower(cell):
    tr = lower_cell(cell)
    h = tr.cost_analysis()
    return {"argument_size_in_bytes":
                tr.memory_analysis().argument_size_in_bytes,
            "dot_flops": h["dot_flops"],
            "collective_bytes": h["collective_bytes"],
            "op_fallbacks": tr.fallbacks}""", ', device="cpu"', DROPPING_ARCHS)


@pytest.fixture(scope="module")
def dropping_cells():
    ref = last_json(run_with_devices(REPRO_DROPPING, n_devices=4,
                                     timeout=600))
    got = last_json(run_port(PORT_DROPPING, timeout=600))
    return ref, got


@pytest.mark.parametrize("arch", DROPPING_ARCHS)
def test_dropping_train_cell_lowers_on_the_small_mesh(dropping_cells, arch):
    """The reduced MoE train cells with ``moe.impl=dropping`` (seq 128,
    batch 8, 2 microbatches on a (2, 2) mesh: 2 groups of 2 rows a
    microbatch) lower with ``--device cpu``, where at the parent they
    raised: no op is rescued by replication, the arguments are
    ``repro``'s to the byte, the dot FLOPs at most 1.1x ``repro``'s
    compiled ones and the collective bytes at most 1.5x (this CPU's
    DTensor swaps all-to-all for all-gather + chunk)."""
    ref, got = dropping_cells
    a, b = ref[arch], got[arch]
    print(arch, "port", b["dot_flops"], b["collective_bytes"], "repro",
          a["dot_flops"], a["collective_bytes"], "fallbacks",
          b["fallbacks"], b["op_fallbacks"])
    assert b["op_fallbacks"] == []
    assert b["fallbacks"] == a["fallbacks"]
    assert b["argument_size_in_bytes"] == a["argument_size_in_bytes"]
    assert b["dot_flops"] <= 1.1 * a["dot_flops"]
    assert b["collective_bytes"] <= 1.5 * a["collective_bytes"]


EMPTY_MESSAGE = """
import json, torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.cells import ReplicateFallback
from repro_torch.launch.dryrun import init_fake_world
from repro_torch.launch.mesh import make_host_mesh
init_fake_world(4)
mesh = make_host_mesh((2, 2), device="cpu")
rows = DTensor.from_local(torch.ones(2, 3), mesh, (Shard(0), Replicate()),
                          run_check=False)

# an op (add's schema: no view) whose sharding fails on a sharded input
# with a message-less AssertionError, as DTensor's index put did on the
# dropping dispatch's scatter
class NoStrategy:
    _schema = torch.ops.aten.add.Tensor._schema

    def __call__(self, t):
        if any(p.is_shard() for p in t.placements):
            raise AssertionError()
        return t + 1

    def __str__(self):
        return "no_strategy"

fallbacks = []
out = ReplicateFallback(fallbacks).__torch_dispatch__(
    NoStrategy(), (DTensor,), (rows,))
print("JSON", json.dumps({"fallbacks": fallbacks, "placements": [
    type(p).__name__ for p in out.placements]}))
"""


def test_an_op_failing_without_a_message_is_named_by_its_type():
    """An op whose sharding fails with an empty message (DTensor's
    ``AssertionError()`` on an index put) runs replicated and is recorded
    with its exception's type as the reason; at the parent the handler
    raised ``IndexError`` on the empty message's first line, which named
    no op."""
    got = last_json(run_port(EMPTY_MESSAGE))
    assert got["placements"] == ["Replicate", "Replicate"]
    assert got["fallbacks"] == [
        "op/no_strategy: no sharding for its inputs (AssertionError); "
        "replicated"]
