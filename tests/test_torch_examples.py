"""The port's four examples (``examples/*_torch.py``), each run at a cut
size as a subprocess with ``--device cpu``: it exits 0, loads no ``repro``
or ``jax`` module, and prints its figures on a ``RESULT`` line.

Held against ``repro`` where the two packages compute the same thing from
the same seeds: the quickstart's NSG baseline (the same graph at this size,
searched from the medoid) has ``repro``'s recall and mean hops exactly.
The towers, the LM weights and the train state are drawn by each
package's own generator, so GATE's recall is held to the quality bound
``tests/test_torch_gate_index.py`` pins (within 0.02 of the baseline's or
better), the distributed search to its single-process composition bit
for bit (``tests/test_torch_distributed_search.py`` holds that
composition to ``repro``'s), and the crashed and restarted training run
to an uninterrupted one bit for bit (``tests/test_torch_fault.py`` holds
the resume and the data pipeline to ``repro``'s).
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from tests._subproc import SRC, run_with_devices

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(SRC)
RUN = """
import json, runpy, sys
sys.argv = {argv!r}
runpy.run_path({path!r}, run_name="__main__")
print("LOADED", json.dumps(sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("repro", "jax",
                                                         "jaxlib"))))
"""


def run_example(name: str, *args: str, timeout: int = 300) -> dict:
    """The example's RESULT, after checking it exited 0 and loaded neither
    package."""
    path = os.path.join(ROOT, "examples", name)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    # one thread, as this process runs (``one_torch_thread``): the parallel
    # test workers share the host's cores, and the train example's bits
    # are held to a run here
    env["OMP_NUM_THREADS"] = "1"
    code = RUN.format(argv=[path, "--device", "cpu", *args], path=path)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    lines = r.stdout.splitlines()
    loaded = json.loads([ln for ln in lines if ln.startswith("LOADED ")][-1][7:])
    assert loaded == [], loaded
    return json.loads([ln for ln in lines if ln.startswith("RESULT ")][-1][7:])


QUICK = dict(n=400, train=64, eval=32, beam=16)
REPRO_BASELINE = """
import json
import jax.numpy as jnp, numpy as np
from repro.data.synthetic import make_database, train_eval_query_split
from repro.graphs.knn import exact_knn, recall_at_k
from repro.graphs.nsg import build_nsg
from repro.graphs.params import SearchParams
from repro.graphs.search import batched_search
c = {c!r}
db, _ = make_database("sift10m-like", c["n"], seed=0)
_, eq = train_eval_query_split(db, c["train"], c["eval"])
nsg = build_nsg(db, R=32, knn_k=32, search_l=64, pool_size=96)
true_ids, _ = exact_knn(eq, db, 10)
res = batched_search(
    jnp.asarray(db), jnp.asarray(nsg.neighbors), jnp.asarray(eq),
    jnp.full((len(eq), 1), nsg.enter_id, jnp.int32),
    params=SearchParams(k=10, beam_width=c["beam"], max_hops=4 * c["beam"]))
print("JSON", json.dumps([recall_at_k(np.asarray(res.ids), true_ids, 10),
                          float(np.asarray(res.hops).mean())]))
"""


def test_quickstart_example_has_repros_baseline_and_gates_quality():
    c = QUICK
    got = run_example("quickstart_torch.py", "--n", str(c["n"]),
                      "--train-queries", str(c["train"]),
                      "--eval-queries", str(c["eval"]), "--hubs", "8",
                      "--epochs", "10", "--beams", str(c["beam"]))
    out = run_with_devices(REPRO_BASELINE.format(c=c), n_devices=1)
    want = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("JSON ")][-1][5:])
    assert got["beams"] == [c["beam"]]
    assert [got["nsg_recall"][0], got["nsg_hops"][0]] == want
    assert got["gate_recall"][0] >= got["nsg_recall"][0] - 0.02
    assert got["loss_last"] < got["loss_first"]


def test_distributed_example_is_its_single_process_composition():
    got = run_example("distributed_search_torch.py", "--devices", "4",
                      "--n", "1024", "--queries", "16")
    assert got["ranks_agree"] and got["equal_single_process"]
    assert got["recall"] == got["recall_single_process"]
    assert len(got["ids0"]) == 10 and len(set(got["ids0"])) == 10
    assert got["recall"] >= 0.5


def test_rag_example_retrieves_and_generates():
    from repro_torch.configs import get_reduced

    got = run_example("rag_serve_torch.py", "--batch", "2", "--db-size",
                      "300", "--new-tokens", "4", "--history", "64",
                      "--hubs", "8", "--epochs", "10")
    V = get_reduced("gemma-2b").vocab_size
    ids, toks = np.asarray(got["retrieved"]), np.asarray(got["tokens"])
    assert ids.shape == (2, 4) and toks.shape == (2, got["steps"])
    assert got["steps"] == 4 and got["logits_finite"]
    assert all(len(set(r)) == 4 for r in ids.tolist())
    assert ids.min() >= 0 and ids.max() < 300
    assert toks.min() >= 0 and toks.max() < V
    assert got["retrieval_recall"] >= 0.5


TRAIN = dict(steps=12, batch=4, seq=32, micro=2, crash=7, every=5)


def _uninterrupted(c) -> tuple:
    """The example's composition without the runner or the crash."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import make_train_state, make_train_step
    from repro_torch.train.optim import adamw

    cfg = get_reduced("llama3-8b")
    model = build_model(cfg)
    optim = adamw(lr=1e-3, warmup=20, total_steps=c["steps"])
    step_fn = make_train_step(model, optim, num_microbatches=c["micro"])
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, c["seq"], c["batch"]))
    state = make_train_state(model, optim,
                             torch.Generator().manual_seed(0), device="cpu")
    losses = []
    for step in range(c["steps"]):
        state, m = step_fn(state, pipe.batch(step))
        losses.append(float(m["loss"]))
    return losses, float(sum(p.double().sum()
                             for p in state["params"].values()))


def test_train_example_survives_its_crash_on_the_same_bits():
    c = TRAIN
    got = run_example("train_lm_torch.py", "--steps", str(c["steps"]),
                      "--batch", str(c["batch"]), "--seq", str(c["seq"]),
                      "--micro", str(c["micro"]), "--crash-at",
                      str(c["crash"]), "--ckpt-every", str(c["every"]))
    assert got["restarts"] == 1 and got["final_step"] == c["steps"]
    losses, digest = _uninterrupted(c)
    assert got["losses"] == losses
    assert got["params_sum"] == digest
    assert got["losses"][-1] < got["losses"][0]
