"""build.gate_s: GATE's own build on the NSG, the sum of the program's
stage timers ``t_hubs``, ``t_topo``, ``t_samples``, ``t_train`` and
``t_nav``."""
MOVES = "setup_s"


def read(run):
    return run.build.get("gate_s")
