"""build.nsg_s: the NSG build's seconds, ``GateIndex.build_report["t_nsg"]``
(the program's stage timer, up to a device sync)."""
MOVES = "setup_s"


def read(run):
    return run.build.get("nsg_s")
