import sys
from pathlib import Path

# the program under test sits in the checkout's src/
_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
