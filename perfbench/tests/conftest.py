import sys
from pathlib import Path

# the port, for the tests that drive it on the CPU
_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
