"""The benchmark's CPU tests: run from the checkout's root with
``python -m pytest benchmark/tests -q -p no:cacheprovider``. The harness's
modules and the program are imported as ``benchmark/run.py`` imports them."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)
