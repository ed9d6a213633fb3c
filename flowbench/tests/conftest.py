"""The harness's tests: run from the checkout's root with
``python -m pytest flowbench/tests -q`` (card tests: add ``-m cuda`` on a
machine with a card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
