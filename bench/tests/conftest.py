"""The benchmark's CPU tests (``python -m pytest bench/tests``): the
harness driven end to end on tiny fixtures with a stand-in card."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch
    torch.set_num_threads(2)
