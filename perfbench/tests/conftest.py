"""The benchmark's own tests: the checkout's root and ``src`` on the
path, and the tiny cells they run on the CPU."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(config: str, mix: str):
    """A cell dict as ``harness.load_cell`` gives it, from the test data."""
    from perfbench import families
    conf = json.loads((DATA / f"{config}.json").read_text())
    return {"name": f"{config}.{mix}", "chips": 1, "config": conf,
            "family": families.load(conf),
            "mix": json.loads((DATA / f"{mix}.json").read_text()),
            "end_to_end": [{"name": "setup_s", "unit": "s"},
                           {"name": "tokens_per_s", "unit": "tokens/s"},
                           {"name": "ttft_mean_s", "unit": "s"}],
            "per_layer": []}


@pytest.fixture
def cell():
    return tiny_cell
