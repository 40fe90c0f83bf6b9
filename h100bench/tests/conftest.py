"""The benchmark's own tests: ``python -m pytest h100bench/tests -q`` from the
root of the repository. Tests that need a CUDA card carry the ``cuda``
marker and skip, with a reason, where there is none; on the card:
``python -m pytest h100bench/tests -q -m cuda``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where torch sees none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return "cuda:0"


@pytest.fixture(scope="session")
def tiny_mixes():
    """Each cell's traffic cut to a size the CPU runs in seconds."""
    return {"car_model.online_fast": {"streams": 8, "frames": 4, "keep": 3,
                                      "ref_block": 4},
            "config3_multiscale.decode_b64": {"pairs": 2,
                                              "distinct_batches": 2}}
