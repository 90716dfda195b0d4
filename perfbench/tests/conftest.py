"""The benchmark's tests: CPU tests of the harness at tiny sizes, and tests
marked ``gpu`` that skip without a CUDA device.  From the repository root:

    python -m pytest -p no:cacheprovider perfbench/tests            # CPU
    python -m pytest -p no:cacheprovider -m gpu perfbench/tests     # card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)
