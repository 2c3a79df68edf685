"""GPU-only checks: chip_smoke.py's phases at small sizes.

They need an NVIDIA GPU, so under the CPU test configuration
(conftest.py) they skip; `python chip_smoke.py` runs the same phases at
full size on the card.
"""

import jax
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")


def test_stencil_1d(gpu):
    cs.check_stencil_1d(1 << 16, 64, window=256)


def test_stencil_3d(gpu):
    cs.check_stencil_3d((24, 20, 16), 8)


def test_bsr(gpu):
    cs.check_bsr(1 << 14, 8, 16, 12)


def test_well_solve(gpu):
    cs.solve_well(16384, 8, 16)


def test_laplacian_3d_both_operators(gpu):
    cs.solve_laplacian_3d(12, 10, 16)
