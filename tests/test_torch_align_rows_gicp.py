"""The `apps/align.py` twin's --device-loop rows of FastGICP (kNN and adaptive covariances) against the
JAX package's bodies (tests/torch_align_rows.py: 2 trips on the CPU, each
pose within 1e-3, its iterations within 1)."""

import pytest

from torch_align_rows import _two_threads, check_row, rows, sides as _sides  # noqa: F401


@pytest.fixture(scope="module")
def sides():
    yield from _sides()


@pytest.mark.parametrize("name, col", rows("fgicp", "fgicp_adaptive"))
def test_device_loop_row_matches_the_jax_body(sides, name, col):
    check_row(sides, name, col)
