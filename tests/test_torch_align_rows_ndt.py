"""The `apps/align.py` twin's --device-loop rows of NDT D2D and P2D against the
JAX package's bodies (tests/torch_align_rows.py: 2 trips on the CPU, each
pose within 1e-3, its iterations within 1).
Also: the rows' jitters are the root app's."""

import pytest

from torch_align_rows import _two_threads, check_row, rows, sides as _sides  # noqa: F401


@pytest.fixture(scope="module")
def sides():
    yield from _sides()


def test_jitters_are_the_root_apps():
    """1e-5 standard-normal twists of default_rng(0) through se3_exp (the
    JAX package's se3_exp within 1e-7)."""
    import jax.numpy as jnp
    import numpy as np

    from fast_gicp_tpu import se3 as jse3
    from fast_gicp_tpu_torch.apps import align as app

    twists = 1e-5 * np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    want = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(t))) for t in twists])
    np.testing.assert_allclose(app.jitters(3), want, atol=1e-7)


@pytest.mark.parametrize("name, col", rows("ndt_d2d", "ndt_p2d"))
def test_device_loop_row_matches_the_jax_body(sides, name, col):
    check_row(sides, name, col)
