"""Fixed-shape masking primitives (ops/masking.py) — the fixed-shape
replacement for the reference's dynamic shapes (SURVEY.md §7 hard part 2)."""

import numpy as np
import jax.numpy as jnp

from lobpcg_tpu.ops import masking


def test_as_mask_prefix_and_bool():
    m = masking.as_mask(5, jnp.int32(3))
    np.testing.assert_array_equal(np.asarray(m), [1, 1, 1, 0, 0])
    b = jnp.asarray([True, False, True])
    np.testing.assert_array_equal(np.asarray(masking.as_mask(3, b)),
                                  [1, 0, 1])


def test_blocks_mask():
    m = masking.blocks_mask((2, 3, 2), (2, jnp.int32(1), jnp.int32(0)))
    np.testing.assert_array_equal(np.asarray(m), [1, 1, 1, 0, 0, 0, 0])


def test_mask_and_shift_cols():
    U = jnp.arange(12.0).reshape(3, 4)
    out = masking.shift_cols(U, jnp.int32(1), jnp.int32(2))
    expect = np.zeros((3, 4))
    expect[:, 0] = np.asarray(U)[:, 1]
    expect[:, 1] = np.asarray(U)[:, 2]
    np.testing.assert_array_equal(np.asarray(out), expect)


def test_inject_diag_blocks():
    G = jnp.ones((4, 4))
    out = np.asarray(masking.inject_diag(G, jnp.int32(2), 7.0))
    assert out[0, 0] == 1.0 and out[1, 0] == 1.0
    assert out[2, 2] == 7.0 and out[3, 3] == 7.0
    assert out[2, 0] == 0.0 and out[0, 3] == 0.0


def test_dead_mass_identifies_sentinels():
    # Eigenvector on a dead coordinate has mass 1 there.
    V = jnp.asarray(np.eye(4))
    dm = np.asarray(masking.dead_mass(V, jnp.int32(2)))
    np.testing.assert_allclose(dm, [0, 0, 1, 1])


def test_compact_by_flag_stable():
    drop = jnp.asarray([False, True, False, True, False])
    perm, kept = masking.compact_by_flag(drop)
    assert int(kept) == 3
    np.testing.assert_array_equal(np.asarray(perm), [0, 2, 4, 1, 3])


def test_prefix_count():
    assert int(masking.prefix_count(jnp.asarray([True, True, False, True]))) == 2
    assert int(masking.prefix_count(jnp.asarray([False, True]))) == 0
    assert int(masking.prefix_count(jnp.asarray([True, True]))) == 2
