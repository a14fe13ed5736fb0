"""The port's threefry generator (gpupathtracer_tpu_torch.random) against
jax.random: keys and draws must be bit-identical."""

import jax
import numpy as np
import pytest

from gpupathtracer_tpu_torch import random as trandom

SEEDS = [0, 1, 7, 42, 123456, 2**31 - 1, -1]


def _key_words(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _key_words(jk))
    for num in (2, 3):
        np.testing.assert_array_equal(trandom.split(tk, num).numpy(),
                                      _key_words(jax.random.split(jk, num)))
    for data in (0, 1, 5, 1000, 2**31 - 1):
        np.testing.assert_array_equal(
            trandom.fold_in(tk, data).numpy(),
            _key_words(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1, 2), (7, 2), (1000, 2), (33, 9),
                                   (2048, 9)])
def test_uniform_bitwise(seed, shape):
    # The wavefront's draw pattern: split, then uniform on the subkey.
    jk = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 3))[1]
    tk = trandom.split(trandom.fold_in(trandom.PRNGKey(seed), 3))[1]
    want = np.asarray(jax.random.uniform(jk, shape))
    got = trandom.uniform(tk, shape).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert (got >= 0.0).all() and (got < 1.0).all()
