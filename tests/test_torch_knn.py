"""Port parity: the streaming selection ``ops/knn.patch_select`` and ``knn``
against the JAX package's, on the same numpy-seeded inputs.

kNN mode: the same ids and pad masks exactly, and the squared distances
within ``tests/test_knn.py``'s tolerance (rtol 1e-4, atol 1e-5): the
expansion ``|q|^2 - 2 q.p + |p|^2`` cancels, and XLA and PyTorch sum the
cross term in different orders. Ball mode: JAX's priorities
(``uniform(fold_in(key, chunk))``) injected into the port give the same
selection exactly; with the port's own generator, every
selected point lies in the ball, once, and in-ball points are picked
uniformly (``tests/test_knn.py``'s checks of the JAX function)."""

import numpy as np
import pytest
import torch
from scipy import spatial

from points2surf_tpu_torch.ops import knn as tk

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from points2surf_tpu.ops import knn as jk  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,n_valid,b,k,chunk", [
    (5000, 5000, 17, 32, 1024),  # tests/test_knn.py's case
    (256, 100, 4, 8, 64),  # padding rows
    (64, 5, 3, 8, 64),  # fewer valid points than k
    (1000, 1000, 9, 16, 300)])  # a ragged last chunk
def test_knn_matches_jax(rng, n, n_valid, b, k, chunk):
    pts = rng.randn(n, 3).astype(np.float32)
    q = rng.randn(b, 3).astype(np.float32)
    want = jk.patch_select(jnp.asarray(pts), jnp.asarray(q), n_valid, k,
                           chunk=chunk)
    got = tk.patch_select(_t(pts), _t(q), n_valid, k, chunk=chunk)
    ids, sqd, pad = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[2].numpy(), pad)
    np.testing.assert_array_equal(got[0].numpy()[~pad], ids[~pad])
    np.testing.assert_allclose(got[1].numpy(), sqd, rtol=1e-4, atol=1e-5)
    i, d, p = tk.knn(_t(pts), _t(q), n_valid, k, chunk=chunk)
    ji, jd, jp = (np.asarray(w) for w in jk.knn(
        jnp.asarray(pts), jnp.asarray(q), n_valid, k, chunk=chunk))
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_array_equal(i.numpy()[~jp], ji[~jp])
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-4, atol=1e-5)


def test_knn_matches_kdtree(rng):
    pts = rng.randn(5000, 3).astype(np.float32)
    q = rng.randn(17, 3).astype(np.float32)
    ids, dists, pad = tk.knn(_t(pts), _t(q), 5000, 32, chunk=1024)
    assert bool((torch.diff(dists, dim=1) >= -1e-6).all())  # ascending
    ref_d, ref_i = spatial.cKDTree(pts).query(q, 32)
    assert not pad.any()
    np.testing.assert_allclose(dists.numpy(), ref_d, rtol=1e-4, atol=1e-5)
    assert (np.sort(ids.numpy(), 1) == np.sort(ref_i, 1)).mean() > 0.999


@pytest.mark.parametrize("n,n_valid,r,chunk", [(2048, 2048, 0.15, 512),
                                               (700, 650, 0.3, 256)])
def test_ball_matches_jax_with_its_priorities(rng, n, n_valid, r, chunk):
    pts = rng.rand(n, 3).astype(np.float32)
    q = rng.rand(5, 3).astype(np.float32)
    key = jax.random.key(1)
    want = jk.patch_select(jnp.asarray(pts), jnp.asarray(q), n_valid, k=16,
                           radius=r, key=key, chunk=chunk, use_ball=True)

    def priorities(ci, shape):
        return _t(jax.random.uniform(jax.random.fold_in(key, ci), shape))

    got = tk.patch_select(_t(pts), _t(q), n_valid, 16, radius=r,
                          priorities=priorities, chunk=chunk, use_ball=True)
    ids, sqd, pad = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[2].numpy(), pad)
    np.testing.assert_array_equal(got[0].numpy()[~pad], ids[~pad])
    np.testing.assert_allclose(got[1].numpy(), sqd, rtol=1e-4, atol=1e-5)


def test_ball_with_a_generator(rng):
    pts = rng.rand(512, 3).astype(np.float32)
    q = np.full((1, 3), 0.5, np.float32)
    r = 0.3
    in_ball = np.nonzero(np.linalg.norm(pts - q, axis=1) <= r)[0]
    assert len(in_ball) > 40
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(512)
    n_trials = 300
    for _ in range(n_trials):
        ids, sqd, pad = tk.patch_select(_t(pts), _t(q), 512, 8, radius=r,
                                        priorities=gen, chunk=128,
                                        use_ball=True)
        sel = ids.numpy()[0][~pad.numpy()[0]]
        assert len(set(sel.tolist())) == len(sel) == 8
        np.testing.assert_allclose(
            np.sqrt(sqd.numpy()[0]), np.linalg.norm(pts[sel] - q[0], axis=1),
            atol=1e-5)
        counts[sel] += 1
    expected = 8.0 / len(in_ball)
    assert abs(counts[in_ball].mean() / n_trials - expected) < 0.2 * expected
    assert counts[np.setdiff1d(np.arange(512), in_ball)].sum() == 0
    with pytest.raises(ValueError, match="priorities"):
        tk.patch_select(_t(pts), _t(q), 512, 8, radius=r, use_ball=True)
