"""K7 masked top-k: the port's plain version (what the CUDA kernel is held
to on the card) against the JAX package's TPU kernel in interpret mode
and its lax.top_k reference, on the cases of tests/test_pallas_knn.py plus
a 1500-candidate one.

Tolerances: ``valid`` exact; ``sq`` within rtol 1e-5, as the JAX
package's own kernel-vs-reference test (XLA-CPU contracts
``dx² + dy² + dz²`` into fused multiply-adds, so the JAX side can differ
from IEEE float32 in the last bits); ``nbrs`` exact where valid.  Against
a NumPy float32 evaluation in the kernel's association order the port is
bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.ops import knn as jknn
from fast_limo_tpu_torch.ops import knn


def _case(rng, N=100, C=81, frac=0.7):
    cand = np.float32(rng.normal(size=(N, C, 3)) * 5)
    valid = rng.random((N, C)) > 1 - frac
    q = np.float32(rng.normal(size=(N, 3)) * 5)
    return cand, valid, q


def _numpy_topk(cand, valid, q, k):
    d = cand - q[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    d2 = np.where(valid, d2, np.float32(np.inf))
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    sq = np.take_along_axis(d2, idx, 1)
    return np.take_along_axis(cand, idx[..., None], 1), sq, np.isfinite(sq)


def _cases():
    rng = np.random.default_rng(0)
    out = {"random": (*_case(rng), 5)}
    cand, _, q = _case(rng, N=8)
    out["all_invalid"] = (cand, np.zeros((8, 81), bool), q, 5)
    cand, _, q = _case(rng, N=4)
    few = np.zeros((4, 81), bool)
    few[:, :3] = True
    out["fewer_than_k"] = (cand, few, q, 5)
    out["c1500"] = (*_case(rng, N=64, C=1500, frac=0.3), 64)
    return out


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel_and_reference(name):
    cand, valid, q, k = CASES[name]
    nb, sq, vl = (a.numpy() for a in knn.masked_topk(
        torch.tensor(cand), torch.tensor(valid), torch.tensor(q), k=k))
    assert knn.masked_topk.launches == 0          # CPU tensors: the plain version
    assert nb.shape == (len(q), k, 3) and sq.shape == vl.shape == (len(q), k)
    np.testing.assert_array_equal(vl, np.isfinite(sq))
    assert np.all(np.isinf(sq[~vl]))
    for want in (jknn.masked_topk(jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(q),
                                  k=k, interpret=True),
                 jknn.masked_topk_reference(jnp.asarray(cand), jnp.asarray(valid),
                                            jnp.asarray(q), k=k)):
        wn, ws, wv = (np.asarray(a) for a in want)
        np.testing.assert_array_equal(vl, wv)
        np.testing.assert_allclose(sq[vl], ws[wv], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(nb[vl], wn[wv])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_is_a_stable_float32_sort(name):
    """Bit-equal to NumPy float32 in the kernel's association order, ties
    to the lowest column, invalid tail included."""
    cand, valid, q, k = CASES[name]
    got = knn.masked_topk_reference(torch.tensor(cand), torch.tensor(valid),
                                    torch.tensor(q), k=k)
    for g, w in zip(got, _numpy_topk(cand, valid, q, k)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_ties_go_to_the_lowest_column():
    cand = np.float32([[[0, 2, 0], [1, 0, 0], [0, 1, 0], [3, 0, 0], [0, 0, 1], [2, 0, 0]]])
    valid = np.ones((1, 6), bool)
    valid[0, 1] = False
    nb, sq, vl = knn.masked_topk(torch.tensor(cand), torch.tensor(valid),
                                 torch.zeros((1, 3)), k=4)
    np.testing.assert_array_equal(sq.numpy()[0], [1.0, 1.0, 4.0, 4.0])
    np.testing.assert_array_equal(nb.numpy()[0], cand[0, [2, 4, 0, 5]])


def test_k_beyond_the_candidates_raises():
    cand, valid, q, _ = CASES["random"]
    with pytest.raises(ValueError, match="k = 82"):
        knn.masked_topk(torch.tensor(cand), torch.tensor(valid), torch.tensor(q), k=82)
