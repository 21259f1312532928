"""K9's plain version (fast_limo_tpu_torch/ops/sort) against the JAX
package's sort: the TPU kernel ``sort3_tpu`` in interpret mode on the cases
of tests/test_sort.py, and the XLA sorts ``sort3``/``sort_key_val`` that
the JAX callers run by default at the two sizes of the main path (N =
10000 insert, 32768 voxel).  Every output must be equal element for
element.  The kernel itself (``csrc/sort3.cu``) runs only on the card
(tests/test_torch_cuda.py); here the CPU wrappers must not count launches,
and the two callers' orders must be those of the stable int64 packed-key
sort they replaced."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.ops import sort as jsort
from fast_limo_tpu_torch.ops import sort, voxel

I32_MAX = np.int32(0x7FFFFFFF)


def _port(k1, k2, v):
    return [t.numpy() for t in sort.sort3(torch.tensor(k1), torch.tensor(k2), torch.tensor(v))]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n", [128, 256, 1000, 2048])
def test_plain_matches_tpu_kernel(n):
    rng = np.random.default_rng(11)
    k1 = rng.integers(0, 50, n).astype(np.int32)      # many duplicate keys
    k2 = rng.integers(0, 7, n).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    want = jsort.sort3_tpu(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v), interpret=True)
    _assert_equal(_port(k1, k2, v), want)


def test_sentinel_sorts_last():
    rng = np.random.default_rng(11)
    n = 700                                            # the kernels pad to 1024
    k1 = rng.integers(0, 100, n).astype(np.int32)
    k1[rng.random(n) < 0.3] = I32_MAX                  # the invalid convention
    k2 = rng.integers(0, 1 << 20, n).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    want = jsort.sort3_tpu(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v), interpret=True)
    got = _port(k1, k2, v)
    _assert_equal(got, want)
    assert got[0].shape == (n,) and (got[0][-int((k1 == I32_MAX).sum()):] == I32_MAX).all()


def test_negative_keys():
    rng = np.random.default_rng(11)
    n = 512
    k1 = rng.integers(-1000, 1000, n).astype(np.int32)
    k2 = rng.integers(-3, 3, n).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    want = jsort.sort3_tpu(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v), interpret=True)
    _assert_equal(_port(k1, k2, v), want)
    _assert_equal(_port(k1, k2, v), jsort.sort3(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v)))


@pytest.mark.parametrize("n", [10000, 32768])
def test_plain_matches_xla_sorts_at_path_sizes(n):
    """The insert's triple (group, packed voxel, index) and the voxel
    downsample's (key, index) at the main path's sizes."""
    rng = np.random.default_rng(n)
    g = rng.integers(0, 8192, n).astype(np.int32)
    g[rng.random(n) < 0.2] = I32_MAX
    packed = rng.integers(0, 1 << 30, n).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    _assert_equal(_port(g, packed, v), jsort.sort3(jnp.asarray(g), jnp.asarray(packed),
                                                   jnp.asarray(v)))
    key = (rng.integers(0, 64, n) << 20).astype(np.int32)
    key[rng.random(n) < 0.3] = I32_MAX
    got = sort.sort_key_val(torch.tensor(key), torch.tensor(v))
    _assert_equal([t.numpy() for t in got],
                  jsort.sort_key_val(jnp.asarray(key), jnp.asarray(v)))


def test_plain_is_exact_for_repeated_v():
    """The plain version sorts by all three operands, so a non-unique v
    (which the kernel's network also sorts exactly) gives the same multiset
    order as numpy's lexsort."""
    rng = np.random.default_rng(3)
    n = 3000
    k1, k2, v = (rng.integers(-4, 4, n).astype(np.int32) for _ in range(3))
    order = np.lexsort((v, k2, k1))
    _assert_equal(_port(k1, k2, v), (k1[order], k2[order], v[order]))


def test_callers_keep_the_stable_packed_key_order():
    """voxel_downsample's and insert's K9 orders are those of the stable
    int64 sorts they replaced (the outputs stay bit-identical)."""
    rng = np.random.default_rng(5)
    n = 4096
    pts = torch.tensor(rng.uniform(-60, 60, (n, 3)).astype(np.float32))
    valid = torch.tensor(rng.random(n) < 0.9)
    vc = voxel.floor_div(pts, 1.0).to(torch.int64)
    key = torch.where(valid, voxel.pack_key(vc), torch.full_like(vc[:, 0], 0x7FFFFFFF))
    idx = torch.arange(n, dtype=torch.int32)
    assert torch.equal(sort.sort_key_val(key.to(torch.int32), idx)[1].long(),
                       torch.sort(key, stable=True)[1])
    g = torch.where(valid, torch.tensor(rng.integers(0, 512, n)), torch.full((n,), 0x7FFFFFFF))
    want = torch.sort((g << 30) | voxel.pack_key(vc), stable=True)[1]
    got = sort.sort3(g.to(torch.int32), voxel.pack_key(vc).to(torch.int32), idx)[2]
    assert torch.equal(got.long(), want)


def test_cpu_tensors_launch_nothing_and_the_kernel_refuses_them():
    n0 = sort.sort3.launches
    k = torch.tensor([3, 1, 2], dtype=torch.int32)
    assert sort.sort3(k, k, k)[0].tolist() == [1, 2, 3]
    assert sort.sort_key_val(k, k)[1].tolist() == [1, 2, 3]
    assert sort.sort3.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        sort._launch(k, k, k)


def test_card_builds_refuse_sorts_above_the_cap(monkeypatch):
    """A scan or a SLAM map rebuild larger than the kernel's MAXN is refused
    when the Localizer or the SLAM engine is built on the card, not at the
    first scan's sort.  The card is stood in for by resolve_device, so the
    refusal must come before anything touches it."""
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.models.slam import SLAM, LoopConfig
    from fast_limo_tpu_torch.ops import dispatch
    from fast_limo_tpu_torch.utils import presets

    sort.require_fits(sort.MAXN, "n")
    with pytest.raises(ValueError, match="at most"):
        sort.require_fits(sort.MAXN + 1, "n")
    monkeypatch.setattr(dispatch, "resolve_device", lambda device: torch.device("cuda"))
    cfg = presets.kitti_like_cfg()
    cfg.tpu.max_points_per_scan = 2 * sort.MAXN         # a 128-beam scan
    with pytest.raises(ValueError, match="max_points_per_scan = 262144"):
        Localizer(cfg, "cuda")
    with pytest.raises(ValueError, match="max_points_per_scan"):
        SLAM(cfg, device="cuda")
    cfg.tpu.max_points_per_scan = 32768
    with pytest.raises(ValueError, match="rebuild_points = 139264"):
        SLAM(cfg, LoopConfig(rebuild_batch=17), device="cuda")
