"""K9's plain version (fast_limo_tpu_torch/ops/sort) against the JAX
package's sort: the TPU kernel ``sort3_tpu`` in interpret mode on the cases
of tests/test_sort.py, and the XLA sorts ``sort3``/``sort_key_val`` that
the JAX callers run by default at the two sizes of the main path (N =
10000 insert, 32768 voxel).  Every output must be equal element for
element.  The kernel itself (``csrc/sort3.cu``) runs only on the card
(tests/test_torch_cuda.py); here the CPU wrappers must not count launches,
the two callers' orders must be those of the stable int64 packed-key sort
they replaced, no sort width may be refused when the step or the SLAM
engine is built for the card, and the plain version must hold above the
cluster kernel's 2^17 too (the grid kernel's route on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

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


class _CudaOnCpu(TorchFunctionMode):
    """A stood-in card: tensors asked for on a CUDA device are made on the
    CPU, so code that takes its card branches can be built here."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if kwargs.get("device") is not None and torch.device(kwargs["device"]).type == "cuda":
            kwargs["device"] = "cpu"
        return func(*args, **kwargs)


def test_card_builds_take_a_128_beam_scan_and_a_262144_point_rebuild(monkeypatch):
    """No sort width is refused any more when the Localizer or the SLAM
    engine is built for the card: a 128-beam scan (both K9 sorts of a scan
    at 262 144 elements) and a map rebuild of 32 × 8192 points take K9's
    grid route.  The card is stood in for by resolve_device and the CPU."""
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.models.slam import SLAM, LoopConfig
    from fast_limo_tpu_torch.ops import dispatch
    from fast_limo_tpu_torch.utils import presets

    monkeypatch.setattr(dispatch, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)
    cfg = presets.ouster128_cfg()
    assert cfg.tpu.max_points_per_scan == 262144 and cfg.tpu.max_insert_points == 0
    lc = LoopConfig(rebuild_batch=32)
    assert lc.rebuild_batch * max(lc.rebuild_points, lc.icp_points) == 262144
    with _CudaOnCpu():
        assert Localizer(cfg, "cuda").device.type == "cuda"
        assert SLAM(presets.kitti_like_cfg(), lc, device="cuda").device.type == "cuda"
        assert SLAM(cfg, device="cuda").loc.device.type == "cuda"


class _OnCard(torch.Tensor):
    """A CPU tensor that passes the wrappers' device check, for the checks
    that come after it (no kernel is reached)."""

    @property
    def is_cuda(self):
        return True


def test_the_kernel_refuses_no_element_and_a_strided_operand(monkeypatch):
    """``sort._launch`` keeps its checks of type, shape and contiguity and
    takes 1 to 2^31 - 1 elements: an empty sort and a strided view are
    refused before the library is asked for."""
    from fast_limo_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "library", lambda: pytest.fail("the kernel was reached"))
    empty = torch.zeros(0, dtype=torch.int32).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="1 to 2147483647 elements, got 0"):
        sort._launch(empty, empty, empty)
    a = torch.arange(2 * (sort.CLUSTER_MAXN + 1), dtype=torch.int32).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="contiguous"):
        sort._launch(a[::2], a[1::2], a[::2])
    with pytest.raises(ValueError, match="int32"):
        sort._launch(a.long(), a, a)
    # the switch is the largest N measured at which the cluster kernel wins
    # both forms on an H100 (PERF §6): 4096, a single point; the grid kernel
    # wins both forms at 1024 (one tile) and from 10 000 up
    assert sort.MAXN == 2 ** 31 - 1 and sort.CLUSTER_MAXN == 4096


def test_plain_matches_lax_sort_above_the_cluster():
    """At N = 2^18 + 3 (the grid kernel's route on the card) the plain
    version equals ``lax.sort`` over all three operands, for full-range
    keys with INT32_MIN / INT32_MAX, heavy ties and a repeated v, and the
    JAX callers' sorts on their forms."""
    n = (1 << 18) + 3
    rng = np.random.default_rng(n)
    i32 = np.iinfo(np.int32)
    k1 = rng.integers(i32.min, i32.max, n, endpoint=True).astype(np.int32)
    k1[rng.random(n) < 0.2] = i32.max
    k1[rng.random(n) < 0.2] = i32.min
    k2 = rng.integers(-2, 2, n).astype(np.int32)
    v = rng.integers(-3, 3, n).astype(np.int32)
    want = jax.lax.sort((jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v)), num_keys=3)
    _assert_equal(_port(k1, k2, v), want)
    ar = np.arange(n, dtype=np.int32)
    _assert_equal(_port(k1, k2, ar), jsort.sort3(jnp.asarray(k1), jnp.asarray(k2),
                                                 jnp.asarray(ar)))
    got = sort.sort_key_val(torch.tensor(k1), torch.tensor(ar))
    _assert_equal([t.numpy() for t in got], jsort.sort_key_val(jnp.asarray(k1), jnp.asarray(ar)))
