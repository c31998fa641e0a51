"""K5 and the binners around it: the port's plain compare-exchange network
against a stable argsort and against the JAX package's `_sort_network`
(bit-equal), and the port's K5 binner, counting binner and `_bin_dispatch`
against the JAX package's (bit-equal tables)."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import SplatConfig as JaxSplatConfig
from pixelsynth_tpu.ops.sort_pallas import _LANES, _sort_network
from pixelsynth_tpu_torch.config import SplatConfig
from pixelsynth_tpu_torch.ops import sort_kernel as K5
from pixelsynth_tpu_torch.ops import splat as S
from torch_threads import _few_torch_threads  # noqa: F401

# the package re-exports the function `splat` over the module's name
jax_splat = importlib.import_module("pixelsynth_tpu.ops.splat")


def _keys(case):
    rng = np.random.default_rng(0)
    if case == "dup_heavy_sentinel_tail":
        E = 1 << 14
        keys = rng.integers(0, 500, size=(2, E)).astype(np.int32)
        keys[1, E // 2:] = np.int32(257 << 16)      # constant sentinel tail
    else:                                           # multi-block directions
        keys = rng.integers(0, 1000, size=(1, 1 << 15)).astype(np.int32)
    return keys


@pytest.mark.parametrize("case", ["dup_heavy_sentinel_tail", "multiblock_2^15"])
def test_plain_network_is_the_stable_sort(case):
    keys = _keys(case)
    B, E = keys.shape
    before = K5.PLAIN_CALLS["sort_kv"], K5.LAUNCHES["sort_kv"]
    sk, sv = K5.sort_kv_kernel(torch.as_tensor(keys))     # CPU: the plain network
    assert K5.PLAIN_CALLS["sort_kv"] == before[0] + 1
    assert K5.LAUNCHES["sort_kv"] == before[1]
    assert sk.dtype == sv.dtype == torch.int32
    net = jax.jit(functools.partial(_sort_network, E=E))
    for b in range(B):
        ref = np.argsort(keys[b], kind="stable")
        np.testing.assert_array_equal(sk[b].numpy(), keys[b][ref])
        np.testing.assert_array_equal(sv[b].numpy(), ref)
        jk, jv = net(jnp.asarray(keys[b].reshape(E // _LANES, _LANES)))
        np.testing.assert_array_equal(sk[b].numpy(), np.asarray(jk).reshape(-1))
        np.testing.assert_array_equal(sv[b].numpy(), np.asarray(jv).reshape(-1))


@pytest.mark.parametrize("E", [1 << 20, 1 << 13, 3 << 13])
def test_sort_rejects_sizes_the_kernel_does_not_take(E):
    with pytest.raises(ValueError):
        K5.sort_kv_kernel(torch.zeros((1, E), dtype=torch.int32))


def _points(B=2, N=4096, W=64, seed=1):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-5, W + 5, (B, N)), rng.uniform(-5, W + 5, (B, N)),
                    rng.uniform(0.5, 10.0, (B, N))], -1).astype(np.float32)
    return pts, rng.random((B, N)) < 0.9


def _same_tables(got, want):
    idx, ok = got[0].numpy(), got[1].numpy()
    want_idx, want_ok = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(ok, want_ok)
    # point ids mean something only in valid slots
    np.testing.assert_array_equal(idx[want_ok], want_idx[want_ok])


def test_sort_kernel_binner_matches_jax():
    pts, valid = _points()                                  # E = 4N = 2^14
    kw = dict(max_points_per_tile=2048)
    got = S._bin_points_batched_pallas(torch.as_tensor(pts), torch.as_tensor(valid),
                                       64, SplatConfig(**kw))
    want = jax_splat._bin_points_batched_pallas(jnp.asarray(pts), jnp.asarray(valid),
                                                64, JaxSplatConfig(**kw))
    _same_tables(got, want)
    # and the library-sort binner's tables (both keep 16 depth-bucket bits)
    _same_tables(got, jax_splat._bin_points_batched(
        jnp.asarray(pts), jnp.asarray(valid), 64, JaxSplatConfig(**kw)))


@pytest.mark.parametrize("M", [2048, 64])     # 64: overfull tiles truncate
def test_counting_binner_matches_jax(M):
    pts, valid = _points(N=1500, seed=2)
    cfg, jcfg = SplatConfig(max_points_per_tile=M), JaxSplatConfig(max_points_per_tile=M)
    want = jax.vmap(lambda p, v: jax_splat._bin_points_counting(p, v, 64, jcfg))(
        jnp.asarray(pts), jnp.asarray(valid))
    got = [S._bin_points_counting(torch.as_tensor(p), torch.as_tensor(v), 64, cfg)
           for p, v in zip(pts, valid)]
    got = (torch.stack([g[0] for g in got]), torch.stack([g[1] for g in got]))
    _same_tables(got, want)
    if M == 64:
        assert np.asarray(want[1]).all(-1).any(), "no tile was overfull"


@pytest.mark.parametrize("binning,sort_backend,route", [
    ("argsort", "xla", "batched"),
    ("argsort", "pallas", "sort_kernel"),
    ("counting", "xla", "counting"),
    ("counting", "pallas", "counting"),
])
def test_bin_dispatch_routes_as_jax(binning, sort_backend, route):
    pts, valid = _points()
    kw = dict(max_points_per_tile=2048, binning=binning, sort_backend=sort_backend)
    before = dict(S.BINNER_CALLS)
    sorts = K5.PLAIN_CALLS["sort_kv"]
    got = S._bin_dispatch(torch.as_tensor(pts), torch.as_tensor(valid), 64,
                          SplatConfig(**kw))
    took = {k: S.BINNER_CALLS[k] - before[k] for k in before}
    assert took == {k: int(k == route) for k in before}
    # only the K5 binner goes through the sort wrapper
    assert K5.PLAIN_CALLS["sort_kv"] - sorts == int(route == "sort_kernel")
    want = jax_splat._bin_dispatch(jnp.asarray(pts), jnp.asarray(valid), 64,
                                   JaxSplatConfig(**kw))
    _same_tables(got, want)


def test_bin_dispatch_above_the_kernel_size_takes_the_batch_sort():
    N = K5.MAX_E // 4 + 1
    pts, valid = _points(B=1, N=N, seed=3)
    cfg = SplatConfig(max_points_per_tile=64, sort_backend="pallas")
    before = dict(S.BINNER_CALLS)
    idx, ok = S._bin_dispatch(torch.as_tensor(pts), torch.as_tensor(valid), 64, cfg)
    assert S.BINNER_CALLS["batched"] == before["batched"] + 1
    assert S.BINNER_CALLS["sort_kernel"] == before["sort_kernel"]
    assert idx.shape == ok.shape == (1, 16, 64)


@pytest.mark.parametrize("field,value", [("binning", "radix"), ("sort_backend", "cub"),
                                         ("blend_dtype", "float16")])
def test_splat_raises_on_values_the_port_does_not_implement(field, value):
    pts, valid = _points(B=1, N=64)
    cfg = dataclasses.replace(SplatConfig(), **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        S.splat(torch.as_tensor(pts), torch.ones((1, 64, 3)), torch.as_tensor(valid),
                W=64, cfg=cfg)


def _radix_keys(case):
    rng = np.random.default_rng(7)
    E = 1 << 14
    if case == "dup_heavy_sentinel_tail_B2":
        keys = rng.integers(0, 500, size=(2, E)).astype(np.int64)
        keys[1, E // 2:] = 257 << 16
    elif case == "all_equal":
        keys = np.full((1, E), 12345, np.int64)
    elif case == "negative_and_int32_extremes":
        keys = rng.integers(-2 ** 31, 2 ** 31, size=(1, E), dtype=np.int64)
        keys[0, :4] = [-2 ** 31, 2 ** 31 - 1, 2 ** 31 - 1, -2 ** 31]
        keys[0, 100:200] = -1                     # a run of equal negative keys
    else:                                         # binning-style keys, B = 2
        keys = ((rng.integers(0, 257, size=(2, E)) << 16)
                + rng.integers(0, 1 << 16, size=(2, E))).astype(np.int64)
    return torch.as_tensor(keys.astype(np.int32))


@pytest.mark.parametrize("case", ["dup_heavy_sentinel_tail_B2", "all_equal",
                                  "negative_and_int32_extremes", "binning_keys_B2"])
def test_radix_plain_is_the_stable_sort(case):
    """The CUDA kernel's arithmetic in tensor ops (histogram, scans, stable
    scatter, four 8-bit passes): bit-equal to a stable sort in keys and
    indices, and to the plain network."""
    keys = _radix_keys(case)
    rk, rv = K5.sort_kv_radix_plain(keys)
    assert rk.dtype == rv.dtype == torch.int32
    want_k, want_v = torch.sort(keys, dim=1, stable=True)
    assert torch.equal(rk, want_k)
    assert torch.equal(rv.long(), want_v)
    nk, nv = K5.sort_kv_plain(keys)
    assert torch.equal(rk, nk) and torch.equal(rv, nv)


def test_radix_plain_rejects_sizes_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        K5.sort_kv_radix_plain(torch.zeros((1, 1 << 13), dtype=torch.int32))
