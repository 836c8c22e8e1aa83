"""Parity of the port's ops (PCG, compaction, linalg) with the JAX package.

Inputs are made from a seed with numpy and fed to both packages. Integer
results must match bit for bit: both implement the same uint32 recipe (the
port in masked int64). The float helpers are exact f32 broadcast math in
the same op order, so they must match bit for bit too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_hanabi_tpu.ops import compaction as cj
from bevy_hanabi_tpu.ops import linalg as lj
from bevy_hanabi_tpu.ops import rng as rj
from bevy_hanabi_tpu_torch.ops import compaction as ct
from bevy_hanabi_tpu_torch.ops import linalg as lt
from bevy_hanabi_tpu_torch.ops import rng as rt


def _seeds(n=4096, seed=0):
    s = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    s[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    return s.astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_pcg_hash_bit_exact():
    s = _seeds()
    np.testing.assert_array_equal(
        rt.pcg_hash(_t(s)).numpy().astype(np.uint32), np.asarray(rj.pcg_hash(jnp.asarray(s)))
    )


def test_initial_seed_bit_exact():
    idx = np.arange(4096, dtype=np.uint32)
    spawner = np.uint32(0xDEADBEEF)
    got = rt.initial_seed(_t(idx), int(spawner)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(rj.initial_seed(idx, spawner)))


def test_to_float01_bit_exact():
    s = _seeds(seed=1)
    got = rt.to_float01(_t(s)).numpy()
    want = np.asarray(rj.to_float01(jnp.asarray(s)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_rand_vec_bit_exact(count):
    s = _seeds(seed=2 + count)
    seed_t, v_t = rt.rand_vec(_t(s), count)
    seed_j, v_j = rj.rand_vec(jnp.asarray(s), count)
    np.testing.assert_array_equal(seed_t.numpy().astype(np.uint32), np.asarray(seed_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_rand_uniform_bit_exact():
    s = _seeds(seed=9)
    _, v_t = rt.rand_uniform(_t(s), torch.tensor(-2.0), torch.tensor(3.0), 3)
    _, v_j = rj.rand_uniform(jnp.asarray(s), jnp.float32(-2.0), jnp.float32(3.0), 3)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("n", [1, 1000, 8192, 12289])
def test_exclusive_rank_bit_exact(n):
    # 8192 takes the JAX package's blocked [B, 4096] form; the port is flat.
    mask = np.random.default_rng(n).random(n) < 0.37
    got = ct.exclusive_rank(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(cj.exclusive_rank(jnp.asarray(mask))))


def _mats(seed=0):
    r = np.random.default_rng(seed)
    m = r.standard_normal((4, 4)).astype(np.float32)
    m[3] = [0.0, 0.0, 0.0, 1.0]
    return m, r.standard_normal((4, 4)).astype(np.float32), r.standard_normal((257, 3)).astype(np.float32)


def test_mat4_mul_and_mvp_w_bit_exact():
    a, b, p = _mats()
    ab = lt.mat4_mul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ab.numpy(), np.asarray(lj.mat4_mul(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        lt.mvp_w(ab, torch.from_numpy(p)).numpy(),
        np.asarray(lj.mvp_w(jnp.asarray(ab.numpy()), jnp.asarray(p))),
    )


def test_rotate3_affine3_bit_exact():
    a, _, p = _mats(1)
    rot, tr = a[:3, :3], a[:3, 3]
    np.testing.assert_array_equal(
        lt.affine3(torch.from_numpy(p), torch.from_numpy(rot), torch.from_numpy(tr)).numpy(),
        np.asarray(lj.affine3(jnp.asarray(p), jnp.asarray(rot), jnp.asarray(tr))),
    )


def test_affine4_inv_matches_jax_and_inverts():
    a, _, _ = _mats(2)
    a[:3, :3] += 3.0 * np.eye(3, dtype=np.float32)  # well conditioned
    got = lt.affine4_inv(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(lj.affine4_inv(jnp.asarray(a))))
    np.testing.assert_allclose(got @ a, np.eye(4), atol=1e-5)


def test_no_tf32_matmuls():
    # TF32 is the Hopper form of the bf16-MXU bug (ops/linalg.py): the port
    # uses broadcast math and never turns TF32 on.
    import bevy_hanabi_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("n", [1, 1000, 8192, 12289])
def test_inclusive_sum_bit_exact(n):
    # 8192 takes the JAX package's blocked [B, 4096] form; the port is flat.
    x = np.random.default_rng(n + 1).integers(0, 9, n).astype(np.int32)
    got = ct.inclusive_sum(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(cj.inclusive_sum(jnp.asarray(x))))


@pytest.mark.parametrize("n,out_size", [(1000, None), (8192, None), (4096, 100)])
def test_compact_indices_bit_exact(n, out_size):
    mask = np.random.default_rng(n + 2).random(n) < 0.3
    idx_t, count_t = ct.compact_indices(torch.from_numpy(mask), out_size)
    idx_j, count_j = cj.compact_indices(jnp.asarray(mask), out_size)
    assert idx_t.dtype == torch.int32 and int(count_t) == int(count_j)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
