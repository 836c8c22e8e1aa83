"""The port's GPU spawn-event buffers against the JAX package, on the CPU.

On the CPU ``build_event_buffer`` takes ``event_compact``'s plain version
(the ``torch.sort(stable=True)`` form of events.py:142) and the payload
gather takes ``gather_rows``' plain version; the CUDA kernels against those
plain versions are in ``test_torch_cuda.py``. Every result here is integer
or a moved f32 bit pattern, so every comparison is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_hanabi_tpu.runtime import events as ej
from bevy_hanabi_tpu_torch.ops import rng
from bevy_hanabi_tpu_torch.runtime import events as et
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401


def _emitters(n, seed, active_share=0.05, max_count=4):
    r = np.random.default_rng(seed)
    mask = r.random(n) < active_share
    count = r.integers(0, max_count + 1, n).astype(np.uint32)
    attrs = {
        "position": r.standard_normal((n, 3)).astype(np.float32),
        "age": r.uniform(0.0, 2.0, n).astype(np.float32),
        "particle_counter": r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
    }
    return mask, count, attrs


def _torch(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def _assert_buffers_equal(buf_t, buf_j):
    np.testing.assert_array_equal(buf_t.parent_slot.numpy().astype(np.uint32), np.asarray(buf_j.parent_slot))
    np.testing.assert_array_equal(buf_t.count.numpy().astype(np.uint32), np.asarray(buf_j.count))
    assert buf_t.num_events.dtype == torch.int32
    np.testing.assert_array_equal(buf_t.num_events.numpy(), np.asarray(buf_j.num_events))
    assert sorted(buf_t.payload) == sorted(buf_j.payload)
    for k, v in buf_j.payload.items():
        got = buf_t.payload[k].numpy()
        if got.dtype == np.int64:
            got = got.astype(np.uint32)
        want = np.asarray(v)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("attrs", [("position", "age"), ("position", "age", "particle_counter"), ()])
def test_build_event_buffer_bit_exact(attrs):
    mask, count, all_attrs = _emitters(4096, 1)
    chosen = {k: all_attrs[k] for k in attrs}
    buf_j = ej.build_event_buffer(
        jnp.asarray(mask), jnp.asarray(count), parent_attrs={k: jnp.asarray(v) for k, v in chosen.items()}
    )
    buf_t = et.build_event_buffer(
        torch.from_numpy(mask), _torch(count), parent_attrs={k: _torch(v) for k, v in chosen.items()}
    )
    assert 0 < int(buf_t.num_events) < 4096
    _assert_buffers_equal(buf_t, buf_j)
    assert buf_t.total_spawn_count().dtype == torch.int32
    assert int(buf_t.total_spawn_count()) == int(buf_j.total_spawn_count())


@pytest.mark.parametrize("emitters", [1, 2])
@pytest.mark.parametrize("seed", [2, 3])
def test_channel_emissions_build_the_jax_buffer(emitters, seed):
    # The step's per-channel build: one emitter passes its own (mask,
    # count), several sum their counts; the JAX package always builds
    # counts = sum of where(mask, count, 0) and passes counts > 0
    # (effect.py:663-687). The buffers must be equal bit for bit.
    n = 4096
    emitted_j, emitted_t = [], []
    for k in range(emitters):
        mask, count, attrs = _emitters(n, seed + 10 * k, active_share=0.3)
        emitted_j.append((0, jnp.asarray(mask), jnp.asarray(count)))
        emitted_t.append((0, torch.from_numpy(mask), _torch(count)))
    counts = sum(jnp.where(m, c, 0).astype(jnp.uint32) for _, m, c in emitted_j)
    captured = {k: attrs[k] for k in ("position", "age", "particle_counter")}
    buf_j = ej.build_event_buffer(counts > 0, counts,
                                  parent_attrs={k: jnp.asarray(v) for k, v in captured.items()})
    ((channel, (mask_t, count_t)),) = et.channel_emissions(emitted_t).items()
    assert channel == 0
    if emitters == 1:  # no mask is built: the emitter's own tensors pass through
        assert mask_t is emitted_t[0][1] and count_t is emitted_t[0][2]
    buf_t = et.build_event_buffer(mask_t, count_t,
                                  parent_attrs={k: _torch(v) for k, v in captured.items()})
    assert 0 < int(buf_t.num_events) < n
    _assert_buffers_equal(buf_t, buf_j)


def test_event_compact_plain_is_a_stable_partition():
    mask = torch.tensor([True, False, True, True, False, True])
    count = torch.tensor([2, 3, 0, 1, 0, 7], dtype=rng.U32)
    payload = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    slot, counts, num, words = et.event_compact(mask, count, payload)
    assert slot.tolist() == [0, 3, 5, 1, 2, 4] and int(num) == 3
    assert counts.tolist() == [2, 1, 7, 0, 0, 0]  # zero past num_events
    assert words[:, 0].tolist() == [0, 6, 10, 2, 4, 8]


def _segments(i, n, seed, w=0):
    """[I, N] emitters: segment 0 all inactive, segment 1 (where I > 1)
    all active, the rest 5-60% active; W random payload words a lane."""
    r = np.random.default_rng(seed)
    mask = r.random((i, n)) < r.uniform(0.05, 0.6, (i, 1))
    count = r.integers(0, 5, (i, n)).astype(np.uint32)
    mask[0] = False
    if i > 1:
        mask[1], count[1] = True, r.integers(1, 5, n)
    words = r.integers(-2**31, 2**31, (i, n, w), dtype=np.int64).astype(np.int32)
    return mask, count, words


@pytest.mark.parametrize("i,n,w", [(1, 1000, 3), (2, 512, 0), (5, 513, 13), (3, 1536, 24),
                                   (16, 100, 5)])
def test_event_compact_segmented_plain_equals_vmapped_build(i, n, w):
    """Each row compacted as jax.vmap(build_event_buffer) compacts it, bit
    for bit: N at, above and below 512-lane chunks, W from 0 to 24 words,
    an all-inactive and an all-active segment."""
    mask, count, words = _segments(i, n, 10 + i, w)
    attrs = {"words": jnp.asarray(words)} if w else {}
    buf_j = jax.vmap(ej.build_event_buffer)(jnp.asarray(mask), jnp.asarray(count), attrs)
    slot, counts, num, out = et.event_compact_segmented_plain(
        torch.from_numpy(mask), _torch(count), torch.from_numpy(words))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(buf_j.parent_slot))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(buf_j.count))
    assert num.dtype == torch.int32
    np.testing.assert_array_equal(num.numpy(), np.asarray(buf_j.num_events))
    assert int(num[0]) == 0 and (i == 1 or int(num[1]) == n)
    if w:
        np.testing.assert_array_equal(out.numpy(), np.asarray(buf_j.payload["words"]))
    # and the wrapper on CPU tensors is the plain version
    got = et.event_compact_segmented(torch.from_numpy(mask), _torch(count), torch.from_numpy(words))
    assert all(torch.equal(a, b) for a, b in zip(got, (slot, counts, num, out)))


def test_segmented_build_event_buffer_bit_exact():
    """build_event_buffer over an instanced group's flat lanes: every field
    with its [I] axis, equal to JAX's vmapped build bit for bit."""
    i, n = 4, 600
    mask, count, _ = _segments(i, n, 3)
    _, _, attrs = _emitters(i * n, 4)
    buf_j = jax.vmap(ej.build_event_buffer)(
        jnp.asarray(mask), jnp.asarray(count),
        {k: jnp.asarray(v.reshape((i, n) + v.shape[1:])) for k, v in attrs.items()})
    buf_t = et.build_event_buffer(torch.from_numpy(mask.reshape(-1)), _torch(count.reshape(-1)),
                                  {k: _torch(v) for k, v in attrs.items()}, instances=i)
    np.testing.assert_array_equal(buf_t.num_events.numpy(), np.asarray(buf_j.num_events))
    _assert_buffers_equal(buf_t, buf_j)


def test_event_compact_rejects_what_the_kernel_does_not_take():
    mask = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        et.event_compact(mask, torch.zeros(8, dtype=torch.int32), torch.zeros((8, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        et.event_compact(mask, torch.zeros(8, dtype=rng.U32), torch.zeros((7, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        et.build_event_buffer(mask, torch.zeros(8, dtype=rng.U32), {"x": torch.zeros(8, dtype=torch.float64)})
    with pytest.raises(ValueError, match="shape"):
        et.event_compact_segmented(mask.view(2, 4), torch.zeros((2, 4), dtype=rng.U32),
                                   torch.zeros((2, 3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[I, N, W\]"):
        et.event_compact_segmented(mask.view(2, 4), torch.zeros((2, 4), dtype=rng.U32),
                                   torch.zeros((8, 1), dtype=torch.int32))


def _consume_pair(const_count, seed, n_child=8192, n_parent=4096):
    r = np.random.default_rng(seed)
    mask, count, attrs = _emitters(n_parent, seed, active_share=0.1)
    if const_count:
        count = np.full(n_parent, const_count, np.uint32)
    chosen = {k: attrs[k] for k in ("position", "age", "particle_counter")}
    buf_j = ej.build_event_buffer(
        jnp.asarray(mask), jnp.asarray(count), parent_attrs={k: jnp.asarray(v) for k, v in chosen.items()}
    )
    buf_t = et.build_event_buffer(
        torch.from_numpy(mask), _torch(count), parent_attrs={k: _torch(v) for k, v in chosen.items()}
    )
    # spawn ranks of a child pool: exclusive ranks of its dead lanes
    dead = r.random(n_child) < 0.6
    rank = (np.cumsum(dead) - dead).astype(np.int32)
    return buf_j, buf_t, rank


@pytest.mark.parametrize("const_count", [None, 4])
@pytest.mark.parametrize("attrs", [("position",), ("position", "age", "particle_counter"), None])
def test_consume_events_bit_exact(const_count, attrs):
    buf_j, buf_t, rank = _consume_pair(const_count, 7 if const_count else 8)
    slot_j, total_j, pay_j = ej.consume_events(buf_j, jnp.asarray(rank), attrs=attrs, const_count=const_count)
    slot_t, total_t, pay_t = et.consume_events(buf_t, torch.from_numpy(rank), attrs=attrs, const_count=const_count)
    np.testing.assert_array_equal(slot_t.numpy().astype(np.uint32), np.asarray(slot_j))
    assert total_t.dtype == torch.int32 and int(total_t) == int(total_j) > 0
    assert sorted(pay_t) == sorted(pay_j)
    for k, v in pay_j.items():
        got = pay_t[k].numpy()
        got = got.astype(np.uint32) if got.dtype == np.int64 else got
        np.testing.assert_array_equal(got.view(np.uint32), np.asarray(v).view(np.uint32))


def test_const_count_map_equals_the_general_map():
    # with every count == K the arithmetic rank // K and the boundary-mark
    # prefix sum agree on every rank the events cover
    _, buf_t, rank = _consume_pair(4, 9)
    total = int(buf_t.total_spawn_count())
    rank_t = torch.from_numpy(rank)
    covered = rank_t < total
    a = et.consume_events(buf_t, rank_t, const_count=4)
    b = et.consume_events(buf_t, rank_t)
    assert torch.equal(a[0][covered], b[0][covered])
    assert torch.equal(a[2]["position"][covered], b[2]["position"][covered])


def test_empty_buffer_matches_jax():
    from bevy_hanabi_tpu.models import firework_effect as fw_j
    from bevy_hanabi_tpu_torch.models import firework_effect as fw_t

    buf_j = ej.EventBuffer.empty(64, fw_j(64).particle_layout(), attrs=("position",))
    buf_t = et.EventBuffer.empty(64, fw_t(64).particle_layout(), attrs=("position",), device="cpu")
    _assert_buffers_equal(buf_t, buf_j)
    assert buf_t.capacity == 64 and buf_t.payload["position"].shape == (64, 3)


@pytest.mark.parametrize("with_parent_pool", [True, False])
def test_step_without_payload_matches_jax(with_parent_pool):
    # A payload-less buffer: the child inherits its position from the parent
    # pool at each event's slot (effect.py:573-585), and both packages
    # refuse the step when no parent pool is passed. Positions within rtol
    # 1e-5 (one step of the same f32 ops), masks and seeds bit for bit.
    from bevy_hanabi_tpu.compiler import SimParams as SimJ
    from bevy_hanabi_tpu.models import firework_effect as fw_j
    from bevy_hanabi_tpu.models import firework_trail_effect as trail_j
    from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ
    from bevy_hanabi_tpu.runtime.effect import StepInputs as InputsJ
    from bevy_hanabi_tpu.runtime.pool import ParticlePool as PoolJ
    from bevy_hanabi_tpu_torch import CompiledEffect, ParticlePool, SimParams, StepInputs
    from bevy_hanabi_tpu_torch.models import firework_effect as fw_t
    from bevy_hanabi_tpu_torch.models import firework_trail_effect as trail_t

    n_parent, n_child = 512, 2048
    r = np.random.default_rng(11)
    mask = r.random(n_parent) < 0.2
    count = np.full(n_parent, 4, np.uint32)
    pos = r.standard_normal((n_parent, 3)).astype(np.float32)
    layout_j, layout_t = fw_j(n_parent).particle_layout(), fw_t(n_parent).particle_layout()
    parent_j = PoolJ.create(layout_j, n_parent)
    parent_j.attrs["position"] = jnp.asarray(pos)
    parent_t = ParticlePool.create(layout_t, n_parent, "cpu")
    parent_t.attrs["position"] = torch.from_numpy(pos)

    fx_j = EffectJ(trail_j(n_child), parent_layout=layout_j, parent_const_count=4)
    fx_t = CompiledEffect(trail_t(n_child), "cpu", parent_layout=layout_t, parent_const_count=4)

    def step_j():
        return fx_j.step(
            fx_j.create_pool(), InputsJ.make(0, 5), SimJ(delta_time=0.05),
            events_in=ej.build_event_buffer(jnp.asarray(mask), jnp.asarray(count)),
            parent_pool=parent_j if with_parent_pool else None,
        )

    def step_t():
        return fx_t.step(
            fx_t.create_pool(), StepInputs.make(0, 5), SimParams(delta_time=0.05),
            events_in=et.build_event_buffer(torch.from_numpy(mask), _torch(count)),
            parent_pool=parent_t if with_parent_pool else None,
        )

    if not with_parent_pool:
        for step in (step_j, step_t):
            with pytest.raises(ValueError, match="requires a parent effect"):
                step()
        return
    pool_j, _ = step_j()
    pool_t, _ = step_t()
    attrs_t, alive_t, seed_t, _ = pool_t.to_numpy()
    assert alive_t.sum() == 4 * mask.sum() > 0
    np.testing.assert_array_equal(alive_t, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed_t, np.asarray(pool_j.seed))
    np.testing.assert_allclose(
        attrs_t["position"], np.asarray(pool_j.attrs["position"]), rtol=1e-5, atol=1e-6
    )
    # every spawned trail starts at its rocket (rank // 4 -> event -> slot)
    slot = np.flatnonzero(mask)[np.arange(n_child)[alive_t] // 4]
    assert np.abs(attrs_t["position"][alive_t] - pos[slot]).max() < 0.5
