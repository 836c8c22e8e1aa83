"""GPU spawn-event buffers (port of ``bevy_hanabi_tpu/runtime/events.py``).

Parent→child dataflow without atomics: a parent's step compacts its
emitting lanes into a fixed-capacity :class:`EventBuffer` that carries a
**payload** — the emitting particles' attributes captured at emission — and
the child's next step maps each of its spawn ranks to an event and inherits
from the payload, never from the live parent pool.

The compaction is the hand-written CUDA kernel :func:`event_compact`
(``csrc/event_compact.cu``), a stable partition that replaces the JAX
package's stable multi-operand ``lax.sort`` (events.py:124-159); its plain
version, :func:`event_compact_plain`, is the ``torch.sort(stable=True)``
form and runs for CPU tensors. The payload's row gather on the consume side
goes through :func:`~..ops.gather.gather_rows` on the card.

``parent_slot`` and ``count`` are uint32 in the JAX package; here they are
int64 tensors holding the uint32 values, as every uint32 of the port
(:mod:`..ops.rng`). The kernel moves the payload as 32-bit words (an f32
payload travels as its bit pattern), so the buffer equals the JAX
package's bit for bit.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..cuda_build import Kernel
from ..cuda_build import check_tensor as _check
from ..cuda_build import current_stream as _stream
from ..ops import rng
from ..ops.compaction import inclusive_sum
from ..ops.gather import gather_rows

__all__ = [
    "EventBuffer",
    "build_event_buffer",
    "channel_emissions",
    "consume_events",
    "event_index",
    "event_compact",
    "event_compact_plain",
    "event_compact_segmented",
    "event_compact_segmented_plain",
    "KERNELS",
]

_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): rng.U32,
    np.dtype(np.bool_): torch.bool,
}


class EventBuffer:
    """Compacted spawn events for one child channel.

    parent_slot: int64[cap] — pool slot of the emitting parent particle (uint32 value)
    count:       int64[cap] — particles to spawn per event (uint32, 0 past num_events)
    num_events:  int32[]     — valid prefix length (a device scalar)
    payload:     dict name → [cap, ...] — parent attributes at emission time
    """

    def __init__(self, parent_slot, count, num_events, payload=None):
        self.parent_slot = parent_slot
        self.count = count
        self.num_events = num_events
        self.payload: Dict[str, torch.Tensor] = payload or {}

    @property
    def capacity(self) -> int:
        return int(self.parent_slot.shape[-1])

    def to(self, device) -> "EventBuffer":
        """The buffer on ``device`` (itself where it already lies there)."""
        return EventBuffer(
            self.parent_slot.to(device),
            self.count.to(device),
            self.num_events.to(device),
            {k: v.to(device) for k, v in self.payload.items()},
        )

    @staticmethod
    def concat(parts, device) -> "EventBuffer":
        """The buffers of a sharded pool's shards as one buffer on ``device``
        (effect.py:697-750): each shard's compacted prefix stays in place,
        so zero-count gaps separate the prefixes; ``parent_slot`` must
        already be global and ``num_events`` is the total."""
        return EventBuffer(
            torch.cat([b.parent_slot.to(device) for b in parts]),
            torch.cat([b.count.to(device) for b in parts]),
            torch.stack([b.num_events.to(device) for b in parts]).sum(dtype=torch.int32),
            {k: torch.cat([b.payload[k].to(device) for b in parts]) for k in parts[0].payload},
        )

    def stacked(self, instances: int) -> "EventBuffer":
        """The buffer repeated on a leading [I] instance axis (an instanced
        group's channel that no modifier emits on, as JAX's vmap broadcasts
        it)."""

        def stack(t):
            return t.expand((instances,) + tuple(t.shape)).contiguous()

        return EventBuffer(stack(self.parent_slot), stack(self.count), stack(self.num_events),
                           {k: stack(v) for k, v in self.payload.items()})

    def total_spawn_count(self) -> torch.Tensor:
        """Device scalar: total child particles requested (int32)."""
        return torch.sum(self.count, dtype=torch.int32)

    @staticmethod
    def empty(capacity: int, layout=None, attrs=None, *, device) -> "EventBuffer":
        """Empty buffer on ``device``; pass the parent ParticleLayout to shape
        the payload. ``attrs`` (optional name tuple) restricts the payload to
        those attributes — it must match the emitting effect's
        ``payload_attrs``."""
        payload = {}
        if layout is not None:
            for a in layout.storage_attributes():
                if attrs is not None and a.name not in attrs:
                    continue
                shape = (capacity,) if a.lanes == 1 else (capacity, a.lanes)
                payload[a.name] = torch.zeros(
                    shape, dtype=_TORCH_DTYPE[np.dtype(a.np_dtype)], device=device
                )
        return EventBuffer(
            torch.zeros((capacity,), dtype=rng.U32, device=device),
            torch.zeros((capacity,), dtype=rng.U32, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            payload,
        )


# ---------------------------------------------------------------------------
# the compaction kernel
# ---------------------------------------------------------------------------


def event_compact_plain(mask, count, payload):
    """Plain version of :func:`event_compact`: the stable sort on the
    inactive flag of events.py:142, carrying slot, count and payload."""
    active = mask & (count > 0)
    order = torch.sort((~active).to(torch.int32), stable=True).indices
    counts = torch.where(active, count, 0)
    return order, counts[order], torch.sum(active, dtype=torch.int32), payload[order]


@functools.lru_cache(maxsize=None)
def _chunk_lanes() -> int:
    """Lanes a CTA of either kernel scans at once: the scratch holds a word
    (``event_compact``) or a pair (``event_compact_segmented``) for each
    such chunk (at most one CTA a chunk)."""
    return cuda_build.library().hanabi_event_compact_chunk()


@cuda_build.on_tensor_device
def event_compact(mask, count, payload):
    """Stable partition of the event lanes of one channel.

    ``mask`` bool [n], ``count`` int64 [n] (uint32 values), ``payload``
    int32 [n, W] words. Returns ``(slot int64 [n], count int64 [n],
    num_events int32 [], payload int32 [n, W])``: active lanes (``mask``
    and ``count > 0``) first in lane order, then the inactive lanes in lane
    order, with ``count`` zeroed past ``num_events``."""
    dev = mask.device
    n = mask.shape[0]
    _check(mask, "mask", torch.bool, (n,), dev)
    _check(count, "count", rng.U32, (n,), dev)
    if payload.dim() != 2:
        raise ValueError(f"payload must be [n, W], got shape {tuple(payload.shape)}")
    _check(payload, "payload", torch.int32, (n, payload.shape[1]), dev)
    if not mask.is_cuda:
        return event_compact_plain(mask, count, payload)
    W = payload.shape[1]
    slot = torch.empty((n,), dtype=torch.int64, device=dev)
    counts = torch.empty((n,), dtype=torch.int64, device=dev)
    num_events = torch.empty((), dtype=torch.int32, device=dev)
    words = torch.empty((n, W), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(1, -(-n // _chunk_lanes())),), dtype=torch.int32, device=dev)
    code = cuda_build.library().hanabi_event_compact(
        mask.data_ptr(), count.data_ptr(), payload.data_ptr(), slot.data_ptr(),
        counts.data_ptr(), words.data_ptr(), num_events.data_ptr(), scratch.data_ptr(),
        n, W, _stream(),
    )
    cuda_build.check(code, "event_compact")
    event_compact.launches += 1
    return slot, counts, num_events, words


event_compact.launches = 0


def event_compact_segmented_plain(mask, count, payload):
    """Plain version of :func:`event_compact_segmented`: each row of
    ``[I, N]`` stably sorted on its inactive flag, as ``jax.vmap`` of
    events.py:142 sorts it."""
    active = mask & (count > 0)
    order = torch.sort((~active).to(torch.int32), dim=-1, stable=True).indices
    counts = torch.gather(torch.where(active, count, 0), 1, order)
    words = torch.gather(payload, 1, order[:, :, None].expand(payload.shape))
    return order, counts, torch.sum(active, dim=-1, dtype=torch.int32), words


@cuda_build.on_tensor_device
def event_compact_segmented(mask, count, payload):
    """I independent stable partitions of N event lanes, one launch.

    ``mask`` bool [I, N], ``count`` int64 [I, N] (uint32 values),
    ``payload`` int32 [I, N, W] words. Returns ``(slot int64 [I, N], count
    int64 [I, N], num_events int32 [I], payload int32 [I, N, W])``: each
    row as :func:`event_compact` compacts one array, slots the lane's index
    in its row.

    On the card, one launch over the 512-lane chunks of every row. Rows of
    at most 8 chunks (N <= 4096): one CTA a chunk and one thread block
    cluster a row, whose CTAs read each other's chunk counts from shared
    memory after a cluster barrier. Longer rows: one cooperative launch
    whose resident grid walks runs of chunks numbered row by row (a run may
    cross rows, a row may span many CTAs); each CTA publishes its active
    counts in the first and last row of its run to a scratch pair and,
    after one grid barrier, reads the pairs of the CTAs that share those
    rows (not a word a chunk), so the scratch holds one int2 a chunk at
    most and needs no memset."""
    dev = mask.device
    if mask.dim() != 2:
        raise ValueError(f"mask must be [I, N], got shape {tuple(mask.shape)}")
    i, n = mask.shape
    _check(mask, "mask", torch.bool, (i, n), dev)
    _check(count, "count", rng.U32, (i, n), dev)
    if payload.dim() != 3:
        raise ValueError(f"payload must be [I, N, W], got shape {tuple(payload.shape)}")
    _check(payload, "payload", torch.int32, (i, n, payload.shape[2]), dev)
    if not mask.is_cuda:
        return event_compact_segmented_plain(mask, count, payload)
    W = payload.shape[2]
    slot = torch.empty((i, n), dtype=torch.int64, device=dev)
    counts = torch.empty((i, n), dtype=torch.int64, device=dev)
    num_events = torch.empty((i,), dtype=torch.int32, device=dev)
    words = torch.empty((i, n, W), dtype=torch.int32, device=dev)
    chunks = i * max(1, -(-n // _chunk_lanes()))
    scratch = torch.empty((max(1, chunks), 2), dtype=torch.int32, device=dev)
    code = cuda_build.library().hanabi_event_compact_segmented(
        mask.data_ptr(), count.data_ptr(), payload.data_ptr(), slot.data_ptr(),
        counts.data_ptr(), words.data_ptr(), num_events.data_ptr(), scratch.data_ptr(), i, n, W,
        _stream(),
    )
    cuda_build.check(code, "event_compact_segmented")
    event_compact_segmented.launches += 1
    return slot, counts, num_events, words


event_compact_segmented.launches = 0

KERNELS = {
    "event_compact": Kernel(
        event_compact,
        event_compact_plain,
        "bevy_hanabi_tpu_torch/csrc/event_compact.cu",
        "bevy_hanabi_tpu/runtime/events.py:124",
    ),
    # the same sort under the instance axis's jax.vmap (runtime/instanced.py:53)
    "event_compact_segmented": Kernel(
        event_compact_segmented,
        event_compact_segmented_plain,
        "bevy_hanabi_tpu_torch/csrc/event_compact.cu",
        "bevy_hanabi_tpu/runtime/events.py:124",
    ),
}


# ---------------------------------------------------------------------------
# build / consume
# ---------------------------------------------------------------------------


def _to_words(arr: torch.Tensor) -> torch.Tensor:
    """An attribute as int32 words [n, lanes] (f32 bit patterns, uint32 wrapped)."""
    a2 = arr[:, None] if arr.dim() == 1 else arr
    if a2.dtype == torch.float32:
        return a2.view(torch.int32)
    if a2.dtype == torch.int32:
        return a2
    if a2.dtype == rng.U32:
        return torch.where(a2 >= 2**31, a2 - 2**32, a2).to(torch.int32)
    raise TypeError(f"event payloads carry 32-bit attributes, got {a2.dtype}")


def _from_words(words: torch.Tensor, ndim: int, dtype) -> torch.Tensor:
    if dtype == torch.float32:
        out = words.view(torch.float32)
    elif dtype == rng.U32:
        out = words.to(torch.int64) & 0xFFFFFFFF
    else:
        out = words
    return out[:, 0] if ndim == 1 else out


def build_event_buffer(
    mask: torch.Tensor,
    count: torch.Tensor,
    parent_attrs: Dict[str, torch.Tensor] = None,
    instances: int = 0,
) -> EventBuffer:
    """Compact per-particle (mask, count) into a dense event list.

    Replaces the reference's atomicAdd append (generated
    ``append_spawn_events_N``, lib.rs:977-994). ``parent_attrs`` (the
    emitting particles' current attribute arrays) are packed into one
    int32 word matrix and compacted alongside as the event payload by the
    same :func:`event_compact` launch. ``instances`` I > 0: the lanes are
    an instanced group's flat ``[I*N]`` lanes, each instance compacted on
    its own by one :func:`event_compact_segmented` launch, and every field
    of the buffer gains a leading [I] axis (JAX's vmapped build)."""
    n = mask.shape[-1]
    schema = []
    cols = []
    for name, arr in (parent_attrs or {}).items():
        words = _to_words(arr)
        schema.append((name, arr.dim(), words.shape[1], arr.dtype))
        cols.append(words)
    if cols:
        payload = torch.cat(cols, dim=1)
    else:
        payload = torch.empty((n, 0), dtype=torch.int32, device=mask.device)
    mask, count = mask.contiguous(), rng.as_u32(count).contiguous()
    if instances:
        per = n // instances
        slot, counts, num_events, words = event_compact_segmented(
            mask.view(instances, per), count.view(instances, per),
            payload.reshape(instances, per, payload.shape[1]).contiguous())
        words = words.view(n, words.shape[2])
    else:
        slot, counts, num_events, words = event_compact(mask, count, payload.contiguous())
    out = {}
    off = 0
    for name, nd, w, dtype in schema:
        col = _from_words(words[:, off : off + w], nd, dtype)
        out[name] = col.reshape((instances, -1) + tuple(col.shape[1:])) if instances else col
        off += w
    return EventBuffer(slot, counts, num_events, out)


def channel_emissions(emitted) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Each event channel's ``(mask, count)`` from a step's emissions, the
    ``(channel, mask, count)`` tuples of ``UpdateContext.events_out``.

    A channel with one emitter keeps that emitter's own mask and count:
    :func:`build_event_buffer` takes the lanes where ``mask`` and ``count >
    0``, the lanes the JAX package marks with ``counts > 0`` of
    ``where(mask, count, 0)`` (effect.py:663-687), so the buffer is the
    same bit for bit without building that mask. Several emitters on one
    channel sum their counts (uint32) and mark ``counts > 0``, as the JAX
    package does."""
    grouped: Dict[int, list] = {}
    for channel, mask, count in emitted:
        grouped.setdefault(channel, []).append((mask, count))
    out = {}
    for channel, pairs in grouped.items():
        if len(pairs) == 1:
            out[channel] = pairs[0]
            continue
        total = 0
        for mask, count in pairs:
            total = (total + torch.where(mask, count, 0)) & 0xFFFFFFFF
        out[channel] = (total > 0, total)
    return out


def event_index(events: EventBuffer, spawn_rank: torch.Tensor, const_count=None,
                lanes=None) -> torch.Tensor:
    """The source event of each child spawn rank, int64 [N] in ``[0, cap)``.

    ``const_count`` K: every event carries ``count == K``, so the rank→event
    map is ``rank // K`` (events.py:196-198). Otherwise each event's
    boundary is marked at its inclusive count sum and a prefix sum of the
    marks gives ``#{e: cum[e] <= rank}`` (events.py:199-214): a zero-count
    row (a sharded parent's gap between two shards' prefixes) shares the
    boundary of the event before it, so rank k lands on the k-th
    positive-count event. ``lanes``: the child pool's lane count where
    ``spawn_rank`` holds one shard's lanes of it (default: its length)."""
    n = spawn_rank.shape[-1] if lanes is None else int(lanes)
    cap = events.capacity
    if const_count:
        event_idx = spawn_rank.to(torch.int64) // int(const_count)
        return torch.clamp(event_idx, max=cap - 1)
    cum = inclusive_sum(events.count.to(torch.int32))
    size = -(-(n + 1) // 4096) * 4096
    marks = torch.zeros((size,), dtype=torch.int32, device=cum.device)
    marks.index_add_(0, torch.clamp(cum, 0, n).long(), torch.ones_like(cum))
    csum = inclusive_sum(marks)
    event_idx = csum[torch.clamp(spawn_rank, 0, n).long()]
    return torch.clamp(event_idx, 0, cap - 1).long()


def consume_events(
    events: EventBuffer,
    spawn_rank: torch.Tensor,
    attrs=None,
    const_count=None,
    checks=None,
    lanes=None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Map each child spawn rank to its source event.

    ``spawn_rank[i]`` is the i-th lane's 0-based rank among this frame's
    spawned particles. Returns ``(parent_slot [N], valid_requests int32[],
    parent_payload {name: [N, ...]})``. Mirrors the child init path of
    vfx_init.wgsl:123-171. The rank→event map is :func:`event_index`'s.
    ``attrs`` limits the payload gathers to the attributes the child
    inherits, and several f32 attributes pack into ONE row matrix first
    (events.py:224-247). Nothing here reads back from the device.
    ``checks`` (a checked step's :class:`~.effect.StepChecks`) bound-checks
    the event index before the gathers read with it. ``lanes``: as
    :func:`event_index`'s, for a shard of a sharded child.
    """
    event_idx = event_index(events, spawn_rank, const_count, lanes)
    if checks is not None:
        event_idx = checks.index(event_idx, events.capacity, "the event buffer")
    parent_slot = events.parent_slot[event_idx]
    names = list(
        events.payload.keys() if attrs is None else [a for a in attrs if a in events.payload]
    )
    payload: Dict[str, torch.Tensor] = {}
    f32_names = [nm for nm in names if events.payload[nm].dtype == torch.float32]
    if f32_names:
        widths = []
        cols = []
        for nm in f32_names:
            a = events.payload[nm]
            a2 = a[:, None] if a.dim() == 1 else a
            widths.append((nm, a.dim(), a2.shape[1]))
            cols.append(a2)
        table = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        rows = gather_rows(table.contiguous(), event_idx.to(torch.int32))
        off = 0
        for nm, nd, w in widths:
            sl = rows[:, off : off + w]
            off += w
            payload[nm] = sl[:, 0] if nd == 1 else sl
    for nm in names:
        if nm not in payload:
            payload[nm] = events.payload[nm][event_idx]
    return parent_slot, events.total_spawn_count(), payload
