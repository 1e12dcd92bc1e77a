"""Super-droplet migration between domain shards.

After displacement, particles whose cell moved outside the owning x-slab are
handed to the ring neighbour (courant < 1 and halo-1 advection guarantee
single-slab moves per step, so only +-1 exchanges are needed — the
replacement for what a distributed reference would do with MPI all-to-all).
Fixed-capacity send buffers keep shapes static; overflow beyond capacity is
counted (particles dropped with their multiplicity recorded in a deficit
counter, mirroring the reference's breakup-overflow bookkeeping style)."""

import jax
import jax.numpy as jnp
from jax import lax


def classify_dest_shift(x, nx_local, multiplicity):
    """destination shift (+-1/0) from a post-displacement x cell origin,
    plus a ``far`` mask for moves beyond the immediate ring neighbour.

    The ring exchange assumes courant < 1 (at most one slab per step); that
    assumption is *checked*, not trusted: a particle landing outside
    [-nx_local, 2*nx_local) cannot be delivered by a +-1 exchange and is
    flagged ``far`` — callers kill it and count it in the
    ``migration_far_moves`` counter (deficit-style accounting like the
    reference's breakup overflows) instead of silently mis-delivering."""
    alive = multiplicity > 0
    far = alive & ((x < -nx_local) | (x >= 2 * nx_local))
    dest = jnp.where(x < 0, -1, jnp.where(x >= nx_local, 1, 0))
    dest = jnp.where(alive & ~far, dest, 0)
    return dest.astype(jnp.int32), far


def _pack(arrays, mask, capacity):
    """gather up to `capacity` masked particles to the buffer front.
    Returns (buffers, valid, n_over) — arrays may be 1D (n,) or 2D (k, n)."""
    n = mask.shape[0]
    order = jnp.argsort(~mask)  # stable: masked first, original order kept
    count = jnp.sum(mask)
    take = order[:capacity]
    valid = jnp.arange(capacity) < count
    bufs = []
    for a in arrays:
        if a.ndim == 1:
            bufs.append(a[take])
        else:
            bufs.append(a[:, take])
    return bufs, valid, jnp.maximum(count - capacity, 0)


def _place(arrays, free_mask, bufs, valid):
    """scatter valid buffer entries into free slots (multiplicity-0 graves)"""
    n = free_mask.shape[0]
    capacity = valid.shape[0]
    free_order = jnp.argsort(~free_mask)  # free slots first
    slots = free_order[:capacity]
    # if more valid incomers than free slots, the surplus is dropped (counted
    # by the caller via free-capacity check); guard the scatter with validity
    slot_ok = valid & (jnp.arange(capacity) < jnp.sum(free_mask))
    out = []
    safe_slots = jnp.where(slot_ok, slots, n)  # n = out-of-range, dropped
    for a, b in zip(arrays, bufs):
        if a.ndim == 1:
            out.append(a.at[safe_slots].set(b, mode="drop"))
        else:
            out.append(a.at[:, safe_slots].set(b, mode="drop"))
    n_lost = jnp.sum(valid) - jnp.sum(slot_ok)
    return out, n_lost


def migrate_ring(
    *, arrays, multiplicity_index, dest_shift, axis_name, capacity, rounds=2
):
    """move particles with dest_shift == +-1 to the ring neighbour.

    arrays: list of per-particle arrays ((n,) or (k, n)); the one at
    ``multiplicity_index`` is the (integer) multiplicity defining liveness.
    Returns (arrays, n_dropped) with migrated particles zeroed at the source
    and placed into dead slots at the destination. ``n_dropped`` is a
    shape-(2,) int64 breakdown — [send_overflow, placement_overflow] — so
    saturation diagnoses point at the right knob: send overflow wants more
    ``rounds`` or ``capacity``; placement overflow wants more free slots at
    the receiver (n_sd headroom). Note a within-round arrival that finds no
    free slot is dropped even though later rounds might free slots — the
    multi-round retry helps senders over capacity, not receivers over
    occupancy (accepted limitation of fixed-capacity buffers).

    The exchange runs up to ``rounds`` passes (static — shapes stay fixed);
    each pass ships up to ``capacity`` of the *remaining* departures per
    direction, so migration bursts (rain shafts, strong crosswind piling
    movers onto one boundary) ride extra passes instead of being dropped.
    Only what is still undelivered after the final pass is killed and
    counted (deficit-style accounting like the reference's breakup
    overflows, ``collisions_methods.py:64-93``)."""
    arrays, inflight = migrate_ring_start(
        arrays=arrays, multiplicity_index=multiplicity_index,
        dest_shift=dest_shift, axis_name=axis_name, capacity=capacity,
    )
    return migrate_ring_commit(
        arrays=arrays, inflight=inflight,
        multiplicity_index=multiplicity_index, axis_name=axis_name,
        capacity=capacity, rounds=rounds,
    )


def _ring_perms(axis_name):
    n_shards = lax.psum(1, axis_name)
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    return fwd, bwd


def _send_round(arrays, multiplicity_index, pending, axis_name, capacity):
    """pack + ppermute both directions; kill shipped departures at the
    source. Returns (arrays, pending, shipments)."""
    fwd, bwd = _ring_perms(axis_name)
    mult = arrays[multiplicity_index]
    # pack BOTH directions from the pre-placement state (a slot refilled
    # by an incoming particle must not be re-shipped by the other
    # direction), then kill all shipped departures at the source before
    # any placement
    shipments = []
    departing = jnp.zeros_like(mult, dtype=bool)
    for direction, perm in ((1, fwd), (-1, bwd)):
        mask = (pending == direction) & (mult > 0)
        # first `capacity` movers (slot order) ship this pass
        rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
        shipped = mask & (rank < capacity)
        bufs, valid, _ = _pack(arrays, shipped, capacity)
        departing = departing | shipped
        bufs = [lax.ppermute(b, axis_name, perm=perm) for b in bufs]
        valid = lax.ppermute(valid, axis_name, perm=perm)
        shipments.append((bufs, valid))

    pending = jnp.where(departing, 0, pending)
    arrays = [
        jnp.where(departing, 0, a) if i == multiplicity_index else a
        for i, a in enumerate(arrays)
    ]
    return arrays, pending, shipments


def _place_round(arrays, multiplicity_index, pending, shipments):
    n_dropped_place = jnp.zeros((), jnp.int64)
    for bufs, valid in shipments:
        free = arrays[multiplicity_index] <= 0
        placed, n_lost = _place(
            arrays + [pending], free,
            bufs + [jnp.zeros(valid.shape[0], pending.dtype)], valid,
        )
        arrays, pending = placed[:-1], placed[-1]
        n_dropped_place = n_dropped_place + n_lost.astype(jnp.int64)
    return arrays, pending, n_dropped_place


def migrate_ring_start(
    *, arrays, multiplicity_index, dest_shift, axis_name, capacity
):
    """communication/compute-overlap entry (BASELINE: halo/migration
    overlapped with the collision kernel): performs the FIRST send round —
    pack departures, kill them at the source, issue the ppermutes — and
    returns the in-flight shipments WITHOUT placing them. The caller runs
    cell-local compute (collision) next; XLA's scheduler overlaps the
    ppermute transfers with that compute because nothing in it depends on
    the arrival buffers. ``migrate_ring_commit`` then places the arrivals
    (and runs any extra rounds). Semantics vs the inline ``migrate_ring``:
    migrating particles skip the collision step of their transit — they are
    resident in neither slab while in flight (one-step staleness, the
    Lagrangian analogue of the reference's async-thread MPDATA overlap,
    reference ``examples/.../mpdata_2d.py:106-116``)."""
    pending = dest_shift.astype(jnp.int32)
    arrays, pending, shipments = _send_round(
        arrays, multiplicity_index, pending, axis_name, capacity
    )
    return arrays, {"pending": pending, "shipments": shipments}


def migrate_ring_commit(
    *, arrays, inflight, multiplicity_index, axis_name, capacity, rounds=2
):
    """place the in-flight arrivals from ``migrate_ring_start`` and run the
    remaining ``rounds - 1`` full exchange rounds; kill + count
    undeliverable leftovers. Returns (arrays, [send_drop, place_drop])."""
    pending = inflight["pending"]
    arrays, pending, n_dropped_place = _place_round(
        arrays, multiplicity_index, pending, inflight["shipments"]
    )
    for _ in range(rounds - 1):
        arrays, pending, shipments = _send_round(
            arrays, multiplicity_index, pending, axis_name, capacity
        )
        arrays, pending, lost = _place_round(
            arrays, multiplicity_index, pending, shipments
        )
        n_dropped_place = n_dropped_place + lost

    # undeliverable leftovers (send-capacity overflow): kill + count
    mult = arrays[multiplicity_index]
    leftover = (pending != 0) & (mult > 0)
    n_dropped_send = jnp.sum(leftover).astype(jnp.int64)
    arrays = [
        jnp.where(leftover, 0, a) if i == multiplicity_index else a
        for i, a in enumerate(arrays)
    ]
    return arrays, jnp.stack([n_dropped_send, n_dropped_place])
