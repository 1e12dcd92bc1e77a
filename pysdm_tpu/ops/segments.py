"""Cell bucketing and pair finding via sorting.

Replacement (SURVEY.md §7 delta #3) for the reference's counting
sort + serial per-cell Fisher-Yates shuffle
(reference ``collisions_methods.py:588-741``, ``index_methods.py:23-44``):
one stable sort of particles by ``(cell_id, u01)`` delivers both the
cell-segment structure and a uniform random permutation within each cell
(sorting i.i.d. uniform keys induces a uniform random permutation — the
distributional equivalent of Fisher-Yates; exercised by the croupier tests).
Dead particles (multiplicity 0) sort to a trailing bucket with key ``n_cell``.

All index arrays are int32; per-cell reductions over *sorted* slots are
cumsum differences / segmented scans, deterministic and free of
scatter-adds (``jax.ops.segment_sum``).
"""

import numpy as np

import jax
import jax.numpy as jnp


def rand_bits_for(n_cell):
    """bits of per-cell randomness left in a packed (cell | random) u32 key"""
    cell_bits = max(1, int(np.ceil(np.log2(n_cell + 1))))
    return 32 - cell_bits


# below this many random bits, key ties within a cell become likely enough
# to bias the pairing — fall back to the 2-key (cell, u01) sort
_MIN_RAND_BITS = 16


def _shuffle_keys(cell_id, alive, rand, n_cell):
    """pack (cell, random) into ONE u32 sort key when enough random bits fit
    (a sort's memory traffic scales with total operand width — one u32
    key instead of (i32 cell, f32 u01)). Dead particles get
    cell n_cell (trailing bucket). ``rand`` may be u32 random bits or u01
    floats (converted — the u01-injection path).
    Returns (keys tuple, num_keys, rand_bits or None)."""
    nbits = rand_bits_for(n_cell)
    if jnp.issubdtype(rand.dtype, jnp.floating):
        bits = jnp.minimum(
            (rand.astype(jnp.float32) * np.float32(2.0**nbits)).astype(
                jnp.uint32
            ),
            jnp.uint32(2**nbits - 1),
        )
    else:
        bits = rand.astype(jnp.uint32) >> (32 - nbits)
    if nbits < _MIN_RAND_BITS:
        key_cell = jnp.where(alive, cell_id, n_cell).astype(jnp.int32)
        return (key_cell, bits), 2, None
    key_cell = jnp.where(alive, cell_id, n_cell).astype(jnp.uint32)
    packed = (key_cell << nbits) | bits
    return (packed,), 1, nbits


def _sorted_cell_of(sorted_key0, num_keys, nbits):
    if num_keys == 1:
        return (sorted_key0 >> nbits).astype(jnp.int32)
    return sorted_key0


def reconstruct_cell_rows(particles, sorted_cell, n_cell, mesh=None):
    """rebuild the cell_id / cell_origin state rows from the sorted cell
    keys instead of carrying them through the sort as payload operands
    (origin = unravel(cell_id) by the mesh's row-major strides,
    ``impl/mesh.py``; dead slots clip to cell n_cell-1 — they are masked by
    multiplicity 0 everywhere)"""
    cell_id = jnp.minimum(sorted_cell, n_cell - 1).astype(
        particles.cell_id.dtype
    )
    n_dim = particles.cell_origin.shape[0]
    if n_dim == 0:
        return particles.replace(cell_id=cell_id)
    assert mesh is not None, "mesh needed to reconstruct cell_origin"
    strides = np.asarray(mesh.strides).ravel()
    rows = []
    rem = cell_id
    for s in strides:
        rows.append((rem // int(s)).astype(particles.cell_origin.dtype))
        rem = rem % int(s)
    origin = jnp.stack(rows)
    return particles.replace(cell_id=cell_id, cell_origin=origin)


def bucket_shuffle(cell_id, alive, u01, n_cell):
    """sort particles by (cell, random key); returns
    order           (n_sd,) int32 — orig index of the particle at sorted slot p
    sorted_cell     (n_sd,) int32 — cell of sorted slot (n_cell for dead)
    cell_start      (n_cell+1,) int32 — segment starts; cell_start[n_cell] = n_alive
    is_first_in_pair(n_sd,) bool — slot p and p+1 form a candidate pair
    (pairing semantics per reference ``pair_methods.py:35-55``: same cell and
    even offset from the cell's segment start)
    """
    n_sd = cell_id.shape[0]
    key_cell = jnp.where(alive, cell_id, n_cell).astype(jnp.int32)
    iota = jnp.arange(n_sd, dtype=jnp.int32)
    sorted_cell, _, order = jax.lax.sort(
        (key_cell, u01, iota), num_keys=2, is_stable=False
    )
    cell_start = jnp.searchsorted(
        sorted_cell, jnp.arange(n_cell + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    offset = iota - cell_start[sorted_cell]
    same_as_next = jnp.concatenate(
        [sorted_cell[1:] == sorted_cell[:-1], jnp.zeros((1,), dtype=bool)]
    )
    is_first_in_pair = same_as_next & (offset % 2 == 0) & (sorted_cell < n_cell)
    return order, sorted_cell, cell_start, is_first_in_pair


def bucket_shuffle_payload(cell_id, alive, u01, n_cell, payloads=()):
    """like ``bucket_shuffle`` but co-sorts ``payloads`` (1D arrays of length
    n_sd) as additional variadic-sort operands instead of gathering them
    through the sort order afterwards. No order/iota operand is carried —
    callers that keep the state sorted never need it.
    Returns (sorted_payloads, sorted_cell, cell_start, is_first)."""
    n_sd = cell_id.shape[0]
    key_cell = jnp.where(alive, cell_id, n_cell).astype(jnp.int32)
    out = jax.lax.sort(
        (key_cell, u01) + tuple(payloads), num_keys=2, is_stable=False
    )
    sorted_cell = out[0]
    sorted_payloads = out[2:]
    cell_start = jnp.searchsorted(
        sorted_cell, jnp.arange(n_cell + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    offset = jnp.arange(n_sd, dtype=jnp.int32) - cell_start[sorted_cell]
    same_as_next = jnp.concatenate(
        [sorted_cell[1:] == sorted_cell[:-1], jnp.zeros((1,), dtype=bool)]
    )
    is_first_in_pair = same_as_next & (offset % 2 == 0) & (sorted_cell < n_cell)
    return sorted_payloads, sorted_cell, cell_start, is_first_in_pair


def bucket_shuffle_state(particles, rand, n_cell, mesh=None):
    """bucket-shuffle an entire ParticleState: every per-particle array rides
    the one sort as a payload operand; the returned state is in sorted slot
    order (particle order is not semantically meaningful — dynamics that sort
    keep the state sorted rather than scattering back).

    Sort-operand slimming: the (cell, random) pair packs into one u32 key
    (``_shuffle_keys``), and the cell_id / cell_origin rows are NOT carried
    as payloads — they are reconstructed from the sorted key + mesh strides
    (``reconstruct_cell_rows``). ``rand`` may be u32 bits or u01 floats.
    Returns (sorted_particles, sorted_cell, cell_start, is_first)."""
    n_sd = particles.n_sd
    keys, num_keys, nbits = _shuffle_keys(
        particles.cell_id, particles.alive, rand, n_cell
    )
    rows = (
        [particles.multiplicity]
        + list(particles.extensive)
        + list(particles.maximum)
        + list(particles.position_in_cell)
    )
    out = jax.lax.sort(keys + tuple(rows), num_keys=num_keys, is_stable=False)
    sorted_cell = _sorted_cell_of(out[0], num_keys, nbits)
    sorted_rows = out[num_keys:]
    cell_start = jnp.searchsorted(
        sorted_cell, jnp.arange(n_cell + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    offset = jnp.arange(n_sd, dtype=jnp.int32) - cell_start[sorted_cell]
    same_as_next = jnp.concatenate(
        [sorted_cell[1:] == sorted_cell[:-1], jnp.zeros((1,), dtype=bool)]
    )
    is_first = same_as_next & (offset % 2 == 0) & (sorted_cell < n_cell)
    sorted_particles = _rebuild_state_slim(particles, sorted_rows)
    sorted_particles = reconstruct_cell_rows(
        sorted_particles, sorted_cell, n_cell, mesh
    )
    return sorted_particles, sorted_cell, cell_start, is_first


def sort_state_by_cell(particles, n_cell, mesh=None):
    """stable sort of the whole ParticleState by cell id (dead particles to a
    trailing bucket), riding per-particle arrays as payload operands of
    one ``lax.sort``. Gives cell-segment structure for cumsum-based per-cell
    reductions (condensation env coupling, products) without any scatter.
    cell_id / cell_origin rows are reconstructed, not carried (see
    ``bucket_shuffle_state``).
    Returns (sorted_particles, sorted_cell, cell_start)."""
    rows = (
        [particles.multiplicity]
        + list(particles.extensive)
        + list(particles.maximum)
        + list(particles.position_in_cell)
    )
    key_cell = jnp.where(particles.alive, particles.cell_id, n_cell).astype(
        jnp.int32
    )
    out = jax.lax.sort((key_cell,) + tuple(rows), num_keys=1, is_stable=True)
    sorted_cell = out[0]
    cell_start = jnp.searchsorted(
        sorted_cell, jnp.arange(n_cell + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    sorted_particles = _rebuild_state_slim(particles, out[1:])
    sorted_particles = reconstruct_cell_rows(
        sorted_particles, sorted_cell, n_cell, mesh
    )
    return sorted_particles, sorted_cell, cell_start


def _rebuild_state_slim(particles, sorted_rows):
    """rebuild from rows [mult, ext..., max..., position_in_cell...]
    (cell_id / cell_origin reconstructed separately)"""
    n_ext = particles.extensive.shape[0]
    n_max = particles.maximum.shape[0]
    n_dim = particles.cell_origin.shape[0]
    i = 0
    mult = sorted_rows[i]; i += 1
    ext = jnp.stack(sorted_rows[i : i + n_ext]) if n_ext else particles.extensive
    i += n_ext
    mx = jnp.stack(sorted_rows[i : i + n_max]) if n_max else particles.maximum
    i += n_max
    pic = (
        jnp.stack(sorted_rows[i : i + n_dim])
        if n_dim
        else particles.position_in_cell
    )
    return particles.replace(
        multiplicity=mult, extensive=ext, maximum=mx, position_in_cell=pic
    )


def _rebuild_state(particles, sorted_rows):
    n_ext = particles.extensive.shape[0]
    n_max = particles.maximum.shape[0]
    n_dim = particles.cell_origin.shape[0]
    i = 0
    mult = sorted_rows[i]; i += 1
    ext = jnp.stack(sorted_rows[i : i + n_ext]) if n_ext else particles.extensive
    i += n_ext
    mx = jnp.stack(sorted_rows[i : i + n_max]) if n_max else particles.maximum
    i += n_max
    cid = sorted_rows[i]; i += 1
    corig = (
        jnp.stack(sorted_rows[i : i + n_dim]) if n_dim else particles.cell_origin
    )
    i += n_dim
    pic = (
        jnp.stack(sorted_rows[i : i + n_dim])
        if n_dim
        else particles.position_in_cell
    )
    return particles.replace(
        multiplicity=mult,
        extensive=ext,
        maximum=mx,
        cell_id=cid,
        cell_origin=corig,
        position_in_cell=pic,
    )


def sorted_segment_sum(values, cell_start, n_cell):
    """per-cell sum over slots sorted by cell, as a cumsum difference
    (deterministic, no scatter): sum_i = csum[cell_start[i+1]] - csum[cell_start[i]].
    Exact for integer dtypes; for floats the error is that of a length-n
    cumsum (fine for rate counters)."""
    c = jnp.cumsum(values, axis=-1)
    cpad = jnp.concatenate([jnp.zeros(c.shape[:-1] + (1,), c.dtype), c], axis=-1)
    return cpad[..., cell_start[1 : n_cell + 1]] - cpad[..., cell_start[:n_cell]]


def _segmented_scan(combine_val, values, is_start, reverse=False):
    """generic segmented inclusive scan: resets at segment starts"""

    def combine(a, b):
        af, av = a
        bf, bv = b
        return af | bf, jnp.where(bf, bv, combine_val(av, bv))

    flags, scanned = jax.lax.associative_scan(
        combine, (is_start, values), reverse=reverse
    )
    del flags
    return scanned


def sorted_segment_min(values, sorted_cell, cell_start, n_cell):
    """per-cell min over sorted slots via a segmented scan (no scatter).
    Empty cells get +inf (the reduction identity)."""
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_cell[1:] != sorted_cell[:-1]]
    )
    scanned = _segmented_scan(jnp.minimum, values, is_start)
    ends = cell_start[1 : n_cell + 1] - 1
    mins = scanned[jnp.clip(ends, 0)]
    empty = cell_start[1 : n_cell + 1] == cell_start[:n_cell]
    return jnp.where(empty, jnp.array(jnp.inf, values.dtype), mins)


def sorted_segment_max(values, sorted_cell, cell_start, n_cell):
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_cell[1:] != sorted_cell[:-1]]
    )
    scanned = _segmented_scan(jnp.maximum, values, is_start)
    ends = cell_start[1 : n_cell + 1] - 1
    maxs = scanned[jnp.clip(ends, 0)]
    empty = cell_start[1 : n_cell + 1] == cell_start[:n_cell]
    return jnp.where(empty, jnp.array(-jnp.inf, values.dtype), maxs)


def segment_sum(values, sorted_cell, n_cell):
    """deterministic per-cell sum over sorted slots (dead bucket dropped).
    NOTE: scatter-based; prefer ``sorted_segment_sum`` in per-step code."""
    return jax.ops.segment_sum(
        values, sorted_cell, num_segments=n_cell + 1, indices_are_sorted=True
    )[:n_cell]


def segment_min(values, sorted_cell, n_cell):
    return jax.ops.segment_min(
        values, sorted_cell, num_segments=n_cell + 1, indices_are_sorted=True
    )[:n_cell]


def segment_max(values, sorted_cell, n_cell):
    return jax.ops.segment_max(
        values, sorted_cell, num_segments=n_cell + 1, indices_are_sorted=True
    )[:n_cell]


def cell_counts(cell_start):
    return jnp.diff(cell_start)


def pair_roll(x, axis=0):
    """value at slot p+1 (garbage at the last slot — always masked by
    is_first_in_pair, which is False there)"""
    return jnp.roll(x, -1, axis=axis)
