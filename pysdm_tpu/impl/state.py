"""Particle state pytree.

Replacement for the reference's Storage/Index/IndexedStorage object zoo
(reference ``PySDM/impl/particle_attributes.py`` and
``backends/impl_common/``): the state is a fixed-size structure-of-arrays
pytree. There is no permutation index and no compaction — particle death is
represented by multiplicity 0 (masked out of all reductions), keeping shapes
static for XLA (SURVEY.md §7 design delta #1).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "multiplicity", "extensive", "maximum", "cell_id", "cell_origin",
        "position_in_cell",
    ),
    meta_fields=("ext_names", "max_names"),
)
@dataclasses.dataclass(frozen=True)
class ParticleState:
    multiplicity: jax.Array  # (n_sd,) int
    extensive: jax.Array  # (n_ext, n_sd) float — conserved sums under coalescence
    maximum: jax.Array  # (n_max, n_sd) float — max-merged under coalescence
    cell_id: jax.Array  # (n_sd,) int
    cell_origin: jax.Array  # (n_dims, n_sd) int ((0, n_sd) for 0D)
    position_in_cell: jax.Array  # (n_dims, n_sd) float ((0, n_sd) for 0D)
    ext_names: tuple = ()
    max_names: tuple = ()

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @property
    def n_sd(self):
        return self.multiplicity.shape[0]

    @property
    def alive(self):
        return self.multiplicity > 0

    def ext(self, name):
        return self.extensive[self.ext_names.index(name)]

    def has_ext(self, name):
        return name in self.ext_names

    def set_ext(self, name, value):
        return self.replace(
            extensive=self.extensive.at[self.ext_names.index(name)].set(value)
        )

    def max_attr(self, name):
        return self.maximum[self.max_names.index(name)]

    def has_max(self, name):
        return name in self.max_names

    def set_max(self, name, value):
        return self.replace(
            maximum=self.maximum.at[self.max_names.index(name)].set(value)
        )

    def permute(self, order):
        """reorder all per-particle arrays by ``order``. Particle identity order is not semantically meaningful (the reference
        instead carries a permutation ``idx``, ``impl/particle_attributes.py``)."""
        return self.replace(
            multiplicity=self.multiplicity[order],
            extensive=self.extensive[:, order],
            maximum=self.maximum[:, order],
            cell_id=self.cell_id[order],
            cell_origin=self.cell_origin[:, order],
            position_in_cell=self.position_in_cell[:, order],
        )


def make_particle_state(
    *,
    multiplicity,
    extensive: dict,
    cell_id=None,
    cell_origin=None,
    position_in_cell=None,
    maximum: dict = None,
    mult_dtype=jnp.int64,
    dtype=jnp.float64,
):
    n_sd = len(multiplicity)
    maximum = maximum or {}
    ext_names = tuple(extensive.keys())
    max_names = tuple(maximum.keys())
    # assemble on host (numpy) and transfer once — each tiny device op at
    # init would otherwise trigger its own XLA compile (slow on cold caches)
    np_dtype = np.dtype(dtype)
    ext = (
        np.stack([np.asarray(extensive[k], dtype=np_dtype) for k in ext_names])
        if ext_names
        else np.zeros((0, n_sd), dtype=np_dtype)
    )
    mx = (
        np.stack([np.asarray(maximum[k], dtype=np_dtype) for k in max_names])
        if max_names
        else np.zeros((0, n_sd), dtype=np_dtype)
    )
    if cell_id is None:
        cell_id = np.zeros(n_sd, dtype=np.int32)
    if cell_origin is None:
        cell_origin = np.zeros((0, n_sd), dtype=np.int32)
    if position_in_cell is None:
        position_in_cell = np.zeros((0, n_sd), dtype=np_dtype)
    return ParticleState(
        multiplicity=jnp.asarray(multiplicity, dtype=mult_dtype),
        extensive=ext,
        maximum=mx,
        cell_id=jnp.asarray(cell_id, dtype=jnp.int32),
        cell_origin=jnp.asarray(cell_origin, dtype=jnp.int32),
        position_in_cell=jnp.asarray(position_in_cell, dtype=dtype),
        ext_names=ext_names,
        max_names=max_names,
    )
