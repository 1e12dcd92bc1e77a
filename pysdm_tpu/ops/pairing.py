"""Disjoint-pair matchings over the particle axis.

The SDM Monte-Carlo estimator (Shima et al. 2009) needs, each (sub)step, a
random set of disjoint candidate pairs within each grid cell such that every
unordered pair {i, j} is a candidate with a *uniform, known* probability P —
the per-candidate probability is then scaled by 1/P (the reference's
"normalization factor", ``collisions_methods.py:634-650``, where
P = floor(n/2) / (n(n-1)/2) under a Fisher-Yates shuffle).

Two interchangeable matching mechanisms:

``AdjacentPairing`` — the sort-croupier: particles are shuffled by sorting on
(cell, random key) and slots (p, p+1) with ``is_first_in_pair[p]`` form pairs
(reference semantics: per-cell Fisher-Yates ``index_methods.py:33-44`` +
``pair_methods.py:35-55``). P = floor(n/2)/(n(n-1)/2) per cell. Costs a full
variadic sort of the state.

``MirrorPairing`` — the sort-free croupier for a single cell spanning the
whole array (0D box / parcel configs): draw ONE uniform integer K in [0, N)
and pair slot o with slot (K - o) mod N. Properties:

- the map o -> (K - o) mod N is an involution, so the matching is disjoint
  by construction and "apply to partner" equals "read from partner";
- pair {i, j} is a candidate iff K == (i + j) mod N: **every** unordered
  pair has candidate probability exactly 1/N, hence the normalization
  factor is dt/dv * N (``ops.collisions.mirror_normalization_factor``) and
  the estimator stays unbiased (the property the Shima scaling requires —
  pairs within one step share the constraint i+j=K, which affects variance
  only; validated empirically by the Golovin-analytic smoke tests);
- fixed points 2o = K (mod N) pair a slot with itself and are masked out;
- partner access is ``roll(flip(x), K+1)`` — two O(N) vector passes, **no
  sort and no gather**: the entire bucket-shuffle phase of the reference
  algorithm disappears.

Dead slots (multiplicity 0) are masked from ``is_first`` rather than
compacted; the 1/N candidate probability is over all N slots, so masking
dead pairs keeps the estimator unbiased (dead pairs contribute zero).
"""

import jax.numpy as jnp


def _bcast(mask, axis):
    return mask if axis == 0 else mask[None, :]


class AdjacentPairing:
    """pairs = slots (p, p+1) where is_first[p] (sort-croupier convention)"""

    def __init__(self, is_first):
        self.is_first = is_first

    @staticmethod
    def partner(x, axis=0):
        """partner value at FIRST slots (slot p sees p+1; garbage at second
        slots — every use is masked by ``is_first``)"""
        return jnp.roll(x, -1, axis=axis)

    @staticmethod
    def merge(orig, a_new, b_new, mask, axis=0):
        """slot p gets a_new[p] if it leads a pair (mask[p]), b_new[p-1] if
        it trails one"""
        mask_prev = jnp.roll(mask, 1)
        b_prev = jnp.roll(b_new, 1, axis=axis)
        return jnp.where(
            _bcast(mask, axis),
            a_new,
            jnp.where(_bcast(mask_prev, axis), b_prev, orig),
        )


class MirrorPairing:
    """pairs = slots {o, (K - o) mod N}; single-cell, sort-free"""

    def __init__(self, K, n_sd, alive):
        self.n_sd = n_sd
        K = jnp.asarray(K, jnp.int32)
        self.shift = (K + 1) % n_sd
        o = jnp.arange(n_sd, dtype=jnp.int32)
        partner_o = (K - o) % n_sd
        alive_partner = self.partner(alive)
        # strict '>' excludes fixed points (2o == K mod N)
        self.is_first = alive & alive_partner & (partner_o > o)

    def partner(self, x, axis=0):
        """value of the pair partner at EVERY slot (true involution):
        partner(x)[o] = x[(K - o) mod N] = roll(flip(x), K + 1)"""
        return jnp.roll(jnp.flip(x, axis=axis), self.shift, axis=axis)

    def merge(self, orig, a_new, b_new, mask, axis=0):
        """first slots (mask) take a_new; their partners take b_new mapped
        through the involution; untouched slots keep orig"""
        second_val = self.partner(b_new, axis=axis)
        second_mask = self.partner(mask)
        return jnp.where(
            _bcast(mask, axis),
            a_new,
            jnp.where(_bcast(second_mask, axis), second_val, orig),
        )
