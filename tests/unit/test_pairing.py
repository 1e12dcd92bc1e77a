"""Mirror-croupier properties (ops/pairing.py): the sort-free single-cell
matching must be a disjoint involution with EXACTLY uniform pair-candidate
marginals — the property the Shima et al. 2009 estimator scaling requires
(reference normalization semantics: ``collisions_methods.py:634-650``; the
reference obtains uniformity via per-cell Fisher-Yates,
``index_methods.py:33-44``, at the cost of a shuffle; the mirror croupier
obtains it from one scalar draw)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysdm_tpu.ops import collisions as ops
from pysdm_tpu.ops.pairing import MirrorPairing


@pytest.mark.parametrize("n", [6, 7, 16])
def test_involution_and_disjoint(n):
    alive = jnp.ones(n, dtype=bool)
    x = jnp.arange(n, dtype=jnp.float32)
    for K in range(n):
        p = MirrorPairing(K, n, alive)
        partner = np.asarray(p.partner(x)).astype(int)
        # involution: partner of partner is self
        assert (partner[partner] == np.arange(n)).all()
        # the claimed mapping
        assert (partner == (K - np.arange(n)) % n).all()
        first = np.asarray(p.is_first)
        # disjoint: first slots and their partners never overlap
        seconds = partner[first]
        assert not np.intersect1d(np.where(first)[0], seconds).size
        # no fixed point is ever a pair
        assert not first[partner == np.arange(n)].any()


@pytest.mark.parametrize("n", [6, 7])
def test_exactly_uniform_pair_marginals(n):
    """over the n equally-likely K values, each unordered pair {i,j} is a
    candidate exactly once => P(candidate) = 1/n for every pair"""
    alive = jnp.ones(n, dtype=bool)
    counts = {}
    for K in range(n):
        p = MirrorPairing(K, n, alive)
        first = np.asarray(p.is_first)
        partner = (K - np.arange(n)) % n
        for i in np.where(first)[0]:
            pair = (min(i, partner[i]), max(i, partner[i]))
            counts[pair] = counts.get(pair, 0) + 1
    all_pairs = {(i, j) for i in range(n) for j in range(i + 1, n)}
    assert set(counts) == all_pairs
    assert set(counts.values()) == {1}


def test_dead_slots_masked():
    n = 8
    alive = jnp.asarray([True, False, True, True, True, True, False, True])
    for K in range(n):
        p = MirrorPairing(K, n, alive)
        first = np.asarray(p.is_first)
        partner = (K - np.arange(n)) % n
        av = np.asarray(alive)
        assert not first[~av].any()
        assert not first[~av[partner]].any()


def test_merge_matches_explicit_scatter():
    """pairing.merge must place a_new at first slots and b_new at the
    involution image of first slots"""
    n = 10
    K = 3
    alive = jnp.ones(n, dtype=bool)
    p = MirrorPairing(K, n, alive)
    orig = jnp.arange(n, dtype=jnp.float32) * 10
    a_new = jnp.arange(n, dtype=jnp.float32) + 100
    b_new = jnp.arange(n, dtype=jnp.float32) + 200
    mask = p.is_first
    out = np.asarray(p.merge(orig, a_new, b_new, mask))
    partner = (K - np.arange(n)) % n
    expected = np.asarray(orig).copy()
    for i in np.where(np.asarray(mask))[0]:
        expected[i] = np.asarray(a_new)[i]
        expected[partner[i]] = np.asarray(b_new)[i]
    np.testing.assert_array_equal(out, expected)


def test_coalesce_conserves_with_mirror_pairing():
    """total xi*ext conserved through the Shima update under mirror pairing"""
    rng = np.random.default_rng(7)
    n = 128
    mult = jnp.asarray(rng.integers(1, 1000, n), dtype=jnp.int64)
    ext = jnp.asarray(rng.uniform(1e-12, 1e-9, (2, n)))
    alive = jnp.ones(n, dtype=bool)
    for K in (0, 17, 101):
        p = MirrorPairing(K, n, alive)
        mp = p.partner(mult)
        mj = jnp.maximum(mult, mp)
        mk = jnp.minimum(mult, mp)
        gamma = jnp.minimum(
            jnp.asarray(rng.integers(0, 3, n), dtype=jnp.int64),
            mj // jnp.maximum(mk, 1),
        )
        gamma = jnp.where(p.is_first, gamma, 0)
        m, e, _ = ops.coalesce(
            mult, ext, gamma, p.is_first, None, 1, None, pairing=p
        )
        before = np.asarray((mult.astype(ext.dtype) * ext).sum(axis=1))
        after = np.asarray((m.astype(e.dtype) * e).sum(axis=1))
        np.testing.assert_allclose(after, before, rtol=1e-12)
        assert (np.asarray(m) >= 0).all()


def test_mirror_normalization_factor():
    """1/P(candidate) = N for the mirror matching (vs n(n-1)/2/floor(n/2)
    under Fisher-Yates) — checked against a brute-force expected collision
    count on a constant kernel"""
    n, dt, dv = 64, 2.0, 10.0
    norm = ops.mirror_normalization_factor(dt, dv, n, jnp.float64)
    np.testing.assert_allclose(np.asarray(norm), [dt / dv * n])
    # expected candidates per K: each pair with prob 1/n, n(n-1)/2 pairs
    alive = jnp.ones(n, dtype=bool)
    total_candidates = sum(
        int(np.asarray(MirrorPairing(K, n, alive).is_first).sum())
        for K in range(n)
    )
    assert total_candidates == n * (n - 1) // 2


def test_box_mirror_vs_sort_croupier_statistics():
    """full box coalescence: the mirror croupier must reproduce the sort
    croupier's moment evolution statistically (same mean droplet count
    trajectory within a few percent over an ensemble)"""
    from pysdm_tpu.backends import CPU
    from pysdm_tpu.builder import Builder
    from pysdm_tpu.environments import Box
    from pysdm_tpu.dynamics import Coalescence
    from pysdm_tpu.dynamics.collisions.collision_kernels import Golovin
    from pysdm_tpu.physics import Formulae, si
    from pysdm_tpu.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu.initialisation.spectra import Exponential

    n_sd = 2**12
    results = {}
    for croupier in ("mirror", "sort"):
        totals = []
        for seed in (1, 2, 3):
            formulae = Formulae(seed=seed)
            backend = CPU(formulae)
            env = Box(dt=1.0 * si.s, dv=1e6 * si.m**3)
            builder = Builder(n_sd=n_sd, backend=backend, environment=env)
            spectrum = Exponential(
                norm_factor=8.39e12, scale=4.19e-15 * si.m**3
            )
            volume, mult = ConstantMultiplicity(spectrum).sample(n_sd)
            water_mass = volume * formulae.constants.rho_w
            builder.add_dynamic(
                Coalescence(
                    collision_kernel=Golovin(b=1.5e3 / si.s),
                    croupier=croupier,
                )
            )
            particulator = builder.build(
                attributes={"multiplicity": mult, "water mass": water_mass}
            )
            particulator.run(40)
            totals.append(
                float(np.asarray(particulator.particles.multiplicity).sum())
            )
        results[croupier] = np.mean(totals)
    # droplet count decays by ~half over the run; croupiers must agree on the
    # ensemble mean within a few percent
    assert results["mirror"] == pytest.approx(results["sort"], rel=0.05)
