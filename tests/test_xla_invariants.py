"""Sampler invariants of the XLA samplers, which run on every backend.

Bookkeeping, frozen sites, tempering, the Dirichlet-multinomial prior,
panel padding and greedy recovery; the selfed and backcross pedigrees
are checked against exact enumeration of the joint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mchap_tpu.models.pedigree import PedigreeCallingMCMC, fit_pedigree_multi
from mchap_tpu.ops.assemble_mcmc import denovo_sampler
from mchap_tpu.ops.calling_mcmc import calling_sampler
from mchap_tpu.ops.exact import genotype_likelihoods
from mchap_tpu.ops.likelihood import prepare_reads
from mchap_tpu.testing import exact_pedigree_marginals, simulate_reads

HAPS2 = np.array([[0, 0], [0, 1], [1, 1]], dtype=np.int8)


def _llk_numpy(lr, genotype):
    """From-scratch llk of an integer genotype [P, NB] (numpy oracle)."""
    R, NB, _ = lr.shape
    rh = lr[
        np.arange(R)[:, None, None], np.arange(NB)[None, :, None],
        genotype.T[None, :, :],
    ].sum(1)  # [R, P]
    m = rh.max(axis=1, keepdims=True)
    return float((np.log(np.exp(rh - m).mean(axis=1)) + m[:, 0]).sum())


def _denovo_problem(P=4, NB=6, A=3, R=12, chains=4, seed=0):
    rng = np.random.default_rng(seed)
    reads = rng.dirichlet(np.ones(A), size=(R, NB))
    init = rng.integers(0, A, size=(chains, P, NB)).astype(np.int32)
    return reads, init


@pytest.mark.parametrize(
    "temps,inbreeding",
    [((1.0,), None), ((0.25, 0.5, 1.0), None), ((1.0,), 0.3)],
    ids=["plain", "tempered", "dirmul"],
)
def test_denovo_bookkeeping_invariant(temps, inbreeding):
    """The llk carried through mutation and structural sub-steps equals
    a from-scratch recompute of the traced (cold-chain) genotype."""
    reads, init = _denovo_problem()
    lr = np.asarray(prepare_reads(reads))
    bd = np.zeros(6)
    bd[:2] = 0.5
    g, llks = denovo_sampler(
        jax.random.PRNGKey(3), jnp.asarray(init), jnp.asarray(lr),
        jnp.ones(len(reads)), jnp.full((6,), 3, jnp.int32), jnp.asarray(bd),
        jnp.asarray(temps), n_steps=6, use_prior=inbreeding is not None,
        inbreeding=inbreeding or 0.0,
    )
    g, llks = np.asarray(g), np.asarray(llks)
    assert g.shape == (4, 6, 4, 6)
    assert (g >= 0).all() and (g < 3).all()
    for c in range(4):
        for step in range(6):
            want = _llk_numpy(lr, g[c, step])
            assert abs(llks[c, step] - want) < 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("temps", [(1.0,), (0.5, 1.0)], ids=["plain", "tempered"])
def test_denovo_fixed_sites_frozen(temps):
    """Positions with n_alleles == 1 never change, including when the
    fixed allele is non-zero."""
    reads, init = _denovo_problem(seed=1)
    init[:, :, 2] = 2
    init[:, :, 4] = 1
    n_alleles = np.full(6, 3, np.int32)
    n_alleles[[2, 4]] = 1
    g, _ = denovo_sampler(
        jax.random.PRNGKey(5), jnp.asarray(init), prepare_reads(reads),
        jnp.ones(len(reads)), jnp.asarray(n_alleles), jnp.full((6,), 1 / 6),
        jnp.asarray(temps), n_steps=8,
    )
    g = np.asarray(g)
    assert (g[..., 2] == 2).all()
    assert (g[..., 4] == 1).all()


def test_calling_xla_panel_padding_masked():
    """Panel columns at or past n_valid (cross-locus padding) are never
    drawn by the XLA calling sampler, even from a flat posterior."""
    rh = jnp.zeros((4, 6))  # uninformative reads: every allele equal
    g, _ = calling_sampler(
        jax.random.PRNGKey(0), jnp.zeros((16, 4), jnp.int32), rh, jnp.ones(4),
        n_steps=40, n_valid=jnp.int32(3),
    )
    g = np.asarray(g)
    assert g.max() == 2 and g.min() >= 0


def test_pedigree_panel_padding_masked():
    """fit_pedigree_multi pads smaller panels to the block's largest;
    a 2-haplotype locus never draws the third (padding) allele."""
    parents = np.array([[-1, -1], [-1, -1], [0, 1]])
    problems = []
    for i, panel in enumerate([HAPS2, HAPS2[:2]]):
        reads = np.stack(
            [simulate_reads(panel[[0, 1]], n_alleles=2, n_reads=4, seed=10 * i + j)
             for j in range(3)]
        )
        problems.append(dict(
            sample_reads=reads, sample_read_counts=np.ones((3, 4), int),
            haplotypes=panel,
        ))
    traces = fit_pedigree_multi(
        problems, sample_ploidy=np.full(3, 2), sample_parents=parents,
        gamete_tau=np.full((3, 2), 1), gamete_lambda=np.zeros((3, 2)),
        gamete_error=np.full((3, 2), 0.01), steps=30, chains=2, random_seed=1,
    )
    assert traces[0].n_allele == 3 and traces[1].n_allele == 2
    assert traces[1].genotypes.max() < 2


def test_greedy_trio_recovers_truth():
    """Deep reads: a diploid trio's three true genotypes are the modes."""
    parents = np.array([[-1, -1], [-1, -1], [0, 1]])
    truths = [HAPS2[[0, 1]], HAPS2[[1, 2]], HAPS2[[0, 2]]]
    reads = np.stack(
        [simulate_reads(t, n_alleles=2, n_reads=16, qual=(30, 30), seed=i)
         for i, t in enumerate(truths)]
    )
    trace = PedigreeCallingMCMC(
        sample_ploidy=np.full(3, 2), sample_parents=parents,
        gamete_tau=np.full((3, 2), 1), gamete_lambda=np.zeros((3, 2)),
        gamete_error=np.full((3, 2), 0.01), haplotypes=HAPS2, steps=60,
        chains=2, random_seed=2,
    ).fit(reads, np.ones((3, 16), int)).burn(20)
    for i, want in enumerate([[0, 1], [1, 2], [0, 2]]):
        mode, _ = trace.individual(i).posterior().mode()
        np.testing.assert_array_equal(mode, want)


def test_greedy_biparental_tetraploid_recovers_truth():
    """2 founders + 5 tetraploid F1 progeny (the bi-parental structure):
    every sample's mode is its true genotype at depth 32."""
    rng = np.random.default_rng(0)
    n_pos, n_haps, n = 6, 8, 7
    haps = np.unique(rng.integers(0, 2, (40, n_pos)).astype(np.int8), axis=0)
    haps = haps[:n_haps]
    parents = np.full((n, 2), -1, int)
    parents[2:] = [0, 1]
    f0, f1 = rng.choice(n_haps, 4), rng.choice(n_haps, 4)
    truth = [f0, f1] + [
        np.concatenate([rng.choice(f0, 2, replace=False),
                        rng.choice(f1, 2, replace=False)])
        for _ in range(n - 2)
    ]
    reads = np.stack(
        [simulate_reads(haps[t], n_alleles=2, n_reads=32, qual=(30, 30),
                        seed=100 + i) for i, t in enumerate(truth)]
    )
    trace = PedigreeCallingMCMC(
        sample_ploidy=np.full(n, 4), sample_parents=parents,
        gamete_tau=np.full((n, 2), 2), gamete_lambda=np.zeros((n, 2)),
        gamete_error=np.full((n, 2), 0.1), haplotypes=haps, steps=60,
        chains=2, random_seed=4,
    ).fit(reads, np.ones((n, 32), int)).burn(20)
    for i in range(n):
        mode, _ = trace.individual(i).posterior().mode()
        np.testing.assert_array_equal(mode, np.sort(truth[i]))


@pytest.mark.parametrize(
    "parents",
    [
        [[-1, -1], [0, 0], [1, 1]],  # two generations of selfing
        [[-1, -1], [-1, -1], [0, 1], [0, 2]],  # F1 backcrossed to a parent
    ],
    ids=["selfed", "backcross"],
)
def test_pedigree_topology_matches_exact(parents):
    """Selfed samples (both parents the same sample) and backcross pairs
    (one parent a child of the other) reach the exact joint posterior."""
    parents = np.asarray(parents)
    n = len(parents)
    tau = np.full((n, 2), 1)
    lam = np.zeros((n, 2))
    err = np.full((n, 2), 0.01)
    rng = np.random.default_rng(3)
    reads = np.stack(
        [simulate_reads(HAPS2[rng.integers(0, 3, 2)], n_alleles=2, n_reads=4,
                        qual=(14, 18), seed=i) for i in range(n)]
    )
    counts = np.ones((n, 4))
    llks = np.stack(
        [np.asarray(genotype_likelihoods(reads[i], 2, HAPS2, counts[i]))
         for i in range(n)]
    )
    want = exact_pedigree_marginals(llks, parents, tau, lam, err, 3, 2)
    trace = PedigreeCallingMCMC(
        sample_ploidy=np.full(n, 2), sample_parents=parents, gamete_tau=tau,
        gamete_lambda=lam, gamete_error=err, haplotypes=HAPS2, steps=3000,
        chains=2, random_seed=11,
    ).fit(reads, counts).burn(500)
    for i in range(n):
        got = trace.individual(i).posterior().as_array(3)
        assert 0.5 * np.abs(got - want[i]).sum() < 0.05


def test_fit_pedigree_multi_drops_burn_in():
    """The batched pedigree path slices the burn-in on device: its trace
    holds steps - burn steps and a further burn() is a no-op."""
    parents = np.array([[-1, -1], [-1, -1], [0, 1]])
    reads = np.stack(
        [simulate_reads(HAPS2[[0, 1]], n_alleles=2, n_reads=4, seed=j)
         for j in range(3)]
    )
    problem = dict(sample_reads=reads, sample_read_counts=np.ones((3, 4), int),
                   haplotypes=HAPS2)
    [trace] = fit_pedigree_multi(
        [problem], sample_ploidy=np.full(3, 2), sample_parents=parents,
        gamete_tau=np.full((3, 2), 1), gamete_lambda=np.zeros((3, 2)),
        gamete_error=np.full((3, 2), 0.01), steps=12, chains=2, random_seed=1,
        burn=5,
    )
    assert trace.genotypes.shape[:2] == (2, 7)
    assert trace.burn(5).genotypes.shape[:2] == (2, 7)
