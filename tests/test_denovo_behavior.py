"""Depth-regime behavioral posteriors for the de novo sampler (CPU).

Port of the reference's behavioral regime
(``mchap/tests/test_assemble/test_mcmc.py:250-352``): with error-free
reads at high depth the posterior concentrates on the true genotype;
at low depth it must NOT concentrate (the sampler honestly reports
uncertainty).  These run the real ``DenovoMCMC.fit`` XLA path on the
CPU backend; chip_smoke.py gates the same sampler against exact
enumeration on the GPU.
"""

import numpy as np
import pytest

from mchap_tpu.models.assemble import DenovoMCMC
from mchap_tpu.testing import simulate_reads

TETRAPLOID_TRUTH = np.array(
    [
        [0, 0, 0, 0, 0, 0],
        [0, 1, 0, 1, 1, 1],
        [0, 1, 0, 1, 1, 1],
        [1, 1, 1, 1, 1, 1],
    ],
    dtype=np.int8,
)


def _fit_posterior(haplotypes, n_reads, seed, steps=1000, burn=500):
    ploidy, n_base = haplotypes.shape
    reads = simulate_reads(
        haplotypes,
        n_reads=n_reads,
        uniform_sample=True,
        errors=False,
        qual=(60, 60),
        seed=seed,
    )
    model = DenovoMCMC(
        ploidy=ploidy,
        n_alleles=[2] * n_base,
        steps=steps,
        chains=2,
        random_seed=seed,
    )
    trace = model.fit(reads).burn(burn)
    assert trace.genotypes.shape == (2, steps - burn, ploidy, n_base)
    return trace, trace.posterior()


def test_denovo_diploid_high_depth_recovers_truth():
    haplotypes = np.array(
        [[0, 0, 0, 1, 1, 1], [1, 0, 0, 0, 0, 0]], dtype=np.int8
    )
    for seed in (0, 1, 2):
        _, posterior = _fit_posterior(haplotypes, n_reads=8, seed=seed)
        assert posterior.probabilities[0] > 0.90
        np.testing.assert_array_equal(haplotypes, posterior.genotypes[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_denovo_tetraploid_high_depth(seed):
    _, posterior = _fit_posterior(TETRAPLOID_TRUTH, n_reads=40, seed=seed)
    assert posterior.probabilities[0] > 0.90
    np.testing.assert_array_equal(TETRAPLOID_TRUTH, posterior.genotypes[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_denovo_tetraploid_medium_depth(seed):
    trace, posterior = _fit_posterior(TETRAPLOID_TRUTH, n_reads=16, seed=seed)
    # mode is the truth but with honest residual uncertainty
    assert 0.30 < posterior.probabilities[0] < 0.95
    np.testing.assert_array_equal(TETRAPLOID_TRUTH, posterior.genotypes[0])
    # at this depth independent chains cannot be identical step-for-step
    assert np.any(trace.genotypes[0] != trace.genotypes[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_denovo_tetraploid_low_depth(seed):
    _, posterior = _fit_posterior(TETRAPLOID_TRUTH, n_reads=8, seed=seed)
    assert posterior.probabilities[0] < 0.30
