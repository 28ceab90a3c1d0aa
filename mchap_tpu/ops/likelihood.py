"""Read-pileup log-likelihood kernels (JAX/XLA).

Accelerator-first re-design of the reference hot kernel ``log_likelihood``
(``mchap/assemble/likelihood.py:17-70``), which scores
P(reads | genotype) with a triple loop over reads x ploidy x positions for
*every* MCMC proposal (mitigated there by a serial trie cache,
``assemble/arraymap.py``).

Here the expensive part — the per-read, per-haplotype product over
positions — is computed ONCE as a single matmul
(``read_hap_loglik``: log-read tensor [R, P*A] x one-hot haplotypes
[P*A, K]), and every subsequent genotype evaluation is a cheap gather +
logsumexp over the precomputed [R, K] matrix (``log_likelihood``).
Caches are unnecessary: recomputation from the [R, K] matrix is O(R *
ploidy) and fully batched.  The golden tests of the reference prove cache
on/off does not change results (test_application_assemble.py:356).

Conventions
-----------
- ``reads``: float[..., R, P, A] probabilistic read matrices; ``nan``
  marks a gap (no observation) exactly as in the reference encoding
  (``encoding/integer/transcode.py:16-77``).
- ``log_reads`` = log(reads) with gaps replaced by log(1) = 0 so they drop
  out of sums, and zeros clamped to a large negative finite value so that
  0 * (-inf) never produces nan inside the matmul.
- ``read_counts``: float/int[..., R] de-duplicated read multiplicities.
"""

import jax
import jax.numpy as jnp

# Large negative stand-in for log(0): finite so 0 * MIN_LOG == 0 inside
# the one-hot matmul, yet small enough that exp() underflows to 0.
MIN_LOG = -1e30


def prepare_reads(reads, dtype=jnp.float64):
    """Convert probabilistic reads to the log-domain tensor used on device.

    nan (gap) -> 0.0 (multiplicative identity); 0.0 -> MIN_LOG.
    """
    reads = jnp.asarray(reads, dtype)
    logs = jnp.log(jnp.where(jnp.isnan(reads), 1.0, reads))
    return jnp.maximum(logs, MIN_LOG)


def read_hap_loglik(log_reads, haplotypes):
    """log P(read r | haplotype k) for every read x haplotype pair.

    Parameters
    ----------
    log_reads : float[..., R, P, A]
        Output of ``prepare_reads``.
    haplotypes : int[..., K, P]
        Integer-encoded haplotypes; negative alleles (null) contribute
        probability 1 at that position (they select no allele column).

    Returns
    -------
    float[..., R, K]

    Notes
    -----
    This is the matmul formulation of the reference's inner product over
    positions (assemble/likelihood.py:51-59): the product over positions of
    selected allele probabilities equals exp of a single dot product
    between the flattened log-read tensor and the one-hot haplotype.
    """
    n_alleles = log_reads.shape[-1]
    onehot = jax.nn.one_hot(haplotypes, n_alleles, dtype=log_reads.dtype)
    return jnp.einsum(
        "...rpa,...kpa->...rk",
        log_reads,
        onehot,
        preferred_element_type=log_reads.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )


def log_likelihood_from_read_hap(read_hap, genotype, read_counts=None):
    """llk of a genotype given the precomputed read x haplotype matrix.

    Parameters
    ----------
    read_hap : float[..., R, K]
    genotype : int[..., ploidy] indices into the K axis
    read_counts : float[..., R] or None

    Matches reference ``log_likelihood`` (assemble/likelihood.py:17-70):
    per read, mean over ploidy haplotypes of the per-haplotype
    probability; log; weighted sum over reads.
    """
    ploidy = genotype.shape[-1]
    sub = jnp.take_along_axis(
        read_hap, genotype[..., None, :], axis=-1
    )  # [..., R, ploidy]
    read_log = jax.scipy.special.logsumexp(sub, axis=-1) - jnp.log(
        jnp.asarray(ploidy, read_hap.dtype)
    )
    if read_counts is not None:
        read_log = read_log * read_counts
    return jnp.sum(read_log, axis=-1)


def log_likelihood(reads, genotype, read_counts=None, dtype=jnp.float64):
    """llk of a genotype of materialized haplotypes given probabilistic reads.

    Drop-in semantic equivalent of reference ``log_likelihood``
    (assemble/likelihood.py:17-70) for genotype int[..., ploidy, P].
    """
    log_reads = prepare_reads(reads, dtype)
    rh = read_hap_loglik(log_reads, genotype)  # [..., R, ploidy]
    ploidy = genotype.shape[-2]
    read_log = jax.scipy.special.logsumexp(rh, axis=-1) - jnp.log(
        jnp.asarray(ploidy, rh.dtype)
    )
    if read_counts is not None:
        read_log = read_log * jnp.asarray(read_counts, rh.dtype)
    return jnp.sum(read_log, axis=-1)
