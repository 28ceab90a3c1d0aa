"""Exact genotype enumeration caller (the ``call-exact`` compute core).

Accelerator-first re-design of ``mchap/calling/exact.py``: the reference streams
genotypes one at a time through ``increment_genotype`` with a scalar
accumulator (exact.py:17-61); here the full VCF-ordered genotype table is
a batch axis and the whole posterior is computed with two matmuls:

1. ``read_hap_loglik``: log P(read | haplotype) for the panel — one
   matmul over the log-read tensor (see ops/likelihood.py).
2. genotype likelihoods for ALL genotypes at once:
   P(read | genotype) = (1/ploidy) * sum_k dosage[g, k] * P(read | hap k),
   i.e. a single [R, K] x [K, G] matmul against the dosage matrix —
   no per-genotype gather loops at all.

This module is also the exact oracle that gates every MCMC sampler test
(same role as the reference's use of exact.py in
tests/test_calling/test_calling_mcmc.py:122+).
"""

import jax
import jax.numpy as jnp
import numpy as np

from mchap_tpu.numerics.combinadics import count_unique_genotypes, enumerate_genotypes
from mchap_tpu.ops.likelihood import prepare_reads, read_hap_loglik
from mchap_tpu.ops.priors import log_genotype_prior

# every f32 contraction on the likelihood path runs at full precision:
# an f32 GPU dot may otherwise run in TF32 (about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST


def genotype_dosage_table(n_alleles: int, ploidy: int) -> np.ndarray:
    """Dense [G, K] dosage matrix of the VCF-ordered genotype table."""
    table = enumerate_genotypes(n_alleles, ploidy)  # [G, ploidy]
    dosage = np.zeros((table.shape[0], n_alleles), np.int32)
    rows = np.repeat(np.arange(table.shape[0]), ploidy)
    np.add.at(dosage, (rows, table.ravel()), 1)
    return dosage


def genotype_likelihoods_from_read_hap(read_hap, ploidy, read_counts=None):
    """llk of every VCF-ordered genotype from the [.., R, K] read-hap matrix.

    Semantics of reference ``_genotype_likelihoods`` (calling/exact.py:252-263)
    but evaluated as one dosage matmul.
    """
    n_alleles = read_hap.shape[-1]
    dosage = jnp.asarray(
        genotype_dosage_table(n_alleles, ploidy), read_hap.dtype
    )  # [G, K]
    # scale per read for stability: P(read|g) = exp(m_r) * dot(E_r, d_g) / p
    m = jnp.max(read_hap, axis=-1)  # [.., R]
    m = jnp.maximum(m, -1e300 if read_hap.dtype == jnp.float64 else -1e30)
    e = jnp.exp(read_hap - m[..., None])  # [.., R, K]
    probs = jnp.einsum(
        "...rk,gk->...rg", e, dosage, preferred_element_type=read_hap.dtype,
        precision=_HIGHEST,
    )
    read_log = jnp.log(probs) + m[..., None] - jnp.log(jnp.asarray(ploidy, read_hap.dtype))
    if read_counts is not None:
        read_log = read_log * jnp.asarray(read_counts, read_hap.dtype)[..., None]
    return jnp.sum(read_log, axis=-2)  # [.., G]


def genotype_likelihoods(reads, ploidy, haplotypes, read_counts=None, dtype=jnp.float64):
    """llk of every possible genotype; reference calling/exact.py:266-292."""
    log_reads = prepare_reads(reads, dtype)
    read_hap = read_hap_loglik(log_reads, jnp.asarray(haplotypes))
    return genotype_likelihoods_from_read_hap(read_hap, ploidy, read_counts)


def genotype_posteriors(log_likelihoods, ploidy, n_alleles, prior=None):
    """Posterior over all genotypes; reference calling/exact.py:295-329.

    ``prior``: optional (inbreeding, frequencies-or-None) tuple as in the
    reference.
    """
    llks = jnp.asarray(log_likelihoods)
    if prior is not None:
        table = jnp.asarray(enumerate_genotypes(n_alleles, ploidy))
        lpriors = log_genotype_prior(
            table, n_alleles, inbreeding=prior[0], frequencies=prior[1]
        )
        llks = llks + lpriors.astype(llks.dtype)
    return jnp.exp(llks - jax.scipy.special.logsumexp(llks, axis=-1)[..., None])


def posterior_allele_frequencies(posteriors, ploidy, n_alleles):
    """Posterior mean allele freqs / counts / occurrence probabilities.

    Reference calling/exact.py:332-369.  Returns (freqs, counts, occur).
    """
    p = jnp.asarray(posteriors)
    dosage = jnp.asarray(genotype_dosage_table(n_alleles, ploidy), p.dtype)  # [G, K]
    counts = jnp.einsum("...g,gk->...k", p, dosage, precision=_HIGHEST)
    occur = jnp.einsum(
        "...g,gk->...k", p, (dosage > 0).astype(p.dtype), precision=_HIGHEST
    )
    return counts / ploidy, counts, occur


# Genotypes whose posteriors agree to this relative tolerance count as
# tied and the lowest VCF index wins.  Symmetric genotypes (two panel
# haplotypes no read tells apart) tie exactly in exact arithmetic, and
# which of them a bare argmax picks then depends on summation order:
# per-locus vs cross-locus padding, CPU vs GPU.  Rounding noise in the
# posteriors is ~1e-11 relative; real differences are far larger.
MODE_TIE_RTOL = 1e-9


def mode_index(posteriors):
    """Index of the posterior mode, ties resolved to the lowest index."""
    p = jnp.asarray(posteriors)
    best = jnp.max(p, axis=-1, keepdims=True)
    return jnp.argmax(p >= best * (1.0 - MODE_TIE_RTOL), axis=-1)


def mode_genotype(posteriors, ploidy, n_alleles):
    """Posterior-mode genotype alleles + its probability + support probability.

    Support probability = summed posterior of all genotypes containing
    exactly the mode's allele set at any dosage (reference
    ``_genotype_support_log_joint``, calling/exact.py:64-105, and
    ``alternate_dosage_posteriors``, :372-407).

    Returns (alleles int[..., ploidy], mode_prob, support_prob, mode_index).
    """
    p = jnp.asarray(posteriors)
    table = jnp.asarray(enumerate_genotypes(n_alleles, ploidy))  # [G, ploidy]
    occupancy = jnp.asarray(
        genotype_dosage_table(n_alleles, ploidy) > 0
    )  # [G, K]
    idx = mode_index(p)
    alleles = table[idx]
    mode_prob = jnp.take_along_axis(p, idx[..., None], axis=-1)[..., 0]
    mode_occ = occupancy[idx]  # [..., K]
    same_support = jnp.all(
        occupancy == mode_occ[..., None, :], axis=-1
    )  # [..., G]
    support_prob = jnp.sum(jnp.where(same_support, p, 0.0), axis=-1)
    return alleles, mode_prob, support_prob, idx


def alternate_dosage_posteriors(genotype_alleles, probabilities):
    """Host-side: probabilities of all dosage-alternatives of a genotype.

    Reference calling/exact.py:372-407.  Returns (genotypes [N, ploidy],
    probs [N]) ordered by genotype index.
    """
    genotype_alleles = np.asarray(genotype_alleles)
    probabilities = np.asarray(probabilities)
    ploidy = len(genotype_alleles)
    support = np.unique(genotype_alleles)
    n_alleles_panel = int(round((_n_from_g(len(probabilities), ploidy))))
    table = enumerate_genotypes(n_alleles_panel, ploidy)
    occupancy = genotype_dosage_table(n_alleles_panel, ploidy) > 0
    target = np.zeros(n_alleles_panel, bool)
    target[support] = True
    mask = np.all(occupancy == target, axis=-1)
    indices = np.flatnonzero(mask)
    return table[indices], probabilities[indices]


def _n_from_g(n_genotypes: int, ploidy: int) -> int:
    """Invert G = C(n + ploidy - 1, ploidy) for the panel size n."""
    n = 1
    while count_unique_genotypes(n, ploidy) < n_genotypes:
        n += 1
    if count_unique_genotypes(n, ploidy) != n_genotypes:
        raise ValueError("invalid number of genotypes for ploidy")
    return n


import functools


@functools.partial(jax.jit, static_argnames=("ploidy", "use_prior"))
def _exact_stats_batch(read_hap, counts, n_valid, inbreeding, frequencies,
                       *, ploidy, use_prior):
    """Batched exact posterior statistics over a padded panel.

    ``read_hap``: f[B, R, H_pad] (padded haplotype columns MIN_LOG,
    padded reads all-zero rows with count 0); ``n_valid``: i[B] true
    panel sizes.  Genotypes drawing any allele >= n_valid[b] occupy a
    contiguous SUFFIX of the VCF-ordered genotype table (the table over
    the first H alleles is a prefix of the table over H' > H), so they
    are masked to -inf before normalisation — the valid prefix is then
    numerically the problem's own exact posterior.

    Returns (alleles [B, ploidy], mode_prob [B], support_prob [B],
    freqs [B, H_pad], occur [B, H_pad]).
    """
    n_pad = read_hap.shape[-1]
    llks = genotype_likelihoods_from_read_hap(read_hap, ploidy, counts)
    table = jnp.asarray(enumerate_genotypes(n_pad, ploidy))  # [G, ploidy]
    if use_prior:
        lprior = jax.vmap(
            lambda ib, fr: log_genotype_prior(
                table, n_pad, inbreeding=ib, frequencies=fr
            )
        )(inbreeding, frequencies)
        scores = llks + lprior.astype(llks.dtype)
    else:
        scores = llks
    valid = jnp.max(table, axis=-1)[None, :] < n_valid[:, None]  # [B, G]
    scores = jnp.where(valid, scores, -jnp.inf)
    post = jnp.exp(
        scores - jax.scipy.special.logsumexp(scores, axis=-1)[..., None]
    )
    alleles, mode_prob, support_prob, _ = mode_genotype(post, ploidy, n_pad)
    freqs, _, occur = posterior_allele_frequencies(post, ploidy, n_pad)
    return alleles, mode_prob, support_prob, freqs, occur


def exact_posterior_stats_multi(problems, ploidy, dtype=jnp.float64):
    """Exact posterior-mode statistics for problems from MANY LOCI in
    one device program (the ``call-exact`` analogue of
    ``fit_calling_multi``'s cross-locus streaming).

    Each problem: dict with ``reads`` (f[R_i, nb_i, A_i]), ``counts``
    (f[R_i]), ``haplotypes`` (i[H_i, nb_i]) and optionally
    ``inbreeding``/``frequencies``.  Panels pad to the block maximum
    with MIN_LOG read-hap columns, reads to a power-of-two bucket; one
    [B, R, H] x [H, G] program then computes every problem's full
    VCF-ordered posterior (reference semantics calling/exact.py:156-249,
    evaluated batched instead of as a per-genotype streaming scan).

    A problem with ``inbreeding`` but no ``frequencies`` uses the
    uniform 1/H_i frequencies (the reference's ``frequencies=None``
    parametrisation, made explicit so panel padding cannot distort it).

    Returns a list of dicts with keys ``alleles``, ``mode_prob``,
    ``support_prob``, ``freqs``, ``occur`` (sliced to each problem's
    own panel size).
    """
    from mchap_tpu.ops.likelihood import MIN_LOG

    n_problems = len(problems)
    use_prior = any(p.get("inbreeding") is not None for p in problems)
    h_list = [len(p["haplotypes"]) for p in problems]
    # pad the panel axis to a power of two: one compiled program (and
    # one genotype table) per panel-size bucket across blocks
    h_max = 1
    while h_max < max(h_list):
        h_max *= 2

    rh_list = []
    for p in problems:
        log_reads = prepare_reads(p["reads"], dtype)
        rh = np.asarray(
            read_hap_loglik(log_reads, jnp.asarray(p["haplotypes"]))
        )
        if rh.shape[1] < h_max:
            rh = np.concatenate(
                [rh, np.full((rh.shape[0], h_max - rh.shape[1]), MIN_LOG)],
                axis=1,
            )
        rh_list.append(rh)

    bucket = 8
    while bucket < max((len(r) for r in rh_list), default=1):
        bucket *= 2
    read_hap = np.zeros((n_problems, bucket, h_max))
    counts = np.zeros((n_problems, bucket))
    for i, (rh, p) in enumerate(zip(rh_list, problems)):
        read_hap[i, : len(rh)] = rh
        counts[i, : len(rh)] = p["counts"]

    inbreeding = np.zeros(n_problems)
    frequencies = np.zeros((n_problems, h_max))
    for i, p in enumerate(problems):
        inbreeding[i] = float(p.get("inbreeding") or 0.0)
        freqs = p.get("frequencies")
        if freqs is None:
            freqs = np.full(h_list[i], 1.0 / h_list[i])
        frequencies[i, : h_list[i]] = np.asarray(freqs, float)

    # pad the problem axis to a fixed granularity (repeat the final
    # problem) so block size changes re-use one compiled program
    b_pad = ((n_problems + 31) // 32) * 32
    n_valid = np.asarray(h_list, np.int32)
    if b_pad != n_problems:
        extra = b_pad - n_problems

        def _rep(a):
            return np.concatenate([a] + [a[-1:]] * extra)

        read_hap, counts, n_valid, inbreeding, frequencies = map(
            _rep, (read_hap, counts, n_valid, inbreeding, frequencies)
        )

    alleles, mode_prob, support_prob, freqs, occur = _exact_stats_batch(
        jnp.asarray(read_hap, dtype),
        jnp.asarray(counts, dtype),
        jnp.asarray(n_valid),
        jnp.asarray(inbreeding, dtype),
        jnp.asarray(frequencies, dtype),
        ploidy=ploidy,
        use_prior=use_prior,
    )
    alleles = np.asarray(alleles)
    mode_prob = np.asarray(mode_prob)
    support_prob = np.asarray(support_prob)
    freqs = np.asarray(freqs)
    occur = np.asarray(occur)
    return [
        dict(
            alleles=alleles[i],
            mode_prob=float(mode_prob[i]),
            support_prob=float(support_prob[i]),
            freqs=freqs[i, : h_list[i]],
            occur=occur[i, : h_list[i]],
        )
        for i in range(n_problems)
    ]


def posterior_mode(
    reads,
    ploidy,
    haplotypes,
    read_counts=None,
    prior=None,
    return_support_prob=False,
    return_posterior_frequencies=False,
    return_posterior_occurrence=False,
    dtype=jnp.float64,
):
    """Mode genotype + statistics; API of reference calling/exact.py:156-249.

    Unlike the reference's low-memory streaming scan, the full posterior is
    materialized on device (one [R, G] matmul); G stays modest for the
    panel sizes where exact calling is tractable at all.
    """
    llks = genotype_likelihoods(reads, ploidy, haplotypes, read_counts, dtype=dtype)
    n_alleles = len(haplotypes)
    post = genotype_posteriors(llks, ploidy, n_alleles, prior=prior)
    alleles, mode_prob, support_prob, idx = mode_genotype(post, ploidy, n_alleles)
    mode_llk = llks[..., idx]
    result = [np.asarray(alleles), float(mode_llk), float(mode_prob)]
    if return_support_prob:
        result.append(float(support_prob))
    if return_posterior_frequencies or return_posterior_occurrence:
        freqs, _, occur = posterior_allele_frequencies(post, ploidy, n_alleles)
        if return_posterior_frequencies:
            result.append(np.asarray(freqs))
        if return_posterior_occurrence:
            result.append(np.asarray(occur))
    return tuple(result)
