"""Batched Gibbs / Metropolis-Hastings sampler over allele-index genotypes.

Accelerator-first re-design of ``mchap/calling/mcmc.py``: the reference runs one
chain at a time, scoring each of the n_alleles options for one slot with
a fresh triple-loop likelihood call (mitigated by a dict cache).  Here:

- the read x haplotype log-likelihood matrix is computed ONCE per sample
  (ops/likelihood.read_hap_loglik — one matmul), so scoring ALL
  options of a Gibbs slot is a rank-1 logaddexp update + one matvec
  against read counts (`_option_llks`);
- chains are a batch axis (vmap), steps and slots are lax.scan loops;
- no caches: recomputation is cheaper than serial cache lookups and the
  reference's own golden tests prove cache on/off changes nothing.

All samplers are built by a factory keyed on static shape/config so each
(ploidy, n_alleles, steps, step_type, prior-kind) bucket compiles once.
"""

import functools

import jax
import jax.numpy as jnp

from mchap_tpu.ops.priors import (
    log_genotype_allele_flat_prior,
    log_genotype_allele_prior,
    log_genotype_prior,
)

# every f32 contraction on the likelihood path runs at full precision:
# an f32 GPU dot may otherwise run in TF32 (about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST

_NEG = -1e300  # effectively -inf in f64 logits without nan-propagation risk


def _option_llks(read_hap, read_counts, genotype, slot, log_ploidy):
    """llk of every allele option for one Gibbs slot, in one shot.

    read_hap: f[R, H]; genotype: i[p]; slot: traced int.
    Returns f[H]: llk of the genotype with ``slot`` replaced by each allele.

    Per read: logaddexp of the (p-1) kept slots' lse with each option's
    read-hap log-prob; weighted sum over reads is a matvec.
    """
    ploidy = genotype.shape[0]
    sub = read_hap[:, genotype]  # [R, p]
    keep = jnp.arange(ploidy) != slot  # [p]
    masked = jnp.where(keep[None, :], sub, _NEG)
    rest = jax.scipy.special.logsumexp(masked, axis=-1)  # [R]
    combined = jnp.logaddexp(rest[:, None], read_hap)  # [R, H]
    read_log = combined - log_ploidy
    return jnp.matmul(read_counts, read_log, precision=_HIGHEST)  # [H]


def _option_genotypes(genotype, slot, n_alleles):
    """All option genotypes [H, p]: ``slot`` replaced by each allele."""
    options = jnp.broadcast_to(genotype, (n_alleles,) + genotype.shape)
    return options.at[:, slot].set(jnp.arange(n_alleles, dtype=genotype.dtype))


def _option_priors(genotype, slot, n_alleles, prior_kind, inbreeding, frequencies):
    """Gibbs conditional log-prior of every allele option for one slot.

    prior_kind: 0 = no prior (flat-with-multiplicity, reference
    ``log_genotype_allele_flat_prior``); 1 = Dirichlet-multinomial /
    frequency prior (reference ``log_genotype_allele_prior``).
    """
    options = _option_genotypes(genotype, slot, n_alleles)
    slots = jnp.full((n_alleles,), slot)
    if prior_kind == 0:
        return log_genotype_allele_flat_prior(options, slots)
    return log_genotype_allele_prior(
        options, slots, n_alleles, inbreeding=inbreeding, frequencies=frequencies
    )


def _gibbs_slot(key, genotype, slot, read_hap, read_counts, log_ploidy,
                prior_kind, inbreeding, frequencies, n_valid=None):
    n_alleles = read_hap.shape[-1]
    llks = _option_llks(read_hap, read_counts, genotype, slot, log_ploidy)
    lpriors = _option_priors(
        genotype, slot, n_alleles, prior_kind, inbreeding, frequencies
    )
    logits = llks + lpriors.astype(llks.dtype)
    if n_valid is not None:
        # columns >= n_valid are padding alleles (cross-locus batching)
        logits = jnp.where(jnp.arange(n_alleles) < n_valid, logits, _NEG)
    choice = jax.random.categorical(key, logits)
    return genotype.at[slot].set(choice.astype(genotype.dtype)), llks[choice]


def _mh_slot(key, genotype, slot, read_hap, read_counts, log_ploidy,
             prior_kind, inbreeding, frequencies, n_valid=None):
    """Metropolis-Hastings slot update; reference calling/mcmc.py:15-140."""
    n_alleles = read_hap.shape[-1]
    ploidy = genotype.shape[0]
    llks = _option_llks(read_hap, read_counts, genotype, slot, log_ploidy)
    options = _option_genotypes(genotype, slot, n_alleles)
    if prior_kind == 0:
        lpriors = jnp.zeros(n_alleles, llks.dtype)
    else:
        lpriors = log_genotype_prior(
            options, n_alleles, inbreeding=inbreeding, frequencies=frequencies
        ).astype(llks.dtype)
    current = genotype[slot]
    llk = llks[current]
    lprior = lpriors[current]
    # proposal ratio: copies of option allele in proposed / copies of
    # current allele in current genotype (calling/mcmc.py:123-127)
    counts_other = jnp.sum(
        jnp.where(jnp.arange(ploidy) != slot, 1, 0)[None, :]
        * (genotype[None, :] == jnp.arange(n_alleles)[:, None]),
        axis=-1,
    )  # [H] copies among constant slots
    copies_proposed = counts_other + 1
    copies_current = counts_other[current] + 1
    lproposal = jnp.log(copies_proposed.astype(llks.dtype)) - jnp.log(
        copies_current.astype(llks.dtype)
    )
    mh_ratio = (llks - llk) + (lpriors - lprior) + lproposal
    accept = jnp.exp(jnp.minimum(0.0, mh_ratio))
    if n_valid is None:
        n_proposals = n_alleles - 1
    else:
        # padding alleles are never proposed; uniform over the valid rest
        accept = jnp.where(jnp.arange(n_alleles) < n_valid, accept, 0.0)
        n_proposals = (n_valid - 1).astype(accept.dtype)
    probs = accept.at[current].set(0.0) / n_proposals
    probs = probs.at[current].set(1.0 - jnp.sum(probs.at[current].set(0.0)))
    # inverse-CDF draw matching reference random_choice semantics
    cdf = jnp.cumsum(probs)
    u = jax.random.uniform(key, dtype=cdf.dtype)
    choice = jnp.sum(cdf <= u * cdf[-1], dtype=jnp.int32)
    return genotype.at[slot].set(choice.astype(genotype.dtype)), llks[choice]


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "step_type", "prior_kind"),
)
def calling_sampler(
    key,
    initial,
    read_hap,
    read_counts,
    *,
    n_steps,
    step_type=0,
    prior_kind=0,
    inbreeding=0.0,
    frequencies=None,
    n_valid=None,
):
    """Run batched-chain MCMC over allele-index genotypes.

    Parameters
    ----------
    key : PRNGKey
    initial : int[n_chains, ploidy]
    read_hap : f[R, H] precomputed read x haplotype log-probabilities
    read_counts : f[R]
    n_steps : static int
    step_type : static, 0 = Gibbs, 1 = Metropolis-Hastings
    prior_kind : static, 0 = flat (no prior supplied), 1 = DM/frequency
    inbreeding : traced float
    frequencies : f[H] or None (must be an array when prior_kind == 1)
    n_valid : traced int or None — number of real (non-padding) alleles;
        columns >= n_valid of ``read_hap`` are cross-locus batch padding
        and are excluded from sampling

    Returns
    -------
    genotypes : int[n_chains, n_steps, ploidy] (sorted per step)
    llks : f[n_chains, n_steps]

    Reference semantics: calling/mcmc.py:232-390 (compound step shuffles
    slots; genotype sorted each step; llk of final choice recorded).
    """
    n_chains, ploidy = initial.shape
    log_ploidy = jnp.log(jnp.asarray(ploidy, read_hap.dtype))
    freqs = frequencies if frequencies is not None else jnp.zeros(read_hap.shape[-1])
    slot_fn = _gibbs_slot if step_type == 0 else _mh_slot

    def chain(key, g0):
        def step(g, step_key):
            kperm, kslots = jax.random.split(step_key)
            order = jax.random.permutation(kperm, ploidy)
            slot_keys = jax.random.split(kslots, ploidy)

            def body(carry, xs):
                g = carry
                slot, skey = xs
                g, llk = slot_fn(
                    skey, g, slot, read_hap, read_counts, log_ploidy,
                    prior_kind, inbreeding, freqs, n_valid,
                )
                return g, llk

            g, llks = jax.lax.scan(body, g, (order, slot_keys))
            g = jnp.sort(g)
            return g, (g, llks[-1])

        _, (gs, llks) = jax.lax.scan(step, g0, jax.random.split(key, n_steps))
        return gs, llks

    keys = jax.random.split(key, n_chains)
    return jax.vmap(chain)(keys, initial)


@functools.partial(jax.jit, static_argnames=("ploidy", "prior_kind"))
def greedy_caller(
    read_hap,
    read_counts,
    *,
    ploidy,
    prior_kind=0,
    inbreeding=0.0,
    frequencies=None,
    n_valid=None,
):
    """Greedy initial genotype: add the best allele one slot at a time.

    Reference: calling/mcmc.py:393-453.  Partial genotypes of length k
    are scored with a k-haplotype likelihood (mean over k) plus the full
    genotype prior of the partial genotype.
    """
    n_alleles = read_hap.shape[-1]
    freqs = frequencies if frequencies is not None else jnp.zeros(n_alleles)
    genotype = jnp.zeros(0, jnp.int32)
    for i in range(ploidy):
        k = i + 1
        options = jnp.concatenate(
            [
                jnp.broadcast_to(genotype, (n_alleles, i)),
                jnp.arange(n_alleles, dtype=jnp.int32)[:, None],
            ],
            axis=-1,
        )  # [H, k]
        sub = read_hap[:, options]  # [R, H, k]
        read_log = jax.scipy.special.logsumexp(sub, axis=-1) - jnp.log(
            jnp.asarray(k, read_hap.dtype)
        )
        llks = jnp.matmul(read_counts, read_log, precision=_HIGHEST)  # [H]
        if prior_kind == 0:
            lpriors = jnp.zeros(n_alleles)
        else:
            lpriors = log_genotype_prior(
                options, n_alleles, inbreeding=inbreeding, frequencies=freqs
            )
        scores = llks + lpriors
        if n_valid is not None:
            scores = jnp.where(jnp.arange(n_alleles) < n_valid, scores, _NEG)
        best = jnp.argmax(scores)
        genotype = jnp.concatenate([genotype, best[None].astype(jnp.int32)])
    return jnp.sort(genotype)
