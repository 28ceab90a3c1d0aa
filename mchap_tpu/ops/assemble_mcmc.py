"""Batched de novo assembly MCMC (the flagship sampler).

Accelerator-first re-design of ``mchap/assemble/`` (mutation.py, structural.py,
tempering.py, mcmc.py): one jitted program runs the full
mutation/recombination/dosage/tempering step for ALL chains at once
(chains vmapped; temperatures unrolled; sites/intervals as lax.scan).

Key design deltas vs the reference (per SURVEY.md §7.1):

- The per-read x per-haplotype log-probability matrix ``rh[r, h]`` is
  maintained incrementally: a mutation at (haplotype h, position j)
  is a rank-1 update, and a structural move swaps interval partial sums
  — so no proposal ever recomputes the reads x ploidy x positions
  triple loop (the reference's hottest kernel,
  assemble/likelihood.py:17-70, there mitigated by a serial trie cache).
- Data-dependent enumerations become fixed-size masked enumerations:
  recombination options over the C(ploidy, 2) pair table and dosage
  options over the ploidy*(ploidy-1) ordered-pair table, invalid
  entries masked (structural.py:121-307).
- Homozygote fixing keeps a static shape: fixed positions stay in the
  state with ``n_alleles = 1`` so every mutation/structural sub-step on
  them is a provable no-op, instead of slicing them out
  (mcmc.py:168-199); interval proposals are padded to n_base with empty
  intervals which are likewise no-ops.
"""

import functools

import jax
import jax.numpy as jnp

from mchap_tpu.ops.priors import log_genotype_prior_dosage

# every f32 contraction on the likelihood path runs at full precision:
# an f32 GPU dot may otherwise run in TF32 (about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST

_NEG = -1e300


def _dosage_from_eq(eq):
    """Haplotype dosage vector from a pairwise row-equality matrix.

    Matches reference ``get_haplotype_dosage`` (jitutils.py:378-422):
    count credited to the first row of each equal group, 0 for dups.
    ``eq``: bool[..., p, p].
    """
    p = eq.shape[-1]
    tri = jnp.tril(jnp.ones((p, p), bool), k=-1)
    first = ~jnp.any(eq & tri, axis=-1)
    counts = jnp.sum(eq, axis=-1)
    return jnp.where(first, counts, 0)


def _row_eq(genotype, mask=None):
    """Pairwise row equality of genotype rows, optionally only at
    positions where ``mask`` is True.  genotype: i[p, nb]."""
    diff = genotype[:, None, :] != genotype[None, :, :]
    if mask is not None:
        diff = diff & mask[None, None, :]
    return ~jnp.any(diff, axis=-1)


def _first_occurrence_labels(eq):
    """Label rows by the index of their first equal row (reference
    ``_label_haplotypes``, structural.py:310-361)."""
    p = eq.shape[-1]
    allowed = eq & (jnp.arange(p)[None, :] <= jnp.arange(p)[:, None])
    return jnp.argmax(allowed, axis=-1)


def segment_labels(genotype, interval_mask):
    """[p, 2] labels: col 0 inside the interval, col 1 outside.

    Reference ``haplotype_segment_labels`` (structural.py:393-430).
    """
    inside = _first_occurrence_labels(_row_eq(genotype, interval_mask))
    outside = _first_occurrence_labels(_row_eq(genotype, ~interval_mask))
    return jnp.stack([inside, outside], axis=-1)


def _labels_dosage(labels):
    """Dosage over [., p, 2] label rows (rows equal iff both labels equal)."""
    eq = jnp.all(labels[..., :, None, :] == labels[..., None, :, :], axis=-1)
    return _dosage_from_eq(eq)


def _recombination_pairs(ploidy):
    return [(h0, h1) for h0 in range(ploidy) for h1 in range(h0 + 1, ploidy)]


def _dosage_pairs(ploidy):
    return [(h0, h1) for h0 in range(ploidy) for h1 in range(ploidy) if h0 != h1]


def recombination_options(labels):
    """All C(p,2) recombination option label-matrices + validity mask.

    Reference ``recombination_step_options`` (structural.py:121-178).
    Returns (options [K, p, 2], valid [K]).
    """
    p = labels.shape[0]
    dosage = _labels_dosage(labels)
    pairs = _recombination_pairs(p)
    options = []
    valids = []
    for h0, h1 in pairs:
        opt = labels.at[h0, 0].set(labels[h1, 0]).at[h1, 0].set(labels[h0, 0])
        valid = (
            (dosage[h0] != 0)
            & (dosage[h1] != 0)
            & (labels[h0, 0] != labels[h1, 0])
            & (labels[h0, 1] != labels[h1, 1])
        )
        options.append(opt)
        valids.append(valid)
    return jnp.stack(options), jnp.stack(valids)


def recombination_n_options(labels):
    """Count of valid recombination options (vectorizable over a leading
    batch of label matrices); reference structural.py:74-118."""
    dosage = _labels_dosage(labels)
    p = labels.shape[-2]
    n = jnp.zeros(labels.shape[:-2], jnp.int32)
    for h0, h1 in _recombination_pairs(p):
        valid = (
            (dosage[..., h0] != 0)
            & (dosage[..., h1] != 0)
            & (labels[..., h0, 0] != labels[..., h1, 0])
            & (labels[..., h0, 1] != labels[..., h1, 1])
        )
        n = n + valid
    return n


def _segment_dosage(labels):
    """Dosage over the interval-segment labels (col 0 only)."""
    eq = labels[..., :, None, 0] == labels[..., None, :, 0]
    return _dosage_from_eq(eq)


def dosage_options(labels):
    """All p*(p-1) dosage-swap option label-matrices + validity mask.

    Reference ``dosage_step_options`` (structural.py:240-307): receiver
    h0's segment is overwritten with donor h1's segment.
    Returns (options [K, p, 2], valid [K]).
    """
    p = labels.shape[0]
    hap_dosage = _labels_dosage(labels)
    seg_dosage = _segment_dosage(labels)
    options = []
    valids = []
    for h0, h1 in _dosage_pairs(p):
        opt = labels.at[h0, 0].set(labels[h1, 0])
        valid = (
            (hap_dosage[h0] != 0)
            & (seg_dosage[h0] != 1)
            & (seg_dosage[h1] != 0)
            & (labels[h0, 0] != labels[h1, 0])
        )
        options.append(opt)
        valids.append(valid)
    return jnp.stack(options), jnp.stack(valids)


def dosage_n_options(labels):
    """Count of valid dosage options (batched); structural.py:181-237."""
    p = labels.shape[-2]
    hap_dosage = _labels_dosage(labels)
    seg_dosage = _segment_dosage(labels)
    n = jnp.zeros(labels.shape[:-2], jnp.int32)
    for h0, h1 in _dosage_pairs(p):
        valid = (
            (hap_dosage[..., h0] != 0)
            & (seg_dosage[..., h0] != 1)
            & (seg_dosage[..., h1] != 0)
            & (labels[..., h0, 0] != labels[..., h1, 0])
        )
        n = n + valid
    return n


def _inverse_cdf_choice(key, probabilities):
    """Reference random_choice semantics (searchsorted on the cumsum)."""
    cdf = jnp.cumsum(probabilities)
    u = jax.random.uniform(key, dtype=cdf.dtype)
    choice = jnp.sum(cdf <= u, dtype=jnp.int32)
    return jnp.minimum(choice, probabilities.shape[0] - 1)


def _genotype_prior_from_eq(eq, log_uh, inbreeding):
    dosage = _dosage_from_eq(eq)
    return log_genotype_prior_dosage(dosage, log_uh, inbreeding=inbreeding)


# ---------------------------------------------------------------------------
# mutation compound step (reference assemble/mutation.py)
# ---------------------------------------------------------------------------


def mutation_sweep(
    key,
    genotype,
    rh,
    llk,
    log_reads,
    read_counts,
    n_alleles_arr,
    log_uh,
    temp,
    use_prior,
    inbreeding,
):
    """Shuffled MH-within-Gibbs sweep over all (haplotype, position) sites.

    Reference ``mutation.compound_step`` + ``base_step``
    (mutation.py:14-246).  ``rh`` ([R, p] per-read per-haplotype log
    probabilities) is updated incrementally (rank-1 per accepted move).
    """
    p, nb = genotype.shape
    n_reads, max_allele = log_reads.shape[0], log_reads.shape[2]
    log_p = jnp.log(jnp.asarray(p, rh.dtype))
    arange_a = jnp.arange(max_allele)
    arange_p = jnp.arange(p)

    kperm, ksites = jax.random.split(key)
    order = jax.random.permutation(kperm, p * nb)
    sites_h = order // nb
    sites_j = order % nb
    site_keys = jax.random.split(ksites, p * nb)

    def site_step(carry, xs):
        genotype, rh, llk = carry
        h, j, skey = xs
        lr_j = log_reads[:, j, :]  # [R, A]
        cur = genotype[h, j]
        base = rh[:, h] - lr_j[:, cur]  # [R]
        keep = arange_p != h
        rest = jax.scipy.special.logsumexp(
            jnp.where(keep[None, :], rh, _NEG), axis=-1
        )  # [R]
        cand = jnp.logaddexp(rest[:, None], base[:, None] + lr_j)  # [R, A]
        llks_a = jnp.matmul(read_counts, cand - log_p, precision=_HIGHEST)  # [A]

        # proposal ratio from haplotype copy counts (mutation.py:84-139)
        row = genotype[h]
        eq_except = (
            jnp.sum((genotype != row[None, :]) & (jnp.arange(nb) != j)[None, :], -1)
            == 0
        )  # [p] rows equal to h outside column j
        col = genotype[:, j]
        count_cur = 1 + jnp.sum(keep & eq_except & (col == cur))
        counts_a = 1 + jnp.sum(
            (keep & eq_except)[None, :] & (col[None, :] == arange_a[:, None]), -1
        )  # [A]
        lproposal = jnp.log(counts_a.astype(rh.dtype)) - jnp.log(
            count_cur.astype(rh.dtype)
        )

        if use_prior:
            eq_full = _row_eq(genotype)
            lprior = _genotype_prior_from_eq(eq_full, log_uh, inbreeding)
            # candidate equality: only row/col h changes
            eq_h_a = eq_except[None, :] & (col[None, :] == arange_a[:, None])
            eq_h_a = eq_h_a.at[:, h].set(True)  # [A, p]
            eq_a = jnp.broadcast_to(eq_full, (max_allele, p, p))
            eq_a = eq_a.at[:, h, :].set(eq_h_a).at[:, :, h].set(eq_h_a)
            lprior_a = _genotype_prior_from_eq(eq_a, log_uh, inbreeding)
            lprior_ratio = lprior_a - lprior
        else:
            lprior_ratio = jnp.zeros(max_allele)

        mh = (llks_a - llk + lprior_ratio) * temp + lproposal
        # n_alleles == 1 marks a homozygote-fixed position: no proposals
        # at all (not even allele 0 when the fixed allele is non-zero,
        # which would be an irreversible move; mcmc.py:168-199)
        valid = (
            (arange_a < n_alleles_arr[j])
            & (arange_a != cur)
            & (n_alleles_arr[j] > 1)
        )
        n_options = jnp.sum(valid)
        log_accept = jnp.where(valid, jnp.minimum(0.0, mh), _NEG) - jnp.log(
            jnp.maximum(n_options, 1).astype(rh.dtype)
        )
        probs = jnp.where(valid, jnp.exp(log_accept), 0.0)
        probs = probs.at[cur].set(1.0 - jnp.sum(probs))
        choice = _inverse_cdf_choice(skey, probs)

        genotype = genotype.at[h, j].set(choice.astype(genotype.dtype))
        rh = rh.at[:, h].set(base + lr_j[:, choice])
        llk = llks_a[choice]
        return (genotype, rh, llk), None

    (genotype, rh, llk), _ = jax.lax.scan(
        site_step, (genotype, rh, llk), (sites_h, sites_j, site_keys)
    )
    return genotype, rh, llk


# ---------------------------------------------------------------------------
# structural compound step (reference assemble/structural.py)
# ---------------------------------------------------------------------------


def interval_step(
    key,
    genotype,
    rh,
    llk,
    interval,
    log_reads,
    read_counts,
    log_uh,
    temp,
    step_type,
    use_prior,
    inbreeding,
):
    """One masked-enumeration structural MH step on one interval.

    Reference ``interval_step`` (structural.py:433-587); ``step_type``
    is static: 0 = recombination, 1 = dosage swap.
    """
    p, nb = genotype.shape
    log_p = jnp.log(jnp.asarray(p, rh.dtype))
    start, end = interval[0], interval[1]
    mask = (jnp.arange(nb) >= start) & (jnp.arange(nb) < end)

    labels = segment_labels(genotype, mask)
    if step_type == 0:
        options, valid = recombination_options(labels)
        n_return = recombination_n_options(options)
    else:
        options, valid = dosage_options(labels)
        n_return = dosage_n_options(options)
    n_options = jnp.sum(valid)

    # per-read interval partial sums of the current genotype
    lr_g = jnp.take_along_axis(
        log_reads, genotype.T[None, :, :], axis=-1
    )  # [R, nb, p]
    rh_int = jnp.sum(jnp.where(mask[None, :, None], lr_g, 0.0), axis=1)  # [R, p]
    rh_out = rh - rh_int

    srcs = options[:, :, 0]  # [K, p] segment-source row per option
    rh_opts = rh_out[None, :, :] + rh_int[:, srcs].transpose(1, 0, 2)  # [K, R, p]
    read_log = jax.scipy.special.logsumexp(rh_opts, axis=-1) - log_p  # [K, R]
    llk_opts = jnp.matmul(read_log, read_counts, precision=_HIGHEST)  # [K]

    if use_prior:
        eq = jnp.all(
            genotype[:, None, :] == genotype[None, :, :], axis=-1
        )
        lprior = _genotype_prior_from_eq(eq, log_uh, inbreeding)
        lprior_opts = _genotype_prior_from_eq(
            jnp.all(options[:, :, None, :] == options[:, None, :, :], axis=-1),
            log_uh,
            inbreeding,
        )
        lprior_ratio = lprior_opts - lprior
    else:
        lprior_ratio = jnp.zeros(len(srcs))

    lproposal = jnp.log(jnp.maximum(n_options, 1).astype(rh.dtype)) - jnp.log(
        jnp.maximum(n_return, 1).astype(rh.dtype)
    )
    mh = (llk_opts - llk + lprior_ratio) * temp + lproposal
    log_accept = jnp.where(valid, jnp.minimum(0.0, mh), _NEG) - jnp.log(
        jnp.maximum(n_options, 1).astype(rh.dtype)
    )
    probs = jnp.where(valid, jnp.exp(log_accept), 0.0)
    probs = jnp.concatenate([probs, (1.0 - probs.sum())[None]])
    choice = _inverse_cdf_choice(key, probs)
    K = srcs.shape[0]
    accepted = choice < K
    safe_choice = jnp.minimum(choice, K - 1)

    src = jnp.where(accepted, srcs[safe_choice], jnp.arange(p))
    genotype_new = jnp.where(mask[None, :], genotype[src], genotype)
    rh_new = rh_out + rh_int[:, src]
    llk_new = jnp.where(accepted, llk_opts[safe_choice], llk)
    return genotype_new, rh_new, llk_new


def random_intervals(key, n_base, break_dist):
    """Draw n_breaks ~ break_dist, then n_breaks random break points.

    Fixed-shape equivalent of reference ``random_breaks``
    (structural.py:22-71): returns [n_base, 2] half-open intervals, the
    unused tail padded with empty (n_base, n_base) intervals.
    """
    kn, kp, ks = jax.random.split(key, 3)
    cdf = jnp.cumsum(break_dist)
    u = jax.random.uniform(kn, dtype=cdf.dtype)
    n_breaks = jnp.sum(cdf <= u, dtype=jnp.int32)
    perm = jax.random.permutation(kp, n_base - 1) + 1 if n_base > 1 else jnp.zeros(0, jnp.int32)
    chosen = jnp.where(jnp.arange(max(n_base - 1, 0)) < n_breaks, perm, n_base)
    points = jnp.sort(chosen)
    starts = jnp.concatenate([jnp.zeros(1, points.dtype), points])
    ends = jnp.concatenate([points, jnp.full(1, n_base, points.dtype)])
    intervals = jnp.stack([starts, ends], axis=-1)  # [n_base, 2]
    # randomize order of the (real) intervals; empty ones are no-ops
    order = jax.random.permutation(ks, intervals.shape[0])
    return intervals[order]


def structural_sweep(
    key,
    genotype,
    rh,
    llk,
    intervals,
    log_reads,
    read_counts,
    log_uh,
    temp,
    step_type,
    use_prior,
    inbreeding,
):
    """Interval steps over a padded interval list; structural.py:590-673."""
    keys = jax.random.split(key, intervals.shape[0])

    def body(carry, xs):
        genotype, rh, llk = carry
        interval, ikey = xs
        genotype, rh, llk = interval_step(
            ikey, genotype, rh, llk, interval, log_reads, read_counts,
            log_uh, temp, step_type, use_prior, inbreeding,
        )
        return (genotype, rh, llk), None

    (genotype, rh, llk), _ = jax.lax.scan(
        body, (genotype, rh, llk), (intervals, keys)
    )
    return genotype, rh, llk


# ---------------------------------------------------------------------------
# tempering (reference assemble/tempering.py)
# ---------------------------------------------------------------------------


def chain_swap(
    key, genotype_i, rh_i, llk_i, temp_i, genotype_j, rh_j, llk_j, temp_j,
    log_uh, use_prior, inbreeding,
):
    """Neighbor-temperature state swap (Sambridge 2014 eq. 11).

    i is the cooler chain (higher inverse temp); tempering.py:10-151.
    The cached per-read per-haplotype matrices ``rh`` travel with their
    genotypes (rh is a pure function of the genotype, so exchanging the
    cached copies is exact — no recomputation).
    """
    if use_prior:
        prior_i = _genotype_prior_from_eq(_row_eq(genotype_i), log_uh, inbreeding)
        prior_j = _genotype_prior_from_eq(_row_eq(genotype_j), log_uh, inbreeding)
    else:
        prior_i = prior_j = 0.0
    post_i = llk_i + prior_i
    post_j = llk_j + prior_j
    acceptance = jnp.minimum(
        1.0, jnp.exp((post_j - post_i) * temp_i + (post_i - post_j) * temp_j)
    )
    u = jax.random.uniform(key, dtype=jnp.float64)
    swap = acceptance >= u
    g_i = jnp.where(swap, genotype_j, genotype_i)
    g_j = jnp.where(swap, genotype_i, genotype_j)
    r_i = jnp.where(swap, rh_j, rh_i)
    r_j = jnp.where(swap, rh_i, rh_j)
    l_i = jnp.where(swap, llk_j, llk_i)
    l_j = jnp.where(swap, llk_i, llk_j)
    return g_i, r_i, l_i, g_j, r_j, l_j


# ---------------------------------------------------------------------------
# full sampler (reference assemble/mcmc.py:_denovo_assembler)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "use_prior"),
)
def denovo_sampler(
    key,
    initial,
    log_reads,
    read_counts,
    n_alleles_arr,
    break_dist,
    temperatures,
    *,
    n_steps,
    use_prior=False,
    inbreeding=0.0,
    recombination_step_probability=0.5,
    partial_dosage_step_probability=0.5,
    dosage_step_probability=1.0,
):
    """Run batched-chain de novo assembly MCMC.

    Parameters
    ----------
    key : PRNGKey
    initial : int[n_chains, ploidy, n_base]
    log_reads : f[R, n_base, A] (prepare_reads output; zero reads must be
        mocked host-side as a single all-gap read, mcmc.py:132-137)
    read_counts : f[R]
    n_alleles_arr : i[n_base] — positions fixed by the homozygote filter
        carry n_alleles = 1 (making every move on them a no-op)
    break_dist : f[n_base] — distribution over break counts
    temperatures : f[n_temps] ascending, last == 1.0

    Returns
    -------
    genotypes : int8[n_chains, n_steps, ploidy, n_base] (cold chain)
    llks : f[n_chains, n_steps]
    """
    n_chains, ploidy, n_base = initial.shape
    n_temps = temperatures.shape[0]
    log_uh = jnp.sum(jnp.log(n_alleles_arr.astype(jnp.float64)))
    log_p = jnp.log(jnp.asarray(ploidy, log_reads.dtype))

    def init_rh(genotype):
        lr_g = jnp.take_along_axis(log_reads, genotype.T[None, :, :], axis=-1)
        return jnp.sum(lr_g, axis=1)  # [R, p]

    def chain(key, g0):
        rh0 = init_rh(g0)
        llk0 = jnp.matmul(
            read_counts,
            jax.scipy.special.logsumexp(rh0, axis=-1) - log_p,
            precision=_HIGHEST,
        )
        genotypes0 = jnp.broadcast_to(g0, (n_temps,) + g0.shape)
        rhs0 = jnp.broadcast_to(rh0, (n_temps,) + rh0.shape)
        llks0 = jnp.full((n_temps,), llk0)

        def sweep_one(tkeys, g, rh, llk, temp):
            """Mutation + structural sub-steps at one temperature.

            Temperatures are independent within a step, so this is a
            vmapped batch axis — the sampler code is traced ONCE for
            any ladder length instead of unrolled per temperature.
            """
            kmut, kp1, kp2, kp3, _, kint = tkeys
            g, rh, llk = mutation_sweep(
                kmut, g, rh, llk, log_reads, read_counts, n_alleles_arr,
                log_uh, temp, use_prior, inbreeding,
            )
            # recombination sub-step
            ku1, ki1 = jax.random.split(kp1)
            do = jax.random.uniform(ku1, dtype=jnp.float64) <= recombination_step_probability
            intervals = random_intervals(ki1, n_base, break_dist)
            g2, rh2, llk2 = structural_sweep(
                kint, g, rh, llk, intervals, log_reads, read_counts,
                log_uh, temp, 0, use_prior, inbreeding,
            )
            g = jnp.where(do, g2, g)
            rh = jnp.where(do, rh2, rh)
            llk = jnp.where(do, llk2, llk)
            # partial dosage sub-step
            ku2, ki2, ks2 = jax.random.split(kp2, 3)
            do = jax.random.uniform(ku2, dtype=jnp.float64) <= partial_dosage_step_probability
            intervals = random_intervals(ki2, n_base, break_dist)
            g2, rh2, llk2 = structural_sweep(
                ks2, g, rh, llk, intervals, log_reads, read_counts,
                log_uh, temp, 1, use_prior, inbreeding,
            )
            g = jnp.where(do, g2, g)
            rh = jnp.where(do, rh2, rh)
            llk = jnp.where(do, llk2, llk)
            # full-length dosage sub-step
            ku3, ks3 = jax.random.split(kp3)
            do = jax.random.uniform(ku3, dtype=jnp.float64) <= dosage_step_probability
            full_interval = jnp.array([0, n_base])
            g2, rh2, llk2 = interval_step(
                ks3, g, rh, llk, full_interval, log_reads, read_counts,
                log_uh, temp, 1, use_prior, inbreeding,
            )
            g = jnp.where(do, g2, g)
            rh = jnp.where(do, rh2, rh)
            llk = jnp.where(do, llk2, llk)
            return g, rh, llk

        def step(carry, step_key):
            genotypes, rhs, llks = carry
            keys = jax.random.split(step_key, n_temps * 6).reshape(n_temps, 6, 2)
            genotypes, rhs, llks = jax.vmap(sweep_one)(
                keys, genotypes, rhs, llks, temperatures
            )
            # neighbor chain swaps, warmest to coldest; a swap exchanges
            # the cached rh matrices along with genotype/llk (cheap
            # selects, so the tiny sequential unroll costs nothing)
            for t in range(1, n_temps):
                kswap = keys[t, 4]
                g_t, r_t, l_t, g_p, r_p, l_p = chain_swap(
                    kswap,
                    genotypes[t], rhs[t], llks[t], temperatures[t],
                    genotypes[t - 1], rhs[t - 1], llks[t - 1],
                    temperatures[t - 1], log_uh, use_prior, inbreeding,
                )
                genotypes = genotypes.at[t].set(g_t).at[t - 1].set(g_p)
                rhs = rhs.at[t].set(r_t).at[t - 1].set(r_p)
                llks = llks.at[t].set(l_t).at[t - 1].set(l_p)
            # record the cold chain (last temperature == 1.0)
            return (genotypes, rhs, llks), (genotypes[-1], llks[-1])

        _, (trace_g, trace_llk) = jax.lax.scan(
            step, (genotypes0, rhs0, llks0), jax.random.split(key, n_steps)
        )
        return trace_g.astype(jnp.int8), trace_llk

    keys = jax.random.split(key, n_chains)
    return jax.vmap(chain)(keys, initial)


# ---------------------------------------------------------------------------
# per-SNP exact posterior (reference assemble/snpcalling.py) and
# homozygosity fixing (mcmc.py:494-541)
# ---------------------------------------------------------------------------


def snp_posteriors(reads, n_alleles_arr, ploidy, use_prior=False, inbreeding=0.0,
                   read_counts=None, dtype=None):
    """Exact genotype posterior at every SNV position, batched.

    reads: f[R, nb, A] probabilistic (nan gaps); returns
    (genotype_table [G, ploidy], probs [nb, G]) where G enumerates
    genotypes over the max allele count; genotypes using disallowed
    alleles get probability 0.  Reference snp_posterior
    (snpcalling.py:14-70) evaluated for all positions at once via a
    dosage matmul.

    ``dtype`` sets the precision of the heavy per-read tensor (the
    [R, nb, G] dosage product and its log); the final [nb, G]
    prior/normalisation always runs in f64.  Default f64 matches the
    reference; the batched homozygosity screen passes f32, where the
    R-major tensor dominates (SURVEY §7.3 numeric-parity note: f64 only
    on the small summary reductions).
    """
    import numpy as np

    from mchap_tpu.numerics.combinadics import enumerate_genotypes
    from mchap_tpu.ops.exact import genotype_dosage_table
    from mchap_tpu.ops.priors import log_genotype_prior

    if dtype is None:
        dtype = jnp.float64
    n_reads, nb, max_allele = reads.shape
    if n_reads == 0:
        reads = jnp.full((1, nb, max_allele), jnp.nan)
        n_reads = 1
        read_counts = None
    table = jnp.asarray(enumerate_genotypes(max_allele, ploidy))  # [G, p]
    # NOTE: the numpy table returned below is recomputed host-side so
    # the jitted trace never converts a traced constant
    dosage = jnp.asarray(
        genotype_dosage_table(max_allele, ploidy), dtype
    )  # [G, A]
    reads = jnp.asarray(reads, dtype)
    m = jnp.where(jnp.isnan(reads), 1.0, reads)  # gap -> multiplicative identity
    # HIGHEST keeps the dosage contraction at true input precision (an
    # f32 GPU dot may otherwise run in TF32)
    probs_rjg = (
        jnp.einsum(
            "rja,ga->rjg", m, dosage, precision=jax.lax.Precision.HIGHEST
        )
        / ploidy
    )  # [R, nb, G]
    tiny = 1e-300 if dtype == jnp.float64 else 1e-30
    # per-read log at working dtype; the read reduction stays at that
    # dtype too (XLA reduces tree-wise, so f32 drift over realistic
    # depths is ~1e-5 in log units — far inside the >= 0.999 fix
    # threshold's slack) and only the small [nb, G] summary is promoted
    # to f64.  The einsum's HIGHEST precision above is what protects the
    # decision (an f32 GPU dot may otherwise run in TF32).
    read_log = jnp.log(jnp.maximum(probs_rjg, tiny))
    if read_counts is not None:
        read_log = read_log * jnp.asarray(read_counts, read_log.dtype)[:, None, None]
    llks = jnp.sum(read_log, axis=0).astype(jnp.float64)  # [nb, G]
    if use_prior:
        lpriors = jax.vmap(
            lambda n: log_genotype_prior(table, n, inbreeding=inbreeding)
        )(jnp.asarray(n_alleles_arr))  # [nb, G]
    else:
        lpriors = jnp.zeros_like(llks)
    logits = llks + lpriors
    # mask genotypes using disallowed alleles per position
    valid = jnp.all(
        table[None, :, :] < jnp.asarray(n_alleles_arr)[:, None, None], axis=-1
    )  # [nb, G]
    logits = jnp.where(valid, logits, -jnp.inf)
    probs = jnp.exp(
        logits - jax.scipy.special.logsumexp(logits, axis=-1, keepdims=True)
    )
    return enumerate_genotypes(max_allele, ploidy), probs


# jitted: one compiled program per (shape, statics) instead of one
# dispatch per primitive
snp_posteriors = functools.partial(
    jax.jit, static_argnames=("ploidy", "use_prior", "dtype")
)(snp_posteriors)


def homozygosity_probabilities(reads, n_alleles_arr, ploidy, use_prior=False,
                               inbreeding=0.0, read_counts=None):
    """P(homozygous for allele a) per position; mcmc.py:494-541.

    Per-locus helper: each distinct ``reads`` shape compiles a fresh
    ``snp_posteriors`` program.  The batched pipelines instead call
    ``homozygosity_probabilities_batch`` below on padded, shape-
    bucketed locus blocks (one compile per bucket).
    """
    import numpy as np

    from mchap_tpu.numerics.combinadics import genotype_alleles_as_index

    table, probs = snp_posteriors(
        reads, n_alleles_arr, ploidy, use_prior, inbreeding, read_counts
    )
    max_allele = reads.shape[-1]
    hom_idx = np.asarray(
        genotype_alleles_as_index(
            np.repeat(np.arange(max_allele)[:, None], ploidy, axis=1)
        )
    )  # [A]
    return np.asarray(probs)[:, hom_idx]  # [nb, A]


@functools.partial(jax.jit, static_argnames=("ploidy", "use_prior"))
def _hom_batch_probs(reads_b, n_alleles_mat, inbreeding_b, read_counts_b,
                     *, ploidy, use_prior):
    """Jitted core of the batched homozygosity filter.

    Module-level jit: the vmap alone would execute eagerly, one
    primitive dispatch at a time; one compiled program per (shape,
    ploidy, use_prior) instead.
    """

    def one(reads, n_alleles_arr, inbreeding, read_counts):
        # f32 on the heavy per-read tensor (the [S, R, nb, G] product is
        # the largest tensor of the batched filter); the read-axis
        # reduction and the
        # normalisation accumulate in f64 inside snp_posteriors, so the
        # >= 0.999 fix decision sees only per-read rounding, not
        # accumulated drift, vs the per-sample f64 path
        _, probs = snp_posteriors(
            reads, n_alleles_arr, ploidy, use_prior, inbreeding, read_counts,
            dtype=jnp.float32,
        )
        return probs  # [nb, G]

    return jax.vmap(one)(reads_b, n_alleles_mat, inbreeding_b, read_counts_b)


def _hom_batch_probs_np(reads_b, n_alleles_mat, read_counts_b, ploidy):
    """Numpy mirror of the flat-prior ``_hom_batch_probs`` for the
    host-side screen route: same math (f32 dosage product + per-read
    log, f64 summary reduction and normalisation), zero XLA compiles."""
    import numpy as np

    from mchap_tpu.numerics.combinadics import enumerate_genotypes
    from mchap_tpu.ops.exact import genotype_dosage_table

    n_samples, n_reads, nb, max_allele = reads_b.shape
    table = np.asarray(enumerate_genotypes(max_allele, ploidy))  # [G, p]
    dosage = np.asarray(
        genotype_dosage_table(max_allele, ploidy), np.float32
    )  # [G, A]
    reads = np.asarray(reads_b, np.float32)
    m = np.where(np.isnan(reads), np.float32(1.0), reads)  # [S, R, nb, A]
    probs_rjg = (
        np.einsum("srja,ga->srjg", m, dosage, optimize=True) / ploidy
    )
    read_log = np.log(np.maximum(probs_rjg, np.float32(1e-30)))
    read_log *= np.asarray(read_counts_b, np.float32)[:, :, None, None]
    llks = read_log.sum(axis=1, dtype=np.float64)  # [S, nb, G]
    valid = np.all(
        table[None, None, :, :] < np.asarray(n_alleles_mat)[:, :, None, None],
        axis=-1,
    )  # [S, nb, G]
    logits = np.where(valid, llks, -np.inf)
    mx = logits.max(axis=-1, keepdims=True)
    e = np.exp(logits - mx)
    return e / e.sum(axis=-1, keepdims=True)


def homozygosity_probabilities_batch(reads_b, n_alleles_mat, ploidy,
                                     use_prior=False, inbreeding_b=None,
                                     read_counts_b=None):
    """Batched homozygosity filter: ONE device program for all samples.

    reads_b: f[S, R, nb, A] (padded; zero-count reads weigh nothing),
    n_alleles_mat: i[S, nb], inbreeding_b/read_counts_b batched per
    sample.  Equivalent to stacking ``homozygosity_probabilities`` per
    sample, without S sequential device round-trips.
    """
    import numpy as np

    from mchap_tpu.numerics.combinadics import genotype_alleles_as_index

    n_samples, n_reads, nb, max_allele = reads_b.shape
    if inbreeding_b is None:
        inbreeding_b = np.zeros(n_samples)
    if read_counts_b is None:
        read_counts_b = np.ones((n_samples, max(n_reads, 1)))
    if n_reads == 0:
        reads_b = np.full((n_samples, 1, nb, max_allele), np.nan)
        read_counts_b = np.ones((n_samples, 1))

    # Where the screen runs (A5 in ROADMAP decides it on the card): by
    # default on the host whenever the main backend is an accelerator,
    # where the flat-prior screen is a few milliseconds of numpy;
    # MCHAP_HOM_SCREEN={auto,host,device} overrides.
    import os

    screen_env = os.environ.get("MCHAP_HOM_SCREEN", "auto").strip().lower()
    on_host = (
        screen_env == "host"
        or (screen_env == "auto" and jax.default_backend() != "cpu")
    )

    def _run_probs():
        # f32 inputs: the screen computes its heavy tensor in f32
        # anyway, and halving the bytes matters on the device path
        return _hom_batch_probs(
            jnp.asarray(np.asarray(reads_b, np.float32)),
            jnp.asarray(n_alleles_mat),
            jnp.asarray(inbreeding_b, jnp.float64),
            jnp.asarray(np.asarray(read_counts_b, np.float32)),
            ploidy=ploidy,
            use_prior=use_prior,
        )  # [S, nb, G]

    if on_host and not use_prior:
        # pure numpy on host: no XLA-CPU compile per shape class for a
        # screen of ~2e8 flops
        probs = _hom_batch_probs_np(
            reads_b, n_alleles_mat, read_counts_b, ploidy
        )
    elif on_host:
        with jax.default_device(jax.devices("cpu")[0]):
            probs = _run_probs()
    else:
        probs = _run_probs()
    hom_idx = np.asarray(
        genotype_alleles_as_index(
            np.repeat(np.arange(max_allele)[:, None], ploidy, axis=1)
        )
    )
    return np.asarray(probs)[:, :, hom_idx]  # [S, nb, A]
