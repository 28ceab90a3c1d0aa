"""Batched pedigree-informed MCMC (trio transition model + joint Gibbs).

Accelerator-first re-design of ``mchap/pedigree/`` (prior.py, mcmc.py): the
reference's irregular gamete-dosage iterator (``increment_dosage``,
prior.py:230-294) becomes a fixed-size masked enumeration over static
composition tables (all dosage vectors of a given gamete ploidy), so
the trio pmf is a handful of masked gathers + a logsumexp.  Chains are
the batch axis (vmap).  The cross-sample Markov-blanket coupling that
forbids a naive sample batch axis (SURVEY.md §3.4) is handled with a
CHROMATIC Gibbs schedule: samples are partitioned into colors whose
members are mutually outside each other's blankets (``chromatic_colors``),
each color updating as one vmapped batch — on the bi-parental example
design that is 2 founder stages + ONE stage for all 20 progeny, versus
the reference's 22 sequential sample updates
(``mchap/pedigree/mcmc.py:362-412``).  The reference shuffles sample
order per step; a fixed color order is an equally valid Gibbs sweep
(the per-sample conditionals are unchanged) and the exact-posterior
gates in tests/test_pedigree_mcmc.py verify the stationary
distribution.

Genotypes are fixed-width int arrays [n_samples, max_ploidy] padded
with -1 for lower-ploidy samples, exactly as the reference.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np

_NEG = -1e300

# binomial lookup (n, k up to 16) — exact in float64 for these sizes
import math as _math

# every f32 contraction on the likelihood path runs at full precision:
# an f32 GPU dot may otherwise run in TF32 (about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST

_COMB_LUT = np.zeros((17, 17))
for _n in range(17):
    for _k in range(17):
        _COMB_LUT[_n, _k] = float(_math.comb(_n, _k)) if _k <= _n else 0.0


def composition_tables(max_ploidy):
    """Static tables of all dosage vectors with a given sum.

    Returns (tables f[max_ploidy+1, K_max, max_ploidy],
             valid  b[max_ploidy+1, K_max])
    where tables[tau] enumerates all vectors of non-negative ints over
    max_ploidy slots summing to tau (the reference's increment_dosage
    walk, prior.py:230-294, made into one masked batch).
    """
    all_tables = []
    for tau in range(max_ploidy + 1):
        rows = [
            c
            for c in itertools.product(range(tau + 1), repeat=max_ploidy)
            if sum(c) == tau
        ]
        all_tables.append(np.array(rows, dtype=np.int32).reshape(-1, max_ploidy))
    k_max = max(len(t) for t in all_tables)
    tables = np.zeros((max_ploidy + 1, k_max, max_ploidy), np.int32)
    valid = np.zeros((max_ploidy + 1, k_max), bool)
    for tau, t in enumerate(all_tables):
        tables[tau, : len(t)] = t
        valid[tau, : len(t)] = True
    return tables, valid


# ---------------------------------------------------------------------------
# dosage helpers on padded genotype rows (reference prior.py:7-92)
# ---------------------------------------------------------------------------


def padded_dosage(genotype):
    """Allelic dosage credited to first occurrence; padding (<0) -> 0."""
    maxp = genotype.shape[-1]
    called = genotype >= 0
    eq = (genotype[..., :, None] == genotype[..., None, :]) & called[..., None, :] & called[..., :, None]
    tri = jnp.tril(jnp.ones((maxp, maxp), bool), k=-1)
    first = ~jnp.any(eq & tri, axis=-1) & called
    counts = jnp.sum(eq, axis=-1)
    return jnp.where(first, counts, 0)


def parental_copies(parent, progeny):
    """Count of each progeny allele within the parent, credited to the
    first progeny slot holding that allele (prior.py:38-70)."""
    maxp = progeny.shape[-1]
    called = progeny >= 0
    match = (parent[..., None, :] == progeny[..., :, None]) & (parent[..., None, :] >= 0)
    counts = jnp.sum(match, axis=-1)  # [maxp] per progeny slot
    # credit only first occurrence of each allele
    eq = (progeny[..., :, None] == progeny[..., None, :]) & called[..., None, :]
    tri = jnp.tril(jnp.ones((maxp, maxp), bool), k=-1)
    first = ~jnp.any(eq & tri, axis=-1) & called
    return jnp.where(first, counts, 0)


def _neg(dtype):
    """Finite large-negative mask value for ``dtype`` log-space math.

    Kept FINITE on purpose (the reference's -inf-free regime): -inf
    masks turn MH ratio differences into nan.  f32 cannot hold -1e300
    (it would overflow to -inf), so the f32 fast path uses -1e30.
    """
    return -1e300 if jnp.dtype(dtype) == jnp.float64 else -1e30


def _tinyf(dtype):
    """Smallest safe log argument for ``dtype`` (underflow guard)."""
    return 1e-300 if jnp.dtype(dtype) == jnp.float64 else 1e-30


def _ln_perms(dosage, dtype):
    d = dosage.astype(dtype)
    return jax.lax.lgamma(jnp.sum(d, -1) + 1.0) - jnp.sum(jax.lax.lgamma(d + 1.0), -1)


def _log_unknown_dosage_prior(dosage, dlf):
    """Multinomial prior of a dosage of unknown origin (prior.py:121-144)."""
    d = dosage.astype(dlf.dtype)
    return _ln_perms(dosage, dlf.dtype) + jnp.sum(
        jnp.where(dosage > 0, d * dlf, 0.0), -1
    )


def _gamete_log_pmf(gametes, tau, parent_dose, parent_ploidy, lam, comb_lut):
    """log pmf of gamete dosages drawn from a parent dosage.

    gametes: i[K, maxp]; tau/parent_ploidy: traced ints; lam: traced float.
    Reference prior.py:329-373 (incl. double-reduction mixture).
    ``comb_lut``'s dtype sets the working precision.
    """
    dtype = comb_lut.dtype
    lam = jnp.asarray(lam, dtype)
    perms = jnp.prod(comb_lut[parent_dose[None, :], gametes], axis=-1)  # [K]
    denom = jnp.maximum(comb_lut[parent_ploidy, tau], 1.0)
    prob = (perms / denom) * (1.0 - lam)
    # double reduction: gamete = 2 copies of one allele (tau == 2 only)
    is_dr = (jnp.max(gametes, -1) == 2) & (jnp.sum(gametes, -1) == 2)
    dr_allele = jnp.argmax(gametes, -1)
    dr_perms = jnp.where(is_dr, parent_dose[dr_allele], 0).astype(dtype)
    prob = prob + jnp.where(
        lam > 0.0, (dr_perms / jnp.maximum(parent_ploidy, 1)) * lam, 0.0
    )
    return jnp.where(
        prob > 0.0, jnp.log(jnp.maximum(prob, _tinyf(dtype))), _neg(dtype)
    )


def trio_log_pmf(
    progeny,
    parent_p,
    parent_q,
    ploidy_p,
    ploidy_q,
    tau_p,
    tau_q,
    lam_p,
    lam_q,
    err_p,
    err_q,
    log_freqs,
    tables,
    tables_valid,
    comb_lut,
):
    """Log probability of a progeny genotype given two parents.

    Fixed-shape equivalent of reference ``trio_log_pmf``
    (prior.py:484-722): four-way error mixture — both parents correct
    (A), only p correct (B), only q correct (C), neither (D) — with
    gamete splits enumerated over the static composition tables.
    All of ploidy/tau/lambda/error may be traced.
    """
    maxp = progeny.shape[-1]
    dtype = log_freqs.dtype
    _NEG = _neg(dtype)
    tiny = _tinyf(dtype)
    err_p = jnp.asarray(err_p, dtype)
    err_q = jnp.asarray(err_q, dtype)
    lam_p = jnp.asarray(lam_p, dtype)
    lam_q = jnp.asarray(lam_q, dtype)
    comb_lut = jnp.asarray(comb_lut, dtype)
    dosage = padded_dosage(progeny)
    dlf = jnp.where(
        progeny >= 0, log_freqs[jnp.clip(progeny, 0, None)], 0.0
    )
    dosage_p = jnp.where(ploidy_p > 0, parental_copies(parent_p, progeny), 0)
    dosage_q = jnp.where(ploidy_q > 0, parental_copies(parent_q, progeny), 0)
    constraint_p = jnp.minimum(dosage, dosage_p)
    constraint_q = jnp.minimum(dosage, dosage_q)
    # double-reduction constraint adjustment (prior.py:583-600)
    constraint_p = jnp.where(
        (lam_p > 0.0) & (dosage >= 2) & (constraint_p == 1), 2, constraint_p
    )
    constraint_q = jnp.where(
        (lam_q > 0.0) & (dosage >= 2) & (constraint_q == 1), 2, constraint_q
    )

    # clone edges (tau == 0) force the error branch (prior.py:556-557)
    err_p = jnp.where(tau_p == 0, 1.0, err_p)
    err_q = jnp.where(tau_q == 0, 1.0, err_q)
    lerr_p = jnp.log(jnp.maximum(err_p, tiny))
    lerr_q = jnp.log(jnp.maximum(err_q, tiny))
    lcor_p = jnp.where(err_p < 1.0, jnp.log(jnp.maximum(1.0 - err_p, tiny)), _NEG)
    lcor_q = jnp.where(err_q < 1.0, jnp.log(jnp.maximum(1.0 - err_q, tiny)), _NEG)

    valid_p = (jnp.sum(constraint_p, -1) >= tau_p) & (tau_p > 0) & (err_p < 1.0)
    valid_q = (jnp.sum(constraint_q, -1) >= tau_q) & (tau_q > 0) & (err_q < 1.0)

    # enumeration from parent p's side: gametes_p summing to tau_p
    gp = tables[tau_p]  # [K, maxp]
    gp_ok = tables_valid[tau_p] & jnp.all(gp <= constraint_p[None, :], axis=-1)
    gq_of_p = dosage[None, :] - gp  # complementary gamete
    lpmf_p = _gamete_log_pmf(gp, tau_p, dosage_p, ploidy_p, lam_p, comb_lut)
    lpmf_q_of_p = _gamete_log_pmf(gq_of_p, tau_q, dosage_q, ploidy_q, lam_q, comb_lut)
    unknown_q = jax.vmap(lambda g: _log_unknown_dosage_prior(g, dlf))(gq_of_p)
    # term A: both parents correct
    a_terms = jnp.where(
        gp_ok & valid_p & valid_q, lpmf_p + lcor_p + lpmf_q_of_p + lcor_q, _NEG
    )
    # term B: p correct, q in error
    b_terms = jnp.where(gp_ok & valid_p, lpmf_p + lcor_p + unknown_q + lerr_q, _NEG)

    # enumeration from parent q's side: gametes_q summing to tau_q
    gq = tables[tau_q]
    gq_ok = tables_valid[tau_q] & jnp.all(gq <= constraint_q[None, :], axis=-1)
    gp_of_q = dosage[None, :] - gq
    lpmf_q = _gamete_log_pmf(gq, tau_q, dosage_q, ploidy_q, lam_q, comb_lut)
    unknown_p = jax.vmap(lambda g: _log_unknown_dosage_prior(g, dlf))(gp_of_q)
    # term C: q correct, p in error
    c_terms = jnp.where(gq_ok & valid_q, lpmf_q + lcor_q + unknown_p + lerr_p, _NEG)

    # term D: both parents in error
    d_term = _log_unknown_dosage_prior(dosage, dlf) + lerr_p + lerr_q

    stacked = jnp.concatenate([a_terms, b_terms, c_terms, d_term[None]])
    return jax.scipy.special.logsumexp(stacked)


def chromatic_colors(sample_parents):
    """Greedy coloring of the pedigree's moral graph.

    Two samples may share a color only if neither is in the other's
    Markov blanket (parent, child, or co-parent) — then their Gibbs
    conditionals are independent given the rest and the color updates
    in ONE vmapped device step (chromatic Gibbs).  On the bi-parental
    designs this tool targets (reference docs/example: 2 founders +
    20 progeny) the progeny all land in one color, collapsing the
    sequential sample sweep from n_samples stages to ~3.
    """
    sample_parents = np.asarray(sample_parents)
    n = len(sample_parents)
    adj = [set() for _ in range(n)]
    for i in range(n):
        p, q = sample_parents[i]
        for r in (int(p), int(q)):
            if r >= 0:
                adj[i].add(r)
                adj[r].add(i)
        if p >= 0 and q >= 0:
            adj[int(p)].add(int(q))
            adj[int(q)].add(int(p))
    colors = []
    for i in sorted(range(n), key=lambda x: -len(adj[x])):
        for group in colors:
            if adj[i].isdisjoint(group):
                group.add(i)
                break
        else:
            colors.append({i})
    return [sorted(g) for g in colors]


def make_pedigree_kernels(
    max_ploidy,
    n_samples,
    max_children,
    n_pairs,
    sample_parents_np=None,
    sample_children_np=None,
    dtype=jnp.float64,
):
    """Build the trio/blanket/sampler functions for static pedigree shapes.

    ``sample_parents_np``/``sample_children_np`` (host-side numpy copies
    of the pedigree structure) enable the CHROMATIC schedule: samples
    are partitioned into Markov-blanket-independent colors updated as
    one vmapped batch each, and every color's children-trio sum is
    sliced to that color's true max child count (a childless-progeny
    color pays zero child-trio cost instead of ``max_children`` masked
    evaluations).  Without them the sampler falls back to one color per
    sample — the reference's sequential sweep order.

    ``dtype`` sets the working precision of the trio/llk math.  f64 is
    the reference-parity default (tests, CPU); the accelerator fit paths
    pass f32 (``models/pedigree._pedigree_dtype``).  The f32 posterior
    is gated against the f64 path (tests/test_pedigree_mcmc.py) and
    against exact enumeration.
    """
    tables_np, valid_np = composition_tables(max_ploidy)
    tables = jnp.asarray(tables_np)
    tables_valid = jnp.asarray(valid_np)
    comb_lut = jnp.asarray(_COMB_LUT, dtype)
    NEG = _neg(dtype)

    if sample_parents_np is None:
        colors = [[i] for i in range(n_samples)]
    else:
        colors = chromatic_colors(sample_parents_np)
    color_ids = [np.asarray(c, np.int32) for c in colors]
    if sample_children_np is not None:
        sample_children_np = np.asarray(sample_children_np, np.int32)
        color_children = []
        for c in colors:
            rows = sample_children_np[c]  # [n_c, max_children]
            w = int((rows >= 0).sum(axis=1).max(initial=0))
            color_children.append(rows[:, :w].copy())
    else:
        color_children = [None] * len(colors)

    def trio_for_sample(i, genotypes, ped):
        """Trio pmf of sample i given the full genotype matrix."""
        (sample_ploidy, sample_parents, sample_children,
         gamete_tau, gamete_lambda, gamete_error, log_freqs) = ped
        p = sample_parents[i, 0]
        q = sample_parents[i, 1]
        has_p = p >= 0
        has_q = q >= 0
        p_safe = jnp.maximum(p, 0)
        q_safe = jnp.maximum(q, 0)
        return trio_log_pmf(
            genotypes[i],
            jnp.where(has_p, genotypes[p_safe], -1),
            jnp.where(has_q, genotypes[q_safe], -1),
            jnp.where(has_p, sample_ploidy[p_safe], 0),
            jnp.where(has_q, sample_ploidy[q_safe], 0),
            gamete_tau[i, 0],
            gamete_tau[i, 1],
            gamete_lambda[i, 0],
            gamete_lambda[i, 1],
            jnp.where(has_p, gamete_error[i, 0], 1.0),
            jnp.where(has_q, gamete_error[i, 1], 1.0),
            log_freqs,
            tables,
            tables_valid,
            comb_lut,
        )

    def _masked_trio_sum(members, genotypes, ped):
        """Sum of trio pmfs over a padded member list (-1 = padding).

        One VMAPPED batch of trio evaluations, not an unrolled loop:
        blankets reach 20+ members on real pedigrees (a bi-parental
        founder's children) and unrolling a full trio_log_pmf per
        member made the traced program enormous (multi-minute
        compiles).  vmap keeps one traced
        instance AND evaluates the members in parallel on device."""
        if members.shape[0] == 0:
            return jnp.zeros((), dtype)
        contribs = jax.vmap(
            lambda i: trio_for_sample(jnp.maximum(i, 0), genotypes, ped)
        )(members)
        return jnp.sum(jnp.where(members >= 0, contribs, 0.0))

    def blanket_log_probability(s, children_row, genotypes, ped):
        """Self trio + children trios (reference prior.py:725-840).

        ``children_row`` is the (possibly color-sliced) padded child
        list of sample ``s``; width 0 reduces to the self trio alone.
        Self and children evaluate as ONE vmapped member batch — one
        traced trio instance per call site, which halves the lowered
        program vs separate self/children instances (compile time is
        the pedigree path's binding constraint)."""
        members = jnp.concatenate([s[None], children_row])
        return _masked_trio_sum(members, genotypes, ped)

    def generic_blanket_log_probability(blanket, genotypes, ped):
        """Joint over an explicit padded blanket (prior.py:845-953)."""
        return _masked_trio_sum(blanket, genotypes, ped)

    def sample_llk(rh, counts, genotype, ploidy):
        """llk of one padded genotype from its read-hap matrix."""
        maxp = genotype.shape[-1]
        sub = rh[:, jnp.clip(genotype, 0, None)]  # [R, maxp]
        mask = (jnp.arange(maxp) < ploidy)[None, :]
        read_log = jax.scipy.special.logsumexp(
            jnp.where(mask, sub, NEG), axis=-1
        ) - jnp.log(ploidy.astype(dtype))
        return jnp.matmul(counts, read_log, precision=_HIGHEST)

    def _slot_options(s, k, children_row, genotypes, rh_all, counts_all, ped):
        """Per-candidate state for updating slot k of sample s: llk of
        every panel allele (rank-1 logaddexp trick over the precomputed
        read-hap matrix), Markov-blanket prior of every candidate
        genotype, and each allele's copy count among the other slots."""
        (sample_ploidy, *_rest) = ped
        n_alleles = rh_all.shape[-1]
        maxp = genotypes.shape[-1]
        ploidy = sample_ploidy[s]
        g = genotypes[s]
        rh = rh_all[s]
        counts = counts_all[s]
        keep = (jnp.arange(maxp) != k) & (jnp.arange(maxp) < ploidy)
        sub = rh[:, jnp.clip(g, 0, None)]
        rest = jax.scipy.special.logsumexp(
            jnp.where(keep[None, :], sub, NEG), axis=-1
        )
        cand = jnp.logaddexp(rest[:, None], rh)  # [R, H]
        llks = jnp.matmul(
            counts, cand - jnp.log(ploidy.astype(dtype)), precision=_HIGHEST
        )  # [H]
        options = jnp.broadcast_to(g, (n_alleles, maxp)).at[:, k].set(
            jnp.arange(n_alleles, dtype=g.dtype)
        )

        def blanket_for(g_s):
            return blanket_log_probability(
                s, children_row, genotypes.at[s].set(g_s), ped
            )

        lpriors = jax.vmap(blanket_for)(options)  # [H]
        counts_other = jnp.sum(
            keep[None, :] & (g[None, :] == jnp.arange(n_alleles)[:, None]), axis=-1
        )
        return llks, lpriors, counts_other

    def gibbs_slot(key, s, k, children_row, genotypes, rh_all, counts_all,
                   ped, n_valid):
        """Gibbs draw for slot k of sample s over all panel alleles.

        The multiplicity term corrects slot-wise sampling of the
        multiset state (same Jacobian as the calling sampler's flat
        allele prior).  ``n_valid`` masks panel padding columns (locus
        batching pads every panel to the block's max size).  Returns
        the NEW ALLELE for the slot (the chromatic sweep owns the row).
        """
        (sample_ploidy, *_rest) = ped
        n_alleles = rh_all.shape[-1]
        g = genotypes[s]
        cur = g[k]
        llks, lpriors, counts_other = _slot_options(
            s, k, children_row, genotypes, rh_all, counts_all, ped
        )
        lmult = jnp.log(counts_other.astype(dtype) + 1.0)
        logits = jnp.where(
            jnp.arange(n_alleles) < n_valid, llks + lpriors + lmult, -jnp.inf
        )
        choice = jax.random.categorical(key, logits).astype(g.dtype)
        return jnp.where(k < sample_ploidy[s], choice, cur)

    def mh_slot(key, s, k, children_row, genotypes, rh_all, counts_all,
                ped, n_valid):
        """Metropolis-Hastings draw for slot k of sample s.

        Compound proposal distribution over the valid panel alleles:
        each non-current allele is proposed uniformly and accepted with
        min(1, llk_ratio * prior_ratio * proposal_ratio); the leftover
        mass keeps the current allele (reference pedigree/mcmc.py:15-142,
        same regime as the calling sampler's MH step).  Returns the new
        allele for the slot.
        """
        (sample_ploidy, *_rest) = ped
        n_alleles = rh_all.shape[-1]
        g = genotypes[s]
        cur = g[k]
        llks, lpriors, counts_other = _slot_options(
            s, k, children_row, genotypes, rh_all, counts_all, ped
        )
        # proposal ratio: copies of candidate in the proposed genotype /
        # copies of the current allele in the current genotype
        copies_proposed = (counts_other + 1).astype(dtype)
        copies_current = (counts_other[cur] + 1).astype(dtype)
        lproposal = jnp.log(copies_proposed) - jnp.log(copies_current)
        mh_ratio = (llks - llks[cur]) + (lpriors - lpriors[cur]) + lproposal
        accept = jnp.exp(jnp.minimum(0.0, mh_ratio))
        accept = jnp.where(jnp.arange(n_alleles) < n_valid, accept, 0.0)
        n_proposals = jnp.maximum(n_valid - 1, 1).astype(accept.dtype)
        probs = accept.at[cur].set(0.0) / n_proposals
        probs = probs.at[cur].set(1.0 - jnp.sum(probs))
        # inverse-CDF draw matching reference random_choice semantics
        cdf = jnp.cumsum(probs)
        u = jax.random.uniform(key, dtype=cdf.dtype)
        choice = jnp.sum(cdf <= u * cdf[-1], dtype=jnp.int32).astype(g.dtype)
        return jnp.where(k < sample_ploidy[s], choice, cur)

    def pair_swap(key, pair, blanket, genotypes, rh_all, counts_all, ped):
        """MH allele swap between a parental pair (mcmc.py:503-655)."""
        (sample_ploidy, *_rest) = ped
        p, q = pair[0], pair[1]
        kp, kq, ka = jax.random.split(key, 3)
        ploidy_p = sample_ploidy[p]
        ploidy_q = sample_ploidy[q]
        idx_p = jax.random.randint(kp, (), 0, ploidy_p)
        idx_q = jax.random.randint(kq, (), 0, ploidy_q)
        allele_p = genotypes[p, idx_p]
        allele_q = genotypes[q, idx_q]
        proposes = allele_p != allele_q

        def count_allele(row, a, ploidy):
            maxp = row.shape[-1]
            return jnp.sum((row == a) & (jnp.arange(maxp) < ploidy))

        proposal = count_allele(genotypes[p], allele_p, ploidy_p) * count_allele(
            genotypes[q], allele_q, ploidy_q
        )
        reversal = (1 + count_allele(genotypes[p], allele_q, ploidy_p)) * (
            1 + count_allele(genotypes[q], allele_p, ploidy_q)
        )
        lproposal = jnp.log(reversal.astype(dtype)) - jnp.log(
            jnp.maximum(proposal, 1).astype(dtype)
        )
        proposed = genotypes.at[p, idx_p].set(allele_q).at[q, idx_q].set(allele_p)
        # batch the current/proposed states through ONE traced instance
        # of the llk and blanket evaluations (program-size discipline:
        # compile time is the pedigree path's binding constraint)
        states = jnp.stack([genotypes, proposed])  # [2, S, maxp]
        llks2 = jax.vmap(
            lambda st: sample_llk(rh_all[p], counts_all[p], st[p], ploidy_p)
            + sample_llk(rh_all[q], counts_all[q], st[q], ploidy_q)
        )(states)
        lpriors2 = jax.vmap(
            lambda st: generic_blanket_log_probability(blanket, st, ped)
        )(states)
        llk_current, llk_proposed = llks2[0], llks2[1]
        lprior_current, lprior_proposed = lpriors2[0], lpriors2[1]
        log_accept = jnp.minimum(
            0.0,
            (llk_proposed - llk_current)
            + (lprior_proposed - lprior_current)
            + lproposal,
        )
        u = jax.random.uniform(ka, dtype=dtype)
        accept = proposes & (u < jnp.exp(log_accept))
        return jnp.where(accept, proposed, genotypes)

    @functools.partial(
        jax.jit, static_argnames=("n_steps", "swap_parental_alleles", "step_type")
    )
    def sampler(
        key,
        initial,  # [n_chains, S, maxp]
        rh_all,  # [S, R, H]
        counts_all,  # [S, R]
        sample_ploidy,
        sample_parents,
        sample_children,
        gamete_tau,
        gamete_lambda,
        gamete_error,
        log_freqs,
        parental_pairs,  # [n_pairs, 2]
        pair_blankets,  # [n_pairs, max_blanket]
        n_valid=None,  # valid panel size (traced); None = full panel
        *,
        n_steps,
        swap_parental_alleles=True,
        step_type=0,  # static: 0 = Gibbs, 1 = Metropolis-Hastings
    ):
        ped = (
            sample_ploidy, sample_parents, sample_children,
            gamete_tau, gamete_lambda, gamete_error, log_freqs,
        )
        if n_valid is None:
            n_valid = rh_all.shape[-1]
        slot_fn = gibbs_slot if step_type == 0 else mh_slot

        def chain(key, genotypes0):
            def sweep_sample(skeys, s, children_row, snapshot):
                """Slot sweep of one sample against a color snapshot.

                Within a color every sample reads the OTHER samples'
                genotypes from the color-start snapshot (they are
                conditionally independent given it — that is the color
                invariant) while its own row evolves slot to slot.
                Returns the sample's new genotype row.
                """
                perm_key, slot_k = skeys[0], skeys[1:]
                slot_order = jax.random.permutation(perm_key, max_ploidy)

                def slot_body(row, slot_xs):
                    k, kkey = slot_xs
                    g_full = snapshot.at[s].set(row)
                    a = slot_fn(
                        kkey, s, k, children_row, g_full, rh_all,
                        counts_all, ped, n_valid,
                    )
                    return row.at[k].set(a), None

                row, _ = jax.lax.scan(
                    slot_body, snapshot[s], (slot_order, slot_k)
                )
                return row

            def step(genotypes, step_key):
                kslots, kswaps = jax.random.split(step_key)
                all_keys = jax.random.split(
                    kslots, n_samples * (max_ploidy + 1)
                ).reshape(n_samples, max_ploidy + 1, 2)
                # chromatic sweep: colors sequential (they interact),
                # samples within a color one vmapped batch
                for ci, ids_np in enumerate(color_ids):
                    ids = jnp.asarray(ids_np)
                    ch_tab = color_children[ci]
                    if ch_tab is None:
                        ch_rows = sample_children[ids]  # [n_c, max_children]
                    else:
                        ch_rows = jnp.asarray(ch_tab)  # [n_c, w_color]
                    new_rows = jax.vmap(
                        sweep_sample, in_axes=(0, 0, 0, None)
                    )(all_keys[ids], ids, ch_rows, genotypes)
                    genotypes = genotypes.at[ids].set(new_rows)
                if swap_parental_alleles and n_pairs > 0:
                    pair_keys = jax.random.split(kswaps, n_pairs)

                    def pair_body(genotypes, xs):
                        pair, blanket, pkey = xs
                        return (
                            pair_swap(
                                pkey, pair, blanket, genotypes, rh_all, counts_all, ped
                            ),
                            None,
                        )

                    genotypes, _ = jax.lax.scan(
                        pair_body, genotypes, (parental_pairs, pair_blankets, pair_keys)
                    )
                return genotypes, genotypes

            _, trace = jax.lax.scan(step, genotypes0, jax.random.split(key, n_steps))
            return trace  # [n_steps, S, maxp]

        keys = jax.random.split(key, initial.shape[0])
        return jax.vmap(chain)(keys, initial)

    return sampler, trio_log_pmf


def sample_children_matrix(sample_parents):
    """Children of each sample, padded with -1 (mcmc.py:415-457)."""
    sample_parents = np.asarray(sample_parents)
    n_samples = len(sample_parents)
    children = [[] for _ in range(n_samples)]
    for i in range(n_samples):
        seen = set()
        for j in range(2):
            p = sample_parents[i, j]
            if p >= 0 and p not in seen:
                children[p].append(i)
                seen.add(p)
    max_children = max((len(c) for c in children), default=0)
    max_children = max(max_children, 1)
    out = np.full((n_samples, max_children), -1, np.int32)
    for i, c in enumerate(children):
        out[i, : len(c)] = c
    return out


def parental_pair_markov_blankets(sample_parents, sample_children):
    """Unique parental pairs + their padded blankets (mcmc.py:460-500)."""
    sample_parents = np.asarray(sample_parents)
    sample_children = np.asarray(sample_children)
    n_samples = len(sample_parents)
    pairs = {}
    for i in range(n_samples):
        p, q = sample_parents[i]
        if p > q:
            p, q = q, p
        if p < 0 or q < 0 or (p, q) in pairs:
            continue
        in_blanket = np.zeros(n_samples, bool)
        in_blanket[[p, q]] = True
        for c in sample_children[p]:
            if c >= 0:
                in_blanket[c] = True
        for c in sample_children[q]:
            if c >= 0:
                in_blanket[c] = True
        pairs[(p, q)] = np.where(in_blanket)[0]
    if not pairs:
        return np.zeros((0, 2), np.int32), np.zeros((0, 1), np.int32)
    max_size = max(len(b) for b in pairs.values())
    parental_pairs = np.zeros((len(pairs), 2), np.int32)
    blankets = np.full((len(pairs), max_size), -1, np.int32)
    for i, ((p, q), blanket) in enumerate(pairs.items()):
        parental_pairs[i] = (p, q)
        blankets[i, : len(blanket)] = blanket
    return parental_pairs, blankets


# ---------------------------------------------------------------------------
# host-side validation (reference pedigree/validation.py) — vectorized
# ---------------------------------------------------------------------------


def _np_dosage_and_copies(progeny, parent):
    """(dosage, parental_copies) for batches of padded genotype rows."""
    called = progeny >= 0
    eq = (progeny[..., :, None] == progeny[..., None, :]) & called[..., None, :] & called[..., :, None]
    maxp = progeny.shape[-1]
    tri = np.tril(np.ones((maxp, maxp), bool), k=-1)
    first = ~np.any(eq & tri, axis=-1) & called
    dosage = np.where(first, eq.sum(-1), 0)
    match = (parent[..., None, :] == progeny[..., :, None]) & (parent[..., None, :] >= 0)
    copies = np.where(first, match.sum(-1), 0)
    return dosage, copies


def _adjust_dr(constraint, dosage, lam):
    return np.where((lam[..., None] > 0) & (dosage >= 2) & (constraint == 1), 2, constraint)


def duo_valid(progeny, parent, tau, lam):
    """Batched: progeny can derive one gamete from parent (validation.py:12-31)."""
    dosage, copies = _np_dosage_and_copies(progeny, parent)
    constraint = _adjust_dr(np.minimum(dosage, copies), dosage, np.asarray(lam))
    return constraint.sum(-1) >= tau


def trio_valid(progeny, parent_p, parent_q, tau_p, tau_q, lam_p, lam_q):
    """Batched: a valid gamete split exists (validation.py:34-99)."""
    progeny = np.asarray(progeny)
    maxp = progeny.shape[-1]
    dosage, copies_p = _np_dosage_and_copies(progeny, parent_p)
    _, copies_q = _np_dosage_and_copies(progeny, parent_q)
    cp = _adjust_dr(np.minimum(dosage, copies_p), dosage, np.asarray(lam_p))
    cq = _adjust_dr(np.minimum(dosage, copies_q), dosage, np.asarray(lam_q))
    tables, valid = composition_tables(maxp)
    tau_p = np.asarray(tau_p)
    t = tables[tau_p]  # [..., K, maxp]
    tv = valid[tau_p]  # [..., K]
    ok = (
        tv
        & np.all(t <= cp[..., None, :], axis=-1)
        & np.all((dosage[..., None, :] - t) >= 0, axis=-1)
        & np.all((dosage[..., None, :] - t) <= cq[..., None, :], axis=-1)
    )
    base = (cp.sum(-1) >= tau_p) & (cq.sum(-1) >= np.asarray(tau_q))
    return base & np.any(ok, axis=-1)
