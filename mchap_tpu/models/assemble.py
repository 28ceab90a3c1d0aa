"""DenovoMCMC model: de novo haplotype assembly by batched MCMC.

API parity with reference ``mchap/assemble/mcmc.py`` (DenovoMCMC) and
``mchap/assemble/classes.py`` (GenotypeMultiTrace,
PosteriorGenotypeDistribution, GenotypeSupportDistribution), plus
``haplotype_calling.call_posterior_haplotypes``.  The sampler runs as a
single batched device program (ops/assemble_mcmc.py); homozygote-fixed
positions stay in the state with n_alleles = 1 instead of being sliced
out, keeping one compiled shape per (ploidy, n_base, reads) bucket.
"""

from collections import Counter
from dataclasses import dataclass
from functools import reduce

import jax
import jax.numpy as jnp
import numpy as np
from scipy import stats as _stats

from mchap_tpu import mset

from mchap_tpu.ops import assemble_mcmc as _kernel
from mchap_tpu.utils import timing as _timing
from mchap_tpu.ops.likelihood import prepare_reads


def _point_beta_probabilities(n_base, a=1, b=1):
    """Discretized Beta pmf over break counts; reference mcmc.py:429-452."""
    dist = _stats.beta(a, b)
    points = np.arange(1, n_base + 1) / n_base
    probs = dist.cdf(points)
    probs[1:] = probs[1:] - probs[:-1]
    return probs


def _read_mean_dist(reads):
    """Per-position allele profile for chain initialisation.

    The mean of the observed read distributions at each (position,
    allele) cell; cells no read observed get a uniform share over the
    position's allowed alleles (disallowed slots are all-zero columns
    and keep probability 0).  Matches the initialisation semantics of
    reference mcmc.py:455-491, computed via masked sums instead of
    in-place fills.
    """
    reads = np.asarray(reads, float)
    observed = ~np.isnan(reads)  # [R, nb, A]
    n_obs = observed.sum(axis=0)  # [nb, A]
    total = np.where(observed, reads, 0.0).sum(axis=0)
    mean = total / np.maximum(n_obs, 1)
    # slots disallowed at a position are all-zero across reads (nan-safe:
    # nan != 0 so gap cells still count as allowed)
    allowed = ~np.all(np.nan_to_num(reads, nan=1.0) == 0.0, axis=0)
    uniform = 1.0 / allowed.sum(axis=1, keepdims=True)
    dist = np.where(n_obs > 0, mean, uniform)
    return dist / dist.sum(axis=-1, keepdims=True)


@dataclass
class DenovoMCMC:
    """De novo assembly sampler; attributes as reference mcmc.py:24-100."""

    ploidy: int
    n_alleles: list
    inbreeding: float = None
    steps: int = 1000
    chains: int = 2
    alpha: float = 1.0
    beta: float = 3.0
    n_intervals: int = None
    fix_homozygous: float = 0.999
    recombination_step_probability: float = 0.5
    partial_dosage_step_probability: float = 0.5
    dosage_step_probability: float = 1.0
    temperatures: tuple = (1.0,)
    random_seed: int = None
    llk_cache_threshold: int = 100  # accepted for API parity; no cache here

    def fit(self, reads, read_counts=None, initial=None):
        """Run ``chains`` batched MCMC chains; returns GenotypeMultiTrace.

        Reference semantics: mcmc.py:103-265 (zero-read mock, homozygote
        fixing, read-mean initialisation, all-fixed shortcut).
        """
        reads = np.asarray(reads, float)
        n_reads, n_pos, max_allele = reads.shape
        if n_reads == 0:
            reads = np.full((1, n_pos, max_allele), np.nan)
            n_reads = 1
            read_counts = None
        if read_counts is None:
            read_counts = np.ones(n_reads)

        n_alleles = np.array(self.n_alleles, dtype=np.int8)
        use_prior = self.inbreeding is not None
        inbreeding = float(self.inbreeding) if use_prior else 0.0

        if n_pos == 0:
            genotypes = np.zeros((self.chains, self.steps, self.ploidy, 0), np.int8)
            llks = np.full((self.chains, self.steps), np.nan)
            return GenotypeMultiTrace(genotypes, llks)

        # homozygote fixing (mcmc.py:168-199)
        hom_probs = _kernel.homozygosity_probabilities(
            jnp.asarray(reads),
            n_alleles,
            self.ploidy,
            use_prior=use_prior,
            inbreeding=inbreeding,
            read_counts=jnp.asarray(read_counts),
        )
        fixed = hom_probs >= self.fix_homozygous
        homozygous = np.any(fixed, axis=-1)
        fixed_allele = np.where(homozygous, np.argmax(fixed, axis=-1), 0)

        if homozygous.all():
            # nothing to sample: tile the fixed haplotype
            haplotype = fixed_allele.astype(np.int8)
            genotypes = np.tile(haplotype, (self.chains, self.steps, self.ploidy, 1))
            llks = np.full((self.chains, self.steps), np.nan)
            return GenotypeMultiTrace(genotypes, llks)

        # fixed positions keep their allele and become single-allele sites
        n_alleles_eff = np.where(homozygous, 1, n_alleles).astype(np.int32)
        n_het = int((~homozygous).sum())

        # break-count distribution over het positions (mcmc.py:211-217);
        # padded to n_base so empty tail intervals are no-ops
        if self.n_intervals is None:
            break_dist = np.zeros(n_pos)
            break_dist[:n_het] = _point_beta_probabilities(n_het, self.alpha, self.beta)
        else:
            break_dist = np.zeros(n_pos)
            break_dist[min(self.n_intervals - 1, n_pos - 1)] = 1.0

        temperatures = np.sort(np.asarray(self.temperatures, float))
        assert temperatures[0] >= 0.0
        assert temperatures[-1] == 1.0

        seed = self.random_seed if self.random_seed is not None else 0
        key = jax.random.PRNGKey(seed)
        kinit, krun = jax.random.split(key)

        if initial is None:
            # sample initial genotypes from the read-mean distribution,
            # overwriting fixed positions with their fixed allele
            dist = _read_mean_dist(reads)
            cdf = np.cumsum(dist, axis=-1)
            u = np.asarray(
                jax.random.uniform(
                    kinit, (self.chains, self.ploidy, n_pos, 1), dtype=jnp.float64
                )
            )
            sampled = (u > cdf[None, None]).sum(axis=-1).astype(np.int32)
            init = np.where(homozygous[None, None, :], fixed_allele[None, None, :], sampled)
        else:
            initial = np.asarray(initial)
            if initial.ndim == 2:
                initial = np.tile(initial, (self.chains, 1, 1))
            init = np.where(
                homozygous[None, None, :], fixed_allele[None, None, :], initial
            ).astype(np.int32)

        # fixed positions also overwrite the reads' disallowed alleles? no:
        # log_reads stays full; fixed columns contribute a constant per read.
        log_reads = prepare_reads(reads)

        genotypes, llks = _kernel.denovo_sampler(
            krun,
            jnp.asarray(init, jnp.int32),
            log_reads,
            jnp.asarray(read_counts, jnp.float64),
            jnp.asarray(n_alleles_eff),
            jnp.asarray(break_dist),
            jnp.asarray(temperatures),
            n_steps=self.steps,
            use_prior=use_prior,
            inbreeding=inbreeding,
            recombination_step_probability=self.recombination_step_probability,
            partial_dosage_step_probability=self.partial_dosage_step_probability,
            dosage_step_probability=self.dosage_step_probability,
        )
        return GenotypeMultiTrace(np.asarray(genotypes), np.asarray(llks))


def fit_denovo_batch(
    ploidy,
    n_alleles,
    reads_list,
    counts_list,
    inbreeding_list=None,
    steps=1000,
    chains=2,
    alpha=1.0,
    beta=3.0,
    fix_homozygous=0.999,
    recombination_step_probability=0.5,
    partial_dosage_step_probability=0.5,
    dosage_step_probability=1.0,
    temperatures=(1.0,),
    random_seed=None,
    burn=0,
):
    """Run the de novo assembler for MANY samples in one device program.

    The reference application loops samples sequentially
    (application/assemble.py:109); here samples are a vmapped batch axis
    of the jitted sampler (per-sample homozygote fixing, break
    distributions, and inbreeding ride along as traced inputs).
    Returns a list of GenotypeMultiTrace, one per sample.
    """
    from mchap_tpu.models.calling import _pad_reads_bucket

    n_samples = len(reads_list)
    n_alleles = np.array(n_alleles, dtype=np.int8)
    n_pos = len(n_alleles)
    use_prior = inbreeding_list is not None
    inbreeding = (
        np.asarray(inbreeding_list, float) if use_prior else np.zeros(n_samples)
    )

    if n_pos == 0:
        return [
            GenotypeMultiTrace(
                np.zeros((chains, steps, ploidy, 0), np.int8),
                np.full((chains, steps), np.nan),
            )
            for _ in range(n_samples)
        ]

    # mock zero-read samples with a single all-gap read (mcmc.py:132-137)
    reads_list = [
        r if len(r) else np.full((1,) + r.shape[1:], np.nan) for r in reads_list
    ]
    counts_list = [c if len(c) else np.ones(1) for c in counts_list]
    reads, counts = _pad_reads_bucket(reads_list, counts_list)
    n_alleles_mat = np.broadcast_to(
        n_alleles[None, :], (n_samples, n_pos)
    ).copy()
    return _fit_denovo_core(
        reads, counts, n_alleles_mat, ploidy, use_prior, inbreeding,
        steps, chains, alpha, beta, fix_homozygous,
        recombination_step_probability, partial_dosage_step_probability,
        dosage_step_probability, temperatures, random_seed, burn=burn,
    )


def _fit_denovo_core(
    reads, counts, n_alleles_mat, ploidy, use_prior, inbreeding,
    steps, chains, alpha, beta, fix_homozygous,
    recombination_step_probability, partial_dosage_step_probability,
    dosage_step_probability, temperatures, random_seed, burn=0,
):
    """Shared batched-assembly core over pre-padded arrays.

    ``n_alleles_mat`` is PER PROBLEM ([S, nb]); positions with
    n_alleles <= 1 (cross-locus padding, fit_denovo_multi) are forced
    homozygous-fixed at allele 0, which the samplers treat as provable
    no-ops.
    """
    n_samples, _, n_pos, _ = reads.shape

    # per-sample homozygote fixing, all samples in one device program
    with _timing.stage("device.homfilter"):
        hom = np.asarray(
            _kernel.homozygosity_probabilities_batch(
                reads,
                n_alleles_mat,
                ploidy,
                use_prior=use_prior,
                inbreeding_b=inbreeding,
                read_counts_b=counts,
            )
        )  # [S, nb, A]
    fixed = hom >= fix_homozygous
    homozygous = np.any(fixed, axis=-1) | (n_alleles_mat <= 1)  # [S, nb]
    fixed_allele = np.where(
        np.any(fixed, axis=-1), np.argmax(fixed, axis=-1), 0
    )
    fixed_allele = np.where(homozygous, fixed_allele, 0)
    n_alleles_eff = np.where(homozygous, 1, n_alleles_mat).astype(np.int32)
    n_het = (~homozygous).sum(axis=-1)

    break_dist = np.zeros((n_samples, n_pos))
    for i in range(n_samples):
        if n_het[i] > 0:
            break_dist[i, : n_het[i]] = _point_beta_probabilities(
                int(n_het[i]), alpha, beta
            )
        else:
            break_dist[i, 0] = 1.0

    temps = np.sort(np.asarray(temperatures, float))
    assert temps[-1] == 1.0

    seed = random_seed if random_seed is not None else 0
    key = jax.random.PRNGKey(seed)
    kinit, krun = jax.random.split(key)

    with _timing.stage("host.chain_init"):
        init = np.zeros((n_samples, chains, ploidy, n_pos), np.int32)
        u_all = np.asarray(
            jax.random.uniform(
                kinit, (n_samples, chains, ploidy, n_pos, 1), dtype=jnp.float64
            )
        )
        for i in range(n_samples):
            dist = _read_mean_dist(reads[i])
            cdf = np.cumsum(dist, axis=-1)
            sampled = (u_all[i] > cdf[None, None]).sum(axis=-1).astype(np.int32)
            init[i] = np.where(
                homozygous[i][None, None, :], fixed_allele[i][None, None, :],
                sampled,
            )

    def one(key, init_i, lr, c, na, bd, ib):
        return _kernel.denovo_sampler(
            key,
            init_i,
            lr,
            c,
            na,
            bd,
            jnp.asarray(temps),
            n_steps=steps,
            use_prior=use_prior,
            inbreeding=ib,
            recombination_step_probability=recombination_step_probability,
            partial_dosage_step_probability=partial_dosage_step_probability,
            dosage_step_probability=dosage_step_probability,
        )

    # multi-chip: the (locus, sample) problem batch shards over the
    # device mesh (placement only; see parallel.sharding)
    from mchap_tpu.parallel.sharding import problem_mesh, shard_problems

    log_reads = prepare_reads(reads)  # [S, R, nb, A]
    keys = jax.random.split(krun, n_samples)
    mesh = problem_mesh(n_samples)
    _, keys_s, init_s, lr_s, counts_s, na_s, bd_s, ib_s = shard_problems(
        mesh, n_samples, np.asarray(keys), init, np.asarray(log_reads),
        np.asarray(counts, np.float64), n_alleles_eff,
        np.asarray(break_dist), np.asarray(inbreeding, np.float64),
    )
    genotypes, llks = jax.vmap(one)(
        keys_s, init_s, lr_s, counts_s, na_s, bd_s, ib_s
    )
    from mchap_tpu.parallel.sharding import gather_result

    genotypes = gather_result(genotypes)[:n_samples]
    llks = gather_result(llks)[:n_samples]

    out = []
    for i in range(n_samples):
        if homozygous[i].all():
            # all-fixed shortcut semantics (nan llks, constant genotype)
            haplotype = fixed_allele[i].astype(np.int8)
            g = np.tile(haplotype, (chains, steps, ploidy, 1))
            out.append(GenotypeMultiTrace(g, np.full((chains, steps), np.nan)))
        else:
            out.append(GenotypeMultiTrace(genotypes[i], llks[i]))
    return out


def fit_denovo_multi(
    problems,
    ploidy,
    steps=1000,
    chains=2,
    alpha=1.0,
    beta=3.0,
    fix_homozygous=0.999,
    recombination_step_probability=0.5,
    partial_dosage_step_probability=0.5,
    dosage_step_probability=1.0,
    temperatures=(1.0,),
    random_seed=None,
    burn=0,
):
    """Run the de novo assembler for problems from MANY LOCI in one
    device program (cross-locus streaming).

    Each problem is a dict with ``reads`` (float[R, nb_i, A_i]),
    ``counts`` (float[R]), ``n_alleles`` (int[nb_i]) and optionally
    ``inbreeding``.  Problems are padded to a common
    [R_max, nb_max, A_max] bucket; padded positions are all-gap reads
    with n_alleles = 1, which the samplers provably never move (the
    cross-locus analogue of the homozygote-fixed static-shape design).
    The reference parallelises this axis with one process per locus
    (baseclass.py:360-394).  Returns one GenotypeMultiTrace per
    problem, sliced back to its true position count.
    """
    n_prob = len(problems)
    nb_list = [len(p["n_alleles"]) for p in problems]
    a_list = [
        (p["reads"].shape[2] if p["reads"].ndim == 3 and p["reads"].shape[2] else 1)
        for p in problems
    ]
    r_list = [max(len(p["reads"]), 1) for p in problems]

    # partition the block into padded-shape BUCKETS so one worst-case
    # locus doesn't drag every problem to its shape: a single triallelic
    # site would make every problem score A-fold more candidates.
    # Buckets are deliberately COARSE — allele radix (pow 2) and a
    # two-tier read class (<= 64 / pow-2 above) — because every distinct
    # bucket shape costs a fresh compile of the sampler program.
    # Position width is not part of the key; padded positions are
    # frozen no-ops.  Each bucket runs as its own device program with a
    # distinct derived seed.
    def _bucket_key(i):
        a_b = 2
        while a_b < a_list[i]:
            a_b *= 2
        r_b = 64
        while r_b < r_list[i]:
            r_b *= 2
        return (a_b, r_b)

    buckets = {}
    for i in range(n_prob):
        buckets.setdefault(_bucket_key(i), []).append(i)
    if len(buckets) > 1:
        out = [None] * n_prob
        base_seed = random_seed if random_seed is not None else 0
        for ordinal, key in enumerate(sorted(buckets)):
            idxs = buckets[key]
            sub = fit_denovo_multi(
                [problems[i] for i in idxs],
                ploidy,
                steps=steps,
                chains=chains,
                alpha=alpha,
                beta=beta,
                fix_homozygous=fix_homozygous,
                recombination_step_probability=recombination_step_probability,
                partial_dosage_step_probability=partial_dosage_step_probability,
                dosage_step_probability=dosage_step_probability,
                temperatures=temperatures,
                random_seed=base_seed + 7919 * ordinal,
                burn=burn,
            )
            for i, t in zip(idxs, sub):
                out[i] = t
        return out

    nb_max = max(nb_list + [0])
    if nb_max:
        # round the block's position width to a multiple of 8: stable
        # compiled shapes across blocks (padded positions are frozen
        # no-ops)
        nb_max = (nb_max + 7) // 8 * 8
    if nb_max == 0:
        return [
            GenotypeMultiTrace(
                np.zeros((chains, steps, ploidy, 0), np.int8),
                np.full((chains, steps), np.nan),
            )
            for _ in range(n_prob)
        ]
    a_max = max(a_list)
    # power-of-two read bucket with a floor of 64: stable compiled
    # shapes across blocks, matching the bucket key's read classes
    # (padding reads are all-gap with zero counts)
    r_max = 64
    while r_max < max(r_list):
        r_max *= 2

    use_prior = any(p.get("inbreeding") is not None for p in problems)
    inbreeding = np.array(
        [float(p.get("inbreeding") or 0.0) for p in problems]
    )

    reads = np.full((n_prob, r_max, nb_max, a_max), np.nan)
    counts = np.zeros((n_prob, r_max))
    n_alleles_mat = np.ones((n_prob, nb_max), np.int32)
    for i, p in enumerate(problems):
        r_i, nb_i, a_i = len(p["reads"]), nb_list[i], a_list[i]
        if r_i and nb_i:
            reads[i, :r_i, :nb_i, :a_i] = p["reads"]
            # allele slots beyond the problem's own allele axis are
            # impossible observations (prob 0 -> MIN_LOG), not gaps
            reads[i, :r_i, :nb_i, a_i:] = 0.0
            counts[i, :r_i] = p["counts"]
        else:
            # zero reads: single all-gap mock read (mcmc.py:132-137)
            counts[i, 0] = 1.0
        n_alleles_mat[i, :nb_i] = np.asarray(p["n_alleles"], np.int32)

    traces = _fit_denovo_core(
        reads, counts, n_alleles_mat, ploidy, use_prior, inbreeding,
        steps, chains, alpha, beta, fix_homozygous,
        recombination_step_probability, partial_dosage_step_probability,
        dosage_step_probability, temperatures, random_seed, burn=burn,
    )
    return [tr.truncate_positions(nb_list[i]) for i, tr in enumerate(traces)]


@dataclass
class PosteriorGenotypeDistribution:
    """Posterior over phased genotypes; reference classes.py:54-166."""

    genotypes: np.ndarray  # [n_genotypes, ploidy, n_pos]
    probabilities: np.ndarray

    def mode(self):
        idx = np.argmax(self.probabilities)
        return self.genotypes[idx], self.probabilities[idx]

    def mode_genotype_support(self):
        """Dosage-marginal mode: group genotypes by their allele-support
        set, pick the heaviest group (reference semantics classes.py:87-128).
        """
        # support key = the genotype with duplicate haplotype rows
        # dropped; genotypes here are row-sorted (trace canonicalisation)
        # so equal supports serialize identically
        keys = np.array([mset.unique(g).tobytes() for g in self.genotypes])
        _, first, group = np.unique(keys, return_index=True, return_inverse=True)
        group_probs = np.bincount(group, weights=self.probabilities)
        # argmax with ties resolved to the group appearing earliest in
        # the (descending-probability) posterior ordering
        winner = np.lexsort((first, -group_probs))[0]
        member = group == winner
        return GenotypeSupportDistribution(
            self.genotypes[member], self.probabilities[member]
        )

    def allele_frequencies(self, dosage=False):
        """(haplotypes, frequencies, occurrence); classes.py:130-166."""
        n_gen, ploidy, n_base = self.genotypes.shape
        haps = self.genotypes.reshape(n_gen * ploidy, n_base)
        uhaps = mset.unique(haps)
        freqs = {h.tobytes(): 0.0 for h in uhaps}
        occur = {h.tobytes(): 0.0 for h in uhaps}
        for gen, prob in zip(self.genotypes, self.probabilities):
            counts = Counter(hap.tobytes() for hap in gen)
            for key, dose in counts.items():
                freqs[key] += prob * dose
                occur[key] += prob
        ufreqs = np.array([freqs[h.tobytes()] for h in uhaps])
        uoccur = np.array([occur[h.tobytes()] for h in uhaps])
        if dosage is False:
            ufreqs = ufreqs / ploidy
        return uhaps, ufreqs, uoccur


@dataclass
class GenotypeSupportDistribution:
    """Dosage-alternatives of one allele support; classes.py:169-244."""

    genotypes: np.ndarray
    probabilities: np.ndarray

    def alleles(self):
        return mset.unique(self.genotypes[0])

    def mode_genotype(self):
        idx = np.argmax(self.probabilities)
        return self.genotypes[idx], self.probabilities[idx]

    def call_genotype_support(self, threshold=0.95):
        """Most complete allele set exceeding ``threshold``; pads with
        null alleles when needed (reference semantics classes.py:207-244).

        The smallest probability-descending prefix of dosage alternatives
        whose mass reaches ``threshold`` is intersected (multiset-wise);
        haplotypes shared by every member are called, the rest are null.
        """
        order = np.argsort(-self.probabilities, kind="stable")
        if self.probabilities[order[0]] >= threshold:
            return self.genotypes[order[0]], self.probabilities[order[0]]
        cum = np.cumsum(self.probabilities[order])
        k = min(int(np.searchsorted(cum, threshold)) + 1, len(cum))
        shared = reduce(mset.intercept, list(self.genotypes[order[:k]]))
        _, ploidy, n_pos = self.genotypes.shape
        result = np.full((ploidy, n_pos), -1, dtype=self.genotypes.dtype)
        result[: len(shared)] = shared
        return result, cum[k - 1]


@dataclass
class GenotypeMultiTrace:
    """Multi-chain trace of phased genotypes; classes.py:247-376."""

    genotypes: np.ndarray  # [n_chains, n_steps, ploidy, n_pos]
    llks: np.ndarray

    def __post_init__(self):
        if (self.genotypes is not None) and (self.genotypes.shape[-1] != 0):
            g = np.array(self.genotypes)
            assert g.ndim == 4
            n_chains, n_steps, ploidy, n_pos = g.shape
            # canonical per-step ordering: lexicographic row sort, fully
            # vectorized (replaces the reference's per-step python loop)
            flat = g.reshape(n_chains * n_steps, ploidy, n_pos)
            keys = flat.transpose(2, 0, 1)[::-1]  # [n_pos, N, ploidy]
            order = np.lexsort(tuple(keys))  # [N, ploidy]
            flat = np.take_along_axis(flat, order[..., None], axis=1)
            self.genotypes = flat.reshape(g.shape)
            self.llks = np.array(self.llks)

    def burn(self, n):
        """Drop the first ``n`` steps of the ORIGINAL trace.

        Batched device paths may pre-slice the burn-in on device (less
        device->host traffic) and record it in ``pre_burned``; burning
        by the same n again is then a no-op, so application code calls
        ``.burn(mcmc_burn)`` uniformly either way.
        """
        pre = getattr(self, "pre_burned", 0)
        k = max(n - pre, 0)
        new = type(self)(None, None)
        new.genotypes = self.genotypes[:, k:]
        new.llks = self.llks[:, k:]
        new.pre_burned = max(n, pre)
        return new

    def posterior(self):
        n_chain, n_step, ploidy, n_base = self.genotypes.shape
        if n_base == 0:
            return PosteriorGenotypeDistribution(
                np.zeros((1, ploidy, 0), self.genotypes.dtype), np.ones(1)
            )
        genotypes = self.genotypes.reshape(n_chain * n_step, ploidy * n_base)
        with _timing.stage("host.posterior_tab"):
            states, counts = mset.unique_counts(genotypes)
        probs = counts / counts.sum()
        idx = np.flip(np.argsort(probs, kind="stable"))
        return PosteriorGenotypeDistribution(
            states[idx].reshape(len(states), ploidy, n_base), probs[idx]
        )

    def split(self):
        for genotypes, llks in zip(self.genotypes, self.llks):
            new = type(self)(None, None)
            new.genotypes = genotypes[None]
            new.llks = llks[None]
            yield new

    def truncate_positions(self, n_pos):
        """Trace restricted to the leading ``n_pos`` positions.

        Used to strip cross-locus padding positions, which are frozen
        (n_alleles = 1) and identical across every state, so truncation
        never merges distinct genotypes.
        """
        new = type(self)(None, None)
        new.genotypes = self.genotypes[..., :n_pos]
        new.llks = self.llks
        new.pre_burned = getattr(self, "pre_burned", 0)
        return new

    def replicate_incongruence(self, threshold=0.6):
        """0/1/2 = none / incongruent / putative CNV; classes.py:341-376."""
        return _replicate_incongruence(self, threshold)


def _replicate_incongruence(trace, threshold):
    """Shared MCI computation over any trace with split()/posterior()."""
    out = 0
    posteriors = [chain.posterior() for chain in trace.split()]
    chain_modes = [dist.mode_genotype_support() for dist in posteriors]
    alleles = [
        mode.alleles()
        for mode in chain_modes
        if mode.probabilities.sum() >= threshold
    ]
    mode_count = len({array.tobytes() for array in alleles})
    if mode_count > 1:
        out = 1
        ploidy = len(alleles[0])
        allele_count = len(reduce(mset.union, alleles))
        if allele_count > ploidy:
            out = 2
    return out


def call_posterior_haplotypes(posteriors, threshold=0.01):
    """Pool per-sample posteriors into a population allele panel.

    Every haplotype whose occurrence probability reaches ``threshold``
    in at least one sample enters the panel; alleles are weighted by
    their summed posterior dosage across samples and emitted in VCF
    order — the reference (all-zero) haplotype first, alternates by
    descending pooled weight.  Returns ``(haplotypes, ref_observed)``.
    Output-contract semantics match reference haplotype_calling.py:4-64
    (re-derived on stacked arrays rather than per-haplotype dicts).
    """
    n_base = posteriors[0].genotypes.shape[-1]
    kept = []
    kept_weights = []
    for post in posteriors:
        haps, weights, probs = post.allele_frequencies(dosage=True)
        supported = probs >= threshold
        kept.append(haps[supported])
        kept_weights.append(weights[supported])
    pool = np.concatenate(
        [np.asarray(h).reshape(len(h), n_base) for h in kept], axis=0
    ).astype(np.int8)
    pool_weights = np.concatenate(kept_weights)

    # sum weights over duplicate rows, keeping first-appearance order
    # (the tie-break order of the final sort)
    uniq, first, inverse = np.unique(
        pool, axis=0, return_index=True, return_inverse=True
    )
    totals = np.bincount(inverse, weights=pool_weights, minlength=len(uniq))
    appearance = np.argsort(first, kind="stable")
    uniq, totals = uniq[appearance], totals[appearance]

    # the reference allele is emitted first whether observed or not
    is_ref = np.all(uniq == 0, axis=1)
    ref_observed = bool(is_ref.any())
    alts, alt_weights = uniq[~is_ref], totals[~is_ref]
    panel = np.concatenate([alts, np.zeros((1, n_base), np.int8)], axis=0)
    weights = np.append(alt_weights, alt_weights.max(initial=-1.0) + 1.0)
    order = np.flip(np.argsort(weights, kind="stable"))
    return panel[order], ref_observed
