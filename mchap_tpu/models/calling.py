"""CallingMCMC model: known-haplotype genotype calling by batched MCMC.

API parity with reference ``mchap/calling/classes.py`` (CallingMCMC,
GenotypeAllelesMultiTrace, PosteriorGenotypeAllelesDistribution), with
the sampler redesigned for an accelerator: all chains run as one batched
device program (ops/calling_mcmc.py); posterior tabulation happens
host-side on the small trace.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from mchap_tpu import mset
from mchap_tpu.numerics.combinadics import count_unique_genotypes
from mchap_tpu.numerics.dosage import allelic_dosage  # noqa: F401 (re-export)
from mchap_tpu.ops import calling_mcmc as _kernel
from mchap_tpu.parallel.sharding import gather_result
from mchap_tpu.ops.likelihood import prepare_reads, read_hap_loglik


def _prior_kind_and_params(prior, n_alleles):
    """Translate the reference's ``prior`` tuple into kernel parameters."""
    if prior is None:
        return 0, 0.0, None
    inbreeding, frequencies = prior
    freqs = (
        jnp.asarray(frequencies, jnp.float64)
        if frequencies is not None
        else None
    )
    return 1, float(inbreeding), freqs


@dataclass
class CallingMCMC:
    """MCMC genotype caller over a known haplotype panel.

    Attributes mirror reference calling/classes.py:15-47.
    """

    ploidy: int
    haplotypes: np.ndarray
    prior: tuple = None
    steps: int = 1000
    chains: int = 2
    random_seed: int = None
    step_type: str = "Gibbs"

    def fit(self, reads, read_counts=None, initial=None):
        """Run ``chains`` batched MCMC chains; returns a multi-chain trace.

        Reference semantics: calling/classes.py:49-124 (zero-variant
        shortcut, greedy initialisation, per-step sorted genotypes).
        """
        haplotypes = np.asarray(self.haplotypes)
        n_alleles = len(haplotypes)

        # zero-variant shortcut: only the reference allele exists
        if reads.shape[1] == 0:
            assert n_alleles == 1
            genotypes = np.zeros((self.chains, self.steps, self.ploidy), np.int8)
            llks = np.full((self.chains, self.steps), np.nan)
            return GenotypeAllelesMultiTrace(genotypes, llks, n_alleles)

        if read_counts is None:
            read_counts = np.ones(len(reads))

        log_reads = prepare_reads(reads)
        read_hap = read_hap_loglik(log_reads, jnp.asarray(haplotypes))
        counts = jnp.asarray(read_counts, read_hap.dtype)

        prior_kind, inbreeding, freqs = _prior_kind_and_params(self.prior, n_alleles)

        if initial is None:
            initial = _kernel.greedy_caller(
                read_hap,
                counts,
                ploidy=self.ploidy,
                prior_kind=prior_kind,
                inbreeding=inbreeding,
                frequencies=freqs,
            )
        initial = jnp.broadcast_to(
            jnp.asarray(initial, jnp.int32), (self.chains, self.ploidy)
        )

        if self.step_type == "Gibbs":
            step_type = 0
        elif self.step_type == "Metropolis-Hastings":
            step_type = 1
        else:
            raise ValueError('MCMC step type must be "Gibbs" or "Metropolis-Hastings"')

        seed = self.random_seed if self.random_seed is not None else 0
        key = jax.random.PRNGKey(seed)
        genotypes, llks = _kernel.calling_sampler(
            key,
            initial,
            read_hap,
            counts,
            n_steps=self.steps,
            step_type=step_type,
            prior_kind=prior_kind,
            inbreeding=inbreeding,
            frequencies=freqs,
        )
        return GenotypeAllelesMultiTrace(
            np.asarray(genotypes, np.int32), np.asarray(llks), n_alleles
        )


def _pad_reads_bucket(reads_list, counts_list, min_bucket=8):
    """Pad per-sample reads to a shared power-of-two read count.

    Bucketing keeps one compiled sampler per (R, P, A) shape across loci
    and samples; padded reads are nan (log 1) with count 0, so they
    contribute nothing to any likelihood.
    """
    max_r = max((len(r) for r in reads_list), default=0)
    bucket = min_bucket
    while bucket < max_r:
        bucket *= 2
    shape = reads_list[0].shape[1:]
    n = len(reads_list)
    reads = np.full((n, bucket) + shape, np.nan)
    counts = np.zeros((n, bucket))
    for i, (r, c) in enumerate(zip(reads_list, counts_list)):
        reads[i, : len(r)] = r
        counts[i, : len(c)] = c
    return reads, counts


def fit_calling_batch(
    ploidy,
    haplotypes,
    reads_list,
    counts_list,
    inbreeding_list=None,
    frequencies=None,
    steps=1000,
    chains=2,
    random_seed=None,
    step_type="Gibbs",
    burn=0,
):
    """Fit the calling sampler for MANY samples in one device program.

    The per-sample loop of the reference application (call.py:120-199,
    one sampler run per sample) becomes a vmapped batch: one read-hap
    matmul for all samples, one compiled sampler for all samples x
    chains.  Returns a list of GenotypeAllelesMultiTrace, one per sample.
    """
    haplotypes = np.asarray(haplotypes)
    n_alleles = len(haplotypes)
    n_samples = len(reads_list)

    if reads_list[0].shape[1] == 0:
        # zero-variant shortcut for every sample
        assert n_alleles == 1
        return [
            GenotypeAllelesMultiTrace(
                np.zeros((chains, steps, ploidy), np.int8),
                np.full((chains, steps), np.nan),
                n_alleles,
            )
            for _ in range(n_samples)
        ]

    reads, counts = _pad_reads_bucket(reads_list, counts_list)
    log_reads = prepare_reads(reads)
    read_hap = read_hap_loglik(log_reads, jnp.asarray(haplotypes))  # [S, R, H]
    counts = jnp.asarray(counts, read_hap.dtype)

    if inbreeding_list is None:
        prior_kind = 0
        inbreeding = jnp.zeros(n_samples)
        freqs = None
    else:
        prior_kind = 1
        inbreeding = jnp.asarray(inbreeding_list, jnp.float64)
        freqs = (
            jnp.asarray(frequencies, jnp.float64) if frequencies is not None else None
        )

    step_type_i = {"Gibbs": 0, "Metropolis-Hastings": 1}[step_type]
    seed = random_seed if random_seed is not None else 0

    keys = jax.random.split(jax.random.PRNGKey(seed), n_samples)

    def one(key, rh, c, f):
        initial = _kernel.greedy_caller(
            rh, c, ploidy=ploidy, prior_kind=prior_kind, inbreeding=f,
            frequencies=freqs,
        )
        return _kernel.calling_sampler(
            key,
            jnp.broadcast_to(initial, (chains, ploidy)),
            rh,
            c,
            n_steps=steps,
            step_type=step_type_i,
            prior_kind=prior_kind,
            inbreeding=f,
            frequencies=freqs,
        )

    # multi-chip: the sample batch shards over the device mesh
    from mchap_tpu.parallel.sharding import problem_mesh, shard_problems

    mesh = problem_mesh(n_samples)
    _, keys, read_hap, counts, inbreeding = shard_problems(
        mesh, n_samples, np.asarray(keys), np.asarray(read_hap),
        np.asarray(counts), np.asarray(inbreeding),
    )
    genotypes, llks = jax.vmap(one)(keys, read_hap, counts, inbreeding)
    small = jnp.int8 if n_alleles <= 127 else jnp.int16
    genotypes = gather_result(genotypes[:, :, burn:].astype(small))[:n_samples]
    llks = gather_result(llks[:, :, burn:])[:n_samples]
    return [
        GenotypeAllelesMultiTrace(genotypes[i], llks[i], n_alleles, burn)
        for i in range(n_samples)
    ]


def fit_calling_multi(
    problems,
    ploidy,
    steps=1000,
    chains=2,
    random_seed=None,
    step_type="Gibbs",
    burn=0,
):
    """Fit the calling sampler for problems spanning MANY LOCI at once.

    ``problems``: list of dicts with keys ``reads`` (f[R_i, P_i, A_i]),
    ``counts`` (f[R_i]), ``haplotypes`` (i[H_i, P_i]) and optionally
    ``inbreeding``/``frequencies``.  Panels are padded to the block's max
    size with impossible (-inf) columns, reads to a power-of-two bucket —
    ONE device program then samples every (locus, sample) chain, which is
    how loci stream through the chip instead of one device call per
    sample (SURVEY.md §2.8 data-parallel axis).

    Returns one GenotypeAllelesMultiTrace per problem (alleles indexed
    within each problem's own panel).
    """
    from mchap_tpu.ops.likelihood import MIN_LOG

    n_problems = len(problems)
    use_prior = any("inbreeding" in p for p in problems)
    h_max = max(len(p["haplotypes"]) for p in problems)

    # per-problem read-hap matrices, padded on H with -inf columns
    rh_list = []
    counts_list = []
    freq_rows = []
    inbreeding_rows = []
    for p in problems:
        log_reads = prepare_reads(p["reads"])
        rh = np.asarray(read_hap_loglik(log_reads, jnp.asarray(p["haplotypes"])))
        h_i = rh.shape[1]
        if h_i < h_max:
            rh = np.concatenate(
                [rh, np.full((rh.shape[0], h_max - h_i), MIN_LOG)], axis=1
            )
        rh_list.append(rh)
        counts_list.append(np.asarray(p["counts"], float))
        if use_prior:
            freqs = p.get("frequencies")
            if freqs is None:
                freqs = np.full(h_i, 1.0 / h_i)
            freq_rows.append(np.pad(np.asarray(freqs, float), (0, h_max - h_i)))
            inbreeding_rows.append(float(p.get("inbreeding", 0.0)))

    # pad reads to a shared power-of-two bucket
    max_r = max(len(r) for r in rh_list)
    bucket = 8
    while bucket < max_r:
        bucket *= 2
    read_hap = np.full((n_problems, bucket, h_max), 0.0)
    counts = np.zeros((n_problems, bucket))
    for i, (rh, c) in enumerate(zip(rh_list, counts_list)):
        read_hap[i, : len(rh)] = rh
        counts[i, : len(c)] = c
    read_hap = jnp.asarray(read_hap)
    counts = jnp.asarray(counts, read_hap.dtype)

    step_type_i = {"Gibbs": 0, "Metropolis-Hastings": 1}[step_type]
    seed = random_seed if random_seed is not None else 0

    n_valid = np.array([len(p["haplotypes"]) for p in problems], np.int32)

    prior_kind = 1 if use_prior else 0
    inbreeding = np.asarray(inbreeding_rows if use_prior else np.zeros(n_problems))
    freqs = np.stack(freq_rows) if use_prior else None
    keys = jax.random.split(jax.random.PRNGKey(seed), n_problems)

    def one(key, rh, c, f, fr, nv):
        initial = _kernel.greedy_caller(
            rh, c, ploidy=ploidy, prior_kind=prior_kind, inbreeding=f,
            frequencies=fr, n_valid=nv,
        )
        return _kernel.calling_sampler(
            key,
            jnp.broadcast_to(initial, (chains, ploidy)),
            rh,
            c,
            n_steps=steps,
            step_type=step_type_i,
            prior_kind=prior_kind,
            inbreeding=f,
            frequencies=fr,
            n_valid=nv,
        )

    # multi-chip: problems shard over the device mesh (placement only —
    # every per-problem program and key is unchanged, see parallel.sharding)
    from mchap_tpu.parallel.sharding import problem_mesh, shard_problems

    mesh = problem_mesh(n_problems)
    if use_prior:
        _, keys, read_hap, counts, inbreeding, freqs, n_valid_j = shard_problems(
            mesh, n_problems, np.asarray(keys), np.asarray(read_hap),
            np.asarray(counts), inbreeding, freqs, n_valid,
        )
        genotypes, llks = jax.vmap(one)(
            keys, read_hap, counts, inbreeding, freqs, n_valid_j
        )
    else:
        _, keys, read_hap, counts, inbreeding, n_valid_j = shard_problems(
            mesh, n_problems, np.asarray(keys), np.asarray(read_hap),
            np.asarray(counts), inbreeding, n_valid,
        )
        genotypes, llks = jax.vmap(
            lambda k, rh, c, f, nv: one(k, rh, c, f, None, nv)
        )(keys, read_hap, counts, inbreeding, n_valid_j)
    small = jnp.int8 if h_max <= 127 else jnp.int16
    genotypes = gather_result(genotypes[:, :, burn:].astype(small))[:n_problems]
    llks = gather_result(llks[:, :, burn:])[:n_problems]
    return [
        GenotypeAllelesMultiTrace(
            genotypes[i], llks[i], len(problems[i]["haplotypes"]), burn
        )
        for i in range(n_problems)
    ]


@dataclass
class GenotypeAllelesMultiTrace:
    """Multi-chain trace of allele-index genotypes.

    Reference: calling/classes.py:127-297.
    """

    genotypes: np.ndarray  # [n_chains, n_steps, ploidy]
    llks: np.ndarray  # [n_chains, n_steps]
    n_allele: int
    pre_burned: int = 0  # steps already dropped on device (batched paths)

    def relabel(self, labels):
        """Map alleles through ``labels``; reference classes.py:147-165."""
        return type(self)(
            labels[self.genotypes], self.llks, labels.max() + 1, self.pre_burned
        )

    def burn(self, n):
        """Drop the first ``n`` steps of the ORIGINAL trace (a no-op for
        steps the device already sliced, see ``pre_burned``)."""
        k = max(n - self.pre_burned, 0)
        return type(self)(
            self.genotypes[:, k:],
            self.llks[:, k:],
            self.n_allele,
            max(n, self.pre_burned),
        )

    def posterior(self):
        """Posterior over unique genotypes (frequency in merged trace)."""
        n_chain, n_step = self.genotypes.shape[:2]
        flat = self.genotypes.reshape((n_chain * n_step,) + self.genotypes.shape[2:])
        states, counts = mset.unique_counts(flat)
        probs = counts / counts.sum()
        idx = np.flip(np.argsort(probs, kind="stable"))
        return PosteriorGenotypeAllelesDistribution(states[idx], probs[idx])

    def split(self):
        """Yield single-chain traces."""
        for genotypes, llks in zip(self.genotypes, self.llks):
            yield type(self)(genotypes[None], llks[None], self.n_allele)

    def replicate_incongruence(self, threshold=0.6):
        """0/1/2 = congruent / incongruent / putative CNV.

        Reference: calling/classes.py:228-260.
        """
        out = 0
        chain_modes = [
            chain.posterior().mode(genotype_support=True) for chain in self.split()
        ]
        alleles = [mode[0] for mode in chain_modes if mode[-1] >= threshold]
        mode_count = len({array.tobytes() for array in alleles})
        if mode_count > 1:
            out = 1
            ploidy = len(alleles[0])
            allele_count = len(set(np.array(alleles).ravel()))
            if allele_count > ploidy:
                out = 2
        return out

    def posterior_frequencies(self):
        """(freqs, counts, occurrence) of alleles over the merged trace.

        Vectorized equivalent of reference ``_posterior_frequencies``
        (classes.py:277-297).
        """
        g = self.genotypes.reshape(-1, self.genotypes.shape[-1])
        n_obs, ploidy = g.shape
        counts = np.bincount(g.ravel(), minlength=self.n_allele).astype(float)
        # occurrence: count each allele once per genotype observation
        eq = g[:, :, None] == g[:, None, :]
        first = ~np.any(np.tril(eq, k=-1), axis=-1)  # slot is first occurrence
        occ_alleles = g[first]
        occurrence = np.bincount(occ_alleles, minlength=self.n_allele).astype(float)
        counts /= n_obs
        occurrence /= n_obs
        return counts / ploidy, counts, occurrence


@dataclass
class PosteriorGenotypeAllelesDistribution:
    """Posterior over observed genotypes; reference classes.py:300-368."""

    genotypes: np.ndarray
    probabilities: np.ndarray

    def mode(self, genotype_support=False):
        """Mode genotype, optionally with genotype-support statistics."""
        if genotype_support is False:
            idx = np.argmax(self.probabilities)
            return self.genotypes[idx], self.probabilities[idx]
        # group genotypes by their allele-support set
        labels = {}
        probs = {}
        assignment = np.zeros(len(self.genotypes), dtype=int)
        for i, gen in enumerate(self.genotypes):
            key = np.unique(gen).tobytes()
            if key not in labels:
                labels[key] = i
                probs[i] = self.probabilities[i]
            else:
                probs[labels[key]] += self.probabilities[i]
            assignment[i] = labels[key]
        keys, vals = zip(*probs.items())
        mode_label = keys[int(np.argmax(vals))]
        idx = assignment == mode_label
        genotypes = self.genotypes[idx]
        prob = self.probabilities[idx]
        best = np.argmax(prob)
        return genotypes[best], prob[best], prob.sum()

    def as_array(self, n_alleles):
        """Dense probability vector over all possible genotypes."""
        _, ploidy = self.genotypes.shape
        from mchap_tpu.numerics.combinadics import genotype_alleles_as_index

        u_genotypes = count_unique_genotypes(n_alleles, ploidy)
        out = np.zeros(u_genotypes)
        idx = np.asarray(genotype_alleles_as_index(np.sort(self.genotypes, axis=-1)))
        out[idx] = self.probabilities
        return out
