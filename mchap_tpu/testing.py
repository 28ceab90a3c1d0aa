"""Test-support utilities: simulators, oracles and a deployment writer.

Same role as reference ``mchap/testing.py``: ``simulate_reads`` generates
probabilistically-encoded reads from ground-truth haplotypes (for
statistical sampler tests), and ``metropolis_hastings_transitions`` builds
the exact MH transition matrix used to verify sampler stationary
distributions.  ``write_deployment`` writes every input file of a
seeded bi-parental population (FASTA, BED, SNV VCF, one SAM per sample,
pedigree, true genotypes) for the CLI tests, ``chip_smoke.py`` and
``bench.py``; ``genotype_concordance`` scores an ``assemble`` VCF
against its true genotypes.
"""

import json
import os

import numpy as np

from mchap_tpu.constant import PFEIFFER_ERROR
from mchap_tpu.encoding.integer import as_probabilistic
from mchap_tpu.io.util import prob_of_qual


def simulate_reads(
    haplotypes,
    n_alleles=None,
    n_reads=20,
    uniform_sample=False,
    errors=True,
    error_rate=PFEIFFER_ERROR,
    qual=(30, 60),
    seed=None,
):
    """Simulate probabilistic reads from haplotypes (tests only).

    Reference: testing.py:9-73.  Reads sample haplotypes (uniformly or at
    random), get random per-base quals in ``qual``, and are optionally
    resampled from their own probability distributions to inject errors.
    """
    rng = np.random.default_rng(seed)
    haplotypes = np.asarray(haplotypes)
    ploidy, _ = haplotypes.shape
    if n_alleles is None:
        n_alleles = int(haplotypes.max()) + 1

    if uniform_sample:
        read_haps = np.tile(haplotypes, (n_reads // ploidy, 1))
    else:
        read_haps = haplotypes[rng.integers(0, ploidy, n_reads)]

    quals = rng.integers(qual[0], qual[1] + 1, size=read_haps.shape)
    probs = prob_of_qual(quals) * (1 - error_rate)
    reads = as_probabilistic(read_haps, n_alleles, p=probs)

    if errors:
        # resample alleles from the encoded distributions
        flat = reads.reshape(-1, reads.shape[-1])
        sums = np.nansum(flat, axis=-1, keepdims=True)
        dists = np.where(np.isnan(flat), 0.0, flat) / sums
        cdf = np.cumsum(dists, axis=-1)
        u = rng.random((len(flat), 1))
        read_haps = (u > cdf).sum(axis=-1).reshape(read_haps.shape).astype(np.int8)
        reads = as_probabilistic(read_haps, n_alleles, p=probs)

    return reads


def metropolis_hastings_transitions(transitions, llks, priors):
    """Exact MH transition matrix over an explicit state graph.

    Reference: testing.py:76-121.  ``transitions`` is the binary adjacency
    of allowed proposals; returns the row-stochastic MH kernel.
    """
    transitions = np.asarray(transitions, dtype=float)
    llks = np.asarray(llks, dtype=float)
    priors = np.asarray(priors, dtype=float)

    lk_ratios = np.exp(llks[None, :] - llks[:, None])
    prior_ratios = priors[None, :] / priors[:, None]
    proposal_ratios = transitions.sum(axis=-1, keepdims=True) / transitions.sum(
        axis=0, keepdims=True
    )
    proposal_ratios = proposal_ratios * transitions

    mh = lk_ratios * proposal_ratios * prior_ratios
    mh[mh > 1] = 1
    proposal_probability = transitions / np.sum(transitions, axis=-1, keepdims=True)
    mh *= proposal_probability
    np.fill_diagonal(mh, 0)
    np.fill_diagonal(mh, 1 - mh.sum(axis=-1))
    return mh


def exact_pedigree_marginals(sample_llks, sample_parents, gamete_tau,
                             gamete_lambda, gamete_error, n_haps, ploidy,
                             log_frequencies=None):
    """Brute-force per-sample posterior marginals of a small pedigree.

    Enumerates all G^S joint genotype assignments (G = C(n_haps +
    ploidy - 1, ploidy)) of the joint density prod_i llk_i x trio_i
    (reference pedigree model) and returns [S, G] marginals.  The whole
    enumeration runs as ONE vmapped device program instead of a device
    round trip per trio evaluation.

    sample_llks: f[S, G] per-sample genotype log-likelihoods in VCF
    genotype order (ops/exact.genotype_likelihoods).
    """
    import itertools

    import jax
    import jax.numpy as jnp

    from mchap_tpu.numerics.combinadics import enumerate_genotypes
    from mchap_tpu.ops import pedigree_mcmc as K

    sample_llks = np.asarray(sample_llks, float)
    parents = np.asarray(sample_parents, int)
    tau = np.asarray(gamete_tau, int)
    lam = np.asarray(gamete_lambda, float)
    err = np.asarray(gamete_error, float)
    n_samples, G = sample_llks.shape
    table = np.zeros((G, ploidy), np.int32)
    for gi, g in enumerate(enumerate_genotypes(n_haps, ploidy)):
        table[gi] = g
    if log_frequencies is None:
        log_frequencies = np.log(np.full(n_haps, 1.0 / n_haps))
    tables, valid = K.composition_tables(ploidy)
    tb = jnp.asarray(table)
    t_j, v_j = jnp.asarray(tables), jnp.asarray(valid)
    lut = jnp.asarray(K._COMB_LUT)
    lf = jnp.asarray(log_frequencies)
    llks_j = jnp.asarray(sample_llks)

    def joint(combo):
        lp = jnp.zeros((), jnp.float64)
        for i in range(n_samples):
            p, q = int(parents[i, 0]), int(parents[i, 1])
            has_p, has_q = p >= 0, q >= 0
            lp = lp + llks_j[i, combo[i]]
            lp = lp + K.trio_log_pmf(
                tb[combo[i]],
                tb[combo[p]] if has_p else jnp.full(ploidy, -1, jnp.int32),
                tb[combo[q]] if has_q else jnp.full(ploidy, -1, jnp.int32),
                jnp.asarray(ploidy if has_p else 0),
                jnp.asarray(ploidy if has_q else 0),
                jnp.asarray(int(tau[i, 0])), jnp.asarray(int(tau[i, 1])),
                jnp.asarray(float(lam[i, 0])), jnp.asarray(float(lam[i, 1])),
                jnp.asarray(float(err[i, 0]) if has_p else 1.0),
                jnp.asarray(float(err[i, 1]) if has_q else 1.0),
                lf, t_j, v_j, lut,
            )
        return lp

    combos = np.asarray(
        list(itertools.product(range(G), repeat=n_samples)), np.int32
    )
    logs = np.asarray(jax.jit(jax.vmap(joint))(jnp.asarray(combos)))
    w = np.exp(logs - logs.max())
    w /= w.sum()
    marginals = np.zeros((n_samples, G))
    for i in range(n_samples):
        np.add.at(marginals[i], combos[:, i], w)
    return marginals


_BASES = np.array(list("ACGT"))
# shapes of MCHap's documented bi-parental example (SURVEY §6)
LOCUS_LENGTH = 119
BASE_QUALS = (20, 40)
POOL_SIZES = (4, 6)  # distinct haplotypes per locus the parents draw from


def _md_tag(read, ref):
    """SAM MD tag of an ungapped alignment of ``read`` to ``ref``."""
    parts = []
    run = 0
    for r, f in zip(read, ref):
        if r == f:
            run += 1
        else:
            parts.append(f"{run}{f}")
            run = 0
    parts.append(str(run))
    return "".join(parts)


def write_deployment(
    out_dir,
    seed=0,
    n_loci=64,
    n_progeny=20,
    ploidy=4,
    snvs=(8, 32),
    reads=(40, 100),
):
    """Write a seeded bi-parental population's input files.

    The shapes follow MCHap's documented bi-parental example: two
    parents and ``n_progeny`` F1 progeny, each child taking
    ``ploidy // 2`` haplotypes from each parent; loci of 119 bp carrying
    a uniform draw of ``snvs`` biallelic SNVs; a uniform draw of
    ``reads`` reads per sample and locus, each spanning the whole locus,
    with per-base qualities drawn from 20-40 and substitution errors at
    the rate they state.  Each locus draws a pool of 4-6 distinct
    haplotypes from which the parents take theirs.

    Files in ``out_dir``: ``reference.fa`` (+ ``.fai``), ``targets.bed``
    (BED4), ``snvs.vcf``, ``<sample>.sam`` per sample (``@RG`` with
    ``SM:``, MD tags), ``pedigree.txt`` and ``truth.json`` (each
    sample's true haplotype sequences and read count per locus).
    Returns a dict of the paths and sample names.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    contig = "chr1"
    spacing = LOCUS_LENGTH + 381
    flank = 1000
    contig_len = 2 * flank + n_loci * spacing
    reference = _BASES[rng.integers(0, 4, contig_len)]
    samples = ["parent1", "parent2"] + [
        f"progeny{i + 1:02d}" for i in range(n_progeny)
    ]

    loci = []
    for li in range(n_loci):
        start = flank + li * spacing
        n_snv = int(rng.integers(snvs[0], snvs[1] + 1))
        offsets = np.sort(rng.choice(LOCUS_LENGTH, n_snv, replace=False))
        ref_bases = reference[start + offsets]
        alt_bases = np.array(
            [rng.choice([b for b in "ACGT" if b != r]) for r in ref_bases]
        )
        n_pool = int(rng.integers(POOL_SIZES[0], POOL_SIZES[1] + 1))
        haps = set()
        while len(haps) < n_pool:
            haps.add(tuple(rng.integers(0, 2, n_snv)))
        haps = np.array(sorted(haps), np.int8)
        parents = [haps[rng.integers(0, n_pool, ploidy)] for _ in range(2)]
        genotypes = list(parents)
        for _ in range(n_progeny):
            child = [
                parents[p][rng.choice(ploidy, ploidy // 2, replace=False)]
                for p in range(2)
            ]
            genotypes.append(np.concatenate(child))
        loci.append((start, offsets, ref_bases, alt_bases, genotypes))

    fasta = os.path.join(out_dir, "reference.fa")
    width = 60
    text = "".join(reference)
    with open(fasta, "w") as f:
        f.write(f">{contig}\n")
        for i in range(0, contig_len, width):
            f.write(text[i : i + width] + "\n")
    with open(fasta + ".fai", "w") as f:
        f.write(f"{contig}\t{contig_len}\t{len(contig) + 2}\t{width}\t{width + 1}\n")

    bed = os.path.join(out_dir, "targets.bed")
    vcf = os.path.join(out_dir, "snvs.vcf")
    with open(bed, "w") as fb, open(vcf, "w") as fv:
        fv.write("##fileformat=VCFv4.2\n")
        fv.write(f"##contig=<ID={contig},length={contig_len}>\n")
        fv.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for li, (start, offsets, ref_bases, alt_bases, _) in enumerate(loci):
            fb.write(f"{contig}\t{start}\t{start + LOCUS_LENGTH}\tlocus{li:03d}\n")
            for off, r, a in zip(offsets, ref_bases, alt_bases):
                fv.write(f"{contig}\t{start + off + 1}\t.\t{r}\t{a}\t.\t.\t.\n")

    truth = {}
    sams = []
    cigar = f"{LOCUS_LENGTH}M"
    for si, sample in enumerate(samples):
        path = os.path.join(out_dir, f"{sample}.sam")
        sams.append(path)
        with open(path, "w") as f:
            f.write("@HD\tVN:1.6\tSO:coordinate\n")
            f.write(f"@SQ\tSN:{contig}\tLN:{contig_len}\n")
            f.write(f"@RG\tID:{sample}\tSM:{sample}\n")
            for li, (start, offsets, ref_bases, alt_bases, genotypes) in enumerate(loci):
                ref_seq = reference[start : start + LOCUS_LENGTH]
                hap_seqs = []
                for hap in genotypes[si]:
                    seq = ref_seq.copy()
                    seq[offsets] = np.where(hap == 1, alt_bases, ref_bases)
                    hap_seqs.append(seq)
                n_reads = int(rng.integers(reads[0], reads[1] + 1))
                name = f"locus{li:03d}"
                truth.setdefault(name, {})[sample] = {
                    "haplotypes": sorted("".join(h) for h in hap_seqs),
                    "reads": n_reads,
                }
                src = rng.integers(0, ploidy, n_reads)
                q = rng.integers(BASE_QUALS[0], BASE_QUALS[1] + 1, (n_reads, LOCUS_LENGTH))
                error = rng.random((n_reads, LOCUS_LENGTH)) < 10.0 ** (-q / 10)
                shift = rng.integers(1, 4, (n_reads, LOCUS_LENGTH))
                for ri in range(n_reads):
                    seq = hap_seqs[src[ri]].copy()
                    idx = np.searchsorted(_BASES, seq)
                    seq = np.where(error[ri], _BASES[(idx + shift[ri]) % 4], seq)
                    qual = "".join(chr(33 + int(v)) for v in q[ri])
                    read = "".join(seq)
                    f.write(
                        f"{sample}_{name}_{ri}\t0\t{contig}\t{start + 1}\t60\t"
                        f"{cigar}\t*\t0\t0\t{read}\t{qual}\tRG:Z:{sample}\t"
                        f"MD:Z:{_md_tag(read, ref_seq)}\n"
                    )

    pedigree = os.path.join(out_dir, "pedigree.txt")
    with open(pedigree, "w") as f:
        for sample in samples:
            if sample.startswith("parent"):
                f.write(f"{sample}\t.\t.\n")
            else:
                f.write(f"{sample}\tparent1\tparent2\n")
    truth_path = os.path.join(out_dir, "truth.json")
    with open(truth_path, "w") as f:
        json.dump(truth, f)
    return dict(
        reference=fasta, bed=bed, vcf=vcf, sams=sams, pedigree=pedigree,
        truth=truth_path, samples=samples, ploidy=ploidy, n_loci=n_loci,
    )


def genotype_concordance(vcf_lines, truth_path, min_reads=40):
    """Share of sample-loci whose called genotype equals the truth.

    ``vcf_lines``: the text lines of an ``assemble`` VCF written over a
    ``write_deployment`` directory.  A call matches when its multiset of
    haplotype sequences equals the sample's true multiset; calls with a
    null allele never match.  Only sample-loci with at least
    ``min_reads`` simulated reads count.  Returns (share, n_scored).
    """
    with open(truth_path) as f:
        truth = json.load(f)
    samples = None
    hits = n = 0
    for line in vcf_lines:
        if line.startswith("##"):
            continue
        fields = line.rstrip("\n").split("\t")
        if line.startswith("#CHROM"):
            samples = fields[9:]
            continue
        alleles = [fields[3]] + ([] if fields[4] == "." else fields[4].split(","))
        locus = truth[fields[2]]
        for sample, cell in zip(samples, fields[9:]):
            if locus[sample]["reads"] < min_reads:
                continue
            n += 1
            gt = cell.split(":")[0].replace("|", "/").split("/")
            if "." in gt:
                continue
            called = sorted(alleles[int(a)] for a in gt)
            hits += called == locus[sample]["haplotypes"]
    return (hits / n if n else float("nan")), n
