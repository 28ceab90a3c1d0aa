"""``mchap assemble``: de novo micro-haplotype assembly.

Reference: mchap/application/assemble.py.
"""

import argparse
import sys
from dataclasses import dataclass

import numpy as np

from mchap_tpu import mset
from mchap_tpu.application import baseclass
from mchap_tpu.utils import timing
from mchap_tpu.application.arguments import (
    ASSEMBLE_MCMC_PARSER_ARGUMENTS,
    collect_assemble_mcmc_program_arguments,
)
from mchap_tpu.application.baseclass import (
    ALT,
    FILTER,
    LOCUS_ASSEMBLY_ERROR,
    REF,
    SAMPLE_ASSEMBLY_ERROR,
    LocusAssemblyError,
    SampleAssemblyError,
)
from mchap_tpu.encoding.integer import minimum_error_correction
from mchap_tpu.io import vcf as VCF
from mchap_tpu.io.bed import read_bed4
from mchap_tpu.io.fastalite import FastaFile
from mchap_tpu.io.loci import Locus
from mchap_tpu.io.util import qual_of_prob
from mchap_tpu.models.assemble import (
    DenovoMCMC,
    call_posterior_haplotypes,
    fit_denovo_batch,
    fit_denovo_multi,
)
from mchap_tpu.numerics.combinadics import (
    count_unique_genotypes,
    genotype_alleles_as_index,
)
from mchap_tpu.numerics.logprob import natural_log_to_log10
from mchap_tpu.ops import exact


@dataclass
class program(baseclass.program):
    bed: str = ""
    region: str = None
    region_id: str = None
    haplotype_posterior_threshold: float = 0.2
    mcmc_chains: int = 1
    mcmc_steps: int = 2000
    mcmc_burn: int = 1000
    mcmc_alpha: float = 1.0
    mcmc_beta: float = 3.0
    mcmc_fix_homozygous: float = 0.999
    mcmc_recombination_step_probability: float = 0.5
    mcmc_partial_dosage_step_probability: float = 0.5
    mcmc_dosage_step_probability: float = 1.0
    mcmc_incongruence_threshold: float = 0.60
    mcmc_llk_cache_threshold: int = 100
    sample_mcmc_temperatures: dict = None

    @classmethod
    def cli(cls, command):
        parser = argparse.ArgumentParser("MCMC haplotype assembly")
        for arg in ASSEMBLE_MCMC_PARSER_ARGUMENTS:
            arg.add_to(parser)
        if len(command) < 3:
            parser.print_help()
            sys.exit(1)
        args = parser.parse_args(command[2:])
        arguments = collect_assemble_mcmc_program_arguments(args)
        return cls(cli_command=command, **arguments)

    def loci(self):
        if (self.bed is None) and (self.region is None):
            raise ValueError("No region or targets bedfile is specified.")
        if self.bed is not None:
            for b in read_bed4(self.bed):
                yield b.set_sequence(self.ref).set_variants(self.vcf)
        else:
            locus = Locus.from_region_string(self.region, self.region_id)
            yield locus.set_sequence(self.ref).set_variants(self.vcf)

    def header_contigs(self):
        with FastaFile(self.ref) as fasta:
            return [
                VCF.ContigHeader(c, length)
                for c, length in zip(fasta.references, fasta.lengths)
            ]

    def _fit_single(self, data, sample, inbreeding, read_dists, read_counts):
        """Fallback path: fit one sample's assembler on its own."""
        return (
            DenovoMCMC(
                ploidy=data.sample_ploidy[sample],
                n_alleles=data.locus.count_alleles(),
                inbreeding=inbreeding,
                steps=self.mcmc_steps,
                chains=self.mcmc_chains,
                alpha=self.mcmc_alpha,
                beta=self.mcmc_beta,
                fix_homozygous=self.mcmc_fix_homozygous,
                recombination_step_probability=self.mcmc_recombination_step_probability,
                partial_dosage_step_probability=self.mcmc_partial_dosage_step_probability,
                dosage_step_probability=self.mcmc_dosage_step_probability,
                temperatures=self.sample_mcmc_temperatures[sample],
                random_seed=self.random_seed,
                llk_cache_threshold=self.mcmc_llk_cache_threshold,
            )
            .fit(reads=read_dists, read_counts=read_counts)
            .burn(self.mcmc_burn)
        )

    def call_sample_genotypes(self, data, traces=None):
        """Per-sample de novo assembly + population allele pooling.

        Reference: application/assemble.py:95-252.  ``traces`` may carry
        precomputed (unburnt) traces per sample from cross-locus device
        batching (``_call_locus_block``).
        """
        sample_modes = {}
        sample_posteriors = {}

        # batch all samples through one device program when their ploidy
        # and tempering ladders agree (the common case)
        ploidies = [data.sample_ploidy[s] for s in data.samples]
        ladders = [tuple(self.sample_mcmc_temperatures[s]) for s in data.samples]
        batch_traces = dict(traces) if traces else {}
        if not batch_traces and len(data.samples) > 1 and len(set(ploidies)) == 1 and len(set(ladders)) == 1:
            traces = fit_denovo_batch(
                ploidy=ploidies[0],
                n_alleles=data.locus.count_alleles(),
                reads_list=[data.read_dists[s] for s in data.samples],
                counts_list=[data.read_counts[s] for s in data.samples],
                inbreeding_list=(
                    None
                    if data.sample_inbreeding is None
                    else [data.sample_inbreeding[s] for s in data.samples]
                ),
                steps=self.mcmc_steps,
                chains=self.mcmc_chains,
                alpha=self.mcmc_alpha,
                beta=self.mcmc_beta,
                fix_homozygous=self.mcmc_fix_homozygous,
                recombination_step_probability=self.mcmc_recombination_step_probability,
                partial_dosage_step_probability=self.mcmc_partial_dosage_step_probability,
                dosage_step_probability=self.mcmc_dosage_step_probability,
                temperatures=ladders[0],
                random_seed=self.random_seed,
                burn=self.mcmc_burn,
            )
            timing.count_sampler_steps(
                len(data.samples) * self.mcmc_chains * self.mcmc_steps
            )
            batch_traces = dict(zip(data.samples, traces))

        for sample in data.samples:
            try:
                if data.sample_inbreeding is None:
                    inbreeding = None
                else:
                    inbreeding = data.sample_inbreeding[sample]
                read_calls = data.read_calls[sample]
                read_dists = data.read_dists[sample]
                read_counts = data.read_counts[sample]
                if sample in batch_traces:
                    trace = batch_traces[sample].burn(self.mcmc_burn)
                else:
                    trace = self._fit_single(
                        data, sample, inbreeding, read_dists, read_counts
                    )
                posterior = trace.posterior()
                sample_posteriors[sample] = posterior

                genotype_support = posterior.mode_genotype_support()
                genotype_support_prob = genotype_support.probabilities.sum()
                data.sampledata[VCF.FORMAT_SPM][sample] = genotype_support_prob
                data.sampledata[VCF.FORMAT_SQ][sample] = qual_of_prob(
                    genotype_support_prob
                )
                genotype, genotype_prob = genotype_support.mode_genotype()
                sample_modes[sample] = genotype
                data.sampledata[VCF.FORMAT_GQ][sample] = qual_of_prob(genotype_prob)
                data.sampledata[VCF.FORMAT_GPM][sample] = genotype_prob

                mec = np.sum(minimum_error_correction(read_calls, genotype))
                mec_denom = np.sum(read_calls >= 0)
                data.sampledata[VCF.FORMAT_MEC][sample] = mec
                data.sampledata[VCF.FORMAT_MECP][sample] = (
                    mec / mec_denom if mec_denom > 0 else np.nan
                )
                data.sampledata[VCF.FORMAT_MCI][sample] = trace.replicate_incongruence(
                    threshold=self.mcmc_incongruence_threshold
                )
            except Exception as e:
                message = SAMPLE_ASSEMBLY_ERROR.format(sample=sample)
                raise SampleAssemblyError(message) from e

        haplotypes, ref_called = call_posterior_haplotypes(
            list(sample_posteriors.values()),
            threshold=self.haplotype_posterior_threshold,
        )
        haplotype_labels = {h.tobytes(): i for i, h in enumerate(haplotypes)}
        data.infodata[VCF.INFO_REFMASKED] = not ref_called
        if not ref_called:
            haplotype_labels.pop(haplotypes[0].tobytes())
            if len(haplotypes) == 1:
                data.columndata[FILTER].append(VCF.NOA.id)

        if len(haplotypes) > 1:
            alts = data.locus.format_haplotypes(haplotypes[1:])
        else:
            alts = []
        data.columndata[REF] = data.locus.sequence
        data.columndata[ALT] = alts

        for sample in data.samples:
            try:
                alleles = _genotype_as_alleles(sample_modes[sample], haplotype_labels)
                data.sampledata[VCF.FORMAT_GT][sample] = alleles

                if self.require_AFP():
                    frequencies = np.zeros(len(haplotypes))
                    occurrences = np.zeros(len(haplotypes))
                    haps, freqs, occur = sample_posteriors[sample].allele_frequencies()
                    idx = mset.categorize(haplotypes, haps)
                    frequencies[idx >= 0] = freqs[idx[idx >= 0]]
                    occurrences[idx >= 0] = occur[idx[idx >= 0]]
                    data.sampledata[VCF.FORMAT_AFP][sample] = frequencies
                    data.sampledata[VCF.FORMAT_AOP][sample] = occurrences
                    data.sampledata[VCF.FORMAT_ACP][sample] = (
                        frequencies * data.sample_ploidy[sample]
                    )
                if VCF.FORMAT_GP in data.formatfields:
                    data.sampledata[VCF.FORMAT_GP][sample] = (
                        _genotype_posterior_as_array(
                            sample_posteriors[sample], haplotype_labels
                        )
                    )
                if VCF.FORMAT_GL in data.formatfields:
                    read_dists = data.read_dists[sample]
                    read_counts = data.read_counts[sample]
                    llks = np.asarray(
                        exact.genotype_likelihoods(
                            read_dists,
                            data.sample_ploidy[sample],
                            haplotypes,
                            read_counts,
                        )
                    )
                    data.sampledata[VCF.FORMAT_GL][sample] = np.asarray(
                        natural_log_to_log10(llks)
                    )
            except Exception as e:
                message = SAMPLE_ASSEMBLY_ERROR.format(sample=sample)
                raise SampleAssemblyError(message) from e
        return data

    def _call_locus_block(self, loci):
        """Assemble a block of loci with ONE device program per
        (ploidy, tempering-ladder) group.

        Cross-locus streaming: every (locus, sample) assembly problem in
        the block is padded into a single batched sampler launch
        (models/assemble.py ``fit_denovo_multi``).  The reference
        parallelises the same axis with one forked process per locus
        (baseclass.py:360-394).  Returns formatted VCF lines in input
        order.
        """
        prepared = []
        with timing.stage("encode_reads"):
            for locus in loci:
                try:
                    data = self._locus_data(locus, self.sample_bams)
                    self.encode_sample_reads(data)
                except Exception as e:
                    message = LOCUS_ASSEMBLY_ERROR.format(
                        name=locus.name,
                        contig=locus.contig,
                        start=locus.start,
                        stop=locus.stop,
                    )
                    raise LocusAssemblyError(message) from e
                prepared.append((locus, data))

        groups = {}
        for idx, (locus, data) in enumerate(prepared):
            n_alleles = locus.count_alleles()
            if len(n_alleles) == 0:
                continue  # zero-variant shortcut handled per locus
            for sample in data.samples:
                problem = dict(
                    reads=data.read_dists[sample],
                    counts=data.read_counts[sample],
                    n_alleles=n_alleles,
                )
                if data.sample_inbreeding is not None:
                    problem["inbreeding"] = data.sample_inbreeding[sample]
                key = (
                    data.sample_ploidy[sample],
                    tuple(self.sample_mcmc_temperatures[sample]),
                )
                groups.setdefault(key, []).append((idx, sample, problem))

        traces = {}
        with timing.stage("device_sampler"):
            for (ploidy, ladder), items in groups.items():
                fitted = fit_denovo_multi(
                    [p for _, _, p in items],
                    ploidy,
                    steps=self.mcmc_steps,
                    chains=self.mcmc_chains,
                    alpha=self.mcmc_alpha,
                    beta=self.mcmc_beta,
                    fix_homozygous=self.mcmc_fix_homozygous,
                    recombination_step_probability=self.mcmc_recombination_step_probability,
                    partial_dosage_step_probability=self.mcmc_partial_dosage_step_probability,
                    dosage_step_probability=self.mcmc_dosage_step_probability,
                    temperatures=ladder,
                    random_seed=self.random_seed,
                    burn=self.mcmc_burn,
                )
                timing.count_sampler_steps(
                    len(items) * self.mcmc_chains * self.mcmc_steps
                )
                for (idx, sample, _), t in zip(items, fitted):
                    traces[(idx, sample)] = t

        results = []
        with timing.stage("summarize_format"):
            for idx, (locus, data) in enumerate(prepared):
                try:
                    locus_traces = {
                        sample: traces[(idx, sample)]
                        for sample in data.samples
                        if (idx, sample) in traces
                    }
                    self.call_sample_genotypes(data, traces=locus_traces or None)
                    self.sumarise_vcf_record(data)
                    results.append(data.format_vcf_record())
                except Exception as e:
                    message = LOCUS_ASSEMBLY_ERROR.format(
                        name=locus.name,
                        contig=locus.contig,
                        start=locus.start,
                        stop=locus.stop,
                    )
                    raise LocusAssemblyError(message) from e
                timing.tick_loci(1, sample_calls=len(data.samples))
        return results


def _genotype_as_alleles(genotype, labels):
    """Haplotype-matrix genotype -> sorted allele indices (-1 unknown).

    Reference: application/assemble.py:255-273.
    """
    alleles = np.sort([labels.get(h.tobytes(), -1) for h in genotype])
    return np.append(alleles[alleles >= 0], alleles[alleles < 0])


def _genotype_posterior_as_array(posterior, labels):
    """Posterior over labeled genotypes as a dense G-length array.

    Reference: application/assemble.py:276-305.
    """
    n_alleles = len(labels)
    _, ploidy, _ = posterior.genotypes.shape
    u_gens = count_unique_genotypes(n_alleles, ploidy)
    probabilities = np.zeros(u_gens, float)
    for haps, prob in zip(posterior.genotypes, posterior.probabilities):
        alleles = np.sort([labels.get(h.tobytes(), -1) for h in haps])
        if alleles[0] < 0:
            continue
        idx = int(genotype_alleles_as_index(alleles))
        probabilities[idx] = prob
    return probabilities
