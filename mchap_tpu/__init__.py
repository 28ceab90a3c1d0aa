"""mchap_tpu — micro-haplotype assembly and genotype calling on an accelerator.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of MCHap
(PlantandFoodResearch/MCHap): micro-haplotype assembly and genotype calling
in autopolyploids.  The reference's per-locus numba MCMC samplers become
batched, jitted JAX programs in which many locus x sample x chain Markov
chains run data-parallel on device; the read-pileup log-likelihood is a
single matmul computed once per sample rather than a per-proposal
triple loop.

Public API mirrors the reference's ``mchap/__init__.py``:
``DenovoMCMC``, ``CallingMCMC``, ``Locus``/``LocusPrior``/``SNP``,
``read_bed4``, read extraction + encoding helpers, and the ``mchap``
CLI (``python -m mchap_tpu``).
"""

import os as _os

import jax

# Combinadic genotype indices and exact log-space reductions need 64-bit
# integers/floats; hot kernels request f32/bf16 explicitly so this only
# affects the small summary computations.
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  Where JAX_COMPILATION_CACHE_DIR is set
# JAX reads it itself and nothing is set here; otherwise the cache lives
# at one fixed path inside the checkout, so every process of the same
# checkout finds what an earlier one compiled.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".build",
    "jax_cache",
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"

from mchap_tpu import mset  # noqa: E402,F401
from mchap_tpu.encoding.integer import (  # noqa: E402,F401
    kmer_representation,
    minimum_error_correction,
)
from mchap_tpu.io.bam import (  # noqa: E402,F401
    encode_read_alleles,
    encode_read_distributions,
    extract_read_variants,
    extract_sample_ids,
)
from mchap_tpu.io.bed import read_bed4  # noqa: E402,F401
from mchap_tpu.io.loci import SNP, Locus, LocusPrior  # noqa: E402,F401
from mchap_tpu.models.assemble import DenovoMCMC  # noqa: E402,F401
from mchap_tpu.models.calling import CallingMCMC  # noqa: E402,F401
from mchap_tpu.models.pedigree import PedigreeCallingMCMC  # noqa: E402,F401
from mchap_tpu.numerics import combinadics as combinatorics  # noqa: E402,F401

__all__ = [
    "DenovoMCMC",
    "CallingMCMC",
    "PedigreeCallingMCMC",
    "Locus",
    "LocusPrior",
    "SNP",
    "combinatorics",
    "read_bed4",
    "extract_sample_ids",
    "extract_read_variants",
    "encode_read_alleles",
    "encode_read_distributions",
    "minimum_error_correction",
    "kmer_representation",
    "mset",
    "__version__",
]
