"""VCF genotype-index combinadics and counting functions.

Device-friendly re-design of the reference's genotype-index machinery
(``mchap/jitutils.py:113-318``) and counting helpers
(``mchap/combinatorics.py``).  The reference iterates genotypes one at a
time with ``increment_genotype``; here we instead enumerate the full
genotype table once host-side (``enumerate_genotypes``) and evaluate all
genotypes as one batch, while the index<->alleles conversions are exact
integer-arithmetic JAX functions usable inside jit (trace encoding).
"""

from functools import lru_cache
import itertools
import math

import jax.numpy as jnp
import numpy as np


def comb(n, k: int):
    """Exact binomial coefficient C(n, k) for traced ``n`` and static ``k``.

    Uses the ascending-factor identity (each partial product is itself a
    binomial times d!, so integer division is exact); int64 throughout.
    Reference: ``jitutils.py:195-225``.
    """
    n = jnp.asarray(n, jnp.int64)
    r = jnp.ones_like(n)
    m = n
    for d in range(1, k + 1):
        r = r * (m - k + d)
        r = r // d
    return jnp.where(n < k, 0, r)


def comb_with_replacement(n, k: int):
    """Multiset coefficient C(n + k - 1, k); reference jitutils.py:228-250."""
    n = jnp.asarray(n, jnp.int64)
    return jnp.where((n == 0) & (k == 0), 0, comb(n + k - 1, k))


def genotype_alleles_as_index(alleles):
    """VCF genotype-order index of a genotype of ascending allele numbers.

    index = sum_i C(a_i + i, i + 1) over allele slots i (VCF spec "genotype
    ordering"); reference ``jitutils.py:253-276``.  ``alleles`` may carry
    leading batch dimensions; the final axis is the ploidy.
    """
    alleles = jnp.asarray(alleles, jnp.int64)
    ploidy = alleles.shape[-1]
    index = jnp.zeros(alleles.shape[:-1], jnp.int64)
    for i in range(ploidy):
        index = index + comb_with_replacement(alleles[..., i], i + 1)
    return index


def index_as_genotype_alleles_np(index: int, ploidy: int) -> np.ndarray:
    """Host-side inverse of ``genotype_alleles_as_index``.

    Reference: ``jitutils.py:279-318``.  Used when decoding posterior-mode
    indices for reporting (small, host-side).
    """
    out = np.full(ploidy, -2, np.int64)
    if index < 0:
        out[:] = -1
        return out
    remainder = int(index)
    for slot in range(ploidy):
        p = ploidy - slot
        n = -1
        new = 0
        prev = 0
        while new <= remainder:
            n += 1
            prev = new
            new = math.comb(n + p - 1, p) if n > 0 else 0
        n -= 1
        remainder -= prev
        out[p - 1] = n
    return out


@lru_cache(maxsize=None)
def _genotype_table_cached(n_alleles: int, ploidy: int):
    tuples = np.array(
        list(itertools.combinations_with_replacement(range(n_alleles), ploidy)),
        dtype=np.int32,
    ).reshape(-1, ploidy)
    # itertools yields lexicographic order; VCF genotype order sorts by the
    # combinadic index, so compute indices vectorized and argsort.
    idx = np.zeros(len(tuples), dtype=np.int64)
    for i in range(ploidy):
        a = tuples[:, i].astype(np.int64)
        k = i + 1
        c = np.ones(len(tuples), dtype=np.int64)
        m = a + k - 1
        for d in range(1, k + 1):
            c = c * (m - k + d) // d
        idx += np.where(a + k - 1 < k, 0, c)
    order = np.argsort(idx, kind="stable")
    table = tuples[order]
    table.setflags(write=False)
    return table


def enumerate_genotypes(n_alleles: int, ploidy: int) -> np.ndarray:
    """All C(n_alleles + ploidy - 1, ploidy) genotypes in VCF order.

    Replaces the reference's one-at-a-time ``increment_genotype`` streaming
    enumeration (jitutils.py:113-146): here the whole table is a batch
    axis.  Rows are ascending allele tuples; row g has combinadic index g.
    """
    return _genotype_table_cached(n_alleles, ploidy)


def count_unique_haplotypes(u_alleles) -> int:
    """Product of per-position allele counts; reference combinatorics.py:16-32."""
    return int(np.prod(np.asarray(u_alleles, dtype=np.int64)))


def count_unique_genotypes(u_haps: int, ploidy: int) -> int:
    """Multiset coefficient; reference combinatorics.py:35-54."""
    return math.comb(u_haps + ploidy - 1, ploidy)


def count_unique_genotype_permutations(u_haps: int, ploidy: int) -> int:
    """Reference combinatorics.py:57-76."""
    return u_haps**ploidy


def count_haplotype_universial_occurance(u_haps: int, ploidy: int) -> int:
    """Reference combinatorics.py:79-98 (name kept verbatim for API parity)."""
    return math.factorial(u_haps + ploidy - 1) // (
        math.factorial(ploidy - 1) * math.factorial(u_haps)
    )


def count_genotype_permutations(dosage) -> int:
    """Multinomial coefficient of a dosage; reference combinatorics.py:101-127."""
    dosage = np.asarray(dosage)
    ploidy = int(dosage.sum())
    denominator = 1
    for d in dosage:
        denominator *= math.factorial(int(d))
    return math.factorial(ploidy) // denominator
