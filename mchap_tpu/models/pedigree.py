"""PedigreeCallingMCMC: joint pedigree-informed genotype calling.

API parity with reference ``mchap/pedigree/classes.py``; the sampler is
the batched device program of ops/pedigree_mcmc.py (chains vmapped,
samples sequential under the Markov-blanket coupling).
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from mchap_tpu.models.calling import GenotypeAllelesMultiTrace
from mchap_tpu.ops import calling_mcmc as _calling_kernel
from mchap_tpu.ops import pedigree_mcmc as _kernel
from mchap_tpu.ops.likelihood import prepare_reads, read_hap_loglik

# reference pedigree/classes.py:54-59
_STEP_TYPES = {"Gibbs": 0, "Metropolis-Hastings": 1}


def _sort_roll_trace(trace, sample_ploidy, max_ploidy):
    """Sort each genotype, rolling the -1 padding of lower-ploidy
    samples to the front (reference mcmc.py:807-813)."""
    trace = np.sort(trace, axis=-1)
    for j in range(len(sample_ploidy)):
        ploidy = int(sample_ploidy[j])
        if ploidy < max_ploidy:
            trace[..., j, :] = np.roll(
                trace[..., j, :], ploidy - max_ploidy, axis=-1
            )
    return trace


def _pedigree_dtype():
    """Working precision for the pedigree sampler.

    f64 (reference parity) on CPU and f32 on an accelerator, where it
    keeps the compiled program small and the arithmetic at the card's
    single-precision rate; whether f64 on the GPU costs enough to keep
    this split is not measured yet.  The f32 posterior is gated against
    f64 and exact enumeration (tests/test_pedigree_mcmc.py); override
    with ``MCHAP_PEDIGREE_DTYPE={f32,f64}``.
    """
    import os

    env = os.environ.get("MCHAP_PEDIGREE_DTYPE", "auto").lower()
    if env in ("f32", "float32"):
        return jnp.float32
    if env in ("f64", "float64"):
        return jnp.float64
    return jnp.float64 if jax.default_backend() == "cpu" else jnp.float32


@dataclass
class PedigreeCallingMCMC:
    """Joint MCMC over all samples in a pedigree.

    Attributes mirror reference pedigree/classes.py:14-28.
    """

    sample_ploidy: np.ndarray
    sample_parents: np.ndarray
    gamete_tau: np.ndarray
    gamete_lambda: np.ndarray
    gamete_error: np.ndarray
    haplotypes: np.ndarray
    frequencies: np.ndarray = None
    steps: int = 2000
    annealing: int = 1000  # accepted for API parity; the reference
    # computes but never applies the annealing weights (mcmc.py:738-740)
    chains: int = 2
    random_seed: int = None
    step_type: str = "Gibbs"
    swap_parental_alleles: bool = True

    def fit(self, sample_reads, sample_read_counts, initial=None):
        """Run ``chains`` batched joint chains; returns a pedigree trace.

        sample_reads: float[n_samples, max_reads, n_pos, max_nucl]
        (padded with nan reads); sample_read_counts: int[n_samples,
        max_reads] (0 marks padding — zero-count reads weigh nothing).
        """
        sample_ploidy = np.asarray(self.sample_ploidy)
        sample_parents = np.asarray(self.sample_parents)
        n_samples = len(sample_ploidy)
        max_ploidy = int(sample_ploidy.max())
        haplotypes = np.asarray(self.haplotypes)
        n_haps = len(haplotypes)

        if self.frequencies is None:
            log_freqs = np.log(np.full(n_haps, 1 / n_haps))
        else:
            with np.errstate(divide="ignore"):
                log_freqs = np.log(np.asarray(self.frequencies, float))
            assert len(log_freqs) == n_haps

        seed = self.random_seed if self.random_seed is not None else 0

        dtype = _pedigree_dtype()
        # one read-hap matrix for the whole pedigree (a single matmul)
        log_reads = prepare_reads(np.asarray(sample_reads, float))
        rh_all = read_hap_loglik(log_reads, jnp.asarray(haplotypes)).astype(
            dtype
        )  # [S, R, H]
        counts_all = jnp.asarray(sample_read_counts, dtype)

        key = jax.random.PRNGKey(seed)

        if initial is None:
            initial = np.full((n_samples, max_ploidy), -1, np.int32)
            for i in range(n_samples):
                ploidy = int(sample_ploidy[i])
                genotype = np.asarray(
                    _calling_kernel.greedy_caller(
                        rh_all[i], counts_all[i], ploidy=ploidy
                    )
                )
                initial[i, :ploidy] = genotype
        else:
            initial = np.asarray(initial, np.int32)

        sample_children = _kernel.sample_children_matrix(sample_parents)
        parental_pairs, pair_blankets = _kernel.parental_pair_markov_blankets(
            sample_parents, sample_children
        )

        sampler, _ = _kernel.make_pedigree_kernels(
            max_ploidy,
            n_samples,
            sample_children.shape[1],
            len(parental_pairs),
            sample_parents_np=sample_parents,
            sample_children_np=sample_children,
            dtype=dtype,
        )
        trace = sampler(
            key,
            jnp.broadcast_to(
                jnp.asarray(initial), (self.chains, n_samples, max_ploidy)
            ),
            rh_all,
            counts_all,
            jnp.asarray(sample_ploidy),
            jnp.asarray(sample_parents),
            jnp.asarray(sample_children),
            jnp.asarray(self.gamete_tau),
            jnp.asarray(self.gamete_lambda, dtype),
            jnp.asarray(self.gamete_error, dtype),
            jnp.asarray(log_freqs, dtype),
            jnp.asarray(parental_pairs),
            jnp.asarray(pair_blankets),
            n_steps=self.steps,
            swap_parental_alleles=self.swap_parental_alleles and len(parental_pairs) > 0,
            step_type=_STEP_TYPES[self.step_type],
        )
        trace = np.asarray(trace, np.int16)  # [chains, steps, S, maxp]
        trace = _sort_roll_trace(trace, sample_ploidy, max_ploidy)
        return PedigreeAllelesMultiTrace(trace, n_allele=n_haps)


def fit_pedigree_multi(
    problems,
    sample_ploidy,
    sample_parents,
    gamete_tau,
    gamete_lambda,
    gamete_error,
    steps=2000,
    chains=1,
    random_seed=None,
    step_type="Gibbs",
    swap_parental_alleles=True,
    burn=0,
):
    """Fit the pedigree sampler for MANY LOCI of the same pedigree at once.

    ``problems``: list of dicts with keys ``sample_reads``
    (f[S, R_i, P_i, N_i]), ``sample_read_counts`` (i[S, R_i]),
    ``haplotypes`` (i[H_i, P_i]) and optionally ``frequencies`` (f[H_i]).
    The pedigree structure (ploidy, parents, gamete tables) is shared —
    the tool calls one pedigree per locus over the same samples.  Panels
    are padded to the block's max size with -inf read-hap columns and
    zero prior frequency (masked out of both slot kernels via
    ``n_valid``), reads to a power-of-two bucket; the locus axis is then
    one vmapped device program, sharded over the mesh when more than one
    device is visible.  This is the same cross-locus streaming move as
    ``fit_calling_multi`` — the axis the reference parallelises with one
    forked process per locus (reference application/baseclass.py:360-394).

    Returns one PedigreeAllelesMultiTrace per problem.
    """
    from mchap_tpu.ops.likelihood import MIN_LOG

    n_problems = len(problems)
    sample_ploidy = np.asarray(sample_ploidy)
    n_samples = len(sample_ploidy)
    max_ploidy = int(sample_ploidy.max())
    h_max = max(len(p["haplotypes"]) for p in problems)

    # read-hap matrices: group same-shaped problems and run ONE
    # prepare+matmul dispatch per group instead of a device round trip
    # per problem
    shape_groups = {}
    for i, p in enumerate(problems):
        reads = np.asarray(p["sample_reads"], float)
        haps = np.asarray(p["haplotypes"])
        shape_groups.setdefault((reads.shape, haps.shape), []).append(i)
    rh_list = [None] * n_problems
    for (rshape, hshape), idxs in shape_groups.items():
        reads_g = np.stack(
            [np.asarray(problems[i]["sample_reads"], float) for i in idxs]
        )  # [G, S, R, P, N]
        haps_g = np.stack(
            [np.asarray(problems[i]["haplotypes"]) for i in idxs]
        )  # [G, H, P]
        log_reads = prepare_reads(reads_g)
        rh_g = np.asarray(
            jax.vmap(read_hap_loglik)(log_reads, jnp.asarray(haps_g))
        )  # [G, S, R, H]
        for gi, i in enumerate(idxs):
            rh_list[i] = rh_g[gi]
    counts_list = []
    freq_rows = []
    for i, p in enumerate(problems):
        rh = rh_list[i]
        h_i = rh.shape[-1]
        if h_i < h_max:
            rh = np.concatenate(
                [rh, np.full(rh.shape[:-1] + (h_max - h_i,), MIN_LOG)], axis=-1
            )
            rh_list[i] = rh
        counts_list.append(np.asarray(p["sample_read_counts"], float))
        freqs = p.get("frequencies")
        if freqs is None:
            freqs = np.full(h_i, 1.0 / h_i)
        freq_rows.append(np.pad(np.asarray(freqs, float), (0, h_max - h_i)))

    max_r = max(rh.shape[1] for rh in rh_list)
    bucket = 8
    while bucket < max_r:
        bucket *= 2
    rh_all = np.full((n_problems, n_samples, bucket, h_max), MIN_LOG)
    counts_all = np.zeros((n_problems, n_samples, bucket))
    for i, (rh, c) in enumerate(zip(rh_list, counts_list)):
        rh_all[i, :, : rh.shape[1]] = rh
        counts_all[i, :, : c.shape[1]] = c
    with np.errstate(divide="ignore"):
        log_freqs = np.log(np.stack(freq_rows))  # padding -> -inf
    n_valid = np.array([len(p["haplotypes"]) for p in problems], np.int32)

    # greedy per-sample initial states in ONE device program: greedy is
    # prefix-consistent (the first p slot choices never depend on the
    # total ploidy), so run every (problem, sample) at max_ploidy and
    # mask the padding slots of lower-ploidy samples
    greedy = jax.vmap(
        jax.vmap(
            lambda rh, c, nv: _calling_kernel.greedy_caller(
                rh, c, ploidy=max_ploidy, n_valid=nv
            ),
            in_axes=(0, 0, None),
        )
    )(
        jnp.asarray(rh_all), jnp.asarray(counts_all), jnp.asarray(n_valid)
    )  # [B, S, maxp]
    initial = np.where(
        np.arange(max_ploidy)[None, None, :] < sample_ploidy[None, :, None],
        np.asarray(greedy, np.int32),
        -1,
    )

    sample_children = _kernel.sample_children_matrix(sample_parents)
    parental_pairs, pair_blankets = _kernel.parental_pair_markov_blankets(
        sample_parents, sample_children
    )
    dtype = _pedigree_dtype()
    sampler, _ = _kernel.make_pedigree_kernels(
        max_ploidy,
        n_samples,
        sample_children.shape[1],
        len(parental_pairs),
        sample_parents_np=np.asarray(sample_parents),
        sample_children_np=sample_children,
        dtype=dtype,
    )

    seed = random_seed if random_seed is not None else 0
    keys = jax.random.split(jax.random.PRNGKey(seed), n_problems)
    ped_static = (
        jnp.asarray(sample_ploidy),
        jnp.asarray(np.asarray(sample_parents)),
        jnp.asarray(sample_children),
        jnp.asarray(np.asarray(gamete_tau)),
        jnp.asarray(np.asarray(gamete_lambda), dtype),
        jnp.asarray(np.asarray(gamete_error), dtype),
        jnp.asarray(parental_pairs),
        jnp.asarray(pair_blankets),
    )

    def one(key, init, rh, c, lf, nv):
        (ploidy_a, parents_a, children_a, tau_a, lambda_a, error_a,
         pairs_a, blankets_a) = ped_static
        return sampler(
            key,
            jnp.broadcast_to(init, (chains, n_samples, max_ploidy)),
            rh,
            c,
            ploidy_a,
            parents_a,
            children_a,
            tau_a,
            lambda_a,
            error_a,
            lf,
            pairs_a,
            blankets_a,
            nv,
            n_steps=steps,
            swap_parental_alleles=swap_parental_alleles
            and len(parental_pairs) > 0,
            step_type=_STEP_TYPES[step_type],
        )

    from mchap_tpu.parallel.sharding import problem_mesh, shard_problems

    np_dtype = np.dtype(jnp.dtype(dtype).name)
    mesh = problem_mesh(n_problems)
    _, keys_j, init_j, rh_j, c_j, lf_j, nv_j = shard_problems(
        mesh, n_problems, np.asarray(keys), initial,
        rh_all.astype(np_dtype), counts_all.astype(np_dtype),
        log_freqs.astype(np_dtype), n_valid,
    )
    trace = jax.vmap(one)(keys_j, init_j, rh_j, c_j, lf_j, nv_j)
    from mchap_tpu.parallel.sharding import gather_result

    # slice the burn-in on device: only kept steps reach the host
    trace = gather_result(trace[:, :, burn:].astype(jnp.int16))[:n_problems]
    trace = _sort_roll_trace(trace, sample_ploidy, max_ploidy)
    return [
        PedigreeAllelesMultiTrace(
            trace[i], n_allele=int(n_valid[i]), pre_burned=burn
        )
        for i in range(n_problems)
    ]


@dataclass
class PedigreeAllelesMultiTrace:
    """Joint trace over all pedigree samples; reference classes.py:137-161."""

    genotypes: np.ndarray  # [chains, steps, n_samples, max_ploidy]
    n_allele: int
    pre_burned: int = 0  # steps already dropped on device (batched path)

    def burn(self, n):
        """Drop the first ``n`` steps of the ORIGINAL trace (a no-op for
        steps the device already sliced, see ``pre_burned``)."""
        k = max(n - self.pre_burned, 0)
        return type(self)(
            self.genotypes[:, k:],
            n_allele=self.n_allele,
            pre_burned=max(n, self.pre_burned),
        )

    def individual(self, index):
        """Per-sample GenotypeAllelesMultiTrace (padding stripped)."""
        sample_trace = self.genotypes[:, :, index, :]
        ploidy = int((sample_trace[0, 0] >= 0).sum())
        return GenotypeAllelesMultiTrace(
            sample_trace[:, :, 0:ploidy],
            np.full(self.genotypes.shape[0:2], np.nan),
            self.n_allele,
        )

    def incongruence(self, sample_ploidy, sample_parents, gamete_tau, gamete_lambda):
        """Per-sample rate of pedigree-incompatible states (PEDERR).

        Vectorized equivalent of reference ``_trace_incongruence``
        (classes.py:91-134).
        """
        trace = self.genotypes
        n_chains, n_steps, n_samples, max_ploidy = trace.shape
        trace = trace.reshape(n_chains * n_steps, n_samples, max_ploidy)
        sample_parents = np.asarray(sample_parents)
        out = np.zeros(n_samples)
        for i in range(n_samples):
            p, q = sample_parents[i]
            progeny = trace[:, i, :]
            if p < 0 and q < 0:
                continue
            if p < 0:
                valid = _kernel.duo_valid(
                    progeny, trace[:, q, :], gamete_tau[i, 1], gamete_lambda[i, 1]
                )
            elif q < 0:
                valid = _kernel.duo_valid(
                    progeny, trace[:, p, :], gamete_tau[i, 0], gamete_lambda[i, 0]
                )
            else:
                valid = _kernel.trio_valid(
                    progeny,
                    trace[:, p, :],
                    trace[:, q, :],
                    gamete_tau[i, 0],
                    gamete_tau[i, 1],
                    gamete_lambda[i, 0],
                    gamete_lambda[i, 1],
                )
            out[i] = 1.0 - valid.mean()
        return out
