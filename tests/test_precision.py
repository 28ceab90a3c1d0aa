"""Every f32 contraction on the likelihood and exact paths asks for
full precision.

A float32 dot may run in TF32 on the GPU (about three decimal digits),
which would break ``call-exact``'s byte-identical output and move the
samplers' decisions.  Each case traces a path at float32 and checks
that every ``dot_general`` in it carries ``Precision.HIGHEST``.
"""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from mchap_tpu.ops import assemble_mcmc, calling_mcmc, exact, pedigree_mcmc
from mchap_tpu.ops.likelihood import read_hap_loglik

F32 = jnp.float32
HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _dots(jaxpr):
    """All dot_general equations of a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else [value]:
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _dots(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _dots(sub)


def _read_hap():
    return read_hap_loglik(jnp.zeros((8, 3, 2), F32), jnp.zeros((4, 3), jnp.int32))


def _pedigree_sampler():
    parents = np.array([[-1, -1], [-1, -1], [0, 1]])
    children = pedigree_mcmc.sample_children_matrix(parents)
    pairs, blankets = pedigree_mcmc.parental_pair_markov_blankets(parents, children)
    sampler, _ = pedigree_mcmc.make_pedigree_kernels(
        2, 3, children.shape[1], len(pairs), sample_parents_np=parents,
        sample_children_np=children, dtype=F32,
    )
    args = (
        jax.random.PRNGKey(0), jnp.zeros((2, 3, 2), jnp.int32),
        jnp.zeros((3, 8, 4), F32), jnp.ones((3, 8), F32), jnp.full(3, 2),
        jnp.asarray(parents), jnp.asarray(children), jnp.ones((3, 2), jnp.int32),
        jnp.zeros((3, 2), F32), jnp.full((3, 2), 0.01, F32),
        jnp.full(4, np.log(0.25), F32), jnp.asarray(pairs), jnp.asarray(blankets),
    )
    return jax.make_jaxpr(lambda *a: sampler(*a, n_steps=2))(*args)


CASES = {
    "read_hap_loglik": lambda: jax.make_jaxpr(
        lambda lr, h: read_hap_loglik(lr, h)
    )(jnp.zeros((8, 3, 2), F32), jnp.zeros((4, 3), jnp.int32)),
    "genotype_likelihoods": lambda: jax.make_jaxpr(
        lambda r: exact.genotype_likelihoods(r, 4, np.zeros((4, 3), np.int8), dtype=F32)
    )(jnp.full((8, 3, 2), 0.5, F32)),
    "posterior_allele_frequencies": lambda: jax.make_jaxpr(
        lambda p: exact.posterior_allele_frequencies(p, 4, 4)
    )(jnp.ones(35, F32) / 35),
    "calling_sampler": lambda: jax.make_jaxpr(
        lambda rh: calling_mcmc.calling_sampler(
            jax.random.PRNGKey(0), jnp.zeros((2, 4), jnp.int32), rh,
            jnp.ones(8, F32), n_steps=2,
        )
    )(_read_hap()),
    "greedy_caller": lambda: jax.make_jaxpr(
        lambda rh: calling_mcmc.greedy_caller(rh, jnp.ones(8, F32), ploidy=4)
    )(_read_hap()),
    "snp_posteriors": lambda: jax.make_jaxpr(
        lambda r: assemble_mcmc.snp_posteriors(
            r, jnp.full(3, 2), 4, dtype=F32, read_counts=jnp.ones(8, F32)
        )[1]
    )(jnp.full((8, 3, 2), 0.5, F32)),
    "denovo_sampler": lambda: jax.make_jaxpr(
        lambda lr: assemble_mcmc.denovo_sampler(
            jax.random.PRNGKey(0), jnp.zeros((2, 4, 3), jnp.int32), lr,
            jnp.ones(8, F32), jnp.full(3, 2), jnp.full(3, 1 / 3),
            jnp.ones(1, F32), n_steps=2,
        )
    )(jnp.zeros((8, 3, 2), F32)),
    "pedigree_sampler": _pedigree_sampler,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_contractions_run_at_highest_precision(name):
    dots = list(_dots(CASES[name]().jaxpr))
    assert dots, f"{name}: no contraction traced"
    for eqn in dots:
        assert eqn.params["precision"] == HIGHEST, (name, eqn)


@pytest.mark.parametrize(
    "posteriors,want",
    [
        ([0.2, 0.4, 0.4], 1),  # exact tie
        ([0.2, 0.4, 0.4 * (1 + 1e-13)], 1),  # tie up to rounding noise
        ([0.1, 0.3, 0.6], 2),  # a real mode
        ([0.5, 0.5 * (1 - 1e-6), 0.0], 0),
    ],
    ids=["exact-tie", "noise-tie", "clear-mode", "near-but-real"],
)
def test_mode_index_resolves_ties_to_lowest_index(posteriors, want):
    """The exact caller's mode does not depend on the summation order
    that differs between per-locus and block runs, or CPU and GPU."""
    assert int(exact.mode_index(np.asarray(posteriors))) == want
