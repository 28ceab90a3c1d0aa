"""Population INFO-field reductions as mesh collectives.

The reference pools per-sample posterior summaries into population INFO
fields in the parent process (mchap/application/baseclass.py:245-301):
elementwise sums for ACP/AFP/AOPSUM/SNVDP and a product of complements
for AOP (1 - prod(1 - p) over samples).  When the (locus, sample)
problem batch is sharded over a device mesh (parallel.sharding), the
samples of one locus can live on different chips, so those reductions
become collectives: a local per-locus segment-sum followed by a ``psum``
over the mesh axis.  AOP's product becomes a sum too by pooling
``log1p(-p)`` and mapping back through ``1 - exp``.

The streaming CLI keeps its host-side pooling (per-sample summaries are
tiny and already host-resident after posterior tabulation); this module
is the device-resident form used by the sharded end-to-end path
(``__graft_entry__.dryrun_multichip``) and validated against the host
formulas in ``tests/test_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def shard_pool_problems(mesh, n_problems, n_loci, locus_ids, *arrays):
    """Pad pooling inputs to a mesh multiple and place them.

    Unlike ``sharding.shard_problems`` (which pads by repeating the last
    problem — correct for independent per-problem programs, wrong for
    reductions), padded rows get locus id ``n_loci`` (out of range, so
    ``segment_sum`` drops them) and zero values (the identity of every
    pooled reduction, including AOP's log-complement sum).
    """
    if mesh is None:
        return (locus_ids,) + tuple(arrays)
    n_dev = mesh.devices.size
    padded_n = -(-n_problems // n_dev) * n_dev
    pad = padded_n - n_problems
    ids = np.concatenate(
        [np.asarray(locus_ids, np.int32), np.full(pad, n_loci, np.int32)]
    )
    spec = lambda a: NamedSharding(  # noqa: E731
        mesh, P("loci", *([None] * (np.ndim(a) - 1)))
    )
    placed = [jax.device_put(ids, spec(ids))]
    for a in arrays:
        a = np.asarray(a)
        if pad:
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        placed.append(jax.device_put(a, spec(a)))
    return tuple(placed)


def pooled_info_collectives(mesh, n_loci):
    """Build the jitted sharded pooling step.

    Returns fn(locus_ids [B], acp [B, K], aop [B, K], snvdp [B, K]) ->
    (ACP [n_loci, K], AOPSUM [n_loci, K], AOP [n_loci, K],
    SNVDP [n_loci, K]) where B (problems = locus x sample) shards over
    the mesh and each output row pools one locus across ALL devices.
    """
    axis = mesh.axis_names[0]

    def per_shard(locus_ids, acp, aop, snvdp):
        acp_local = jax.ops.segment_sum(acp, locus_ids, num_segments=n_loci)
        aopsum_local = jax.ops.segment_sum(aop, locus_ids, num_segments=n_loci)
        # product of complements -> sum of log-complements
        log_not = jnp.log1p(-jnp.clip(aop, 0.0, 1.0 - 1e-12))
        aop_log_local = jax.ops.segment_sum(
            log_not, locus_ids, num_segments=n_loci
        )
        snvdp_local = jax.ops.segment_sum(snvdp, locus_ids, num_segments=n_loci)
        acp_total = jax.lax.psum(acp_local, axis)
        aopsum_total = jax.lax.psum(aopsum_local, axis)
        aop_total = 1.0 - jnp.exp(jax.lax.psum(aop_log_local, axis))
        snvdp_total = jax.lax.psum(snvdp_local, axis)
        return acp_total, aopsum_total, aop_total, snvdp_total

    fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(), P()),
    )
    return jax.jit(fn)
