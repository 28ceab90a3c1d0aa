"""Shard the problem batch axis of the real fit paths over a device mesh.

The reference scales by forking one process per locus block
(mchap/application/baseclass.py:360-394); SURVEY.md §2.8 maps that to
data parallelism over the padded (locus, sample) problem axis.  Here the
mapping is implemented the idiomatic XLA way: the batched sampler
programs in ``models/calling.py`` and ``models/assemble.py`` are plain
``vmap`` programs over a leading problem axis, so multi-chip execution
is purely a *placement* decision — pad the batch to a multiple of the
device count, place every input with ``NamedSharding(mesh, P("loci"))``,
and ``jit`` partitions the compiled program across the mesh with no
communication (each problem's chains are independent; the only
collectives are the population INFO pools, see ``parallel.pools``).

Sharding activates automatically whenever more than one device is
visible (several GPUs on one host, or the 8-virtual-device CPU mesh
used in tests);
``MCHAP_SHARD=0`` disables it for A/B comparisons — outputs are
element-wise identical either way because every per-problem program and
its PRNG keys are unchanged by placement.
"""

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def problem_mesh(min_problems=2):
    """1-D "loci" mesh over all visible devices, or None.

    Returns None when sharding is disabled (``MCHAP_SHARD=0``), only one
    device exists, or the batch is too small to matter.
    """
    if os.environ.get("MCHAP_SHARD", "auto").strip() == "0":
        return None
    devices = jax.devices()
    if len(devices) <= 1 or min_problems < 2:
        return None
    return Mesh(np.array(devices), ("loci",))


def shard_problems(mesh, n_problems, *arrays):
    """Pad each array's leading axis to a mesh multiple and place it.

    Padding repeats the final problem row (a real, convergent program —
    never degenerate shapes); padded rows are computed and discarded.
    Returns (padded_n, placed_arrays...).  With ``mesh=None`` the arrays
    pass through untouched.

    Multi-host (multi-controller SPMD, e.g. ``jax.distributed``): when
    the mesh spans more than one process, each process holds the full
    host copy (every controller reads the same inputs — the standard
    same-program-same-data launch) and contributes only its addressable
    shards via ``make_array_from_callback``, so the global array is
    assembled without any host ever sending data it does not own.
    """
    if mesh is None:
        return (n_problems,) + tuple(arrays)
    n_dev = mesh.devices.size
    padded_n = -(-n_problems // n_dev) * n_dev
    multi_host = jax.process_count() > 1
    placed = []
    for a in arrays:
        if padded_n != n_problems:
            a = np.concatenate(
                [np.asarray(a)]
                + [np.asarray(a[-1:])] * (padded_n - n_problems)
            )
        sharding = NamedSharding(mesh, P("loci", *([None] * (np.ndim(a) - 1))))
        if multi_host:
            a_host = np.asarray(a)
            placed.append(
                jax.make_array_from_callback(
                    a_host.shape, sharding, lambda idx, _a=a_host: _a[idx]
                )
            )
        else:
            placed.append(jax.device_put(a, sharding))
    return (padded_n,) + tuple(placed)


def gather_result(x):
    """Device output -> full host ndarray on every process.

    Single-controller: a plain ``np.asarray``.  Multi-controller: the
    output of a sharded jit is only partially addressable per process,
    so all-gather it across hosts first (one collective; the per-locus
    results are small relative to the sampling work).
    """
    if jax.process_count() <= 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
