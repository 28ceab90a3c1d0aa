"""Multi-host (multi-controller SPMD) initialisation and output gating.

The reference's only cluster mechanism is shell-level data parallelism:
split the BED, run one job per shard, ``cat``-merge the VCFs
(/root/reference/docs/assemble.rst:344-377).  That pattern still works
here unchanged (``--region`` / per-shard BED files).  This build
additionally supports TRUE multi-controller SPMD: every host runs the
SAME ``mchap`` command, ``jax.distributed.initialize`` connects the
processes, the device mesh spans every host's devices, and the
(locus, sample) problem batch shards globally — each process contributes
its addressable shards (``parallel.sharding.shard_problems``) and reads
back full results via a cross-host all-gather
(``parallel.sharding.gather_result``).

Activation is env-gated so single-host behavior is untouched:

- ``MCHAP_DISTRIBUTED=1`` (or ``auto``) — ``jax.distributed.initialize()``
  with no arguments, for clusters whose scheduler JAX can query for the
  coordinator, process count and process id.
- ``MCHAP_DISTRIBUTED=<host>:<port>,<num_processes>,<process_id>`` —
  explicit wiring for clusters without metadata discovery (each process
  passes its own ``process_id``).

Every process computes the same global result (single-program model),
so only process 0 emits the VCF; set ``MCHAP_EMIT_ALL_HOSTS=1`` to
emit everywhere (e.g. for debugging shard placement).

See ``scripts/launch_multihost.py`` for the launch runbook and a
same-machine smoke launcher.
"""

import os

_initialized = False


def maybe_initialize():
    """Env-gated ``jax.distributed.initialize``; returns True if called.

    Idempotent: repeated calls (cli + library use) initialize once.
    """
    global _initialized
    spec = os.environ.get("MCHAP_DISTRIBUTED", "").strip()
    if not spec or spec == "0":
        return False
    if _initialized:
        return True
    import jax

    if spec in ("1", "auto"):
        jax.distributed.initialize()
    else:
        try:
            address, num_processes, process_id = spec.split(",")
        except ValueError as e:
            raise ValueError(
                "MCHAP_DISTRIBUTED must be '1', 'auto', or "
                "'<host>:<port>,<num_processes>,<process_id>'"
                f" (got {spec!r})"
            ) from e
        jax.distributed.initialize(
            coordinator_address=address.strip(),
            num_processes=int(num_processes),
            process_id=int(process_id),
        )
    _initialized = True
    return True


def is_output_process():
    """True when this process should emit the VCF stream.

    Process 0 in a multi-controller launch (all processes hold the full
    gathered results, so emitting once avoids duplicate records);
    everywhere with ``MCHAP_EMIT_ALL_HOSTS=1`` or single-controller.
    """
    if os.environ.get("MCHAP_EMIT_ALL_HOSTS", "").strip() in ("1", "true"):
        return True
    import jax

    return jax.process_count() <= 1 or jax.process_index() == 0
