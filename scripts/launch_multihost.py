#!/usr/bin/env python
"""Multi-host SPMD launch runbook + same-machine smoke launcher.

This build scales across hosts with TRUE multi-controller SPMD
(replacing the reference's shell-level BED-splitting pattern,
docs/assemble.rst:344-377 in MCHap, which also still works): every host
runs the SAME command, ``jax.distributed.initialize`` connects the
processes, every process reads the same inputs and computes the same
global result; the (locus, sample) problem batch shards over ALL hosts'
devices (mchap_tpu/parallel/sharding.py), results are all-gathered, and
ONLY process 0 writes the VCF.

RUNBOOK — explicit coordinator wiring
-------------------------------------
Pass explicit coordinator wiring per process::

    # on host A (process 0, also the coordinator)
    MCHAP_DISTRIBUTED=hostA:8476,2,0 mchap assemble ... > out.vcf
    # on host B (process 1)
    MCHAP_DISTRIBUTED=hostA:8476,2,1 mchap assemble ... > /dev/null

Smoke mode (this script)
------------------------
``python scripts/launch_multihost.py --smoke`` forks N local CPU
processes wired through ``jax.distributed`` on localhost and verifies
they (a) form one global device mesh, (b) produce identical sharded
fit results, (c) emit from process 0 only.  The same procedure runs in
CI as ``tests/test_distributed.py``.
"""

import argparse
import os
import subprocess
import sys
import tempfile

_WORKER = r"""
import os, sys
import numpy as np
pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
os.environ["MCHAP_DISTRIBUTED"] = f"localhost:{port},2,{pid}"
import jax
jax.config.update("jax_platforms", "cpu")
from mchap_tpu.parallel.distributed import maybe_initialize, is_output_process
assert maybe_initialize()
from mchap_tpu.models.calling import fit_calling_multi
from mchap_tpu.testing import simulate_reads
haps = np.array([[0, 0, 0], [0, 1, 1], [1, 1, 1]], np.int8)
problems = []
for i in range(5):
    reads = simulate_reads(haps[np.array([0, 1, 1, 2])], n_alleles=2,
                           n_reads=8, errors=False, seed=i)
    problems.append(dict(reads=reads, counts=np.ones(len(reads)),
                         haplotypes=haps))
traces = fit_calling_multi(problems, ploidy=4, steps=20, chains=2,
                           random_seed=3)
np.savez(out, **{f"g{i}": t.genotypes for i, t in enumerate(traces)},
         meta=np.array([jax.process_index(), jax.process_count(),
                        len(jax.devices()), int(is_output_process())]))
"""


def launch_smoke(port=29518, devices_per_process=2):
    env_base = dict(os.environ)
    env_base["JAX_PLATFORMS"] = "cpu"
    env_base["XLA_FLAGS"] = (
        env_base.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices_per_process}"
    ).strip()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env_base["PYTHONPATH"] = repo + os.pathsep + env_base.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"p{i}.npz") for i in range(2)]
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(i), str(port), outs[i]],
                env=env_base,
            )
            for i in range(2)
        ]
        for p in procs:
            assert p.wait(timeout=300) == 0, "worker failed"
        import numpy as np

        d0, d1 = np.load(outs[0]), np.load(outs[1])
        assert d0["meta"][1] == 2 and d0["meta"][2] == 2 * devices_per_process
        assert d0["meta"][3] == 1 and d1["meta"][3] == 0  # p0 emits only
        for k in d0.files:
            if k != "meta":  # meta holds per-process identity
                np.testing.assert_array_equal(d0[k], d1[k])
        return {f: d0[f] for f in d0.files if f != "meta"}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--smoke", action="store_true",
                        help="run the 2-process localhost smoke launch")
    args = parser.parse_args()
    if args.smoke:
        launch_smoke()
        print("multi-host smoke OK: 2 processes, one global mesh, "
              "identical gathered results, process-0-only emission")
    else:
        print(__doc__)
