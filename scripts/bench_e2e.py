"""End-to-end loci/s of ``mchap assemble`` and ``mchap call-pedigree``.

Inputs come from ``mchap_tpu.testing.write_deployment`` (a seeded
bi-parental tetraploid population: 2 parents + 20 progeny, 119 bp
loci, 8-32 SNVs per locus, 40-100 reads per sample and locus), written
once into ``.build/bench_e2e`` inside the checkout.  Each run covers the
whole CLI pipeline: SAM IO, read encoding, the batched sampler and VCF
formatting.

    python scripts/bench_e2e.py [--loci N]

Prints one JSON line: {"metric": "e2e_loci_per_s", ...}.
"""

import argparse
import contextlib
import io
import json
import os
import pathlib
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WORK = ROOT / ".build" / "bench_e2e"
HAPLOTYPES = str(WORK / "assemble.vcf")
N_LOCI = 64


_DEPLOYMENTS = {}


def deployment(n_loci=N_LOCI, seed=0):
    """Write (once per process) and return the generated inputs."""
    from mchap_tpu.testing import write_deployment

    key = (n_loci, seed)
    if key not in _DEPLOYMENTS:
        out = WORK / f"inputs_{n_loci}_{seed}"
        _DEPLOYMENTS[key] = write_deployment(out, seed=seed, n_loci=n_loci)
    return _DEPLOYMENTS[key]


def _run(program, command):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prog = program.cli(command)
    buffer = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buffer):
        prog.run_stdout()
    dt = time.perf_counter() - t0
    text = buffer.getvalue()
    n_records = sum(1 for ln in text.splitlines() if not ln.startswith("#"))
    return dt, n_records, text


def run_assemble(steps=1000, burn=500, out_vcf=None, n_loci=N_LOCI):
    """Full ``mchap assemble``; returns (wall_seconds, n_loci) and writes
    the VCF to ``out_vcf`` when given (the call-pedigree workload's
    haplotypes)."""
    from mchap_tpu.application.assemble import program

    dep = deployment(n_loci)
    command = ["mchap", "assemble", "--bam", *dep["sams"], "--ploidy", "4",
               "--targets", dep["bed"], "--variants", dep["vcf"],
               "--reference", dep["reference"], "--mcmc-steps", str(steps),
               "--mcmc-burn", str(burn), "--mcmc-seed", "11"]
    dt, n_records, text = _run(program, command)
    assert n_records == n_loci, f"expected {n_loci} records, got {n_records}"
    if out_vcf:
        os.makedirs(os.path.dirname(out_vcf), exist_ok=True)
        with open(out_vcf, "w") as f:
            f.write(text)
    return dt, n_records


def run_call_pedigree(haplotypes_vcf, steps=1000, burn=500, n_loci=N_LOCI):
    """Full ``mchap call-pedigree`` against a haplotypes VCF; returns
    (wall_seconds, n_loci)."""
    from mchap_tpu.application.call_pedigree import program

    dep = deployment(n_loci)
    command = ["mchap", "call-pedigree", "--bam", *dep["sams"], "--ploidy", "4",
               "--haplotypes", haplotypes_vcf, "--sample-parents",
               dep["pedigree"], "--mcmc-steps", str(steps), "--mcmc-burn",
               str(burn), "--mcmc-seed", "11"]
    dt, n_records, _ = _run(program, command)
    assert n_records == n_loci, f"expected {n_loci} records, got {n_records}"
    return dt, n_records


def main():
    import jax

    parser = argparse.ArgumentParser(description="end-to-end loci/s")
    parser.add_argument("--loci", type=int, default=N_LOCI)
    args = parser.parse_args()
    dt, n_loci = run_assemble(1000, 500, n_loci=args.loci)
    devices = jax.devices()
    print(json.dumps(dict(
        metric="e2e_loci_per_s", value=n_loci / dt,
        unit="loci/s (22 samples, 1000 steps, 2 chains)", seconds=dt,
        platform=devices[0].platform, device_kind=devices[0].device_kind,
        device_count=len(devices),
    )), flush=True)


if __name__ == "__main__":
    main()
