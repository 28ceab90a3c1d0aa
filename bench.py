"""Sampler throughput on one GPU against the reference's inner loops.

Workloads (shapes match ``mchap_tpu/native/bench_oracle.cpp``: ploidy 4,
16 biallelic SNVs, 64 reads, a 16-haplotype panel), each run through
the model-level fit path a tool calls:

* ``denovo``: ``fit_denovo_multi`` (the de novo assembler);
* ``calling``: ``fit_calling_multi``;
* ``pedigree``: ``fit_pedigree_multi`` over a 22-sample bi-parental
  pedigree (2 parents + 20 progeny), batched over loci;
* ``e2e`` / ``pedigree_e2e``: ``mchap assemble`` and ``mchap
  call-pedigree`` over a generated 22-sample population
  (``scripts/bench_e2e.py``), in loci/s.

Each workload warms up once and then times one fit, which returns host
arrays, so the time covers the device work.  Rates are compound steps/s
(problems x samples x chains x steps / s, as ``chip_smoke.py`` and the
``MCHAP_TIMING`` summary count them; a pedigree problem is one locus of
22 samples, the others one sample).

Baseline: the reference's own inner loops (mchap/assemble/mcmc.py,
mchap/calling/mcmc.py, mchap/pedigree/mcmc.py) re-implemented in
single-thread C++ -O3 with the reference's likelihood caches, scaled to
64 cores.

The parent process never imports JAX: a probe child reports the device
and the run stops with exit code 1 unless it is a GPU; each workload
then runs in its own child under a timeout, one at a time.  Every
result names the platform, device kind and device count.  Prints one
JSON line.

    python bench.py [--only NAME ...] [--budget SECONDS]
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PLOIDY = 4
N_READS = 64
N_POS = 16
N_HAPS = 16
CALLING = dict(problems=1024, chains=64, steps=500)
DENOVO = dict(problems=1024, chains=16, steps=200)
PEDIGREE = dict(loci=128, steps=500)


def device_info():
    import jax

    devices = jax.devices()
    return dict(
        platform=devices[0].platform,
        device_kind=devices[0].device_kind,
        device_count=len(devices),
    )


def _timed(fit):
    fit()  # compile and warm up
    t0 = time.perf_counter()
    fit()
    return time.perf_counter() - t0


def measure_calling():
    import numpy as np

    from mchap_tpu.models.calling import fit_calling_multi
    from mchap_tpu.testing import simulate_reads

    rng = np.random.default_rng(0)
    haps = np.unique(rng.integers(0, 2, (64, N_POS)).astype(np.int8), axis=0)
    haps = haps[:N_HAPS]
    problems = [
        dict(
            reads=simulate_reads(
                haps[rng.integers(0, N_HAPS, PLOIDY)], n_alleles=2,
                n_reads=N_READS, seed=i,
            ),
            counts=np.ones(N_READS),
            haplotypes=haps,
        )
        for i in range(CALLING["problems"])
    ]

    def fit():
        fit_calling_multi(
            problems, PLOIDY, steps=CALLING["steps"],
            chains=CALLING["chains"], random_seed=1,
        )

    n = CALLING["problems"] * CALLING["chains"] * CALLING["steps"]
    return n / _timed(fit)


def measure_denovo():
    import numpy as np

    from mchap_tpu.models.assemble import fit_denovo_multi
    from mchap_tpu.testing import simulate_reads

    rng = np.random.default_rng(0)
    problems = [
        dict(
            reads=simulate_reads(
                rng.integers(0, 2, (PLOIDY, N_POS)), n_alleles=2,
                n_reads=N_READS, seed=i,
            ),
            counts=np.ones(N_READS),
            n_alleles=[2] * N_POS,
        )
        for i in range(DENOVO["problems"])
    ]

    def fit():
        fit_denovo_multi(
            problems, PLOIDY, steps=DENOVO["steps"], chains=DENOVO["chains"],
            random_seed=1, fix_homozygous=1.1,
        )

    n = DENOVO["problems"] * DENOVO["chains"] * DENOVO["steps"]
    return n / _timed(fit)


def measure_pedigree():
    import numpy as np

    from mchap_tpu.models.pedigree import fit_pedigree_multi
    from mchap_tpu.testing import simulate_reads

    rng = np.random.default_rng(0)
    n_samples = 22
    parents = np.full((n_samples, 2), -1, int)
    parents[2:] = [0, 1]
    haps = np.unique(rng.integers(0, 2, (64, N_POS)).astype(np.int8), axis=0)
    haps = haps[:N_HAPS]
    problems = []
    for _ in range(PEDIGREE["loci"]):
        truth = haps[rng.integers(0, N_HAPS, (n_samples, PLOIDY))]
        reads = np.stack(
            [simulate_reads(t, n_alleles=2, n_reads=N_READS,
                            seed=int(rng.integers(1 << 30))) for t in truth]
        )
        problems.append(dict(
            sample_reads=reads,
            sample_read_counts=np.ones((n_samples, N_READS), int),
            haplotypes=haps,
        ))

    def fit():
        fit_pedigree_multi(
            problems, sample_ploidy=np.full(n_samples, PLOIDY),
            sample_parents=parents,
            gamete_tau=np.full((n_samples, 2), PLOIDY // 2),
            gamete_lambda=np.zeros((n_samples, 2)),
            gamete_error=np.full((n_samples, 2), 0.01),
            steps=PEDIGREE["steps"], chains=1, random_seed=1,
        )

    return PEDIGREE["loci"] * n_samples * PEDIGREE["steps"] / _timed(fit)


def measure_e2e():
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import bench_e2e

    dt, n_loci = bench_e2e.run_assemble(1000, 500, out_vcf=bench_e2e.HAPLOTYPES)
    return n_loci / dt


def measure_pedigree_e2e():
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import bench_e2e

    if not os.path.exists(bench_e2e.HAPLOTYPES):
        bench_e2e.run_assemble(500, 250, out_vcf=bench_e2e.HAPLOTYPES)
    dt, n_loci = bench_e2e.run_call_pedigree(bench_e2e.HAPLOTYPES, 1000, 500)
    return n_loci / dt


WORKLOADS = {
    "denovo": (measure_denovo, 900),
    "calling": (measure_calling, 900),
    "pedigree": (measure_pedigree, 900),
    "e2e": (measure_e2e, 900),
    "pedigree_e2e": (measure_pedigree_e2e, 900),
}


def run_child(name):
    """Child-process entry: run one workload, print one JSON line."""
    info = device_info()
    if name == "probe":
        print(json.dumps(info))
        return
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: {info}")
    t0 = time.perf_counter()
    rate = WORKLOADS[name][0]()
    print(json.dumps(dict(info, rate=rate, seconds=time.perf_counter() - t0)))


def spawn(name, timeout):
    """One workload in a child process; returns (result dict, error)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--workload", name]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return None, f"timeout after {timeout}s"
    if proc.returncode != 0:
        tail = (proc.stderr or "").strip().splitlines()[-3:]
        return None, f"rc={proc.returncode}: {' | '.join(tail)}"
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1]), None
    except (ValueError, IndexError) as e:
        return None, f"unparseable output ({e!r}): {proc.stdout[-200:]!r}"


def oracle_rates():
    """Build and run the single-core C++ oracle; returns its JSON dict."""
    src = os.path.join(HERE, "mchap_tpu", "native", "bench_oracle.cpp")
    binary = os.path.join(HERE, ".build", "bench_oracle")
    try:
        if not os.path.exists(binary) or os.path.getmtime(binary) < os.path.getmtime(src):
            os.makedirs(os.path.dirname(binary), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-o", binary, src],
                check=True, capture_output=True, timeout=300,
            )
        out = subprocess.run([binary, "2000"], capture_output=True, text=True,
                             timeout=600)
        return json.loads(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        print(f"[bench] oracle failed: {e!r}", file=sys.stderr)
        return None


def main():
    parser = argparse.ArgumentParser(description="sampler throughput on one GPU")
    parser.add_argument("--only", nargs="+", choices=sorted(WORKLOADS))
    parser.add_argument("--budget", type=float, default=1800.0)
    args = parser.parse_args()

    info, err = spawn("probe", 300)
    if info is None or info["platform"] != "gpu":
        print(f"[bench] no GPU ({err or info}); nothing measured", file=sys.stderr)
        sys.exit(1)
    deadline = time.monotonic() + args.budget
    results, errors = {}, {}
    for name in args.only or list(WORKLOADS):
        timeout = min(WORKLOADS[name][1], deadline - time.monotonic())
        if timeout < 60:
            errors[name] = "skipped (budget exhausted)"
            continue
        print(f"[bench] {name}: starting (timeout {timeout:.0f}s)", file=sys.stderr)
        res, err = spawn(name, timeout)
        if res is None:
            errors[name] = err
            print(f"[bench] {name}: FAILED ({err})", file=sys.stderr)
        else:
            results[name] = res["rate"]
            print(f"[bench] {name}: {res['rate']:.6g}/s", file=sys.stderr)

    cores = 64
    extra = dict(info)
    extra["baseline_source"] = (
        "single-core C++ -O3 port of the reference inner loops "
        "(includes the reference's llk caches) x 64 cores"
    )
    oracle = oracle_rates()
    for name, rate in results.items():
        unit = "loci_per_s" if name.endswith("e2e") else "compound_steps_per_s"
        extra[f"{name}_{unit}"] = rate
        key = f"{name}_steps_per_s_1core"
        if oracle and key in oracle:
            # the oracle counts pedigree sweeps; a sweep steps S samples
            per_step = oracle["S"] if name == "pedigree" else 1
            extra[f"{name}_vs_baseline"] = rate / (oracle[key] * per_step * cores)
    if oracle:
        extra["oracle"] = oracle
    for name, err in errors.items():
        extra[f"{name}_error"] = err
    value = results.get("denovo", 0.0)
    print(json.dumps(dict(
        metric="denovo_compound_steps_per_s", value=value, unit="steps/s",
        vs_baseline=extra.get("denovo_vs_baseline"), extra=extra,
    )))


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--workload":
        run_child(sys.argv[2])
    else:
        main()
