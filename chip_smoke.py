#!/usr/bin/env python3
"""Bring-up check: run mchap's main path on one GPU and check what it says.

    python chip_smoke.py                 # one card, the default run
    python chip_smoke.py --quick         # one card, a short probe (no
                                         # concordance floor, no ok line)
    python chip_smoke.py --four-cards    # only the sharded-vs-single check

The default run generates a seeded bi-parental tetraploid population
(``mchap_tpu.testing.write_deployment``: 2 parents + 20 F1 progeny,
64 loci of 119 bp, 8-32 SNVs per locus, 40-100 reads per sample and
locus) and drives it through the CLI's entry points with the default
MCMC settings:

1. a card-marked pytest child (``-m gpu``), before this process opens
   the card;
2. ``assemble`` on the generated SAMs, scored against the simulated
   genotypes;
3. ``call`` against phase 1's haplotypes, cold and then warm;
4. ``call-exact`` on the same haplotypes;
5. ``call-pedigree`` with the generated pedigree;
6. the sampler gates against exact enumeration;
7. ``call-exact`` again in a ``JAX_PLATFORMS=cpu`` child, after every
   timed phase so it takes no host cores from them; phase 4's VCF body
   must match it byte for byte.

Each CLI phase prints its wall time, the stage split (with the compile
seconds inside each stage), the peak device memory and the compiles
inside its second locus block.
The last line is one JSON object naming the device; the script exits
non-zero (and prints no such line) when there is no GPU, when the
package is not next to it, or when any phase fails.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# floor on assemble's genotype concordance with the simulated truth
# (sample-loci with >= 40 reads).  The target is 0.9, but the CPU run of
# the same generator and settings (seed 0, 16 loci x 22 samples, 2000
# steps) reaches only 0.798 over 352 sample-loci: most misses are
# diffuse-posterior calls with a null allele.  The floor sits about two
# standard errors of that estimate below it.
CONCORDANCE_TARGET = 0.9
CONCORDANCE_CPU = 0.798
CONCORDANCE_FLOOR = 0.75

SEED = 0
# run sizes: the default (MCHap's bi-parental example shapes and the
# CLI's MCMC defaults), a short probe, and the four-card comparison,
# whose only check is that 4 cards and 1 card write the same VCF.  That
# one is small (4 samples, 40 steps), so its wall times are mostly
# compilation and say nothing of how sharding scales.
DEFAULT = dict(loci=64, progeny=20, steps=2000, burn=1000, floor=CONCORDANCE_FLOOR)
QUICK = dict(loci=8, progeny=4, steps=500, burn=200, floor=0.0)
FOUR_CARDS = dict(loci=128, progeny=2, steps=40, burn=20)


def log(*parts):
    print(*parts, flush=True)


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()


def probe_device():
    """Platform, kind and count from a child, so this process stays off
    the card until the pytest child has run."""
    code = (
        "import json, jax; d = jax.devices(); "
        "print(json.dumps(dict(platform=d[0].platform, "
        "kind=d[0].device_kind, count=len(d))))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=HERE,
    )
    if out.returncode != 0:
        raise SystemExit(f"device probe failed: {out.stderr.strip()[-500:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def run_gpu_tests():
    """The card-marked tests (all in tests/test_gpu.py), in a child that
    has the card to itself."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_gpu.py", "-q", "-m",
         "gpu", "-p", "no:cacheprovider"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600,
    )
    tail = out.stdout.strip().splitlines()[-1:] or [out.stderr[-300:]]
    log(f"[tests] pytest -m gpu: rc={out.returncode} {tail[0]}"
        f" ({time.perf_counter() - t0:.1f}s)")
    if out.returncode != 0:
        log(out.stdout[-4000:])
        log(out.stderr[-2000:])
        raise SystemExit("card-marked tests failed")


def body(lines):
    return [ln for ln in lines if not ln.startswith("##")]


def run_tool(name, argv, label=None):
    """One CLI run in this process; returns (stdout lines, report)."""
    import jax

    from mchap_tpu.application.cli import main
    from mchap_tpu.utils import timing

    os.environ["MCHAP_TIMING"] = "1"
    timers = timing.reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = main(["mchap", name] + argv)
    wall = time.perf_counter() - t0
    if rc:
        raise SystemExit(f"{name} exited {rc}")
    lines = buf.getvalue().splitlines()
    stats = jax.devices()[0].memory_stats() or {}
    report = dict(
        wall=wall,
        stages=dict(timers.stages),
        stage_compile_seconds=dict(timers.stage_compile_seconds),
        steps=timers.sampler_steps,
        compiles=timers.compiles,
        compile_seconds=timers.compile_seconds,
        block_compiles=list(timers.block_compiles),
        peak=stats.get("peak_bytes_in_use"),
    )
    label = label or name
    log(f"[{label}] wall {wall:.2f}s, compile {timers.compile_seconds:.2f}s"
        f" ({timers.compiles} programs), compiles per locus block"
        f" {timers.block_compiles}, peak device memory {report['peak']} B")
    for line in timers.summary_lines():
        log(f"[{label}]   {line}")
    return lines, report


def check_records(lines, n_loci, samples, ploidy, tool):
    rows = [ln.split("\t") for ln in body(lines)[1:]]
    if len(rows) != n_loci:
        raise SystemExit(f"{tool}: {len(rows)} records for {n_loci} loci")
    header = body(lines)[0].split("\t")
    if header[9:] != samples:
        raise SystemExit(f"{tool}: samples {header[9:]} != {samples}")
    for row in rows:
        for cell in row[9:]:
            gt = cell.split(":")[0].replace("|", "/").split("/")
            if len(gt) != ploidy:
                raise SystemExit(f"{tool}: genotype {cell} at {row[2]}")


def log_differences(gpu, cpu, limit=8):
    """Name each differing VCF field (record, column, FORMAT key)."""
    header = gpu[0].split("\t")
    shown = 0
    for a, b in zip(gpu, cpu):
        fa, fb = a.split("\t"), b.split("\t")
        keys = fa[8].split(":") if len(fa) > 8 else []
        for col, (x, y) in enumerate(zip(fa, fb)):
            if x == y or shown >= limit:
                continue
            shown += 1
            if col > 8:
                parts = [(k, u, v) for k, u, v in zip(keys, x.split(":"), y.split(":"))
                         if u != v]
                log(f"  {fa[2]} {header[col]}: " + ", ".join(
                    f"{k} gpu={u} cpu={v}" for k, u, v in parts))
            else:
                log(f"  {fa[2]} {header[col]}: gpu={x[:120]} cpu={y[:120]}")
    if len(gpu) != len(cpu):
        log(f"  {len(gpu)} lines on the GPU, {len(cpu)} on the CPU")


def sampler_rate(report):
    """Compound steps/s of the device sampler, compilation inside the
    stage left out, and the stage's share of the phase wall."""
    seconds = report["stages"].get("device_sampler", 0.0)
    running = seconds - report["stage_compile_seconds"].get("device_sampler", 0.0)
    rate = report["steps"] / running if running > 0 else float("nan")
    return rate, seconds / report["wall"]


# ---------------------------------------------------------------------------
# phase 6: sampler gates against exact enumeration (settings and TV
# limits as stated at each gate; samplers run at their production
# precision: calling and de novo f64, pedigree f32 on the GPU; every f32
# contraction pinned to HIGHEST)
# ---------------------------------------------------------------------------


def _tv(a, b):
    import numpy as np

    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def _hist(genotypes, n_states):
    """Empirical distribution of sorted allele-index genotypes [N, P]."""
    import numpy as np

    from mchap_tpu.numerics.combinadics import genotype_alleles_as_index

    idx = np.asarray(genotype_alleles_as_index(np.sort(genotypes, axis=-1)))
    return np.bincount(idx, minlength=n_states) / len(idx)


def _xla_trace(rh, counts, initial, steps, chains, seed):
    """XLA calling sampler -> [steps, chains, P] genotypes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mchap_tpu.ops.calling_mcmc import calling_sampler

    init = jnp.broadcast_to(jnp.asarray(initial, jnp.int32), (chains, len(initial)))
    g, _ = calling_sampler(
        jax.random.PRNGKey(seed), init, rh, counts, n_steps=steps
    )
    return np.asarray(g).transpose(1, 0, 2)


def _calling_gate(haps, reads, initial, chains, steps, burn, limit, label):
    import jax.numpy as jnp
    import numpy as np

    from mchap_tpu.ops import exact
    from mchap_tpu.ops.likelihood import prepare_reads, read_hap_loglik

    n = len(haps)
    want = np.asarray(
        exact.genotype_posteriors(exact.genotype_likelihoods(reads, 4, haps), 4, n)
    )
    rh = read_hap_loglik(prepare_reads(reads), jnp.asarray(haps))
    g = _xla_trace(rh, jnp.ones(len(reads)), initial, steps, chains, 13)
    tv = _tv(_hist(g[burn:].reshape(-1, 4), len(want)), want)
    log(f"[gates] calling {label} vs exact: TV {tv:.4f} (limit {limit})")
    assert tv < limit, f"calling {label} TV {tv}"
    return tv


def gate_calling():
    """Calling XLA vs exact: P=4, 4 haplotypes, 8 reads, 1024 chains,
    3000 steps, burn 500; TV < 0.03."""
    import numpy as np

    from mchap_tpu.testing import simulate_reads

    haps = np.array([[0, 0, 0], [0, 1, 1], [1, 1, 0], [1, 1, 1]], np.int8)
    reads = simulate_reads(
        haps[[0, 1, 1, 3]], n_alleles=2, n_reads=8, errors=False,
        uniform_sample=True, qual=(20, 20), seed=7,
    )
    return _calling_gate(haps, reads, [0, 0, 0, 0], 1024, 3000, 500, 0.03,
                         "P=4 H=4 R=8")


def gate_calling_real_width():
    """Calling XLA vs exact at real widths, R=64, H=16, P=4 (3876
    genotypes), low base quality so the posterior spreads: 1024 chains,
    1000 steps, burn 200; TV < 0.04."""
    import jax.numpy as jnp
    import numpy as np

    from mchap_tpu.ops.calling_mcmc import greedy_caller
    from mchap_tpu.ops.likelihood import prepare_reads, read_hap_loglik
    from mchap_tpu.testing import simulate_reads

    rng = np.random.default_rng(5)
    haps = np.unique(rng.integers(0, 2, (40, 6)).astype(np.int8), axis=0)[:16]
    reads = simulate_reads(
        haps[[0, 3, 3, 9]], n_alleles=2, n_reads=64, qual=(3, 8), seed=5
    )
    rh = read_hap_loglik(prepare_reads(reads), jnp.asarray(haps))
    init = np.asarray(greedy_caller(rh, jnp.ones(64), ploidy=4))
    return _calling_gate(haps, reads, init, 1024, 1000, 200, 0.04,
                         "P=4 H=16 R=64")


def gate_denovo():
    """De novo XLA vs exact over the full 2-SNV haplotype space: plain,
    tempered (0.33, 0.66, 1.0) and Dirichlet-multinomial (F=0.3); P=4,
    8 reads, 64 chains, 1500 steps, burn 300; TV < 0.03 each."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mchap_tpu.ops import exact
    from mchap_tpu.ops.assemble_mcmc import denovo_sampler
    from mchap_tpu.ops.likelihood import prepare_reads
    from mchap_tpu.testing import simulate_reads

    truth = np.array([[0, 0], [0, 1], [1, 1], [0, 0]], np.int8)
    reads = simulate_reads(
        truth, n_alleles=2, n_reads=8, errors=False, uniform_sample=True,
        qual=(20, 20), seed=11,
    )
    panel = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.int8)
    llks = exact.genotype_likelihoods(reads, 4, panel)
    chains, steps, burn = 64, 1500, 300
    rng = np.random.default_rng(0)
    init = jnp.asarray(rng.integers(0, 2, (chains, 4, 2)), jnp.int32)
    bd = jnp.asarray([0.75, 0.25])
    out = {}
    cases = [
        ("plain", (1.0,), None),
        ("tempered", (0.33, 0.66, 1.0), None),
        ("dirmul", (1.0,), 0.3),
    ]
    for name, temps, inbreeding in cases:
        prior = None if inbreeding is None else (inbreeding, None)
        want = np.asarray(exact.genotype_posteriors(llks, 4, 4, prior=prior))
        g, _ = denovo_sampler(
            jax.random.PRNGKey(11), init, prepare_reads(reads),
            jnp.ones(len(reads)), jnp.full((2,), 2, jnp.int32), bd,
            jnp.asarray(temps), n_steps=steps,
            use_prior=inbreeding is not None,
            inbreeding=0.0 if inbreeding is None else inbreeding,
        )
        g = np.asarray(g)[:, burn:].reshape(-1, 4, 2)
        codes = g[:, :, 0] * 2 + g[:, :, 1]
        out[name] = _tv(_hist(codes, len(want)), want)
        log(f"[gates] de novo {name} vs exact: TV {out[name]:.4f} (limit 0.03)")
        assert out[name] < 0.03, f"de novo {name} TV {out[name]}"
    return out


PEDIGREES = {
    # name: (ploidy, parents, child tau or None)
    "trio": (2, [[-1, -1], [-1, -1], [0, 1]], (1, 1)),
    "tau31": (4, [[-1, -1], [-1, -1], [0, 1]], (3, 1)),
    "selfed": (2, [[-1, -1], [0, 0], [1, 1]], None),
    "backcross": (2, [[-1, -1], [-1, -1], [0, 1], [0, 2]], None),
}


def gate_pedigree(names=tuple(PEDIGREES), chains=32, steps=1000, burn=500):
    """Pedigree XLA vs ``exact_pedigree_marginals``: 3 haplotypes,
    4 reads per sample, parental-pair swaps on; per-sample TV < 0.05.

    The earlier form of this gate ran 2 chains x 3000 steps (burn 500).
    A pedigree step is latency-bound on the GPU (tens of ms) while
    chains are a vmapped axis, so this runs 32 chains x 1000 steps
    (burn 500): 16,000 kept samples instead of 5,000, for a third of the
    sequential steps.
    """
    import numpy as np

    from mchap_tpu.models.pedigree import PedigreeCallingMCMC
    from mchap_tpu.ops.exact import genotype_likelihoods
    from mchap_tpu.testing import exact_pedigree_marginals, simulate_reads

    haps = np.array([[0, 0], [0, 1], [1, 1]], np.int8)
    out = {}
    for name in names:
        ploidy, parents, tau_child = PEDIGREES[name]
        parents = np.asarray(parents)
        n = len(parents)
        tau = np.full((n, 2), max(ploidy // 2, 1))
        if tau_child is not None:
            tau[2] = tau_child
        lam = np.zeros((n, 2))
        err = np.full((n, 2), 0.01)
        rng = np.random.default_rng(3)
        truths = [haps[rng.integers(0, 3, ploidy)] for _ in range(n)]
        reads = [
            simulate_reads(t, n_alleles=2, n_reads=4, qual=(14, 18), seed=i)
            for i, t in enumerate(truths)
        ]
        sample_reads = np.full((n, 4, 2, 2), np.nan)
        for i, r in enumerate(reads):
            sample_reads[i, : len(r)] = r
        counts = np.ones((n, 4))
        llks = np.stack(
            [np.asarray(genotype_likelihoods(sample_reads[i], ploidy, haps, counts[i]))
             for i in range(n)]
        )
        want = exact_pedigree_marginals(llks, parents, tau, lam, err, 3, ploidy)
        trace = PedigreeCallingMCMC(
            sample_ploidy=np.full(n, ploidy), sample_parents=parents,
            gamete_tau=tau, gamete_lambda=lam, gamete_error=err,
            haplotypes=haps, steps=steps, chains=chains, random_seed=11,
        ).fit(sample_reads, counts).burn(burn)
        tvs = [
            _tv(trace.individual(i).posterior().as_array(3), want[i])
            for i in range(n)
        ]
        out[name] = max(tvs)
        log(f"[gates] pedigree {name} vs exact: per-sample TV "
            f"{[round(t, 4) for t in tvs]} (limit 0.05)")
        assert out[name] < 0.05, f"pedigree {name} TV {tvs}"
    return out


# ---------------------------------------------------------------------------
# main run
# ---------------------------------------------------------------------------


def cli_inputs(dep):
    return ["--bam", *dep["sams"], "--ploidy", str(dep["ploidy"])]


def mcmc_argv(size):
    return ["--mcmc-steps", str(size["steps"]), "--mcmc-burn", str(size["burn"])]


def default_run(size, work):
    import numpy as np

    from mchap_tpu.testing import genotype_concordance, write_deployment

    t0 = time.perf_counter()
    dep = write_deployment(
        os.path.join(work, "inputs"), seed=SEED, n_loci=size["loci"],
        n_progeny=size["progeny"],
    )
    log(f"[inputs] {len(dep['samples'])} samples x {size['loci']} loci written"
        f" in {time.perf_counter() - t0:.1f}s (seed {SEED})")
    mcmc = mcmc_argv(size)
    n = size["loci"]

    # phase 2: assemble
    lines, rep_asm = run_tool(
        "assemble",
        cli_inputs(dep) + ["--targets", dep["bed"], "--variants", dep["vcf"],
                           "--reference", dep["reference"]] + mcmc,
    )
    check_records(lines, n, dep["samples"], 4, "assemble")
    haps = os.path.join(work, "assemble.vcf")
    with open(haps, "w") as f:
        f.write("\n".join(lines) + "\n")
    share, scored = genotype_concordance(lines, dep["truth"], min_reads=40)
    floor = size["floor"]
    log(f"[assemble] genotype concordance {share:.4f} over {scored} sample-loci"
        f" (floor {floor}; target {CONCORDANCE_TARGET}, CPU rehearsal"
        f" {CONCORDANCE_CPU})")
    assert share >= floor, f"concordance {share} below {floor}"
    rate, frac = sampler_rate(rep_asm)
    log(f"[assemble] de novo XLA sampler: {rate:.4g} compound steps/s"
        f" (compilation left out), {100 * frac:.1f}% of phase wall")

    # phase 3: call, cold then warm
    call_argv = cli_inputs(dep) + ["--haplotypes", haps] + mcmc
    for rnd in ("cold", "warm"):
        lines, _ = run_tool("call", call_argv, f"call {rnd}")
        check_records(lines, n, dep["samples"], 4, "call")
    share, _ = genotype_concordance(lines, dep["truth"], min_reads=40)
    log(f"[call] genotype concordance {share:.4f}")

    # phase 4: call-exact; the same block size as the CPU child of
    # phase 7, so the comparison is of the devices' arithmetic on one
    # code path
    exact_argv = cli_inputs(dep) + ["--haplotypes", haps, "--locus-batch", "32"]
    exact_gpu, _ = run_tool("call-exact", exact_argv)
    check_records(exact_gpu, n, dep["samples"], 4, "call-exact")

    # phase 5: call-pedigree
    lines, rep_ped = run_tool(
        "call-pedigree",
        cli_inputs(dep) + ["--haplotypes", haps,
                           "--sample-parents", dep["pedigree"]] + mcmc,
    )
    check_records(lines, n, dep["samples"], 4, "call-pedigree")
    from mchap_tpu.models.pedigree import _pedigree_dtype

    rate, frac = sampler_rate(rep_ped)
    log(f"[call-pedigree] working dtype {np.dtype(_pedigree_dtype()).name};"
        f" pedigree XLA sampler: {rate:.4g} compound steps/s (compilation"
        f" left out), {100 * frac:.1f}% of phase wall")
    share, _ = genotype_concordance(lines, dep["truth"], min_reads=40)
    log(f"[call-pedigree] genotype concordance {share:.4f}")

    # phase 6: gates
    for gate in (gate_calling, gate_calling_real_width, gate_denovo,
                 gate_pedigree):
        t0 = time.perf_counter()
        gate()
        log(f"[gates] {gate.__name__}: {time.perf_counter() - t0:.1f}s")

    # phase 7: call-exact on the CPU, compared with phase 4 byte for byte
    t0 = time.perf_counter()
    cpu = subprocess.run(
        [sys.executable, "-m", "mchap_tpu", "call-exact"] + exact_argv,
        cwd=HERE, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=900,
    )
    if cpu.returncode != 0:
        raise SystemExit(f"call-exact CPU child failed: {cpu.stderr[-2000:]}")
    exact_cpu = cpu.stdout.splitlines()
    log(f"[call-exact cpu] wall {time.perf_counter() - t0:.2f}s")
    same = body(exact_gpu) == body(exact_cpu)
    log(f"[call-exact] VCF body vs CPU child: "
        f"{'identical' if same else 'DIFFERENT'} ({len(body(exact_gpu))} lines)")
    if not same:
        log_differences(body(exact_gpu), body(exact_cpu))
        raise SystemExit("call-exact differs from the CPU run")


def four_card_run(size, work, device):
    """assemble + call on 128 loci over 4 cards, and the same with
    MCHAP_SHARD=0 on one card; VCF bodies must be identical."""
    import jax
    import numpy as np

    from mchap_tpu.parallel.pools import pooled_info_collectives, shard_pool_problems
    from mchap_tpu.parallel.sharding import problem_mesh
    from mchap_tpu.testing import write_deployment

    if device["count"] != 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {device['count']}")
    dep = write_deployment(
        os.path.join(work, "inputs"), seed=SEED, n_loci=size["loci"],
        n_progeny=size["progeny"],
    )
    # the GPU's default block size, named so a CPU rehearsal on virtual
    # devices runs the same (sharded) block path
    mcmc = mcmc_argv(size) + ["--locus-batch", "32"]
    results = {}
    for shard in ("auto", "0"):
        os.environ["MCHAP_SHARD"] = shard
        label = "4 cards" if shard == "auto" else "1 card"
        asm, rep_a = run_tool(
            "assemble",
            cli_inputs(dep) + ["--targets", dep["bed"], "--variants", dep["vcf"],
                               "--reference", dep["reference"]] + mcmc,
            f"assemble {label}",
        )
        haps = os.path.join(work, f"assemble_{shard}.vcf")
        with open(haps, "w") as f:
            f.write("\n".join(asm) + "\n")
        call, rep_c = run_tool(
            "call", cli_inputs(dep) + ["--haplotypes", haps] + mcmc,
            f"call {label}",
        )
        results[shard] = (body(asm), body(call), rep_a, rep_c)
    os.environ.pop("MCHAP_SHARD", None)

    def wall(rep):
        return f"{rep['wall']:.2f}s (compiling {rep['compile_seconds']:.2f}s)"

    for i, tool in enumerate(("assemble", "call")):
        same = results["auto"][i] == results["0"][i]
        log(f"[four-cards] {tool}: 4 cards {wall(results['auto'][i + 2])},"
            f" 1 card {wall(results['0'][i + 2])}, VCF bodies"
            f" {'identical' if same else 'DIFFERENT'}")
        assert same, f"{tool} differs between 4 cards and 1"

    # population INFO pools as psum collectives vs the host formulas
    n_loci, k = size["loci"], 8
    n_problems = n_loci * (size["progeny"] + 2)
    mesh = problem_mesh(n_problems)
    rng = np.random.default_rng(SEED)
    ids = np.repeat(np.arange(n_loci), size["progeny"] + 2).astype(np.int32)
    aop = rng.uniform(0, 1, (n_problems, k))
    acp = rng.uniform(0, 4, (n_problems, k))
    snvdp = rng.integers(0, 100, (n_problems, k)).astype(float)
    step = pooled_info_collectives(mesh, n_loci)
    got = [np.asarray(x) for x in step(*shard_pool_problems(
        mesh, n_problems, n_loci, ids, acp, aop, snvdp))]
    want = [
        np.stack([acp[ids == i].sum(0) for i in range(n_loci)]),
        np.stack([aop[ids == i].sum(0) for i in range(n_loci)]),
        np.stack([1 - np.prod(1 - aop[ids == i], axis=0) for i in range(n_loci)]),
        np.stack([snvdp[ids == i].sum(0) for i in range(n_loci)]),
    ]
    for name, g, w in zip(("ACP", "AOPSUM", "AOP", "SNVDP"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9, err_msg=name)
    log(f"[four-cards] pooled INFO over {len(jax.devices())} cards matches"
        " the host formulas")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card sharded-vs-single check")
    parser.add_argument("--quick", action="store_true",
                        help="a short probe: 8 loci, 6 samples, 500 steps;"
                        " no concordance floor and no ok line")
    args = parser.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "mchap_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    for line in card_line():
        log(f"card: {line}")
    device = probe_device()
    if device["platform"] != "gpu":
        print(f"no GPU: JAX reports {device}", file=sys.stderr)
        return 1
    if not args.four_cards:
        run_gpu_tests()

    import jax

    devices = jax.devices()
    assert devices[0].platform == "gpu", devices
    log(f"device: {devices[0].device_kind} x {len(devices)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            four_card_run(FOUR_CARDS, work, device)
        else:
            default_run(QUICK if args.quick else DEFAULT, work)
    log(f"total wall {time.perf_counter() - t_start:.1f}s")
    if args.quick:
        log("quick probe: concordance not held to a floor, so no ok line")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
