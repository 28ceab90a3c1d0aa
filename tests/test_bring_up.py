"""The seeded deployment writer, the CLI on its files, and start-up rules.

These are the first CLI tests that need no external fixture: every
input is written by ``mchap_tpu.testing.write_deployment``.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import pytest

from mchap_tpu.application.cli import main
from mchap_tpu.testing import genotype_concordance, write_deployment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ["--mcmc-steps", "120", "--mcmc-burn", "60"]


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["mchap"] + argv) == 0
    return buf.getvalue().splitlines()


def _body(lines):
    return [ln for ln in lines if not ln.startswith("##")]


def _records(lines):
    return [ln.split("\t") for ln in _body(lines)[1:]]


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    out = tmp_path_factory.mktemp("deployment")
    dep = write_deployment(out / "in", seed=5, n_loci=2, n_progeny=2,
                           snvs=(3, 5), reads=(20, 30))
    common = ["--bam", *dep["sams"], "--ploidy", "4"]
    lines = _cli(["assemble", *common, "--targets", dep["bed"], "--variants",
                  dep["vcf"], "--reference", dep["reference"], *STEPS])
    haps = out / "haplotypes.vcf"
    haps.write_text("\n".join(lines) + "\n")
    return dict(dep, common=common, assemble=lines, haplotypes=str(haps))


# -- the writer -------------------------------------------------------------


def _tree(path):
    return {
        name: open(os.path.join(path, name), "rb").read()
        for name in sorted(os.listdir(path))
    }


def test_writer_same_seed_same_files(tmp_path):
    kw = dict(n_loci=2, n_progeny=1)
    write_deployment(tmp_path / "a", seed=3, **kw)
    write_deployment(tmp_path / "b", seed=3, **kw)
    write_deployment(tmp_path / "c", seed=4, **kw)
    a, b, c = (_tree(tmp_path / x) for x in "abc")
    assert a == b
    assert a.keys() == c.keys() and a != c


def test_writer_files_parse_through_readers(tmp_path):
    from mchap_tpu.io.bam import extract_read_variants, extract_sample_ids
    from mchap_tpu.io.bamlite import AlignmentFile
    from mchap_tpu.io.bed import read_bed4
    from mchap_tpu.io.fastalite import FastaFile

    dep = write_deployment(tmp_path, seed=1, n_loci=3, n_progeny=2,
                           snvs=(4, 6), reads=(10, 12))
    assert dep["samples"] == ["parent1", "parent2", "progeny01", "progeny02"]
    loci = [
        locus.set_sequence(dep["reference"]).set_variants(dep["vcf"])
        for locus in read_bed4(dep["bed"])
    ]
    assert [locus.name for locus in loci] == ["locus000", "locus001", "locus002"]
    for locus in loci:
        assert locus.stop - locus.start == 119
        assert 4 <= len(locus.variants) <= 6
        with FastaFile(dep["reference"]) as fasta:
            assert fasta.fetch(locus.contig, locus.start, locus.stop) == locus.sequence
    assert extract_sample_ids(dep["sams"]) == dict(zip(dep["samples"], dep["sams"]))
    for sample, path in zip(dep["samples"], dep["sams"]):
        calls = extract_read_variants(loci[0], AlignmentFile(path))
        chars, quals = calls[sample]
        assert 10 <= len(chars) <= 12
        assert chars.shape[1] == len(loci[0].variants)
        assert (quals >= 20).all()
    pedigree = open(dep["pedigree"]).read().splitlines()
    assert pedigree[:2] == ["parent1\t.\t.", "parent2\t.\t."]
    assert pedigree[2] == "progeny01\tparent1\tparent2"


def test_writer_progeny_inherit_half_of_each_parent(tmp_path):
    import json

    dep = write_deployment(tmp_path, seed=2, n_loci=4, n_progeny=5)
    truth = json.load(open(dep["truth"]))
    for locus in truth.values():
        p1 = locus["parent1"]["haplotypes"]
        p2 = locus["parent2"]["haplotypes"]
        for sample, entry in locus.items():
            assert len(entry["haplotypes"]) == 4
            assert 40 <= entry["reads"] <= 100
            if sample.startswith("progeny"):
                kid = list(entry["haplotypes"])
                for h in p1 + p2:
                    if h in kid:
                        kid.remove(h)
                assert not kid  # every haplotype came from a parent


def test_concordance_of_truth_is_one(tmp_path):
    import json

    dep = write_deployment(tmp_path, seed=6, n_loci=2, n_progeny=1)
    truth = json.load(open(dep["truth"]))
    lines = ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(dep["samples"])]
    for name, locus in truth.items():
        alleles = sorted({h for e in locus.values() for h in e["haplotypes"]})
        cells = [
            "/".join(str(alleles.index(h)) for h in locus[s]["haplotypes"])
            for s in dep["samples"]
        ]
        lines.append("\t".join(
            ["chr1", "1", name, alleles[0], ",".join(alleles[1:]), ".", ".",
             ".", "GT"] + cells))
    assert genotype_concordance(lines, dep["truth"]) == (1.0, 6)
    lines[1] = lines[1].replace("\t0/", "\t./", 1)
    assert genotype_concordance(lines, dep["truth"])[0] < 1.0


# -- the CLI on generated inputs --------------------------------------------


def test_cli_assemble_on_generated_inputs(deployment):
    rows = _records(deployment["assemble"])
    assert [r[2] for r in rows] == ["locus000", "locus001"]
    for row in rows:
        for cell in row[9:]:
            assert len(cell.split(":")[0].split("/")) == 4
    share, n = genotype_concordance(deployment["assemble"], deployment["truth"],
                                    min_reads=0)
    assert n == 8 and share >= 0.5


def test_cli_call_on_generated_inputs(deployment):
    lines = _cli(["call", *deployment["common"], "--haplotypes",
                  deployment["haplotypes"], *STEPS])
    rows = _records(lines)
    assert len(rows) == 2
    assert [r[4] for r in rows] == [r[4] for r in _records(deployment["assemble"])]


def test_cli_call_exact_on_generated_inputs(deployment):
    lines = _cli(["call-exact", *deployment["common"], "--haplotypes",
                  deployment["haplotypes"]])
    rows = _records(lines)
    assert len(rows) == 2
    for row in rows:
        assert all(len(c.split(":")[0].split("/")) == 4 for c in row[9:])


def test_cli_call_pedigree_on_generated_inputs(deployment):
    lines = _cli(["call-pedigree", *deployment["common"], "--haplotypes",
                  deployment["haplotypes"], "--sample-parents",
                  deployment["pedigree"], *STEPS])
    rows = _records(lines)
    assert len(rows) == 2
    assert _body(lines)[0].split("\t")[9:] == deployment["samples"]


def test_call_exact_block_matches_per_locus_bytes(deployment, monkeypatch):
    """The GPU's default cross-locus block path and the CPU's per-locus
    path write the same call-exact VCF body."""
    argv = ["call-exact", *deployment["common"], "--haplotypes",
            deployment["haplotypes"]]
    per_locus = _cli(argv + ["--locus-batch", "1"])
    block = _cli(argv + ["--locus-batch", "32"])
    assert _body(per_locus) == _body(block)


# -- start-up rules ----------------------------------------------------------


def _cache_dir(env):
    out = subprocess.run(
        [sys.executable, "-c",
         "import mchap_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_environment(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _cache_dir(env) == str(tmp_path)


def test_compile_cache_defaults_inside_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    assert _cache_dir(env) == os.path.join(REPO, ".build", "jax_cache")


def _no_result(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--loci", "1"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    _no_result(proc)


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    _no_result(proc)


def test_bench_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    _no_result(proc)


def test_timing_counts_compiles_per_block(monkeypatch):
    import jax
    import jax.numpy as jnp

    from mchap_tpu.utils import timing

    monkeypatch.setenv("MCHAP_TIMING", "1")
    timers = timing.reset()
    with timing.block():
        jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
    with timing.block():
        pass
    assert timers.block_compiles[0] >= 1 and timers.block_compiles[1] == 0
    assert "compiles per locus block" in "\n".join(timers.summary_lines())
    timing.reset()


def test_timing_charges_compiles_to_their_stage(monkeypatch):
    import jax
    import jax.numpy as jnp

    from mchap_tpu.utils import timing

    monkeypatch.setenv("MCHAP_TIMING", "1")
    timers = timing.reset()
    with timing.stage("device_sampler"):
        jax.jit(lambda x: x * 5 - 2)(jnp.arange(9)).block_until_ready()
    with timing.stage("summarize_format"):
        pass
    compiling = timers.stage_compile_seconds
    assert 0 < compiling["device_sampler"] <= timers.stages["device_sampler"]
    assert compiling["summarize_format"] == 0
    assert compiling["device_sampler"] == pytest.approx(timers.compile_seconds)
    lines = timers.summary_lines()
    assert any("device_sampler" in ln and "compiling" in ln for ln in lines)
    assert not any("summarize_format" in ln and "compiling" in ln for ln in lines)
    timing.reset()


def test_chip_smoke_sampler_rate_leaves_out_compilation():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    report = dict(
        wall=20.0, steps=1000,
        stages={"device_sampler": 10.0},
        stage_compile_seconds={"device_sampler": 6.0},
    )
    rate, share = chip_smoke.sampler_rate(report)
    assert rate == pytest.approx(1000 / 4.0)
    assert share == pytest.approx(0.5)


@pytest.mark.parametrize("ploidy", [2, 4, 6])
def test_writer_ploidy(tmp_path, ploidy):
    import json

    from mchap_tpu.io.bam import extract_read_variants
    from mchap_tpu.io.bamlite import AlignmentFile
    from mchap_tpu.io.bed import read_bed4

    dep = write_deployment(tmp_path, seed=ploidy, n_loci=2, n_progeny=2,
                           ploidy=ploidy, reads=(8, 8))
    truth = json.load(open(dep["truth"]))
    assert all(len(e["haplotypes"]) == ploidy
               for locus in truth.values() for e in locus.values())
    locus = next(iter(read_bed4(dep["bed"]))).set_variants(dep["vcf"])
    chars, _ = extract_read_variants(locus, AlignmentFile(dep["sams"][0]))["parent1"]
    assert chars.shape == (8, len(locus.variants))


def test_concordance_counts_only_deep_sample_loci(tmp_path):
    import json

    dep = write_deployment(tmp_path, seed=8, n_loci=1, n_progeny=2, reads=(5, 60))
    truth = json.load(open(dep["truth"]))
    deep = sum(e["reads"] >= 30 for e in truth["locus000"].values())
    lines = ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(dep["samples"]),
             "\t".join(["chr1", "1", "locus000", "A", ".", ".", ".", ".", "GT"]
                       + ["./././."] * len(dep["samples"]))]
    assert genotype_concordance(lines, dep["truth"], min_reads=30)[1] == deep
    assert genotype_concordance(lines, dep["truth"], min_reads=0)[1] == 4


@pytest.mark.parametrize(
    "backend,env,want",
    [("cpu", "", "float64"), ("gpu", "", "float32"), ("gpu", "f64", "float64"),
     ("cpu", "f32", "float32")],
)
def test_pedigree_working_dtype(monkeypatch, backend, env, want):
    import jax
    import numpy as np

    from mchap_tpu.models.pedigree import _pedigree_dtype

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setenv("MCHAP_PEDIGREE_DTYPE", env or "auto")
    assert np.dtype(_pedigree_dtype()).name == want


def _smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


_HEADER = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ta\tb"


@pytest.mark.parametrize(
    "lines,error",
    [
        (["##x", _HEADER, "c\t1\tl\tA\tC\t.\t.\t.\tGT\t0/0/1/1\t0/1/1/1"], None),
        (["##x", _HEADER], "records"),
        ([_HEADER.replace("\tb", "\tc"), "c\t1\tl\tA\tC\t.\t.\t.\tGT\t0/0/0/0\t0/0/0/0"],
         "samples"),
        ([_HEADER, "c\t1\tl\tA\tC\t.\t.\t.\tGT\t0/0/1\t0/0/0/0"], "genotype"),
    ],
    ids=["ok", "missing-record", "wrong-samples", "wrong-ploidy"],
)
def test_chip_smoke_checks_records(lines, error):
    smoke = _smoke()
    if error is None:
        smoke.check_records(lines, 1, ["a", "b"], 4, "tool")
    else:
        with pytest.raises(SystemExit, match=error):
            smoke.check_records(lines, 1, ["a", "b"], 4, "tool")
