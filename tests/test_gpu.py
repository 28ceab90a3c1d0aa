"""Tests that need the card (marker ``gpu``; ``chip_smoke.py`` runs them).

Each decides inside the ``gpu_device`` fixture whether there is a GPU
and skips with the reason otherwise, so every worker collects the same
tests wherever they run.
"""

import contextlib
import io
import os
import subprocess
import sys

import pytest

from mchap_tpu.testing import write_deployment

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _truth_haplotypes_vcf(dep, path):
    """A haplotypes VCF whose alleles are each locus's true haplotypes."""
    import json

    truth = json.load(open(dep["truth"]))
    starts = [int(line.split()[1]) for line in open(dep["bed"])]
    lines = ["##fileformat=VCFv4.3",
             '##INFO=<ID=END,Number=1,Type=Integer,Description="End">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    reference = "".join(open(dep["reference"]).read().split("\n")[1:])
    for (name, locus), start in zip(truth.items(), starts):
        ref = reference[start : start + 119]
        alts = sorted({h for e in locus.values() for h in e["haplotypes"]} - {ref})
        lines.append(f"chr1\t{start + 1}\t{name}\t{ref}\t{','.join(alts)}"
                     f"\t.\tPASS\tEND={start + 119}")
    path.write_text("\n".join(lines) + "\n")


def test_call_exact_on_card_matches_cpu_bytes(gpu_device, tmp_path):
    """call-exact's VCF body on the card equals the CPU's byte for byte
    (every f32 contraction on the path is pinned to full precision)."""
    from mchap_tpu.application.cli import main

    dep = write_deployment(tmp_path / "in", seed=3, n_loci=3, n_progeny=3)
    haps = tmp_path / "haps.vcf"
    _truth_haplotypes_vcf(dep, haps)
    argv = ["call-exact", "--bam", *dep["sams"], "--ploidy", "4",
            "--haplotypes", str(haps), "--locus-batch", "32"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["mchap", *argv])
    cpu = subprocess.run(
        [sys.executable, "-m", "mchap_tpu", *argv], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, check=True,
    )

    def body(text):
        return [ln for ln in text.splitlines() if not ln.startswith("##")]

    lines = body(buf.getvalue())
    assert len(lines) == 4
    assert lines == body(cpu.stdout)
