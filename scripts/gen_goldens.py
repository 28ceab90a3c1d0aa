"""Regenerate tests/golden_outputs/ from the shared config matrix.

Run on CPU so the goldens match what CI's forced-CPU test run produces:

    JAX_PLATFORMS=cpu python scripts/gen_goldens.py [only-this-golden.vcf ...]

Byte-compared by tests/test_regression_goldens.py.  Regenerate ONLY
when a deliberate sampler/VCF change is made, and re-check the
decision-level golden tests afterwards.
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")

from tests.golden import run_stdout_lines  # noqa: E402
from tests.golden_configs import CONFIGS, build_program  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden_outputs"


def main():
    only = set(sys.argv[1:])
    OUT.mkdir(exist_ok=True)
    for name, command in CONFIGS.items():
        if only and name not in only:
            continue
        t0 = time.time()
        lines = run_stdout_lines(build_program(command))
        (OUT / name).write_text("".join(lines))
        n_records = sum(1 for ln in lines if not ln.startswith("#"))
        print(f"{name}: {n_records} records in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
