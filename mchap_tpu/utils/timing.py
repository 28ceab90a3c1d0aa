"""Per-stage pipeline timing and throughput reporting.

The reference ships no tracing or profiling hooks at all (SURVEY §5:
no timers, no logging framework — the VCF is the only observability
surface).  For a device-batched pipeline the first operational question
is the host/device split — is the run bound by read extraction and
encoding on the host, by the sampler on the chip, or by VCF formatting?
— so the applications time each stage and report locus/sample/sampler
throughput.

Activation (stderr only; output VCF is never touched):

- ``MCHAP_TIMING=1``     — per-stage summary on completion.
- ``MCHAP_PROGRESS=<N>`` — a progress line every N loci.

Stages used by the applications:

- ``read_loci``         — BED/VCF/FASTA locus construction.
- ``encode_reads``      — alignment-file extraction + probabilistic
                          encoding + dedup (host).
- ``device_sampler``    — batched MCMC / exact-caller device calls
                          (includes host<->device transfer and, on the
                          first batch of a shape bucket, compilation).
                          The fit paths return host arrays, so device
                          execution is charged here, not to the stage
                          that first touches the result.
- ``summarize_format``  — posterior summarisation + VCF record
                          formatting (host).

``count_sampler_steps`` records device compound MCMC steps (problems x
chains x steps) from the application fit sites; the summary derives an
aggregate steps/s from it.  ``block()`` wraps each cross-locus block and
records how many XLA programs were compiled inside it (JAX's backend
compile event), so a warm run shows zero compiles after the first
block of each shape.  Each stage also records the compile seconds spent
inside it, so a device rate can leave compilation out.

All timers are wall-clock (`time.perf_counter`).  The module is a
process-level singleton, mirroring how the applications stream a single
VCF; `reset()` re-reads the environment (used by tests).
"""

import os
import sys
import time
from contextlib import contextmanager


class PipelineTimers:
    """Accumulates per-stage wall time plus locus/sample/step counters."""

    def __init__(self):
        progress = os.environ.get("MCHAP_PROGRESS", "") or "0"
        try:
            self.progress_every = int(progress)
        except ValueError:
            self.progress_every = 0
        timing_flag = os.environ.get("MCHAP_TIMING", "") or "0"
        self.timing = timing_flag not in ("0", "", "false", "False")
        verbose_flag = os.environ.get("MCHAP_TIMING_VERBOSE", "") or "0"
        self.verbose = verbose_flag not in ("0", "", "false", "False")
        self.enabled = (
            self.timing or self.verbose or self.progress_every > 0
        )
        self.stages = {}
        self.stage_compile_seconds = {}
        self.loci = 0
        self.sample_calls = 0
        self.sampler_steps = 0
        self.compiles = 0
        self.compile_seconds = 0.0
        self.block_compiles = []
        self._t0 = None
        if self.enabled:
            _listen_for_compiles()

    # -- recording ----------------------------------------------------

    def _start_clock(self):
        if self._t0 is None:
            self._t0 = time.perf_counter()

    @contextmanager
    def stage(self, name):
        if not self.enabled:
            yield
            return
        self._start_clock()
        t = time.perf_counter()
        compiled = self.compile_seconds
        if self.verbose:
            # MCHAP_TIMING_VERBOSE=1: eager stage enter/exit lines, for
            # localising a stall (e.g. a pathological compile)
            # without waiting for the end-of-run summary
            sys.stderr.write(f"[mchap-tpu] >> {name}\n")
            sys.stderr.flush()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            self.stages[name] = self.stages.get(name, 0.0) + dt
            self.stage_compile_seconds[name] = (
                self.stage_compile_seconds.get(name, 0.0)
                + self.compile_seconds - compiled
            )
            if self.verbose:
                sys.stderr.write(f"[mchap-tpu] << {name} {dt:.2f}s\n")
                sys.stderr.flush()

    @contextmanager
    def block(self):
        """Count the compiles inside one cross-locus block."""
        before = self.compiles
        try:
            yield
        finally:
            if self.enabled:
                self.block_compiles.append(self.compiles - before)

    def count_sampler_steps(self, n):
        """Count device compound MCMC steps (problems x chains x steps)."""
        if self.enabled:
            self.sampler_steps += int(n)

    def tick_loci(self, n=1, sample_calls=0):
        """Count emitted loci; emits a progress line when due."""
        if not self.enabled:
            return
        self._start_clock()
        before = self.loci
        self.loci += n
        self.sample_calls += sample_calls
        every = self.progress_every
        if every and (before // every) != (self.loci // every):
            elapsed = time.perf_counter() - self._t0
            rate = self.loci / elapsed if elapsed > 0 else float("nan")
            sys.stderr.write(
                f"[mchap-tpu] {self.loci} loci in {elapsed:.1f}s"
                f" ({rate:.2f} loci/s)\n"
            )

    # -- reporting ----------------------------------------------------

    def summary_lines(self):
        elapsed = (
            time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        )
        rate = self.loci / elapsed if elapsed > 0 else float("nan")
        lines = [
            f"timing: {self.loci} loci, {self.sample_calls} sample-calls"
            f" in {elapsed:.2f}s ({rate:.2f} loci/s)"
        ]
        for name, seconds in sorted(
            self.stages.items(), key=lambda kv: -kv[1]
        ):
            frac = 100.0 * seconds / elapsed if elapsed > 0 else 0.0
            line = f"  {name:<18} {seconds:8.2f}s {frac:5.1f}%"
            compiling = self.stage_compile_seconds.get(name, 0.0)
            if compiling:
                line += f" (compiling {compiling:.2f}s)"
            lines.append(line)
        if self.sampler_steps:
            sps = self.sampler_steps / elapsed if elapsed > 0 else 0.0
            lines.append(
                f"  sampler: {self.sampler_steps:.3g} compound steps"
                f" ({sps:.3g} steps/s aggregate)"
            )
        if self.compiles:
            lines.append(
                f"  compiles: {self.compiles} programs,"
                f" {self.compile_seconds:.2f}s"
            )
        if self.block_compiles:
            lines.append(f"  compiles per locus block: {self.block_compiles}")
        return lines

    def emit_summary(self):
        """Write the per-stage summary to stderr (MCHAP_TIMING only)."""
        if not self.timing:
            return
        for line in self.summary_lines():
            sys.stderr.write(f"[mchap-tpu] {line}\n")


_LISTENING = False


def _on_event(event, seconds, **kwargs):
    if event == "/jax/core/compile/backend_compile_duration":
        TIMERS.compiles += 1
        TIMERS.compile_seconds += seconds


def _listen_for_compiles():
    global _LISTENING
    if not _LISTENING:
        import jax

        jax.monitoring.register_event_duration_secs_listener(_on_event)
        _LISTENING = True


TIMERS = PipelineTimers()


def reset():
    """Re-read the environment; returns the fresh singleton (tests)."""
    global TIMERS
    TIMERS = PipelineTimers()
    return TIMERS


def stage(name):
    return TIMERS.stage(name)


def block():
    return TIMERS.block()


def tick_loci(n=1, sample_calls=0):
    TIMERS.tick_loci(n, sample_calls=sample_calls)


def count_sampler_steps(n):
    TIMERS.count_sampler_steps(n)


def emit_summary():
    TIMERS.emit_summary()
