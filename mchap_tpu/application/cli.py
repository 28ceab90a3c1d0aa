"""CLI dispatch: ``mchap {assemble,call,call-exact,call-pedigree,find-snvs,atomize}``.

Reference: mchap/application/cli.py.
"""

import sys


def main(command=None):
    if command is None:
        command = sys.argv
    # multi-host SPMD: env-gated jax.distributed.initialize before any
    # backend touch (parallel/distributed.py; no-op unless
    # MCHAP_DISTRIBUTED is set)
    from mchap_tpu.parallel.distributed import maybe_initialize

    maybe_initialize()
    tools = ["assemble", "call", "call-exact", "call-pedigree", "find-snvs", "atomize"]
    usage = "usage: mchap [-h] {" + ",".join(tools) + "} ..."
    if len(command) < 2 or command[1] in {"-h", "--help"}:
        print(usage)
        print("\nMicro-haplotype assembly and genotype calling (JAX build)")
        return 0
    tool = command[1]
    if tool == "assemble":
        from mchap_tpu.application.assemble import program

        prog = program.cli(command)
        prog.run_stdout()
    elif tool == "call":
        from mchap_tpu.application.call import program

        prog = program.cli(command)
        prog.run_stdout()
    elif tool == "call-exact":
        from mchap_tpu.application.call_exact import program

        prog = program.cli(command)
        prog.run_stdout()
    elif tool == "call-pedigree":
        from mchap_tpu.application.call_pedigree import program

        prog = program.cli(command)
        prog.run_stdout()
    elif tool == "find-snvs":
        from mchap_tpu.application.find_snvs import main as find_snvs_main

        find_snvs_main(command)
    elif tool == "atomize":
        from mchap_tpu.application.atomize import main as atomize_main

        atomize_main(command)
    else:
        print(usage, file=sys.stderr)
        print(f"error: unknown tool '{tool}'", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
