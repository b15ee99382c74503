#!/usr/bin/env python
"""Record every [succinct] benchmark class into SUCCINCT_SUITES.tsv
(reference runSuccinctBenchmarks.sh -> benchmarks.csv, same TSV schema).
Host lane (CPU) for comparability with the committed reference numbers;
scale via --scale (default 0.02, the round-4 record)."""
import argparse
import sys

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--nruns", type=int, default=2)
    ap.add_argument("--out", default="SUCCINCT_SUITES.tsv")
    ap.add_argument("--pattern", default=None,
                    help="only classes whose name contains this")
    args = ap.parse_args()
    from adacom.bench import succinct_benchmarks  # noqa: F401
    from adacom.bench.runner import REGISTRY, run_benchmark

    rows = [f"# all [succinct] benchmark classes at scale {args.scale} "
            f"({args.nruns} hot runs), host lane"]
    for name, cls in REGISTRY.items():
        if getattr(cls, "group", "") != "[succinct]":
            continue
        if args.pattern and args.pattern.lower() not in name.lower():
            continue
        print(f"== {name}", file=sys.stderr, flush=True)
        for rec in run_benchmark(cls, scale=args.scale, nruns=args.nruns):
            rows.append(f"{rec['name']}\t{rec['run']}\t"
                        f"{rec['timing']:.6f}\t{rec['sizeInBytes']}\t"
                        f"{rec['MemoryAllocationInBytes']}")
    with open(args.out, "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
