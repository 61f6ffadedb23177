"""The benchmark sweep's command line (port of
``raytrace_tpu/bench/cli.py``): renders a grid of scenes x samples and
writes its report.

    python -m raytrace_tpu_torch.bench.cli --width 400 --height 300 \
        --samples 4,16 --scenes ring --output report.json [--device cpu]

``--device`` is ``cuda`` by default (the mask and trace kernels; it
raises without a GPU); ``cpu`` runs their plain versions. ``--profile``
records a ``torch.profiler`` trace (``obs.Profiler``) into ./profiles;
``--metrics`` prints the host and device memory stats after the run.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_int_slice(s: str):
    """Comma-separated ints."""
    return tuple(int(x) for x in s.split(",") if x.strip())


def parse_string_slice(s: str):
    return tuple(x.strip() for x in s.split(",") if x.strip())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rt-benchmark",
        description="Grid-sweep render benchmark (actually renders)")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=300)
    p.add_argument("--samples", type=parse_int_slice, default=(4, 16))
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--scenes", type=parse_string_slice, default=("ring",),
                   help="'ring' or paths to scene JSON files")
    p.add_argument("--repetitions", type=int, default=3)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--output", default="benchmark_report.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--profile", action="store_true",
                   help="record a torch.profiler trace into ./profiles")
    p.add_argument("--metrics", action="store_true",
                   help="print host and device memory stats after the run")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .. import obs
    from .suite import BenchmarkConfig, BenchmarkSuite

    suite = BenchmarkSuite(BenchmarkConfig(
        width=args.width, height=args.height,
        samples_list=args.samples, max_depth=args.max_depth,
        scenes=args.scenes, repetitions=args.repetitions,
        warmup=args.warmup), device=args.device)
    profiler = obs.Profiler() if args.profile else None
    if profiler:
        profiler.start()
    try:
        suite.run()
    finally:
        if profiler:
            profiler.stop()
            print(f"profile saved to {profiler.trace_path}")
    suite.print_table()
    suite.save_report(args.output)
    print(f"report saved to {args.output}")
    if args.metrics:
        print(json.dumps(obs.Profiler().get_stats(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
