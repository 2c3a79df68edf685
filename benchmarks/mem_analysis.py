"""Compile-time peak-memory analysis of the flagship solve.

Lowers and compiles the jitted ilobpcg solve of the BdG well pencil for
the default device WITHOUT executing it (operators enter as shapes
only, so nothing of the problem's size is allocated), and prints XLA's
memory analysis (argument / output / temp / total bytes).  Used to
attribute device-memory changes to specific config knobs (e.g.
use_b_cache holding pre-applied B blocks across the iteration body).

Usage:
  python benchmarks/mem_analysis.py --n 4000000 --size-sub 64 \
      [--compare b_cache] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def analyze(n, ss, nev, cfg_kwargs):
    import jax.numpy as jnp

    from lobpcg_tpu import SolverConfig
    from lobpcg_tpu.utils.plan import compile_solve, peak_bytes
    from solve_bdg import well_problem_shapes

    A, B, T = well_problem_shapes(n, jnp.float32)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=40,
                       **cfg_kwargs)
    compiled = compile_solve(A, cfg, B, T, indefinite=True)
    ma = compiled.memory_analysis()
    gb = 1 / (1 << 30)
    out = {
        "config": cfg_kwargs,
        "arg_gb": ma.argument_size_in_bytes * gb,
        "out_gb": ma.output_size_in_bytes * gb,
        "temp_gb": ma.temp_size_in_bytes * gb,
        "alias_gb": ma.alias_size_in_bytes * gb,
        "peak_gb": peak_bytes(compiled) * gb,
    }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--size-sub", type=int, default=64)
    ap.add_argument("--nev", type=int, default=56)
    ap.add_argument("--cpu", action="store_true",
                    help="compile for the CPU backend instead of the "
                         "default device")
    ap.add_argument("--compare", default="b_cache",
                    choices=("b_cache", "ax_cache", "dual_basis", "none"),
                    help="knob to toggle; 'none' analyzes defaults only")
    ap.add_argument("--x64", action="store_true",
                    help="enable jax_enable_x64 (the escalated-RR peak "
                         "study: width > 512 auto-escalates rr_dtype)")
    ap.add_argument("--config-json", default=None,
                    help="JSON dict of SolverConfig kwargs to analyze "
                         "(overrides --compare), e.g. "
                         '\'{"use_b_cache": false, "dual_basis": false}\'')
    args = ap.parse_args()

    import jax

    if args.x64:
        jax.config.update("jax_enable_x64", True)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    configs = [{}]
    if args.config_json is not None:
        configs = [json.loads(args.config_json)]
    elif args.compare != "none":
        key = {"b_cache": "use_b_cache", "ax_cache": "use_ax_cache",
               "dual_basis": "dual_basis"}[args.compare]
        configs = [{key: True}, {key: False}]

    dev = jax.devices()[0]
    for kw in configs:
        r = analyze(args.n, args.size_sub, args.nev, kw)
        r.update({"n": args.n, "size_sub": args.size_sub,
                  "device": {"platform": dev.platform,
                             "kind": dev.device_kind}})
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
