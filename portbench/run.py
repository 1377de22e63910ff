"""Run one cell of the port's benchmark and print its result as the last
line of standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1> [--dump PATH]

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names its configuration (``portbench/configs/<config>.json``) and traffic
mix (``portbench/traffic/<mix>.json``); its lanes, context and check are in
``portbench/cells/<workload>.json``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a run traced
in the middle of its window. ``--dump`` writes the window's requests and
the result to a file. Exits 2, printing no result, without enough CUDA
devices, without the program beside the benchmark, or where the process
holds JAX or the JAX package once the window has closed."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout; the
# port's own nvcc builds go to agentainer_tpu_torch/_build/
CACHE = os.path.join(CHECKOUT, "portbench", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
# the checkout, not this directory, on the path: ``portbench`` imports as a
# package and its modules shadow no standard ones (``trace``)
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = CHECKOUT
else:
    sys.path.insert(0, CHECKOUT)


def fail(message: str) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return 2


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default="")
    args = ap.parse_args(argv)

    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    entry = cells[args.workload]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        return fail(f"{args.workload} needs {entry['chips']} CUDA device(s); {torch.cuda.device_count()} visible")
    try:
        from portbench import core
        from portbench.shapes import load_json, shapes_of

        prog = core.load_program()
    except ImportError as e:
        return fail(f"the program does not import beside the benchmark: {e!r}")

    raw = load_json("configs", entry["config"])
    cell = load_json("cells", args.workload)
    mix = load_json("traffic", entry["traffic"])
    s = shapes_of(entry["config"], raw)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = core.run_cell(
        s=s, raw=raw, mix_params=mix, cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device, t_start=T_START, prog=prog,
    )
    line, check_lines = core.result_line(bench, args.workload, run, bool(args.trace), cell, int(entry["chips"]), device)
    if args.dump:
        core.dump(args.dump, run, line)
    found = core.forbidden_modules()
    if found:
        return fail(f"the process holds {', '.join(found)} after the window")
    for text in check_lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
