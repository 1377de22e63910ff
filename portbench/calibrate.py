"""The readings a cell's ``correct`` limit is set from, read in one process:
for each seed, the program's widest served-token logit gap after a short
window at the cell's own load, and for the first ``--control`` seeds the
same read for the control, the reference in the next precision below the
configuration's (fp8 for bf16 weights, int4 for int8) put in the program's
place over the same prompts and tokens.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--control 3] [--seconds 15]

One engine serves every seed: its weights are drawn again in place from
each seed (the step graphs read them where they are) and its sessions are
dropped between seeds. Prints one JSON line a seed. The benchmark's own
runs never run the control."""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = CHECKOUT


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--witness", type=int, default=0, help="seeds that also read the bf16 witness")
    ap.add_argument("--gaps", default="", help="write every gap read to this JSON-lines file")
    args = ap.parse_args(argv)

    import torch

    from portbench import core
    from portbench.shapes import load_json, shapes_of
    from portbench.weights import fill_weights, make_weights

    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        entry = {w["name"]: w for w in json.load(f)["workloads"]}[args.workload]
    raw = load_json("configs", entry["config"])
    cell = load_json("cells", args.workload)
    params = load_json("traffic", entry["traffic"])
    s = shapes_of(entry["config"], raw)
    control = "int4" if s.quant == "int8" else "fp8"
    device = torch.device("cuda", 0)
    seeds = [int(x) for x in args.seeds.split(",")]
    prog = core.load_program()
    weights = fill_weights(make_weights(s, device), seeds[0], device)
    engine = core.build_engine(prog, s, raw, cell, core.program_params(prog, weights), device)
    try:
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            if i:
                fill_weights(weights, seed, device)
                engine.clear_sessions()
            traffic = core.Traffic(engine)
            gen = core.make_traffic(params, cell, seed)

            async def go() -> dict:
                await gen.fill(traffic.send)
                return await core._window(engine, traffic, gen, float(params.get("ramp_s", 0.0)), args.seconds, False,
                                          finish=True)

            asyncio.run(go())
            t_ref = time.perf_counter()
            sample = core.pick_contexts(traffic.contexts, int(cell["check"]["contexts"]), seed)
            precisions = ("f32",) + ((control,) if i < args.control else ()) + (("bf16",) if i < args.witness else ())
            raw: dict = {}
            check = core.check_outputs(s, weights, sample, device, precisions, margins=True, raw_gaps=raw)
            if args.gaps:
                with open(args.gaps, "a") as f:
                    f.write(json.dumps({"seed": seed, **raw}) + "\n")
            print(json.dumps({
                "workload": args.workload, "seed": seed, **check, "contexts": len(sample),
                "requests": len(traffic.requests), "failed": sum(1 for r in traffic.requests if r["error"]),
                "seed_s": time.perf_counter() - t0, "reference_s": time.perf_counter() - t_ref,
            }), flush=True)
    finally:
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
