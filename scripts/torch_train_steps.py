"""Time the port's training steps on one GPU: phase 12c's one-device step
and phase 15b-f's mesh steps, through ``chip_smoke.py``'s own phases.

    python scripts/torch_train_steps.py [--package DIR]

``--package`` times another checkout (a ``git archive`` of the parent, say)
with that checkout's ``chip_smoke.py`` and kernels; run it and this tree in
turns in one call (parent, this, this, parent) to compare two versions on
one card. Prints one JSON line: each step's ms by CUDA events, 12c's warm
p50 (steps 2 on) and its forward / backward / optimizer split, each mesh's
warm p50 beside the one-device path's, and the card. Needs a CUDA device;
exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", default=ROOT, help="the checkout to time (default: this one)")
    root = os.path.abspath(parser.parse_args().package)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.phase_build()
    one = cs.phase_train(card)
    out = {"package": root, "card": card, "12c": {
        "step_ms": one["step_ms"], "warm_step_ms_p50": statistics.median(one["step_ms"][1:]),
        "split_ms_p50": one["split_ms_p50"]}}
    for label, mesh in cs.phase_train_mesh(card).items():
        if isinstance(mesh, dict) and "warm_step_ms_p50" in mesh:
            out[label] = {key: mesh[key] for key in ("step_ms", "warm_step_ms_p50", "one_device_warm_step_ms_p50")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
