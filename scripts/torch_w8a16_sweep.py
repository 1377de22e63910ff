"""Time the int8-weight GEMM at every token tile and split count it can run.

    python scripts/torch_w8a16_sweep.py

For each (K, N) of llama3-8b's weights and each M (8: a decode step; 24,
40, 72: the verify rounds; 256: a prefill chunk), every (token tile,
contraction splits) the kernel takes (``agentainer_tpu_torch/csrc/
w8a16_gemm.cu``; tiles 16 / 64 / 128, splits up to 16 and at most one per
four 64-deep tiles of K) is checked against the plain version and timed
through the library's C entry point with ``chip_smoke.time_in_turns``
(device span of single calls in a profiler trace, cold L2, in turns),
beside the split that ``cuda_quant.plan`` picks. Prints one JSON line per
(K, N, M), then the card. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256))
MS = (8, 24, 40, 72, 256)
SPLITS = (1, 2, 4, 8, 16)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from agentainer_tpu_torch.ops import cuda_quant as cq

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    lib = cq._lib()
    for k, n in SHAPES:
        for m in MS:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            q = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g, device=dev)
            scale = ((0.5 + torch.rand((1, n), generator=g, device=dev)) * (0.02 / 127.0)).to(torch.bfloat16)
            want = cq.w8a16_matmul_plain(x, q, scale).float()
            fns = {}
            for bm in (16, 64, 128):
                if (m <= 16) != (bm == 16):
                    continue
                for splits in SPLITS:
                    if splits > 1 and splits > (k // cq.BK) // cq.MIN_SPLIT_STEPS:
                        continue
                    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                    part = torch.empty(max(1, splits * m * n), dtype=torch.float32, device=dev)

                    def call(bm=bm, splits=splits, out=out, part=part):
                        err = lib.atpu_w8a16_matmul(
                            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), part.data_ptr(),
                            m, n, k, bm, splits, torch.cuda.current_stream().cuda_stream,
                        )
                        if err:
                            raise RuntimeError(f"cudaError {err}")
                        return out

                    call()
                    torch.cuda.synchronize()
                    torch.testing.assert_close(
                        out.float(), want, rtol=chip_smoke.W8_RTOL, atol=chip_smoke.W8_ATOL,
                        msg=lambda msg, bm=bm, splits=splits: f"M={m} K={k} N={n} bm={bm} splits={splits}: {msg}",
                    )
                    fns[f"bm{bm}_s{splits}"] = call
            times, card = chip_smoke.time_in_turns(fns)
            row = {
                "K": k, "N": n, "M": m, "plan": "bm{}_s{}".format(*cq.plan(m, n, k)),
                **chip_smoke._bound(k * n + 2 * n + 2 * m * k + 2 * m * n, 2.0 * m * k * n),
                "ms": {name: round(t["median"], 5) for name, t in times.items()},
                "ms_min_max": {name: (round(t["min"], 5), round(t["max"], 5)) for name, t in times.items()},
                "sm_mhz": (card["sm_mhz_min"], card["sm_mhz_max"]),
            }
            best = min(row["ms"], key=row["ms"].get)
            row["best"] = best
            print(json.dumps(row), flush=True)
    print(chip_smoke.smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
