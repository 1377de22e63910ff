"""Time the int8-weight GEMM at every split count it can run, and its
wrapper's host cost.

    python scripts/torch_w8a16_sweep.py                      # the sweep
    python scripts/torch_w8a16_sweep.py --host [--package DIR]
    python scripts/torch_w8a16_sweep.py --against DIR         # this source vs DIR's
    python scripts/torch_w8a16_sweep.py --repeat SECONDS [--against DIR]

The sweep: for each (K, N) of llama3-8b's weights and each M (8: a decode
step; 24, 40, 72: the verify rounds; 256: a prefill chunk), the plan's token
tile at every contraction split the kernel takes (``agentainer_tpu_torch/
csrc/w8a16_gemm.cu``: 1, 2, 4 or 8 blocks of one cluster, each over at
least ``MIN_SPLIT_STEPS`` 64-deep tiles), and at M = 256 also the 128-row
tile (two token tiles), is checked against the plain version and timed
through the library's C entry point with ``chip_smoke.time_in_turns``
(device span of single calls in a profiler trace, cold L2, in turns), beside
the bf16 cuBLAS product of the dense weight and the (tile, split) that
``cuda_quant.plan`` picks. One JSON line per (K, N, M).

``--host``: the host cost of one ``w8a16_matmul`` call at M = 8 for each
(K, N), beside the bf16 product's (``chip_smoke.host_cost``: the host clock
around a loop while the device is held, and CUDA events around a loop back
to back). ``--package DIR`` imports ``agentainer_tpu_torch`` from the
checkout at DIR instead, to time another version's wrapper in the same run.

``--against DIR``: the 2-D product at the plan's (tile, split) for each
(K, N) and M = 8, 72 and 256, through this checkout's library and through
one built from DIR's ``agentainer_tpu_torch/csrc/w8a16_gemm.cu`` (into this
checkout's ``_build/``), both checked against the plain version and timed in
turns in one row, so that two versions of the kernel compare on one card.

``--repeat SECONDS``: the 2-D product at M = 72 (the 72-row tile of a
verify round) for w_down and w_gate, at one split (the most ring rounds per
block), launched back to back for SECONDS, alone and then beside a
device-to-device copy on another stream that loads the memory system,
twice each; every launch's bits are held against the first launch's on the
device, and one JSON line per run counts the launches that differed. With
``--against DIR`` DIR's source runs in turns with this one.

Prints the card last. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256))
MS = (8, 24, 40, 72, 256)


def _inputs(torch, g, m, k, n):
    dev = torch.device("cuda")
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g, device=dev)
    scale = ((0.5 + torch.rand((1, n), generator=g, device=dev)) * (0.02 / 127.0)).to(torch.bfloat16)
    return x, q, scale


def sweep(torch, chip_smoke, cq) -> None:
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    lib = cq._lib()
    for k, n in SHAPES:
        for m in MS:
            x, q, scale = _inputs(torch, g, m, k, n)
            want = cq.w8a16_matmul_plain(x, q, scale).float()
            dense = q.to(torch.bfloat16) * scale
            plan_bm, _ = cq.plan(m, n, k)
            fns = {}
            for bm in sorted({plan_bm, 128} if m > 128 else {plan_bm}):
                for splits in cq.CLUSTERS_PER_WAVE:
                    if splits > 1 and (k // cq.BK) // splits < cq.MIN_SPLIT_STEPS:
                        continue
                    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")

                    def call(bm=bm, splits=splits, out=out):
                        err = lib.atpu_w8a16_matmul(
                            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k, bm, splits,
                            torch.cuda.current_stream().cuda_stream,
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
            fns["cublas_bf16"] = lambda x=x, dense=dense: x @ dense
            times, card = chip_smoke.time_in_turns(fns)
            row = {
                "K": k, "N": n, "M": m, "plan": "bm{}_s{}".format(*cq.plan(m, n, k)),
                **chip_smoke._bound(k * n + 2 * n + 2 * m * k + 2 * m * n, 2.0 * m * k * n),
                "ms": {name: t["median"] for name, t in times.items()},
                "ms_min_max": {name: (t["min"], t["max"]) for name, t in times.items()},
                "sm_mhz": (card["sm_mhz_min"], card["sm_mhz_max"]),
            }
            row["best"] = min((name for name in row["ms"] if name != "cublas_bf16"), key=row["ms"].get)
            print(json.dumps(row), flush=True)


AGAINST_MS = (8, 72, 256)


def _library_of(src: str):
    """``src`` built as ``ops/_build.library`` builds the port's own source
    (same flags, named by the same hash), with the C signature set."""
    import ctypes
    import hashlib
    import subprocess

    from agentainer_tpu_torch.ops import _build, cuda_quant

    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(_build._OUT, f"libw8a16_gemm-{digest}.so")
    if not os.path.exists(so):
        os.makedirs(_build._OUT, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.atpu_w8a16_matmul.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.atpu_w8a16_matmul.restype = i32
    assert cuda_quant.BK == 64 and cuda_quant.BN == 128  # the other source's tiles are these too
    return lib


def against(torch, chip_smoke, cq, other_dir: str) -> None:
    libs = {
        "this": cq._lib(),
        "against": _library_of(os.path.join(other_dir, "agentainer_tpu_torch", "csrc", "w8a16_gemm.cu")),
    }
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    for k, n in SHAPES:
        for m in AGAINST_MS:
            x, q, scale = _inputs(torch, g, m, k, n)
            want = cq.w8a16_matmul_plain(x, q, scale).float()
            bm, splits = cq.plan(m, n, k)
            fns, outs = {}, {}
            for name, lib in libs.items():
                out = outs[name] = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")

                def call(lib=lib, out=out):
                    err = lib.atpu_w8a16_matmul(
                        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k, bm, splits,
                        torch.cuda.current_stream().cuda_stream,
                    )
                    if err:
                        raise RuntimeError(f"cudaError {err}")
                    return out

                call()
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    out.float(), want, rtol=chip_smoke.W8_RTOL, atol=chip_smoke.W8_ATOL,
                    msg=lambda msg, name=name: f"{name} M={m} K={k} N={n}: {msg}",
                )
                fns[name] = call
            times, card = chip_smoke.time_in_turns(fns)
            print(json.dumps({
                "K": k, "N": n, "M": m, "plan": f"bm{bm}_s{splits}",
                "bit_equal": torch.equal(outs["this"], outs["against"]),
                "ms": {name: t["median"] for name, t in times.items()},
                "ms_min_max": {name: (t["min"], t["max"]) for name, t in times.items()},
                "launches": {name: t["launches"] for name, t in times.items()},
                "kernels": {name: t["kernels"] for name, t in times.items()},
                "sm_mhz": (card["sm_mhz_min"], card["sm_mhz_max"]),
            }), flush=True)


REPEAT_SHAPES = ((14336, 4096), (4096, 14336))
REPEAT_M = 72


def repeat(torch, cq, seconds: float, other_dir: str | None) -> None:
    import time

    libs = {"this": cq._lib()}
    if other_dir:
        libs["against"] = _library_of(os.path.join(other_dir, "agentainer_tpu_torch", "csrc", "w8a16_gemm.cu"))
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    src = torch.empty(1 << 29, dtype=torch.int16, device="cuda")  # 1 GiB each
    dst = torch.empty_like(src)
    side = torch.cuda.Stream()
    m = REPEAT_M
    for k, n in REPEAT_SHAPES:
        x, q, scale = _inputs(torch, g, m, k, n)
        bm, _ = cq.plan(m, n, k)
        for load in ("alone", "copy", "alone", "copy"):
            for name, lib in libs.items():
                first = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
                out = torch.empty_like(first)
                stream = torch.cuda.current_stream().cuda_stream

                def call(out, lib=lib):
                    err = lib.atpu_w8a16_matmul(
                        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k, bm, 1, stream
                    )
                    if err:
                        raise RuntimeError(f"cudaError {err}")

                call(first)
                differed = torch.zeros((), dtype=torch.int64, device="cuda")
                launches = 0
                torch.cuda.synchronize()
                t0 = time.monotonic()
                while time.monotonic() - t0 < seconds:
                    if load == "copy" and launches % 4 == 0:
                        with torch.cuda.stream(side):
                            dst.copy_(src)
                    call(out)
                    differed += (out != first).any()
                    launches += 1
                torch.cuda.synchronize()
                print(json.dumps({
                    "K": k, "N": n, "M": m, "tile": bm, "splits": 1, "source": name, "load": load,
                    "launches": launches, "differed": int(differed.item()),
                }), flush=True)


def host(torch, chip_smoke, cq) -> None:
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    for k, n in SHAPES:
        x, q, scale = _inputs(torch, g, 8, k, n)
        dense = q.to(torch.bfloat16) * scale
        print(json.dumps({
            "K": k, "N": n, "M": 8, "package": os.path.dirname(os.path.dirname(os.path.abspath(cq.__file__))),
            "w8a16_matmul": chip_smoke.host_cost(lambda: cq.w8a16_matmul(x, q, scale)),
            "bf16_matmul": chip_smoke.host_cost(lambda: x @ dense),
        }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", action="store_true", help="time the wrapper's host cost instead of the sweep")
    ap.add_argument("--package", default=ROOT, help="checkout to import agentainer_tpu_torch from")
    ap.add_argument("--against", metavar="DIR", help="time this source's 2-D product beside DIR's")
    ap.add_argument("--repeat", type=float, metavar="SECONDS", help="count launches whose bits differ")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    sys.path.insert(0, os.path.abspath(args.package))
    from agentainer_tpu_torch.ops import cuda_quant as cq

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.repeat:
        repeat(torch, cq, args.repeat, args.against and os.path.abspath(args.against))
    elif args.against:
        against(torch, chip_smoke, cq, os.path.abspath(args.against))
    else:
        (host if args.host else sweep)(torch, chip_smoke, cq)
    print(chip_smoke.smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
