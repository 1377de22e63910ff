"""Time variants of the port's attention kernels on one GPU.

    python scripts/torch_kernel_variants.py

A variant is the kernel source, ``agentainer_tpu_torch/csrc/flash_attention.cu``,
with regular-expression substitutions on its code applied, each matching
exactly once: the source as it is, and copies that drop a part of the work
(the decode products, the combine launch, the programmatic dependent
launch, the prefill products), so that what is left shows what a part
costs. Every variant is built with nvcc, all at once, and timed through the
port's wrappers with ``chip_smoke.time_in_turns`` (device span of single
calls in a profiler trace, cold L2, in turns) at llama3-8b attention shapes:
decode over 8 lanes at positions that vary the tiles per block and the
number of live blocks, and one 256-token prefill chunk at offsets that
vary the tiles per block. Only the unchanged source is checked against the
plain versions. Prints one JSON line per variant, then SDPA's times at two
of the decode shapes, then the card. Needs a CUDA device; exits 2 without
one.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "agentainer_tpu_torch", "csrc", "flash_attention.cu")
NO_DECODE_PRODUCTS = {  # every tile's copies still land; nothing reads them
    r"(const int k0 = k_begin \+ tile \* DC_BK;)": r"if (split >= 0) continue;\n    \1",
}
VARIANTS = {
    "source": {},
    "no_decode_products": NO_DECODE_PRODUCTS,
    "no_decode_products_no_combine": {
        **NO_DECODE_PRODUCTS,
        r"const cudaError_t err = cudaLaunchKernelEx\(": "const cudaError_t err = cudaSuccess; if (0) cudaLaunchKernelEx(",
    },
    "no_programmatic_launch": {r"cfg\.numAttrs = 1;": "cfg.numAttrs = 0;"},
    "no_prefill_products": {r"if \(tile < n_tiles && k0 <= wmax\) \{": "if (false) {"},
}
S, B, H, KV, HD = 2048, 8, 32, 8, 128
DECODE = {
    "none": (-1,) * B,  # every split exits: the fixed cost of the two launches
    "all63": (63,) * B,  # 64 blocks of 1 tile
    "all255": (255,) * B,  # 64 blocks of 4 tiles
    "all1023": (1023,) * B,  # 256 blocks of 4 tiles
    "all2047": (2047,) * B,  # 512 blocks of 4 tiles
}
PREFILL_OFFSETS = (0, 300, 1000, 1700)


def build(variants: dict, out_dir: str) -> dict[str, str]:
    src = open(SRC).read()
    from agentainer_tpu_torch.ops import _build

    procs = {}
    for name, subs in variants.items():
        text = src
        for pattern, repl in subs.items():
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                raise ValueError(f"{name}: {pattern!r} matched {n} times")
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
    for name, proc in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
    return {name: os.path.join(out_dir, f"{name}.so") for name in variants}


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from agentainer_tpu_torch.ops import _build
    from agentainer_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v, qp = randn(B, H, HD), randn(B, S, KV, HD), randn(B, S, KV, HD), randn(1, 256, H, HD)
    decode = {"mixed": cs.MIXED_POS, "served_mix": cs.SERVED_MIX_POS, **DECODE}
    decode = {name: torch.tensor(p, device=dev, dtype=torch.int32) for name, p in decode.items()}
    prefill = {off: (off + torch.arange(256, device=dev, dtype=torch.int32))[None] for off in PREFILL_OFFSETS}
    with tempfile.TemporaryDirectory() as tmp:
        for name, so in build(VARIANTS, tmp).items():
            lib = ctypes.CDLL(so)
            ca._lib.cache_clear()
            _build.library = lambda _name, lib=lib: lib
            fns = {}
            for case, pos in decode.items():
                fns[f"decode/{case}"] = lambda pos=pos: ca.flash_decode(q, k, v, pos)
                if name == "source":
                    torch.testing.assert_close(
                        ca.flash_decode(q, k, v, pos).float(), ca.flash_decode_plain(q, k, v, pos).float(),
                        rtol=3e-2, atol=3e-2,
                    )
            for off, pos in prefill.items():
                fns[f"prefill/{off}"] = lambda pos=pos: ca.flash_prefill(qp, k[:1], v[:1], pos)
                if name == "source":
                    torch.testing.assert_close(
                        ca.flash_prefill(qp, k[:1], v[:1], pos).float(),
                        ca.flash_prefill_plain(qp, k[:1], v[:1], pos).float(), rtol=3e-2, atol=3e-2,
                    )
            times, card = cs.time_in_turns(fns, rounds=5)
            print(json.dumps({
                "variant": name, "us": {f: round(1e3 * t["median"], 1) for f, t in times.items()},
                "sm_mhz": [card["sm_mhz_min"], card["sm_mhz_max"]],
            }), flush=True)
    fns = {}
    for case in ("mixed", "all2047"):
        mask = (torch.arange(S, device=dev)[None, :] <= decode[case][:, None])[:, None, None]
        fns[f"sdpa/{case}"] = lambda mask=mask: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )
    times, card = cs.time_in_turns(fns, rounds=5)
    print(json.dumps({
        "library": {f: round(1e3 * t["median"], 1) for f, t in times.items()},
        "sm_mhz": [card["sm_mhz_min"], card["sm_mhz_max"]],
    }))
    print(cs.smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
