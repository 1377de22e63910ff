"""Each metric reader's arithmetic, on a hand-made record and trace, and the
reduction of profiler events."""

import pytest

from portbench import core, work
from portbench.shapes import shapes_of
from portbench.tests import tiny
from portbench.trace import reduce_events, short_name

PEAKS = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}


def metrics(before: dict, after: dict) -> tuple[dict, dict]:
    base = {"decode_chunk_hist": {}, "prefix_tokens_saved": 0, "host_syncs_total": 0, "tokens_generated": 0,
            "decode_steps": 0, "batch_occupancy": 0.0}
    return {**base, **before}, {**base, **after}


def record(quant=""):
    raw = dict(tiny.TINY_MOE, engine={"quant": quant}) if quant else tiny.TINY
    s = shapes_of("t", raw)
    # two requests in a 10 s window: r0 a fresh turn of 50 positions (40 of a
    # shared prompt) with 4 outputs; r1 a continuing turn from position 99
    # to 120 with 3 outputs, its last after the close
    r0 = {"t_send": 1.0, "emits": [(1.5, 1), (2.0, 2), (2.5, 1)], "n_out": 4, "need_start": 40, "ctx0": 50,
          "fresh": True, "queue_ms": 10.0, "error": None, "in_window": True, "cut": False}
    r1 = {"t_send": 3.0, "emits": [(3.2, 1), (5.0, 1), (11.5, 1)], "n_out": 3, "need_start": 99, "ctx0": 120,
          "fresh": False, "queue_ms": 30.0, "error": None, "in_window": True, "cut": False}
    counters = metrics(
        {"decode_steps": 10, "batch_occupancy": 0.5, "prefix_tokens_saved": 100, "host_syncs_total": 5,
         "tokens_generated": 50, "decode_chunk_hist": {"8": 1}},
        {"decode_steps": 30, "batch_occupancy": 0.25, "prefix_tokens_saved": 132, "host_syncs_total": 9,
         "tokens_generated": 58, "decode_chunk_hist": {"8": 2, "1": 5}},
    )
    trace = {"t0": 1.8, "t1": 5.5, "window_s": 4.0, "busy_s": 3.0, "counters": counters,
             "kernel_s": {"decode_kernel": 0.02, "decode_combine_kernel": 0.01, "prefill_kernel": 0.5,
                          "w8a16_grouped_kernel": 2.0, "at::native::foo": 9.0}}
    return {"shapes": s, "peaks": PEAKS, "max_batch": 4, "w0": 0.0, "w1": 10.0, "requests": [r0, r1],
            "counters": counters, "trace": trace}


def read(name, rec):
    return core.load_reader(name)(rec)


def test_end_to_end():
    rec = record()
    assert core.end_to_end("ttft_p85_ms", rec, 0.0) == pytest.approx(200 + 0.85 * (500 - 200))
    # tpot over requests completed in the window: r0 only, (2.5 - 1.5) / 3
    assert core.end_to_end("tpot_p85_ms", rec, 0.0) == pytest.approx(1000 / 3)
    # tokens that reached their clients in [0, 10]: 4 + 2
    assert core.end_to_end("output_tokens_per_s", rec, 0.0) == pytest.approx(0.6)
    assert core.end_to_end("setup_s", rec, 12.5) == 12.5
    # a request sent in the ramp and completed in the window counts for its
    # tpot, not for its ttft
    ramp = {**rec["requests"][0], "t_send": -1.0, "emits": [(-0.5, 1), (0.5, 1)], "n_out": 2, "in_window": False}
    rec["requests"].append(ramp)
    assert core.end_to_end("tpot_p85_ms", rec, 0.0) == pytest.approx(1000 / 3 + 0.85 * (1000 - 1000 / 3))
    assert core.end_to_end("ttft_p85_ms", rec, 0.0) == pytest.approx(200 + 0.85 * (500 - 200))


def test_counter_readers():
    rec = record()
    assert read("batch_occupancy.tput", rec) == pytest.approx(4 * (0.25 * 30 - 0.5 * 10) / 20)
    assert read("batch_occupancy.ttft", rec) == read("batch_occupancy.tput", rec)
    assert read("host_syncs_per_token.tpot", rec) == pytest.approx(4 / 8)
    # prompt tokens submitted: 50 (fresh) + 21 (continuing, the pending token with them)
    assert read("prefix_hit_share.ttft", rec) == pytest.approx(100 * 32 / 71)
    assert read("queue_wait_p85_ms.ttft", rec) == pytest.approx(10 + 0.85 * 20)
    assert read("ttft_p85_ms.batch", rec) == pytest.approx(core.end_to_end("ttft_p85_ms", rec, 0))


def test_mfu_counts_what_the_tokens_need():
    rec = record()
    s = rec["shapes"]
    decode = work.decode_flops(s, 51) + work.decode_flops(s, 52) + work.decode_flops(s, 53) + work.decode_flops(s, 121)
    prefill = work.prefill_flops(s, 40, 50) + work.prefill_flops(s, 99, 120)
    assert read("mfu.tpot", rec) == pytest.approx(100 * decode / 10 / 1e12)
    assert read("mfu.ttft", rec) == pytest.approx(100 * prefill / 10 / 1e12)
    assert read("mfu.tput", rec) == pytest.approx(100 * (decode + prefill) / 10 / 1e12)
    # by hand: a decode token at 51 keys through tiny's 2 layers
    layer = 2 * (64 * 64 * 2 + 2 * 64 * 32 + 3 * 64 * 128)
    assert work.decode_flops(s, 51) == 2 * (layer + 4 * 4 * 16 * 51) + 2 * 64 * 512


def test_trace_readers():
    rec = record()
    s = rec["shapes"]
    # decode tokens that reached their clients in [1.8, 5.5]: r0's at 2.0 (x2)
    # and 2.5 (keys 51, 52, 53), r1's at 5.0 (keys 121)
    bound = sum(work.decode_attention_bound_s(s, k, PEAKS) for k in (51, 52, 53, 121))
    assert read("decode_attention_roofline.tpot", rec) == pytest.approx(100 * bound / 0.03)
    # turns whose first token came in [1.8, 5.5]: r1
    assert read("prefill_attention_roofline.ttft", rec) == pytest.approx(
        100 * work.prefill_attention_bound_s(s, 99, 120, PEAKS) / 0.5)
    assert read("device_idle_share.tput", rec) == pytest.approx(25.0)
    assert read("device_idle_share.ttft", rec) == pytest.approx(25.0)
    assert read("w8a16_gemm_roofline.tput", rec) is None  # bf16 weights


def test_w8a16_roofline():
    rec = record("int8")
    s = rec["shapes"]
    steps = 8 * 1 + 1 * 5  # decode steps between the trace's counter readings
    lanes = round(4 / steps) or 1
    bound = steps * work.w8a16_bound_s(s, lanes, PEAKS, lanes) + work.w8a16_bound_s(s, 21, PEAKS, 1)
    assert read("w8a16_gemm_roofline.tput", rec) == pytest.approx(100 * bound / 2.0)


def test_bounds_by_hand():
    s = shapes_of("t", tiny.TINY)
    # one decode query over 100 keys: K and V 2 x 100 x 2 heads x 16 x 2 B,
    # q and out 2 x 4 x 16 x 2 B, per layer; bytes-bound at 1 GB/s
    nbytes = 2 * 100 * 2 * 16 * 2 + 2 * 4 * 16 * 2
    assert work.decode_attention_bound_s(s, 100, PEAKS) == pytest.approx(2 * nbytes / 1e9)
    assert work.int8_gemm_bound_s(8, 4096, 4096, {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}) == pytest.approx(
        (4096 * 4096 + 2 * 4096 + 2 * 8 * 4096 + 2 * 8 * 4096) / 3.35e12)
    moe = shapes_of("m", tiny.TINY_MOE)
    assert work.experts_touched(moe, 1) == pytest.approx(2)
    assert work.experts_touched(moe, 1000) == pytest.approx(4)


def test_trace_reduction():
    events = [
        ("void decode_kernel<__nv_bfloat16, 4, DenseArena>(Params)", True, 100, 300),
        ("void (anonymous namespace)::prefill_kernel<float>(P)", True, 250, 400),
        ("Memcpy DtoH (Device -> Pinned)", True, 600, 700),
        ("cudaGraphLaunch", False, 50, 120),
        ("aten::copy_", False, 390, 650),
        ("aten::copy_", False, 400, 550),
    ]
    out = reduce_events(events, 0, 1000)
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["busy_s"] == pytest.approx(400e-9)  # [100, 400] and [600, 700]
    assert out["kernel_s"]["decode_kernel"] == pytest.approx(200e-9)
    assert out["kernel_s"]["prefill_kernel"] == pytest.approx(150e-9)
    idle = dict(out["breakdown"]["idle_gaps"])
    # gaps [0, 100] (cudaGraphLaunch at its middle), [400, 600] (the inner
    # aten::copy_), [700, 1000] (nothing traced)
    assert idle["cudaGraphLaunch"] == pytest.approx(100e-9)
    assert idle["aten::copy_"] == pytest.approx(200e-9)
    assert idle["no_host_call_traced"] == pytest.approx(300e-9)
    assert out["breakdown"]["device_ops"][0][0] == "decode_kernel"
    assert short_name("at::native::vectorized_elementwise_kernel<4, Foo>(int, Foo)") == \
        "at::native::vectorized_elementwise_kernel"
