"""Tiny shapes and traffic for the CPU tests: the configurations' published
keys at the sizes of the port's ``tiny`` and ``tiny-moe``."""

TINY = {
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 128, "vocab_size": 512, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 256, "engine": {"speculative": False},
}
TINY_MOE = {**TINY, "num_local_experts": 4, "num_experts_per_tok": 2}
TINY_MOE_INT8 = {**TINY_MOE, "engine": {"speculative": False, "quant": "int8"}}
# deep and wide enough that a served token depends on its context: at 2
# layers of 64 a step that forgets its KV still serves tokens the reference
# ranks above its mean
TINY_MOE_INT8_DEEP = {**TINY_MOE_INT8, "num_hidden_layers": 4, "hidden_size": 128, "intermediate_size": 256}

SESSIONS = {
    "generator": "closed_loop", "sessions": True, "system_prompt_tokens": 40,
    "prompt_tokens": {"dist": "loguniform", "lo": 8, "hi": 24},
    "output_tokens": {"dist": "loguniform", "lo": 3, "hi": 12},
    "think_s": {"dist": "exponential", "mean": 0.01},
    "fill_tokens": {"dist": "uniform", "lo": 8, "hi": 60},
    "ramp_s": 0.3,
}
BATCH = {
    "generator": "closed_loop", "sessions": False, "system_prompt_tokens": 0,
    "prompt_tokens": {"dist": "loguniform", "lo": 8, "hi": 32},
    "output_tokens": {"dist": "loguniform", "lo": 4, "hi": 16},
    "think_s": {"dist": "none"},
    "ramp_s": 0.3,
}


def cell(lanes=3, max_seq=160, contexts=3, number="max_logit_gap", limit=1e-3):
    return {"engine": {"max_batch": lanes, "max_seq": max_seq}, "clients": lanes,
            "check": {"contexts": contexts, "number": number, "limit": limit}}
