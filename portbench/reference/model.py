"""The plain reference of the Mistral and Mixtral decoders, in float32 with
TF32 off, written from the published layer equations (Hugging Face's
``MistralForCausalLM`` and ``MixtralForCausalLM``):

- RMSNorm: ``x / sqrt(mean(x²) + eps) · w``;
- RoPE in the rotate-half layout at the configuration's theta, angles in
  float64;
- grouped-query attention, query head h reading KV head ``h // (H / KV)``,
  causal, softmax scaled by ``1 / sqrt(head_dim)``;
- SwiGLU: ``(silu(x W_gate) · x W_up) W_down``;
- Mixtral's router: ``x W_router``, the ``experts_per_token`` largest
  logits, a softmax over them, each chosen expert's SwiGLU weighted by it;
- the head over the final RMSNorm.

It takes the benchmark's weight tree (``weights.py``): matrices stored
``[in, out]``, an int8 leaf as ``{"q": int8, "scale": bf16 [.., 1, out]}``,
dequantized here as ``q · scale``. Nothing of the program is imported, and
nothing the program made is read: its outputs are judged, never used.

``precision`` puts a lower precision in the program's place, for the
control of ``correct``: ``"fp8"`` rounds every weight (per output column)
and every product's input (per token) to float8 e4m3, as an fp8 serving
path would; ``"int4"`` rounds every weight to symmetric int4 per output
column, as a w4a16 path would. The attention products stay in float32.
``"bf16"`` is no control but a witness: every product's input and output
rounded to bf16, as the program serves them, to show what bf16 alone
moves."""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _int4(w: torch.Tensor) -> torch.Tensor:
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-30) / 7.0
    return torch.clamp(torch.round(w / scale), -8, 7) * scale


class Reference:
    def __init__(self, shapes, weights: dict, precision: str = "f32", track_margins: bool = False):
        if precision not in ("f32", "fp8", "int4", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.s = shapes
        self.w = weights
        self.precision = precision
        # per context, each position's narrowest router margin over the
        # layers: the last chosen expert's logit minus the first unchosen's
        self.margins: list[torch.Tensor] | None = [] if track_margins else None

    # -- weights --------------------------------------------------------
    def matrix(self, leaf, *index) -> torch.Tensor:
        """One ``[in, out]`` matrix of a leaf in float32, through the
        control's rounding."""
        if isinstance(leaf, dict):
            q, scale = leaf["q"], leaf["scale"]
            for i in index:
                q, scale = q[i], scale[i]
            w = q.to(torch.float32) * scale.to(torch.float32)
        else:
            w = leaf
            for i in index:
                w = w[i]
            w = w.to(torch.float32)
        if self.precision == "fp8":
            return _fp8(w, -2)
        if self.precision == "int4":
            return _int4(w)
        return w

    def vector(self, leaf, *index) -> torch.Tensor:
        for i in index:
            leaf = leaf[i]
        return leaf.to(torch.float32)

    def product(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x = _fp8(x, -1)
        if self.precision == "bf16":
            return (x.to(torch.bfloat16).to(torch.float32) @ w).to(torch.bfloat16).to(torch.float32)
        return x @ w

    # -- the layer equations --------------------------------------------
    def rms_norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.s.norm_eps) * w

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """``x [T, heads, hd]`` at positions 0..T-1."""
        t, hd = x.shape[0], x.shape[-1]
        inv = 1.0 / (self.s.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
        ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
        cos = torch.cat([ang.cos(), ang.cos()], -1).to(torch.float32)[:, None, :]
        sin = torch.cat([ang.sin(), ang.sin()], -1).to(torch.float32)[:, None, :]
        half = hd // 2
        rotated = torch.cat([-x[..., half:], x[..., :half]], -1)
        return x * cos + rotated * sin

    def attention(self, x: torch.Tensor, layer: int, block: int = 512) -> torch.Tensor:
        s, lw = self.s, self.w["layers"]
        t, hd, kv = x.shape[0], s.head_dim, s.n_kv_heads
        g = s.n_heads // kv
        q = self.rope(self.product(x, self.matrix(lw["wq"], layer)).view(t, s.n_heads, hd))
        k = self.rope(self.product(x, self.matrix(lw["wk"], layer)).view(t, kv, hd))
        v = self.product(x, self.matrix(lw["wv"], layer)).view(t, kv, hd)
        q = q.view(t, kv, g, hd)
        out = torch.empty_like(q)
        for a in range(0, t, block):
            b = min(t, a + block)
            scores = torch.einsum("qkgd,skd->kgqs", q[a:b], k[:b]) / hd**0.5
            mask = torch.arange(b, device=x.device)[None, :] <= torch.arange(a, b, device=x.device)[:, None]
            scores = scores.masked_fill(~mask, float("-inf"))
            out[a:b] = torch.einsum("kgqs,skd->qkgd", scores.softmax(-1), v[:b])
        return self.product(out.reshape(t, s.n_heads * hd), self.matrix(lw["wo"], layer))

    def swiglu(self, x: torch.Tensor, layer: int, *expert) -> torch.Tensor:
        lw = self.w["layers"]
        gate = F.silu(self.product(x, self.matrix(lw["w_gate"], layer, *expert)))
        up = self.product(x, self.matrix(lw["w_up"], layer, *expert))
        return self.product(gate * up, self.matrix(lw["w_down"], layer, *expert))

    def moe(self, xs: list[torch.Tensor], layer: int) -> list[torch.Tensor]:
        """Every context's routed experts, one expert's weights at a time."""
        s = self.s
        router = self.matrix(self.w["layers"]["router"], layer)
        routes = []
        for i, x in enumerate(xs):
            logits = self.product(x, router)
            top, chosen = torch.topk(logits, s.experts_per_token, dim=-1)
            routes.append((chosen, top.softmax(-1)))
            if self.margins is not None:
                ranked = torch.topk(logits, s.experts_per_token + 1, dim=-1).values
                margin = ranked[:, -2] - ranked[:, -1]
                if len(self.margins) <= i:
                    self.margins.append(margin)
                else:
                    self.margins[i] = torch.minimum(self.margins[i], margin)
        outs = [torch.zeros_like(x) for x in xs]
        for e in range(s.n_experts):
            picked = [(chosen == e).nonzero(as_tuple=True) for chosen, _ in routes]
            if not any(rows.numel() for rows, _ in picked):
                continue
            for x, out, (rows, slot), (_, weight) in zip(xs, outs, picked, routes):
                if rows.numel():
                    out.index_add_(0, rows, weight[rows, slot, None] * self.swiglu(x[rows], layer, e))
        return outs

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        leaf = self.w["embed"]
        if isinstance(leaf, dict):
            return leaf["q"][tokens].to(torch.float32) * leaf["scale"][0].to(torch.float32)
        return leaf[tokens].to(torch.float32)

    @torch.no_grad()
    def logits(self, contexts: list[list[int]], rows: list[list[int]], device) -> list[torch.Tensor]:
        """The logits ``[len(rows[i]), vocab]`` of context i at positions
        ``rows[i]`` (row j scores the token at j + 1), all contexts through
        one layer at a time."""
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            s, lw = self.s, self.w["layers"]
            xs = [self.embed(torch.tensor(c, device=device)) for c in contexts]
            for layer in range(s.n_layers):
                xs = [x + self.attention(self.rms_norm(x, self.vector(lw["attn_norm"], layer)), layer) for x in xs]
                hs = [self.rms_norm(x, self.vector(lw["mlp_norm"], layer)) for x in xs]
                ffn = self.moe(hs, layer) if s.is_moe else [self.swiglu(h, layer) for h in hs]
                xs = [x + f for x, f in zip(xs, ffn)]
            head = self.matrix(self.w["lm_head"])
            norm = self.vector(self.w["final_norm"])
            return [self.product(self.rms_norm(x[torch.tensor(r, device=device)], norm), head) for x, r in zip(xs, rows)]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
