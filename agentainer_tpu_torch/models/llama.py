"""Llama-3-family transformer in PyTorch.

Reference: ``agentainer_tpu/models/llama.py`` — ``KVCache``,
``PagedKVCache``, ``init_params``, ``_mlp``, ``_moe_mlp`` (the
dense-einsum MoE), ``routed_capacity`` and ``_moe_mlp_routed`` (the GShard
one-hot dispatch), ``_attention_block`` (``_qkv``, the cache branches in
``parallel/flash_mesh`` and the no-cache causal branch ``_causal``, summed
into the residual in ``forward``), ``forward`` (with ``moe_impl``) and
``greedy_decode``. ``forward``'s ``attn_impl`` is the reference's hook for
the no-cache path, which the training step (``train.py``) uses: the
trainable attention, run on each shard. Over a sequence-sharded mesh the
shards' blocks need one another's k/v, and ``seq_attn_impl`` takes the
mesh's attention over all of them (``ring_attention``, ``ulysses``).

``forward`` runs each layer per shard, one device being one shard (its
collectives no-ops). Over a mesh (``forward(..., mesh=)``, ``parallel/``)
each shard holds its slice of the weights and of the KV arena: column-
parallel wq/wk/wv, attention over the shard's own heads
(``parallel/flash_mesh.make_meshed_cache_attention``, the serving
attention on one device too), a row-parallel wo partial, then an
``all_reduce`` over tp; the MLP likewise (an MoE layer through the
engine's ``moe_impl``, ``parallel/expert.py``); a vocab-sharded embedding
as a masked lookup plus an ``all_reduce``; a vocab-sharded ``lm_head``
whose logits are ``all_gather``ed. Over sp each shard holds a slice of
every row's slots and the shards' attention rows are joined over sp; over
pp each layer runs on its stage's shards, the stages in turn. Without a
cache (training) each shard may take its own dp rows and sp block of the
tokens, and return its vocab slice of the logits for a vocab-parallel
loss. ``MeshCache`` holds the shards' arenas or pools.

Every op of the no-cache path keeps autograd intact (``train.py`` takes
gradients through it): the embedding gather, the layer views, the norms,
RoPE, the products and the MoE's sort and masks write nothing in place.

Parameters keep the reference's tree: a dict whose ``layers`` entries carry
a leading ``[n_layers, ...]`` axis and whose matmul weights are stored
``[in, out]`` (``x @ w``), so a JAX ``init_params`` tree converts leaf for
leaf (models/convert.py). The reference's ``lax.scan`` over the stacked
layers is a Python loop here; each iteration slices one layer as a view
(an int8 ``QTensor`` leaf field by field, ``ops/quant.layer_slice``).
Every weight product goes through ``ops/quant.qmatmul``: ``x @ w`` for a
dense weight, the fused int8 kernel for a quantized one (the reference
dequantizes and leaves the fusion to XLA).

Rounding points follow the reference: norms and RoPE compute in f32 and
cast back, attention softmax is f32, logits are f32; the MoE router's
softmax is f32 cast to x's dtype, and every MoE einsum is in x's dtype.

MoE: an expert stack ``[E, K, N]`` is multiplied by ``ops/quant.qmatmul_experts``
(every expert in one call: the grouped int8 kernel for a quantized stack).
The router ``[D, E]`` takes its own route, ``x @ dequant(router)`` in x's
dtype (``_router_logits``): E is below the int8 kernel's 16-byte rows, and
the leaf is E·D values. Two JAX behaviours are spelt out, since torch's
differ: ``lax.top_k`` puts the lower index first on ties (a stable
descending sort here, ``_top_k``), and ``jax.nn.one_hot`` of an index out
of range is an all-zero row (a comparison with an ``arange`` here,
``_one_hot``; ``F.one_hot`` raises). Both MoE forms are capture-safe:
static shapes, no host sync, no boolean indexing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.attention import attention_reference, causal_mask, flash_attention
from ..ops.norms import rms_norm
from ..ops.quant import QTensor, dequant, embed_lookup, layer_slice, qmatmul, qmatmul_experts
from ..ops.rope import apply_rope
from ..parallel.collectives import all_gather, all_reduce, broadcast, handoff
from ..parallel.flash_mesh import make_meshed_cache_attention
from ..parallel.pipeline import check_stages
from ..parallel.sharding import batch_spec, unshard_layers, unshard_slots, unshard_tensor
from .configs import ModelConfig


class KVCache:
    """Static-shape KV arena: ``k``/``v`` are ``[L, B, S, KV, hd]``.

    The storage holds one spare slot past the arena, ``[L, B, S + 1, KV,
    hd]``: JAX's scatter silently DROPS writes at positions >= S (bucket
    padding can run past the arena end), while torch's ``index_put_`` raises
    on the CPU and asserts on the card. Out-of-range writes are redirected
    to the spare slot S, which attention never reads — the same effect
    without a host sync to filter them. ``k``/``v`` are views without it.

    ``rows`` (a device int tensor ``[B']``, see ``at_rows``) makes batch row
    b of a forward write and attend arena row ``rows[b]``: the arena row is
    read from device memory, so a CUDA graph of the forward serves
    whichever slot the buffer names."""

    def __init__(self, k_store: torch.Tensor, v_store: torch.Tensor, rows=None):
        self.k_store = k_store
        self.v_store = v_store
        self.rows = rows

    @staticmethod
    def create(
        cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device=None,
        n_kv_heads: int | None = None, n_layers: int | None = None,
    ) -> "KVCache":
        """``n_kv_heads``: a tp shard's, ``n_layers``: a pipeline stage's
        (default: the model's); ``max_seq``: an sp shard's slots."""
        kv = n_kv_heads or cfg.n_kv_heads
        shape = (n_layers or cfg.n_layers, batch, max_seq + 1, kv, cfg.head_dim)
        return KVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )

    @property
    def k(self) -> torch.Tensor:
        return self.k_store[:, :, :-1]

    @property
    def v(self) -> torch.Tensor:
        return self.v_store[:, :, :-1]

    @property
    def max_seq(self) -> int:
        return self.k_store.shape[2] - 1

    def row(self, b: int) -> "KVCache":
        """Batch row ``b`` as a one-row cache VIEW: writes through it land in
        this arena (the reference slices the row and writes it back)."""
        return KVCache(self.k_store[:, b : b + 1], self.v_store[:, b : b + 1])

    def at_rows(self, rows: torch.Tensor) -> "KVCache":
        """The whole arena, addressed through ``rows`` (int32 ``[B']`` on the
        arena's device): batch row b of a forward is arena row rows[b]."""
        return KVCache(self.k_store, self.v_store, rows)

    # -- what the engine reads and writes outside a forward ---------------
    def tensors(self) -> list[torch.Tensor]:
        return [self.k_store, self.v_store]

    def read_prefix(self, row: int, n: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Arena row ``row``'s first ``n`` positions, every layer, as views
        ``[L, n, KV, hd]``: one (k, v) pair (a mesh gives one per tp slice)."""
        return [(self.k_store[:, row, :n], self.v_store[:, row, :n])]

    def write_prefix(self, row: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write ``[L, n, KV, hd]`` into arena row ``row``'s prefix, in
        place; a pinned host source is copied without waiting."""
        n = k.shape[1]
        nb = k.device.type == "cpu" and k.is_pinned()
        self.k_store[:, row, :n].copy_(k, non_blocking=nb)
        self.v_store[:, row, :n].copy_(v, non_blocking=nb)

    def clone_prefix(self, row: int, n: int):
        """Copies of row ``row``'s first ``n`` positions (a prefix-cache
        entry); ``fork_prefix`` writes them into a row."""
        return self.k_store[:, row, :n].clone(), self.v_store[:, row, :n].clone()

    def fork_prefix(self, row: int, saved) -> None:
        k, v = saved
        self.k_store[:, row, : k.shape[1]].copy_(k)
        self.v_store[:, row, : v.shape[1]].copy_(v)

    def write(self, layer: int, positions: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
        """In-place scatter of this step's k/v [B, T, KV, hd] at per-row
        ``positions`` [B, T] (the reference's donated ``.at[].set``), into
        arena rows ``rows`` when set."""
        s = self.max_seq
        idx = torch.where((positions >= 0) & (positions < s), positions, s).long()
        b_idx = (
            torch.arange(k.shape[0], device=k.device) if self.rows is None else self.rows.long()
        )[:, None].expand_as(idx)
        self.k_store[layer].index_put_((b_idx, idx), k)
        self.v_store[layer].index_put_((b_idx, idx), v)


class PagedKVCache:
    """Block-table KV arena: pools ``k``/``v`` of ``[L, n_pages, page_size,
    KV, hd]``. A sequence owns a list of pages (its block-table row) instead
    of a dense arena row, so resident sessions are bounded by the pool, not
    by the batch width. Writes go through ``scatter_paged_kv`` in place."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @staticmethod
    def create(
        cfg: ModelConfig, n_pages: int, page_size: int, dtype=torch.bfloat16, device=None,
        n_kv_heads: int | None = None,
    ) -> "PagedKVCache":
        """``n_kv_heads``: a tp shard's (default: the model's)."""
        kv = n_kv_heads or cfg.n_kv_heads
        shape = (cfg.n_layers, n_pages, page_size, kv, cfg.head_dim)
        return PagedKVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )

    def tensors(self) -> list[torch.Tensor]:
        return [self.k, self.v]

    def read_pages(self, ids: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Pages ``ids`` (a device long tensor) gathered into one contiguous
        ``[L, count * page, KV, hd]`` each for k and v: one pair (a mesh
        gives one per tp slice)."""
        n_layers, _, ps, kv, hd = self.k.shape
        ids = ids.to(self.k.device)
        count = ids.shape[0]
        return [
            tuple(p.index_select(1, ids).reshape(n_layers, count * ps, kv, hd) for p in (self.k, self.v))
        ]

    def write_pages(self, ids: torch.Tensor, k: torch.Tensor, v: torch.Tensor, position: int) -> None:
        """Write a prefix ``[L, position, KV, hd]`` (the pools' dtype; a
        pinned host source is copied without waiting) into pages ``ids``.
        The tail of the last page past ``position`` is never read before
        it is written."""
        n_layers, _, ps, kv, hd = self.k.shape
        ids = ids.to(self.k.device)
        count = ids.shape[0]
        for pool, src in ((self.k, k), (self.v, v)):
            tmp = torch.zeros((n_layers, count * ps, kv, hd), dtype=pool.dtype, device=pool.device)
            tmp[:, :position].copy_(src, non_blocking=True)
            pool.index_copy_(1, ids, tmp.view(n_layers, count, ps, kv, hd))

    def copy_page(self, src: int, dst: int) -> None:
        """One page copied, every layer."""
        self.k[:, dst].copy_(self.k[:, src])
        self.v[:, dst].copy_(self.v[:, src])


class MeshCache:
    """The KV arenas (``KVCache``) or pools (``PagedKVCache``) of a mesh's
    shards, shard ``s``'s on its device holding its slice of the unsharded
    ``[L, B, S, KV, hd]``: the kv heads of its tp slice, the slots of its sp
    slice (``parallel/sharding.cache_spec``) and the layers of its pipeline
    stage (``pipeline_cache_spec``); the shards of an ep group hold the
    same slice, as the reference's replicated arena (``pool_spec``: a pool
    splits over tp only). The engine's reads come from one shard per
    (tp, sp, pp) slice, joined into the unsharded layout's order, one
    ``[L, n, KV/tp, hd]`` pair per tp slice; its writes go to every shard,
    each taking its slice of the unsharded ``[L, n, KV, hd]`` source."""

    def __init__(self, shards: list, mesh):
        self.shards = shards
        self.mesh = mesh
        tp, sp, pp = self._tp, self._sp, self._pp = mesh.shape["tp"], mesh.shape["sp"], mesh.shape["pp"]
        # the readers, [tp][pp][sp] → shard (first_of orders them by tp, sp, pp)
        firsts = mesh.first_of(("tp", "sp", "pp"))
        self._grid = [[[firsts[(t * sp + j) * pp + p] for j in range(sp)] for p in range(pp)] for t in range(tp)]

    @staticmethod
    def create(mesh, make) -> "MeshCache":
        """``make(device)`` builds one shard's cache, with the kv heads of a
        tp slice, the slots of an sp slice and the layers of a stage."""
        return MeshCache([make(d) for d in mesh.device_list], mesh)

    def at_rows(self, rows: torch.Tensor) -> "MeshCache":
        return MeshCache(
            [c.at_rows(rows.to(c.k_store.device)) for c in self.shards], self.mesh
        )

    def tensors(self) -> list[torch.Tensor]:
        return [t for c in self.shards for t in c.tensors()]

    def _slots(self, shard: int, n: int) -> tuple[int, int]:
        """Of the first ``n`` slots, the range ``[lo, hi)`` shard ``shard``
        holds (its own slots ``[0, hi - lo)``)."""
        if self._sp == 1:
            return 0, n
        s_loc = self.shards[shard].max_seq
        lo = self.mesh.index("sp", shard) * s_loc
        return lo, max(lo, min(n, lo + s_loc))

    def _count(self, shard: int, n: int) -> int:
        lo, hi = self._slots(shard, n)
        return hi - lo

    def _part(self, x: torch.Tensor, shard: int, n: int | None = None) -> torch.Tensor:
        """Shard ``shard``'s slice of an unsharded ``[L, n, KV, hd]`` source:
        its tp slice of the kv heads, its stage's layers and (with ``n``)
        its sp slice of the first ``n`` slots; contiguous where it cuts (a
        pinned host source stays pinned)."""
        part = x
        if self._tp > 1:
            k = x.shape[-2] // self._tp
            part = part.narrow(-2, self.mesh.index("tp", shard) * k, k)
        if self._pp > 1:
            per = x.shape[0] // self._pp
            part = part.narrow(0, self.mesh.index("pp", shard) * per, per)
        if n is not None and self._sp > 1:
            lo, hi = self._slots(shard, n)
            part = part.narrow(1, lo, hi - lo)
        if part is x or part.is_contiguous():
            return part
        if x.device.type == "cpu" and x.is_pinned():
            return torch.empty(part.shape, dtype=part.dtype, pin_memory=True).copy_(part)
        return part.contiguous()

    @staticmethod
    def _join(pieces: list) -> tuple[torch.Tensor, torch.Tensor]:
        """(k, v) pieces ``[pp][sp]`` of one tp slice as one pair: slots
        joined along axis 1, layers along axis 0 (views where one piece)."""
        return tuple(
            unshard_layers([unshard_slots([kv[i] for kv in stage]) for stage in pieces]) for i in (0, 1)
        )

    def read_prefix(self, row: int, n: int):
        return [
            self._join([[self.shards[s].read_prefix(row, self._count(s, n))[0] for s in stage]
                        for stage in by_pp])
            for by_pp in self._grid
        ]

    def write_prefix(self, row: int, k: torch.Tensor, v: torch.Tensor) -> None:
        n = k.shape[1]
        for s, c in enumerate(self.shards):
            kp = self._part(k, s, n)
            if kp.shape[1]:
                c.write_prefix(row, kp, self._part(v, s, n))

    def clone_prefix(self, row: int, n: int):
        return [c.clone_prefix(row, self._count(s, n)) for s, c in enumerate(self.shards)]

    def fork_prefix(self, row: int, saved) -> None:
        for c, part in zip(self.shards, saved):
            c.fork_prefix(row, part)

    def read_pages(self, ids: torch.Tensor):
        return [p for by_pp in self._grid for p in self.shards[by_pp[0][0]].read_pages(ids)]

    def write_pages(self, ids: torch.Tensor, k: torch.Tensor, v: torch.Tensor, position: int) -> None:
        for s, c in enumerate(self.shards):
            c.write_pages(ids, self._part(k, s), self._part(v, s), position)

    def copy_page(self, src: int, dst: int) -> None:
        for c in self.shards:
            c.copy_page(src, dst)


def init_params(
    cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16, device=None
) -> dict:
    """Random init (normal, 0.02 scale) from an explicit generator, filled
    one ``[K, N]`` slice at a time (a layer's, or a layer's expert's) so the
    f32 staging stays one slice big. Checkpoint loading maps onto the same
    tree. An MoE config has the reference's leaves: ``router [L, D, E]``
    and the expert stacks ``w_gate``/``w_up [L, E, D, F]``, ``w_down [L,
    E, F, D]``."""
    d, hd = cfg.dim, cfg.head_dim
    L = cfg.n_layers

    def w(*shape, scale=0.02):
        out = torch.empty(shape, dtype=dtype, device=device)
        for sl in out.view(-1, *shape[-2:]):
            sl.copy_(
                torch.randn(sl.shape, generator=generator, dtype=torch.float32, device=device)
                * scale
            )
        return out

    layers = {
        "attn_norm": torch.ones((L, d), dtype=dtype, device=device),
        "wq": w(L, d, cfg.n_heads * hd),
        "wk": w(L, d, cfg.n_kv_heads * hd),
        "wv": w(L, d, cfg.n_kv_heads * hd),
        "wo": w(L, cfg.n_heads * hd, d),
        "mlp_norm": torch.ones((L, d), dtype=dtype, device=device),
    }
    if cfg.is_moe:
        e = cfg.n_experts
        layers.update(
            {
                "router": w(L, d, e),
                "w_gate": w(L, e, d, cfg.ffn_dim),
                "w_up": w(L, e, d, cfg.ffn_dim),
                "w_down": w(L, e, cfg.ffn_dim, d),
            }
        )
    else:
        layers.update(
            {
                "w_gate": w(L, d, cfg.ffn_dim),
                "w_up": w(L, d, cfg.ffn_dim),
                "w_down": w(L, cfg.ffn_dim, d),
            }
        )
    return {
        "embed": w(cfg.vocab_size, d),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": w(d, cfg.vocab_size),
    }


def _mlp(x: torch.Tensor, lp: dict) -> torch.Tensor:
    """SwiGLU."""
    gate = F.silu(qmatmul(x, lp["w_gate"]))
    return qmatmul(gate * qmatmul(x, lp["w_up"]), lp["w_down"])


def _router_logits(x: torch.Tensor, router) -> torch.Tensor:
    """The router's product in x's dtype: ``x @ dequant(router)``, as XLA
    computes it for the reference (which dequantizes the layer's leaves,
    then multiplies). Its own route, not ``qmatmul``: the router's N is the
    expert count (8 for Mixtral: 8-byte int8 rows, below the 16 bytes a TMA
    row needs), and dequantizing it writes E·D values a layer."""
    return x @ dequant(router).to(x.dtype)


def _top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest, descending, and the lower index first
    among equal values (``torch.topk`` promises no order among ties, which
    synthetic int8 routers with one scale make common in bf16)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: ``[..., n]``, and an index outside [0, n) gives an
    all-zero row (the routed path's drop rule relies on it)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _moe_mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig, base: int = 0) -> torch.Tensor:
    """Dense-einsum MoE (the reference's single-chip default): top-k
    routing, every expert computed for every token, masked combine. The
    expert products run expert-major, ``[E, N, F]``, each stack in one
    ``qmatmul_experts`` call (gate and up from the shared x, down from each
    expert's own input). ``base``: ``lp`` holds the experts ``[base, base +
    E_loc)`` of the full set the router scores, and only their share of the
    combine is kept (the reference's ``parallel/expert._moe_local``); 0 on
    one device."""
    b, t, d = x.shape
    w_gate = lp["w_gate"]
    e = (w_gate.q if isinstance(w_gate, QTensor) else w_gate).shape[0]
    logits = _router_logits(x, lp["router"])  # [B, T, E]
    weights, chosen = _top_k(logits, cfg.experts_per_token)
    weights = torch.softmax(weights.float(), dim=-1).to(x.dtype)
    combine = (weights[..., None] * _one_hot(chosen - base, e, x.dtype)).sum(-2)  # [B, T, E_loc]
    xf = x.reshape(b * t, d)
    gate = F.silu(qmatmul_experts(xf, lp["w_gate"]))  # [E, N, F]
    up = qmatmul_experts(xf, lp["w_up"])
    expert_out = qmatmul_experts(gate * up, lp["w_down"])  # [E, N, D]
    out = torch.einsum("end,ne->nd", expert_out, combine.reshape(b * t, e))
    return out.reshape(b, t, d)


# token counts at or below this run routed MoE with cap = n (dropless) even
# for prefill-shaped (t > 1) calls; decode calls (t == 1) are always
# dropless, whatever max_batch is (the reference's gate)
_DROPLESS_MAX_N = 64


def routed_capacity(n_tokens: int, n_experts: int, k: int, capacity_factor: float) -> int:
    """Static per-expert dispatch-buffer size: ``capacity_factor`` × the
    balanced share (n·k/E), clamped to n (top-k choices are distinct, so a
    token takes at most one slot per expert and C = n is dropless)."""
    return max(1, min(n_tokens, math.ceil(n_tokens * k / n_experts * capacity_factor)))


def _moe_mlp_routed(
    x: torch.Tensor,
    lp: dict,
    cfg: ModelConfig,
    *,
    capacity_factor: float = 2.0,
    base: int = 0,
) -> torch.Tensor:
    """Top-k token-dispatch MoE, the reference's GShard one-hot form:
    static shapes, dispatch and combine as products, no gather, scatter or
    host sync. Each expert computes only its dispatched tokens, up to its
    capacity; a token past an expert's capacity loses that expert's
    contribution. Decode-shaped calls (t == 1) and calls of at most
    ``_DROPLESS_MAX_N`` tokens run dropless (cap = n), so a parked lane's
    token never takes a real one's slot.

    ``base``: ``lp`` holds the experts ``[base, base + E_loc)`` of the full
    set the router scores, and choices outside it one-hot to zero rows —
    the expert-parallel wrapper's contract (``parallel/expert.py`` of the
    reference); 0 on one device."""
    b, t, d = x.shape
    w_gate = lp["w_gate"]
    e_loc = (w_gate.q if isinstance(w_gate, QTensor) else w_gate).shape[0]
    n, k = b * t, cfg.experts_per_token
    if t == 1 or n <= _DROPLESS_MAX_N:
        cap = n
    else:
        cap = routed_capacity(n, cfg.n_experts, k, capacity_factor)
    xf = x.reshape(n, d)
    logits = _router_logits(xf, lp["router"])  # [N, E], the full expert set
    weights, chosen = _top_k(logits, k)
    weights = torch.softmax(weights.float(), dim=-1).to(x.dtype)
    local = (chosen - base).reshape(n * k)
    oh = _one_hot(local, e_loc, torch.float32)  # [S, E_loc]
    # an assignment's slot in its expert's buffer: how many earlier
    # assignments chose that expert (f32 cumsum, exact here); a slot >= cap
    # one-hots to zero and the token drops
    slot = ((torch.cumsum(oh, dim=0) - 1.0) * oh).to(torch.int32)
    disp = (oh[:, :, None] * _one_hot(slot, cap, torch.float32)).reshape(n, k, e_loc, cap)
    # a token's k choices are distinct experts: at most one nonzero per
    # (token, expert) after the sum over k
    disp_tok = disp.sum(1).to(x.dtype)  # [N, E_loc, C]
    combine_tok = (disp * weights[..., None, None]).sum(1).to(x.dtype)
    xe = torch.einsum("nd,nec->ecd", xf, disp_tok)  # [E_loc, C, D]
    gate = F.silu(qmatmul_experts(xe, w_gate))
    up = qmatmul_experts(xe, lp["w_up"])
    out_buf = qmatmul_experts(gate * up, lp["w_down"])  # [E_loc, C, D]
    out = torch.einsum("ecd,nec->nd", out_buf, combine_tok)  # weighted scatter
    return out.reshape(b, t, d)


def _qkv(x, lp, cfg, positions, n_heads, n_kv_heads):
    """The attention sublayer's queries, keys and values after RoPE, over
    ``n_heads`` query heads and ``n_kv_heads`` kv heads: the model's, or one
    tp shard's (its wq/wk/wv columns)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = qmatmul(h, lp["wq"]).reshape(b, t, n_heads, hd)
    k = qmatmul(h, lp["wk"]).reshape(b, t, n_kv_heads, hd)
    v = qmatmul(h, lp["wv"]).reshape(b, t, n_kv_heads, hd)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _causal(q, k, v, mask, use_flash, attn_impl) -> torch.Tensor:
    """Causal self-attention without a cache: ``attn_impl(q, k, v)`` when
    given (the training step passes ops/attention.trainable_causal_attention:
    kernel forward, plain backward), else the kernel or the plain version."""
    if attn_impl is not None:
        return attn_impl(q, k, v)
    if use_flash:
        return flash_attention(q, k, v, causal=True)
    return attention_reference(q, k, v, mask=mask)


def _embed_shard(embed, tokens: torch.Tensor, lo: int) -> torch.Tensor:
    """A vocab shard's part of the embedding: the rows it holds, zeros for
    tokens outside ``[lo, lo + rows)`` (summed over tp or pp, every token's
    row comes from exactly one shard)."""
    rows = (embed.q if isinstance(embed, QTensor) else embed).shape[0]
    local = tokens.long() - lo
    mine = (local >= 0) & (local < rows)
    e = embed_lookup(embed, torch.where(mine, local, torch.zeros_like(local)))
    return torch.where(mine[..., None], e, torch.zeros_like(e))


def forward(
    params: dict | list[dict],
    cfg: ModelConfig,
    tokens,  # [B, T] int, or over a mesh without a cache one [B', T'] per shard
    positions,  # [B, T] int, likewise
    cache: KVCache | PagedKVCache | MeshCache | None = None,
    use_flash: bool = True,
    block_table: torch.Tensor | None = None,  # [B, n_blocks] int
    last_index: torch.Tensor | None = None,  # [B] int
    moe_impl=None,
    attn_impl=None,
    mesh=None,
    local_logits: bool = False,
    seq_attn_impl=None,
):
    """Returns logits [B, T, V] in f32; with ``last_index`` only row
    ``last_index[b]`` of each sequence goes through the final norm and
    ``lm_head``, and the logits are [B, 1, V] (a prefill chunk needs its last
    real token's only).

    With a cache: serves prefill (T = prompt chunk) and decode (T = 1) with
    per-sequence positions, writing K/V into ``cache`` IN PLACE (the
    reference returns an updated cache from donated buffers). With
    ``block_table`` the cache is a :class:`PagedKVCache` and every KV read
    and write goes through the table. Without a cache: pure causal
    self-attention, through ``attn_impl(q, k, v)`` when given (the training
    step's differentiable attention). ``use_flash=False`` takes the plain
    attention path even where the kernels would run. An MoE config runs
    ``_moe_mlp`` in each layer, or ``moe_impl(h, lp)`` when given (the
    engine's routed MoE).

    With ``mesh``: ``params`` is ``parallel/sharding.shard_params``' list,
    ``cache`` a ``MeshCache``, ``moe_impl(hs, lps)`` is required for an MoE
    config over tp or ep (``parallel/expert.py``), and the logits land on
    the first shard's device. One device runs the same loop as one shard,
    its collectives no-ops. A mesh of sp > 1 holds each row's slots split
    over sp (``parallel/flash_mesh.py`` joins the shards' attention). A mesh
    of pp > 1 runs each layer on its stage's shards alone (layer ``l`` on
    stage ``l // (L/pp)``; serving: one shard a stage, against the stage's
    arena), the activation handed to the next stage at a boundary; its
    vocabulary is sharded over pp as tp's is over tp, and the last stage's
    hidden state is broadcast to every stage for its ``lm_head`` columns
    (``parallel/pipeline.py``).

    Over a mesh without a cache (training, ``train.py``): ``tokens`` and
    ``positions`` may be one tensor per shard (``parallel/sharding.shard_batch``:
    each shard its dp rows and its sp block, at their global positions).
    ``attn_impl(q, k, v)`` runs on each shard's heads and rows, as on one
    device. Over sp > 1 such a split needs ``seq_attn_impl(qs, ks, vs)``,
    the mesh's attention over every shard's list (``ring_attention``,
    ``ulysses``, ``flash_mesh.make_gathered_causal_attention``). pp then
    composes with dp and tp: a stage is the shards of one pp index.
    ``local_logits``: the shards' logits before the vocab gather, each its
    vocab slice, for a vocab-parallel loss; otherwise the whole batch's
    logits, joined over dp and sp."""
    pp = 1 if mesh is None else mesh.shape["pp"]
    split = isinstance(tokens, list)
    if mesh is None:
        shards, caches, devs, tp = [params], [cache], [tokens.device], 1

        def reduce(parts, axis="tp", on=None):
            return parts

        def moe(hs, lps, on):
            return [moe_impl(hs[0], lps[0]) if moe_impl is not None else _moe_mlp(hs[0], lps[0], cfg)]

        def gather(parts, axis):
            return parts
    else:
        if pp > 1:
            if cache is not None and mesh.size != pp:
                raise ValueError(f"{mesh}: serve-time pp composes with no other axis and needs its staged arena")
            if cache is None and (mesh.shape["sp"] > 1 or mesh.shape["ep"] > 1):
                raise ValueError(f"{mesh}: pipeline parallelism does not compose with sp or ep")
            check_stages(cfg, pp)
        elif cfg.is_moe and moe_impl is None:
            raise ValueError("a meshed MoE forward needs moe_impl (parallel/expert.py)")
        shards, caches, devs, tp = params, cache.shards if cache is not None else [None] * mesh.size, \
            mesh.device_list, mesh.shape["tp"]

        def reduce(parts, axis="tp", on=None):
            return all_reduce(parts, mesh, axis, shards=on)

        def moe(hs, lps, on):
            # a stage runs the dense-einsum MoE of its layers, widths over tp
            if pp == 1:
                return moe_impl(hs, lps)
            return reduce([_moe_mlp(h, lp, cfg) for h, lp in zip(hs, lps)], "tp", on)

        def gather(parts, axis):
            return all_gather(parts, mesh, axis, dim=-1)
    n = len(shards)
    heads, kv_heads = cfg.n_heads // tp, cfg.n_kv_heads // tp

    def each(x):
        return [None if x is None else x.to(d, non_blocking=True) for d in devs]

    if split:
        toks = [x.to(d, non_blocking=True) for x, d in zip(tokens, devs)]
        pos = [x.to(d, non_blocking=True) for x, d in zip(positions, devs)]
    else:
        toks, pos = each(tokens), each(positions)
    tables = each(block_table)
    b, t = toks[0].shape
    attend = make_meshed_cache_attention(paged=block_table is not None, mesh=mesh)
    if split and mesh.shape["sp"] > 1 and seq_attn_impl is None:
        raise ValueError(f"{mesh}: a sequence-sharded forward needs seq_attn_impl (ring_attention, ulysses)")
    masks = [None] * n
    if cache is None and not use_flash and attn_impl is None and seq_attn_impl is None:
        masks = [causal_mask(t, device=d).expand(b, t, t) for d in devs]
    # the vocabulary splits over tp, or over pp (they do not share it)
    vaxis, n_vocab = ("pp", pp) if pp > 1 else ("tp", tp)
    vocab = cfg.vocab_size // n_vocab
    xs = reduce([
        embed_lookup(shards[s]["embed"], toks[s]) if n_vocab == 1
        else _embed_shard(shards[s]["embed"], toks[s], mesh.index(vaxis, s) * vocab)
        for s in range(n)
    ], vaxis)
    on, per = list(range(n)), cfg.n_layers // pp  # the shards a layer runs on; layers a stage
    for layer in range(cfg.n_layers):
        stage, local = divmod(layer, per)
        if pp > 1 and local == 0:
            nxt = [s for s in range(n) if mesh.index("pp", s) == stage]
            xs = [xs[s] for s in nxt] if stage == 0 else [handoff(x, mesh, s) for x, s in zip(xs, nxt)]
            on = nxt
        lps = [{k: layer_slice(v, local) for k, v in shards[s]["layers"].items()} for s in on]
        qkv = [_qkv(x, lp, cfg, pos[s], heads, kv_heads) for x, lp, s in zip(xs, lps, on)]
        if cache is not None:
            attn = attend([q for q, _, _ in qkv], [(k, v) for _, k, v in qkv], [caches[s] for s in on], local,
                          [pos[s] for s in on], [tables[s] for s in on], use_kernel=use_flash)
        elif seq_attn_impl is not None:
            attn = seq_attn_impl(*([x[i] for x in qkv] for i in range(3)))
        else:
            attn = [_causal(*qkv[i], masks[s], use_flash, attn_impl) for i, s in enumerate(on)]
        outs = reduce([qmatmul(a.reshape(b, t, heads * cfg.head_dim), lp["wo"]) for a, lp in zip(attn, lps)],
                      "tp", on)
        xs = [x + o for x, o in zip(xs, outs)]
        hs = [rms_norm(x, lp["mlp_norm"], cfg.norm_eps) for x, lp in zip(xs, lps)]
        outs = moe(hs, lps, on) if cfg.is_moe else reduce([_mlp(h, lp) for h, lp in zip(hs, lps)], "tp", on)
        xs = [x + o for x, o in zip(xs, outs)]
    if last_index is not None:
        last = each(last_index)
        xs = [x.gather(1, last[s].long()[:, None, None].expand(-1, 1, x.shape[-1])) for x, s in zip(xs, on)]
    if pp > 1:
        xs = broadcast(xs, mesh, "pp", on)
    logits = [
        qmatmul(rms_norm(xs[s], shards[s]["final_norm"], cfg.norm_eps), shards[s]["lm_head"]).float()
        for s in range(n)
    ]
    if local_logits:
        return logits
    whole = gather(logits, vaxis)
    return unshard_tensor(whole, batch_spec(), mesh) if split else whole[0]


@torch.inference_mode()
def greedy_decode(
    params: dict,
    cfg: ModelConfig,
    prompt: torch.Tensor,  # [B, Tp]
    max_new_tokens: int,
    cache_len: int,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Reference generation loop: prefill, then one-token decode steps.
    Engine-grade batching lives in engine/llm.py; this is the simple path
    used by tests."""
    b, tp = prompt.shape
    dev = prompt.device
    cache = KVCache.create(cfg, b, cache_len, dtype=dtype, device=dev)
    positions = torch.arange(tp, device=dev).expand(b, tp)
    logits = forward(params, cfg, prompt, positions, cache)
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    pos = torch.full((b,), tp, device=dev)
    for _ in range(max_new_tokens - 1):
        logits = forward(params, cfg, tok[:, None], pos[:, None], cache)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)  # [B, max_new_tokens]
