"""Architecture configuration for the assigned model zoo.

One frozen dataclass describes every family (dense / GQA / MLA+MoE / SSM /
hybrid / enc-dec / vlm); per-arch modules in ``repro_torch/configs``
instantiate it with the exact public hyper-parameters. It is the
reference's ``ModelConfig`` (``repro.models.config``) field for field.
``input_specs`` gives a dry-run cell's inputs as meta tensors (shape and
dtype, no storage), the port's counterpart of the reference's
``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch


# ---------------------------------------------------------------------------
# shapes assigned to the LM family (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------
SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False
    gated_mlp: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden
    moe_num_shared: int = 0         # shared (always-on) experts
    moe_dense_ff: int = 0           # parallel dense residual FFN (arctic)
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 2048      # dispatch group along sequence

    # MLA (deepseek)
    mla_kv_lora: int = 0
    mla_rope_dim: int = 64

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid (recurrentgemma): layer pattern, local-attention window
    hybrid_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    attn_window: int = 0                    # 0 = global attention
    rnn_width: int = 0                      # RG-LRU recurrence width

    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500                     # precomputed audio frames (stub)

    # vlm
    num_prefix_tokens: int = 0              # precomputed patch embeds (stub)

    # numerics / memory policy
    dtype: str = "bfloat16"                 # compute/activation dtype
    param_dtype: str = "float32"            # master params
    remat: str = "full"                     # none | full (per layer)
    unroll_segments: bool = False           # python-loop layers (accurate HLO
                                            # cost analysis: scan bodies are
                                            # counted once by XLA)
    loss_chunk: int = 0                     # >0: compute CE over sequence
                                            # chunks (never materialize the
                                            # full [B,S,V] logits tensor)
    gqa_grouped: bool = False               # baseline-only: grouped (G, rep)
                                            # attention layout (unshardable
                                            # when G < model-axis; kept for
                                            # §Perf before/after runs)
    moe_combine_f32: bool = False           # baseline-only: fp32 combine
                                            # tensor (2x MoE activation bytes)
    attn_probs_bf16: bool = False           # §Perf iter 4: bf16 softmax
                                            # probabilities (fp32 row stats /
                                            # accumulators stay) — halves the
                                            # attention-chain bytes
    blockwise_q: int = 1024                 # flash-style q-chunk for long seq
    blockwise_kv: int = 1024

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded for lane alignment + 16-way TP divisibility."""
        return _round_up(self.vocab_size, 128)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state => eligible for long_500k."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an AR decoder (whisper: dec side)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        H, G = self.num_heads, self.num_kv_heads
        hd = self.resolved_head_dim
        per_layer = 0
        if self.family == "ssm":
            d_in = self.ssm_expand * D
            nh = d_in // self.ssm_head_dim
            # in_proj (z,x,B,C,dt) + conv + out_proj
            per_layer = D * (2 * d_in + 2 * self.ssm_state + nh) \
                + self.ssm_conv * (d_in + 2 * self.ssm_state) \
                + d_in * D + 2 * D
        else:
            if self.mla_kv_lora:
                qd = H * (hd + self.mla_rope_dim)
                per_layer += D * qd
                per_layer += D * (self.mla_kv_lora + self.mla_rope_dim)
                per_layer += self.mla_kv_lora * (2 * H * hd)
                per_layer += H * hd * D
            else:
                per_layer += D * (H + 2 * G) * hd + H * hd * D
                if self.qkv_bias:
                    per_layer += (H + 2 * G) * hd
            if self.moe_num_experts:
                per_layer += D * self.moe_num_experts
                e_ff = self.moe_d_ff
                mult = 3 if self.gated_mlp else 2
                per_layer += self.moe_num_experts * mult * D * e_ff
                per_layer += self.moe_num_shared * mult * D * e_ff
                if self.moe_dense_ff:
                    per_layer += mult * D * self.moe_dense_ff
            elif F:
                per_layer += (3 if self.gated_mlp else 2) * D * F
            per_layer += 2 * D  # norms
        total = self.num_layers * per_layer
        if self.family == "hybrid":
            # recurrent layers replace attention with RG-LRU width-d_rnn
            n_rec = sum(1 for _ in range(self.num_layers)
                        if self.layer_kind(_) == "rec")
            d_rnn = self.rnn_width or D
            attn_cost = D * (H + 2 * G) * hd + H * hd * D
            rec_cost = 2 * D * d_rnn + 2 * d_rnn + d_rnn * D + 2 * d_rnn * self.ssm_conv
            total += n_rec * (rec_cost - attn_cost)
        total += V * D  # embeddings
        if not self.tie_embeddings:
            total += V * D
        if self.enc_layers:
            enc_per = D * 4 * hd * H // H  # rough: qkv+o
            enc_per = 4 * D * H * hd + (2 if not self.gated_mlp else 3) * D * F + 2 * D
            total += self.enc_layers * (enc_per + D * H * hd)  # + cross-kv
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if not self.moe_num_experts:
            return self.param_count()
        full = self.param_count()
        mult = 3 if self.gated_mlp else 2
        routed_all = self.num_layers * self.moe_num_experts * mult * self.d_model * self.moe_d_ff
        routed_act = self.num_layers * self.moe_top_k * mult * self.d_model * self.moe_d_ff
        return int(full - routed_all + routed_act)

    def layer_kind(self, i: int) -> str:
        """Temporal-mixing kind of layer i ('attn' | 'rec' | 'ssm')."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.hybrid_pattern:
            return self.hybrid_pattern[i % len(self.hybrid_pattern)]
        return "attn"

    def shape_skips(self) -> dict[str, str]:
        """Map of shape-name -> reason, for cells this arch does not run."""
        skips = {}
        if not self.supports_long_context:
            skips["long_500k"] = (
                "full quadratic attention; 500k decode needs sub-quadratic "
                "state (see DESIGN.md §Arch-applicability)"
            )
        return skips

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# dry-run input specs (meta tensors only: nothing is allocated)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Model inputs for a (config, shape) cell as meta tensors, the
    reference's ``input_specs`` leaf for leaf: ``tokens`` (and a train
    cell's ``targets``) int32, an enc-dec model's ``enc_embeds`` and a VLM's
    ``prefix_embeds`` in the compute dtype; a decode cell's ``tokens`` (B,
    1), ``positions`` (B,) and the ``cache`` of ``cache.cache_specs``."""
    sh = SHAPES[shape_name]
    return cell_inputs(cfg, sh["kind"], sh["batch"], sh["seq"])


def cell_inputs(cfg: ModelConfig, kind: str, B: int, S: int) -> dict:
    """:func:`input_specs` of a ``kind`` ("train", "prefill" or "decode")
    cell of batch B and sequence (or decode cache) S."""
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind in ("train", "prefill"):
        spec = {"tokens": meta((B, S), torch.int32)}
        if kind == "train":
            spec["targets"] = meta((B, S), torch.int32)
        if cfg.family == "encdec":
            spec["enc_embeds"] = meta((B, cfg.enc_seq, cfg.d_model), act)
        if cfg.family == "vlm":
            spec["prefix_embeds"] = meta((B, cfg.num_prefix_tokens, cfg.d_model), act)
        return spec

    # decode: one new token against a cache of size S
    from .cache import cache_specs  # the cache module imports nothing of this one's users

    return {"tokens": meta((B, 1), torch.int32),
            "positions": meta((B,), torch.int32),
            "cache": cache_specs(cfg, batch=B, max_seq=S)}
