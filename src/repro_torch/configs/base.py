"""ModelConfig: one dataclass describing every architecture in the pool
(the port's copy of ``repro/configs/base.py``)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.quantizer import WeightQuantConfig

FAMILIES = ("dense", "moe", "vlm", "audio", "ssm_rwkv", "hybrid", "paper")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # see FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 → d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    rope_sections: tuple = ()     # M-RoPE (vlm)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity: float = 1.25
    moe_token_chunks: int = 1
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    shared_attn_every: int = 6    # zamba: shared block cadence
    rwkv_head_dim: int = 64
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_len: int = 0
    # paper technique (defaults: continuous baseline; flip for quant runs)
    act_kind: str = "silu"
    act_levels: int = 0
    wq: WeightQuantConfig = dataclasses.field(default_factory=WeightQuantConfig)
    # numerics / structure
    dtype: str = "float32"
    remat: bool = True
    tie_embeddings: bool = True
    window: int = 0               # sliding-window attention (0 = full)
    long_window: int = 8192       # window used for the long_500k cell (hybrid)
    vocab_pad: int = 256
    kv_block: int = 1024          # flash attention KV chunk
    kv_quant: bool = False        # int8 KV cache (serving)
    fsdp: bool = True
    batch_over_model: bool = False
    # capability flags
    supports_long: bool = False
    has_decoder: bool = True
    moments_dtype: str = "float32"
    scan_unroll: bool = False
    microbatches: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.vocab_pad) * self.vocab_pad

    def shapes(self):
        """The assigned shape cells that apply to this architecture."""
        out = ["train_4k", "prefill_32k"]
        if self.has_decoder:
            out.append("decode_32k")
            if self.supports_long:
                out.append("long_500k")
        return out

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def quantized(self, levels: int = 32, n_weights: int = 1000,
                  method: str = "laplacian_l1") -> "ModelConfig":
        """The paper's working point: |A|=32, |W|=1000."""
        return self.replace(act_levels=levels,
                            wq=WeightQuantConfig(num_weights=n_weights,
                                                 method=method))

    def reduced(self) -> "ModelConfig":
        """CPU-smoke-size config of the same family."""
        kw = dict(
            n_layers=4 if self.family == "hybrid" else min(self.n_layers, 2),
            shared_attn_every=2,
            d_model=128, d_ff=256, vocab=512,
            n_heads=4, n_kv=min(self.n_kv, 4) if self.n_kv else 0,
            head_dim=32, enc_len=min(self.enc_len, 16),
            enc_layers=min(self.enc_layers, 2),
            ssm_head_dim=32, rwkv_head_dim=32, ssm_chunk=16,
            kv_block=64, window=min(self.window, 64) if self.window else 0,
            long_window=64, dtype="float32", microbatches=1, moe_token_chunks=1,
        )
        if self.n_experts:
            kw.update(n_experts=min(self.n_experts, 8), top_k=min(self.top_k, 2))
        if self.rope_sections:
            kw.update(rope_sections=(4, 6, 6))  # sums to head_dim/2 = 16
        return self.replace(**kw)
