"""The 10 assigned architectures (exact figures from the brief) + paper nets.

Source tags from the assignment are kept as comments.  Every entry is a
zero-arg factory so importing this module allocates nothing.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def zamba2_2p7b():
    # [hybrid] 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
    # ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242; hf]
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv=32, d_ff=10240, vocab=32000, head_dim=80,
        ssm_state=64, shared_attn_every=6, rope_theta=1e4, ssm_chunk=64,
        supports_long=True, dtype="bfloat16", microbatches=4)


def qwen2_vl_7b():
    # [vlm] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 —
    # M-RoPE, dynamic resolution [arXiv:2409.12191; hf]
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
        n_heads=28, n_kv=4, d_ff=18944, vocab=152064, head_dim=128,
        rope_theta=1e6, rope_sections=(16, 24, 24), tie_embeddings=False,
        dtype="bfloat16")


def whisper_small():
    # [audio] 12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865 —
    # enc-dec, conv frontend (stub) [arXiv:2212.04356]
    return ModelConfig(
        name="whisper-small", family="audio", n_layers=12, d_model=768,
        n_heads=12, n_kv=12, d_ff=3072, vocab=51865, head_dim=64,
        enc_layers=12, enc_len=1500, rope_theta=1e4, act_kind="gelu",
        tie_embeddings=True, dtype="bfloat16")


def qwen3_1p7b():
    # [dense] 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936 —
    # qk_norm, GQA [hf:Qwen/Qwen3-8B]
    return ModelConfig(
        name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
        n_heads=16, n_kv=8, d_ff=6144, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6, dtype="bfloat16")


def mistral_large_123b():
    # [dense] 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768
    # [hf:mistralai/Mistral-Large-Instruct-2407]
    return ModelConfig(
        name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
        n_heads=96, n_kv=8, d_ff=28672, vocab=32768, head_dim=128,
        rope_theta=1e6, tie_embeddings=False, dtype="bfloat16",
        moments_dtype="bfloat16", microbatches=8)


def codeqwen1p5_7b():
    # [dense] 32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416 —
    # qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B]
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv=32, d_ff=13440, vocab=92416, head_dim=128,
        rope_theta=1e6, tie_embeddings=False, dtype="bfloat16",
        kv_quant=True)


def llama3p2_3b():
    # [dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256 —
    # small llama3 [hf:meta-llama/Llama-3.2]
    return ModelConfig(
        name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
        n_heads=24, n_kv=8, d_ff=8192, vocab=128256, head_dim=128,
        rope_theta=5e5, dtype="bfloat16")


def grok1_314b():
    # [moe] 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
    # MoE 8e top-2 [hf:xai-org/grok-1]
    return ModelConfig(
        name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
        n_heads=48, n_kv=8, d_ff=32768, vocab=131072, head_dim=128,
        n_experts=8, top_k=2, rope_theta=1e4, tie_embeddings=False,
        dtype="bfloat16", moments_dtype="bfloat16", microbatches=16,
        moe_token_chunks=8, kv_quant=True)


def qwen3_moe_30b_a3b():
    # [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936,
    # MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B]
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv=4, d_ff=768, vocab=151936, head_dim=128,
        qk_norm=True, n_experts=128, top_k=8, rope_theta=1e6,
        tie_embeddings=False, dtype="bfloat16", microbatches=4)


def rwkv6_7b():
    # [ssm] 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
    # Finch, data-dependent decay [arXiv:2404.05892]
    return ModelConfig(
        name="rwkv6-7b", family="ssm_rwkv", n_layers=32, d_model=4096,
        n_heads=64, n_kv=0, d_ff=14336, vocab=65536, rwkv_head_dim=64,
        supports_long=True, dtype="bfloat16", batch_over_model=True)


# --- the paper's own networks (benchmarks §3) --------------------------------

def paper_mnist():
    """Fully-connected MNIST classifier (paper §3.1); hidden width/depth are
    overridden by the benchmark sweep."""
    return ModelConfig(
        name="paper-mnist", family="paper", n_layers=2, d_model=64,
        n_heads=1, n_kv=1, d_ff=64, vocab=10, act_kind="tanh",
        has_decoder=False)


def paper_autoencoder():
    """Conv + FC auto-encoders (paper §3.2)."""
    return ModelConfig(
        name="paper-autoencoder", family="paper", n_layers=7, d_model=50,
        n_heads=1, n_kv=1, d_ff=50, vocab=0, act_kind="tanh",
        has_decoder=False)


def paper_alexnet():
    """AlexNet-style conv classifier (paper §3.3), scaled for CPU."""
    return ModelConfig(
        name="paper-alexnet", family="paper", n_layers=8, d_model=96,
        n_heads=1, n_kv=1, d_ff=1024, vocab=1000, act_kind="relu6",
        has_decoder=False)


CONFIGS = {
    "zamba2-2.7b": zamba2_2p7b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "whisper-small": whisper_small,
    "qwen3-1.7b": qwen3_1p7b,
    "mistral-large-123b": mistral_large_123b,
    "codeqwen1.5-7b": codeqwen1p5_7b,
    "llama3.2-3b": llama3p2_3b,
    "grok-1-314b": grok1_314b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "rwkv6-7b": rwkv6_7b,
    "paper-mnist": paper_mnist,
    "paper-autoencoder": paper_autoencoder,
    "paper-alexnet": paper_alexnet,
}

ASSIGNED = [n for n in CONFIGS if not n.startswith("paper-")]
