"""Moonshot/Moonlight 16B-A3B — MoE 64 experts top-6, 2 shared experts.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab_size=163840,
    ffn_act="swiglu", norm="rmsnorm", attn_kind="full",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, shared_experts=2),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
