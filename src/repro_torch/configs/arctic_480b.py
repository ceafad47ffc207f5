"""Snowflake Arctic 480B — MoE 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab_size=32000,
    ffn_act="swiglu", norm="rmsnorm", attn_kind="full",
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864,
                  dense_residual=True, dense_d_ff=4864),
    source="hf:Snowflake/snowflake-arctic-base",
)
