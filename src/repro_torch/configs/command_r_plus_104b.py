"""Cohere Command R+ 104B — dense GQA, no-bias, 256k vocab.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=33792, vocab_size=256000,
    ffn_act="swiglu", norm="rmsnorm", attn_kind="full", use_bias=False,
    source="hf:CohereForAI/c4ai-command-r-v01 (unverified)",
)
