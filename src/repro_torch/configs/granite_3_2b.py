"""IBM Granite 3.0 2B base — dense GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab_size=49155,
    ffn_act="swiglu", norm="rmsnorm", attn_kind="full",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
