"""RecurrentGemma 2B — RG-LRU + local attention, 2:1 pattern (Griffin).
[arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig, HybridConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab_size=256000,
    ffn_act="geglu", norm="rmsnorm", attn_kind="local", window=2048,
    hybrid=HybridConfig(pattern=("recurrent", "recurrent", "local_attn"),
                        lru_width=2560, conv_kernel=4),
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
