"""Mamba-2 1.3B — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_head=64,
    d_ff=0, vocab_size=50280,
    ffn_act="gelu", norm="rmsnorm", attn_kind="none",
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1,
                  conv_kernel=4, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060 (unverified)",
)
