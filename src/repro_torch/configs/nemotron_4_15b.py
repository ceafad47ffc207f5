"""NVIDIA Nemotron-4 15B — GQA, squared-ReLU (non-gated) FFN.
[arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab_size=256000,
    ffn_act="relu2", norm="layernorm", attn_kind="full",
    source="arXiv:2402.16819 (unverified)",
)
