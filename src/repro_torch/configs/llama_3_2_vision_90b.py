"""Llama 3.2 Vision 90B — decoder backbone with cross-attn image layers
every 5th layer (80 self + 20 cross = 100L). Vision frontend is a stub:
input_specs provides precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=28672, vocab_size=128256,
    ffn_act="swiglu", norm="rmsnorm", attn_kind="full",
    cross_attn_every=4, n_img_tokens=1024,
    source="hf:meta-llama/Llama-3.2-11B-Vision (unverified)",
)
