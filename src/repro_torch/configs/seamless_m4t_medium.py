"""SeamlessM4T medium — enc-dec transformer backbone (12L enc + 12L dec);
audio frontend is a stub: input_specs provides precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab_size=256206,
    ffn_act="gelu", norm="layernorm", attn_kind="full", use_bias=True,
    encoder_layers=12, n_frames=3072,
    source="arXiv:2308.11596",
)
