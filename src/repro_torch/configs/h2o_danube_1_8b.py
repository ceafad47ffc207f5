"""H2O Danube 1.8B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_head=80,
    d_ff=6912, vocab_size=32000,
    ffn_act="swiglu", norm="rmsnorm", attn_kind="swa", window=4096,
    source="arXiv:2401.16818",
)
