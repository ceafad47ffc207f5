"""repro_torch.models — the LM's dense family (layers, LM, weight
conversion from the JAX package's parameter tree)."""
