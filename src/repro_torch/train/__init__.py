"""repro_torch.train — the training step, AdamW and int8 gradient
compression; the port of ``repro.train``."""
