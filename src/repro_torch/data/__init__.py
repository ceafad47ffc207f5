"""repro_torch.data — the synthetic token pipeline; the port of
``repro.data``."""
