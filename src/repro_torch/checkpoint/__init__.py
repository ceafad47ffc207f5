"""repro_torch.checkpoint — atomic, async checkpoints of nested tensor
dicts; the port of ``repro.checkpoint``."""
