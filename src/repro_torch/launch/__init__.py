"""repro_torch.launch — command-line drivers of the port."""
