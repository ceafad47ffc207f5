"""Paper core: GA-driven automatic offloading to a mixed destination
environment (Yamato 2020), ported to PyTorch on an NVIDIA card."""
