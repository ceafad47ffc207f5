"""PyTorch port of the mixed-destination automatic offloading planner.

A second package beside the JAX reference (``src/repro``): the paper's
planner, its three apps and the FPGA-analogue destination, whose kernels
are hand-written CUDA for Hopper (``csrc/``).  Entry points run on the card
unless the caller names another device.
"""
