"""Hand-written CUDA kernels (csrc/) for Hopper, each beside its plain
torch version, plus the torch oracles (ref.py) and the ops that compose
them."""
