"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions.

Kernels: ell_spmm (GNN aggregation).  Built with nvcc at first use
(`build.py`); dispatched on the tensor's device (`ops.py`).
"""
