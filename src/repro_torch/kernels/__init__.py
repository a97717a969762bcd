"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions.

Kernels: ell_spmm (GNN aggregation) and ell_spmm_transpose (its gradient).  Built with nvcc at first use
(`build.py`); dispatched on the tensor's device (`ops.py`).
"""
