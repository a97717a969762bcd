"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions.

Kernels: in `csrc/ell_spmm.cu`, ell_spmm (GNN aggregation, and the
attention-weighted sum with the weights in the mask lane), ell_spmm_transpose
(its gradient with respect to the rows) and ell_attend_dw (the weighted sum's
gradient with respect to the weights); in `csrc/sddmm.cu`, sddmm (GAT edge
logits) and ell_slot_transpose (the per-slot scalar transpose of its
gradient).  Built with nvcc at first use (`build.py`); dispatched on the
tensor's device (`ops.py`).
"""
