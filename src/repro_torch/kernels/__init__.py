"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions.

Kernels: in `csrc/ell_spmm.cu`, ell_spmm (GNN aggregation, and the
attention-weighted sum with the weights in the mask lane), ell_spmm_transpose
(its gradient with respect to the rows) and ell_attend_dw (the weighted sum's
gradient with respect to the weights); in `csrc/sddmm.cu`, sddmm (GAT edge
logits) and ell_slot_transpose (the per-slot scalar transpose of its
gradient); in `csrc/flash_attention.cu`, flash_attention (softmax
attention forward, causal or not, fp32 and bf16, with an optional
log-sum-exp output), and in `csrc/flash_attention_bwd.cu` its backward's
two passes (flash_attention_bwd_dq, flash_attention_bwd_dkdv); in
`csrc/wkv_chunk.cu`, wkv (the chunked RWKV6 WKV forward; `wkv_with_state`
also returns the final state) and wkv_bwd (its gradient).  The two
forward wrappers are differentiable through the backward kernels.  Built with nvcc at first use
(`build.py`); dispatched on the tensor's device (`ops.py`).
"""
