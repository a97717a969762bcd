"""The kernel API the rest of the port calls (the counterpart of
`repro/kernels/ops.py`).

`repro` picks Pallas or its jnp oracle from the default backend.  Here each
wrapper dispatches on the device of the tensors it is given: the plain
PyTorch version for CPU tensors, the hand-written kernel for CUDA tensors,
never the plain version for a CUDA tensor.  `flash_attention` and `wkv`
take the reference's signature without `force_pallas`; `wkv` clips g to
[-1.2, 0] on both paths, and `wkv_with_state` also returns the final state
(the prefill's, for decode).  All three are differentiable: on the card
their gradients are the backward kernels (`flash_attention_bwd`,
`wkv_bwd`), on the CPU autograd through the plain versions.
"""
from repro_torch.kernels.ell_spmm import (
    ell_attend,
    ell_attend_dw,
    ell_spmm,
    ell_spmm_transpose,
    ell_transpose_plan,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_with_lse,
)
from repro_torch.kernels.sddmm import (
    ell_slot_gather,
    ell_slot_transpose,
    sddmm,
    sddmm_ell,
)
from repro_torch.kernels.wkv_chunk import wkv, wkv_bwd, wkv_with_state

__all__ = ["ell_attend", "ell_attend_dw", "ell_slot_gather",
           "ell_slot_transpose", "ell_spmm", "ell_spmm_transpose",
           "ell_transpose_plan", "flash_attention", "flash_attention_bwd",
           "flash_attention_with_lse", "sddmm", "sddmm_ell", "wkv", "wkv_bwd",
           "wkv_with_state"]
