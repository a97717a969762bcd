"""The kernel API the rest of the port calls (the counterpart of
`repro/kernels/ops.py`).

`repro` picks Pallas or its jnp oracle from the default backend.  Here each
wrapper dispatches on the device of the tensors it is given: the plain
PyTorch version for CPU tensors, the hand-written kernel for CUDA tensors,
never the plain version for a CUDA tensor.
"""
from repro_torch.kernels.ell_spmm import (
    ell_attend,
    ell_attend_dw,
    ell_spmm,
    ell_spmm_transpose,
    ell_transpose_plan,
)
from repro_torch.kernels.sddmm import (
    ell_slot_gather,
    ell_slot_transpose,
    sddmm,
    sddmm_ell,
)

__all__ = ["ell_attend", "ell_attend_dw", "ell_slot_gather",
           "ell_slot_transpose", "ell_spmm", "ell_spmm_transpose",
           "ell_transpose_plan", "sddmm", "sddmm_ell"]
