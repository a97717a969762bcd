"""PyTorch + CUDA port of the distributed GNN engine, one slice at a time.

Each module sits at the same path as its counterpart in the JAX package
(`repro`), which stays the reference the port is held against.  The port
imports `torch` and `numpy` only; it keeps its own copies of the host-side
code it needs.

Ported so far: the layer-wise full-graph GCN inference sweep
(`core.engine.DistGNNEngine.infer_full_graph`, driven by
`launch.serve_gnn`) on one card, whose neighbor aggregation runs through the
hand-written CUDA ELL-SpMM kernel (`kernels/csrc/ell_spmm.cu`).
"""
