"""dgraph_tpu_torch: the PyTorch and CUDA port of dgraph_tpu for NVIDIA
Hopper (H100).

The package stands alone: it imports torch and numpy, never jax and
nothing of `dgraph_tpu`. Where it needs numpy code that lives in a JAX
module of the reference package it keeps its own copy.

Ported so far: the batched BFS traversal plane (`ops.bitgraph`), with
the gather-OR step as a hand-written CUDA kernel (`ops.kernels`,
`csrc/bucket_or.cu`), and its benchmark (`bench.bfs`).

Entry points run on `cuda:0` unless the caller passes `device="cpu"`;
see `backend.resolve_device`.
"""
