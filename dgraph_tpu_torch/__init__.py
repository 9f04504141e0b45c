"""dgraph_tpu_torch: the PyTorch and CUDA port of dgraph_tpu for NVIDIA
Hopper (H100).

The package stands alone: it imports torch and numpy, never jax and
nothing of `dgraph_tpu`. Where it needs numpy code that lives in a JAX
module of the reference package it keeps its own copy.

Ported so far:
- the batched BFS traversal plane (`ops.bitgraph`), with the gather-OR
  step as a hand-written CUDA kernel (`ops.kernels.bucket_or`,
  `csrc/bucket_or.cu`), and its benchmark (`bench.bfs`);
- the similar_to vector search plane: the exact and two-stage device
  tiers (`ops.knn`) and the quantized IVF tier (`ops.ivf`), with the
  scoring products as hand-written CUDA kernels (`ops.kernels.score_dot`
  and `score_int8_lists`, the quantized tier's approximate stage in one
  launch, `csrc/score.cu`), and its benchmark (`bench.vectors`).

Entry points run on `cuda:0` unless the caller passes `device="cpu"`;
see `backend.resolve_device`.
"""
