"""Cluster control plane: coordinator (Zero-equivalent), membership,
replication. Round 1 ships the in-process coordinator; the gRPC/DCN
service wrapping and Raft replication layer over it."""

from dgraph_tpu_torch.cluster.coordinator import Coordinator, TxnAborted
