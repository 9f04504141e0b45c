"""Query processing: planner/executor (SubGraph-equivalent) and JSON
encoding. Re-provides the reference's query/ package semantics
(query/query.go ProcessGraph, outputnode.go ToJson) with level-batched
device calls in place of goroutine fan-out."""
