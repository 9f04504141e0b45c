"""knn_kernels_per_call: device kernels in the traced window (PyTorch's fills
among them, the runtime's copies and memsets not: `trace.is_kernel`),
over the search calls completed in it."""


def read(run):
    t = run.trace
    if not t or not run.latencies_s:
        return None
    return t["kernels"] / len(run.latencies_s)
