"""knn_roofline: the least time of one search call (`work/knn.py`: the
larger of its operations at the float32 rate and its bytes at the
memory rate) over the device's busy time a call in the traced window,
in percent."""


def read(run):
    t = run.trace
    least = run.work.get("knn_least_s")
    if not t or least is None or not run.latencies_s or t["busy_s"] <= 0:
        return None
    return 100.0 * least / (t["busy_s"] / len(run.latencies_s))
