"""digest_roofline: the least time of one batch of the reach digest
(`work/digest.py`: the bytes the batch needs at the card's memory rate)
over the device's busy time a batch in the traced window, in percent."""


def read(run):
    t = run.trace
    least = run.work.get("digest_least_s")
    if not t or least is None or not run.latencies_s or t["busy_s"] <= 0:
        return None
    return 100.0 * least / (t["busy_s"] / len(run.latencies_s))
