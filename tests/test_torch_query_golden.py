"""The 75 golden queries through the port's GraphDB on the CPU.

The golden movie graph at scale 1 (tests/golden/dataset.py) goes into
`GraphDB(device_min_edges=1, device="cpu")` at the reference's other
defaults (plan cache 128, `planner="auto"`, so the adaptive planner),
as tests/golden/runner.py loads it into the reference's. Each query's
`data` must equal its committed golden under the golden suite's own
comparison (`_json_close`: relative 1e-9 on floats, everything else
exact), and equal the reference GraphDB's `data` for the same query
exactly. `device_min_edges=1` forces every device tier the port has
onto the engine's device (here the CPU), so the seams onto ops/graph,
ops/setops and ops/bitgraph run; the last test checks that they did.
"""

import pytest

from dgraph_tpu_torch.utils import metrics as tmetrics
from tests.golden import runner
from tests.test_golden import _json_close
from tests.test_torch_query_paths import golden_text, port_golden_db


@pytest.mark.parametrize("name", runner.query_names())
def test_golden_query_through_the_port(name):
    q = golden_text(name)
    got = port_golden_db().query(q)["data"]
    assert _json_close(got, runner.load_expected(name)), name
    assert got == runner.get_db().query(q)["data"], name


def test_golden_workload_reaches_the_device_tiers():
    """The seams the golden suite drives: forward and reverse expand,
    inequality range scans, order-by pages and sorts, the count page
    and the fused block page."""
    before = tmetrics.counters_snapshot()
    db = port_golden_db()
    for name in runner.query_names():
        db.query(golden_text(name))
    delta = tmetrics.counters_delta(before)
    for counter in ('query_device_expand_total{dir="fwd"}',
                    'query_device_expand_total{dir="rev"}',
                    "query_device_range_total",
                    "query_device_sort_page_total",
                    "query_device_multisort_total",
                    "query_device_count_page_total",
                    "query_fused_dispatch_total"):
        assert delta.get(counter, 0) > 0, counter
