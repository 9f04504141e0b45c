"""device_idle_share.reach: the share of a reach cell's traced window in
which no operation ran on the device (the window less the union of the
device's operation intervals, over the window), in percent."""

from benchmark.harness.trace import idle_share as read  # noqa: F401
