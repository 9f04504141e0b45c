"""At-rest and on-wire version contracts for rolling upgrades.

The reference negotiates through protobuf's open-ended field numbering
plus explicit manifest versions (ee/backup/ Manifest.Version,
x/x.go DgraphVersion checks at restore). We make both contracts
explicit and testable:

  FORMAT_VERSION    stamped into snapshot payloads and backup
                    manifests/headers. Files written before the stamp
                    existed carry NO version key and load as version 0
                    — the pinned legacy contract
                    (tests/test_format_version.py drives committed
                    legacy bytes through restore). A reader refuses
                    formats NEWER than it understands with the typed
                    UnsupportedFormat instead of misparsing.

  PROTOCOL_VERSION  advertised by the `hello` wire op on alphas and
                    zeros; a connecting peer negotiates
                    min(ours, theirs) (negotiate()). Today every
                    protocol change has been additive (new dict keys,
                    new record tags), so min() is always servable —
                    the negotiation surface exists so the FIRST
                    breaking change has somewhere to land, and so a
                    rolling upgrade can assert the fleet's spread
                    (tools/dgchaos.py rolling-upgrade nemesis).

  build version     a free-form string (DGRAPH_TPU_BUILD_VERSION env,
                    default "dev") surfaced on /debug/stats and hello.
                    The rolling-upgrade drill restarts nodes with a
                    new build string one at a time and asserts mixed
                    fleets interoperate checker-green.

Port of `dgraph_tpu/storage/versions.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import os

# at-rest payload format (snapshots, backups). 0 = pre-stamp legacy.
FORMAT_VERSION = 1
# cluster wire protocol (the request/response op surface)
PROTOCOL_VERSION = 1


class UnsupportedFormat(ValueError):
    """The artifact was written by a NEWER format than this node
    understands — restoring it could silently misparse. Upgrade the
    node (or restore with a build >= the writer's)."""

    def __init__(self, what: str, version: int):
        self.what = what
        self.version = version
        super().__init__(
            f"{what} has format_version {version}, newer than this "
            f"build's {FORMAT_VERSION}; upgrade before restoring")


def check_format(version: int, what: str) -> int:
    """Gate an at-rest artifact's stamped version (absent = 0 legacy,
    always accepted). Returns the version for the caller to log."""
    v = int(version)
    if v > FORMAT_VERSION:
        raise UnsupportedFormat(what, v)
    return v


def negotiate(peer_protocol: int) -> int:
    """Both sides speak min(ours, theirs) — the protobuf discipline
    (old readers skip unknown additive fields) made explicit."""
    return min(PROTOCOL_VERSION, int(peer_protocol))


def build_version() -> str:
    return os.environ.get("DGRAPH_TPU_BUILD_VERSION", "dev")


def versions_payload() -> dict:
    """The `hello` wire-op / debug-stats versions block."""
    return {"protocol": PROTOCOL_VERSION, "format": FORMAT_VERSION,
            "build": build_version()}
