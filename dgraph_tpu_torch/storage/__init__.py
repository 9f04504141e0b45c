"""Host-side storage: MVCC tablets, write-ahead log, rollups.

The reference stores posting lists in Badger with an immutable layer +
ts-keyed mutation deltas (posting/list.go:70, posting/mvcc.go). Here each
predicate is a `Tablet`: a rolled-up base state (host numpy + device
tiles) plus a commit-ts-stamped delta overlay, with rollups folding the
overlay forward — same MVCC semantics, re-shaped so the committed state
is always one repack away from dense device tensors.

Port of `dgraph_tpu/storage/__init__.py`: a copy, its imports pointed at this
package.
"""

from dgraph_tpu_torch.storage.tablet import Posting, Tablet
from dgraph_tpu_torch.storage.wal import Wal
