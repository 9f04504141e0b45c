"""Serving layer: the Alpha-equivalent HTTP API surface.

Ref: dgraph/cmd/alpha/run.go:415-436 (HTTP handlers) and
dgraph/cmd/alpha/http.go (queryHandler/mutationHandler/commitHandler).

Port of `dgraph_tpu/server/__init__.py`: a copy, its imports pointed at this
package.
"""

from dgraph_tpu_torch.server.http import AlphaServer, serve

__all__ = ["AlphaServer", "serve"]
