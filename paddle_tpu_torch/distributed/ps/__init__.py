"""paddle_tpu_torch.distributed.ps — twin of ``paddle_tpu/distributed/ps``:
the parameter-server sparse-table capability (reference:
paddle/fluid/distributed/table/common_sparse_table.cc — shard-partitioned
host storage with rowwise optimizer rules; service/communicator.cc —
sync/async/geo gradient merge; service/brpc_ps_client.cc — the pull/push
RPC surface).

Design (the JAX package's, SURVEY §7 step 10): the accelerator never
holds the [vocab, dim] table.  Rows live host-side in shard-partitioned
numpy arenas; each training step PULLS just the batch's unique rows to
the device (or gathers them from a device cache of hot rows), the
backward produces a dense [n_unique, dim] grad, and the communicator
PUSHes it back applying the rowwise optimizer on the host.  Cross-host
scale-out rides the hosts' network with the same pull/push contract (the
in-process table here is the single-host degenerate case of the brpc
service)."""
from ...framework.concurrency import declare_hierarchy as _declare_hierarchy

# PS-side declared lock hierarchy (docs/ANALYSIS.md), outermost first:
# the device cache may call into its backing table, which (remote) may
# call into a PS connection — never the reverse.
_declare_hierarchy("ps.device_cache_io", "ps.device_cache", "ps.table",
                   "ps.conn")

from . import runtime  # noqa: F401
from .table import SparseTable
from .communicator import Communicator
from .embedding import SparseEmbedding
from .service import (  # noqa: F401
    AsyncPushQueue,
    DenseTable,
    PSClient,
    PSServer,
    RemoteSparseTable,
)

__all__ = ["SparseTable", "Communicator", "SparseEmbedding", "PSServer",
           "PSClient", "RemoteSparseTable", "DenseTable", "AsyncPushQueue"]
