"""The CPU parameter server ("the-one-ps"), counterpart of
paddlebox_tpu/ps/.

Sharded host sparse tables with the CTR accessor's semantics
(table/memory_sparse_table.cc, ctr_accessor.cc, sparse_sgd_rule.cc),
dense tables (memory_dense_table.cc), the client interface
(service/ps_client.h) with an in-process client (ps_local_client.h), and a
TCP server and client pair over the host plane's framed transport in the
brpc service's place. ps/worker.py is the Downpour trainer over it;
embedding/ps_store.py puts it behind the sharded table (PSGPUTrainer).
"""

from paddlebox_tpu_torch.ps.sgd_rule import numpy_apply_push
from paddlebox_tpu_torch.ps.table import DenseTable, SparseTable
from paddlebox_tpu_torch.ps.service import (PSCore, PSServer, PsLocalClient,
                                            TcpPSClient)

__all__ = [
    "numpy_apply_push",
    "DenseTable",
    "SparseTable",
    "PSCore",
    "PSServer",
    "PsLocalClient",
    "TcpPSClient",
]
