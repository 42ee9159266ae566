"""The sparse table: the value layouts, the host stores, the pass table
and its push kernels.

The reference's package-level names the port has
(paddlebox_tpu/embedding/__init__.py), each loaded on first use: the
serving plane imports embedding/ckpt_store.py, and must not load torch
through this package.
"""

_EXPORTS = {
    "ValueLayout": "accessor",
    "PushLayout": "accessor",
    "PassTable": "pass_table",
    "HostEmbeddingStore": "host_store",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    import importlib
    mod = importlib.import_module("paddlebox_tpu_torch.embedding."
                                  + _EXPORTS[name])
    return getattr(mod, name)
