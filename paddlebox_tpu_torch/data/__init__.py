"""The feed: parsers, packers, the pass dataset and the streaming tailer.

The reference's package-level names (paddlebox_tpu/data/__init__.py),
each loaded on first use, so importing a submodule never pulls in the
others.
"""

_EXPORTS = {
    "SlotRecord": "slot_record",
    "MultiSlotParser": "parser",
    "PackedBatch": "packer",
    "BatchPacker": "packer",
    "ColumnarBlock": "columnar",
    "BoxDataset": "dataset",
    "write_synthetic_ctr_files": "generator",
    "DirectoryWatcher": "streaming",
    "FileLedger": "streaming",
    "MicroWindow": "streaming",
    "SocketFeedServer": "streaming",
    "StreamingDataset": "streaming",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    import importlib
    mod = importlib.import_module("paddlebox_tpu_torch.data."
                                  + _EXPORTS[name])
    return getattr(mod, name)
