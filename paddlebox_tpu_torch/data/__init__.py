"""The feed: parsers, packers, the pass dataset and the streaming tailer.

``StreamingDataset`` (data/streaming.py) is exported here, as the
reference's data package exports it; it loads on first use, so importing a
submodule never pulls in the others.
"""

__all__ = ["BoxDataset", "DirectoryWatcher", "FileLedger", "MicroWindow",
           "SocketFeedServer", "StreamingDataset"]


def __getattr__(name):
    if name == "BoxDataset":
        from paddlebox_tpu_torch.data.dataset import BoxDataset
        return BoxDataset
    if name in __all__:
        from paddlebox_tpu_torch.data import streaming
        return getattr(streaming, name)
    raise AttributeError(name)
