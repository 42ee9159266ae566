"""Parser plugins (paddlebox_tpu/data/plugin.py; DLManager/CustomParser,
data_feed.h:682-780). A plugin is either

  * a Python file exporting ``make_parser(feed)``, whose parser has
    ``parse_file(path) -> Iterator[SlotRecord]`` (MultiSlotParser's
    contract), or
  * a shared object with the columnar slot parser's C interface
    (native/slot_parser.cc), loaded through the port's
    NativeMultiSlotParser.

Give the parser to ``BoxDataset(feed, parser=...)``: a dataset with an
explicit parser loads on the record path through it, as the reference's
does.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any

from paddlebox_tpu_torch.config.configs import DataFeedConfig


def load_parser_plugin(path: str, feed: DataFeedConfig) -> Any:
    """The parser of the plugin file ``path`` for ``feed``."""
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "pbt_parser_plugin_%s" % os.path.basename(path)[:-3], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if not hasattr(mod, "make_parser"):
            raise AttributeError(
                "parser plugin %s must export make_parser(feed)" % path)
        parser = mod.make_parser(feed)
        if not hasattr(parser, "parse_file"):
            raise AttributeError(
                "plugin parser must provide parse_file(path)")
        return parser
    if path.endswith(".so"):
        from paddlebox_tpu_torch.data.native_parser import \
            NativeMultiSlotParser
        return NativeMultiSlotParser(feed, lib_path=path)
    raise ValueError("parser plugin must be a .py module or native .so: "
                     + path)
