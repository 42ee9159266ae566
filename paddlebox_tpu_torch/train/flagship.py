"""The flagship configuration of the port, defined once.

bench.py's flagship shape (bench.py:88-91,179-190): DeepFM with hidden
512-256-128 over 32 sparse slots, batch 1024, max_len 4, embedx 8,
in-table adagrad, a 2^20-row f32 pass slab, mf_create_thresholds 0,
mf_initial_range 1e-3, f32 dense Adam at lr 1e-3; trained on synthetic
files (4 files x 4096 lines = 16 batches a pass, 20,000 ids a slot,
seed 0). ``FLAGSHIP_BF16`` is the same with the reference's bf16 slab
diet (``slab_embed_dtype="bfloat16"``: 25 two-byte columns a row, 50 B,
against 17 f32 columns, 68 B); the dense model stays f32 unless
``compute_dtype`` or ``matmul_dtype`` says otherwise. chip_smoke.py drives
its main path from here, profile_pass.py profiles the same pass, and
rate_probe.py gathers at the pull's shape from one of its batches
(``first_batch_ids``); a smaller
configuration is a ``dataclasses.replace`` of ``FLAGSHIP``. The
datasets and the trainer take the defaults, so all of them run on the
native host tier (the columnar dataset, the C++ store, the route index).

The incremental cadence (``write_cadence``): twice the files from the same
seed, of which the first ``num_files`` are the main path's, byte for byte,
and three passes over sliding windows of ``num_files`` files that advance
by half a window. It is a synthetic stress of the pass lifecycle, not a
model of any user's traffic: the generator draws every key uniformly from
a fixed vocabulary that each pass nearly covers, so a pass keeps about 90%
of the previous pass's keys, and would share nearly as many with any other
window. cadence_probe.py holds its run modes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import (DataFeedConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import (DtypeFlags, PassFlags,
                                              PushFlags, StageFlags)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.device import DeviceLike
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train.trainer import BoxTrainer


@dataclasses.dataclass(frozen=True)
class Flagship:
    num_slots: int = 32
    batch: int = 1024
    max_len: int = 4
    embedx: int = 8
    hidden: Tuple[int, ...] = (512, 256, 128)
    capacity: int = 1 << 20
    # the synthetic data of one pass
    num_files: int = 4
    lines_per_file: int = 4096
    vocab_per_slot: int = 20000
    data_seed: int = 0
    # the dtype diet (DtypeFlags, TrainerConfig.compute_dtype)
    slab_embed_dtype: str = "float32"
    matmul_dtype: str = "float32"
    compute_dtype: str = "float32"

    def table(self) -> TableConfig:
        return TableConfig(embedx_dim=self.embedx,
                           pass_capacity=self.capacity,
                           optimizer=SparseOptimizerConfig(
                               mf_create_thresholds=0.0,
                               mf_initial_range=1e-3))


FLAGSHIP = Flagship()
FLAGSHIP_BF16 = dataclasses.replace(FLAGSHIP, slab_embed_dtype="bfloat16")
DENSE_LR = 1e-3
BLOCK_ROWS = 1024  # push_block_rows of push_write='blocked'


def write_files(out_dir: str, cfg: Flagship = FLAGSHIP
                ) -> Tuple[List[str], DataFeedConfig]:
    """The configuration's synthetic files and their feed config."""
    files, feed = write_synthetic_ctr_files(
        out_dir, num_files=cfg.num_files, lines_per_file=cfg.lines_per_file,
        num_slots=cfg.num_slots, vocab_per_slot=cfg.vocab_per_slot,
        max_len=cfg.max_len, seed=cfg.data_seed)
    return files, dataclasses.replace(feed, batch_size=cfg.batch)


def write_cadence(out_dir: str, cfg: Flagship = FLAGSHIP
                  ) -> Tuple[List[List[str]], DataFeedConfig]:
    """(the file lists of the cadence's three passes, feed config): writes
    2 * cfg.num_files files once; pass p reads files [p * s, p * s +
    num_files) with s = num_files // 2. The first pass's files are
    ``write_files``' files."""
    n = cfg.num_files
    files, feed = write_files(out_dir, dataclasses.replace(cfg,
                                                           num_files=2 * n))
    step = n // 2
    return [files[p * step:p * step + n] for p in range(3)], feed


def _load(files: List[str], feed: DataFeedConfig
          ) -> Tuple[BoxDataset, np.ndarray]:
    """(dataset loaded from ``files``, its sorted unique keys)."""
    ds = BoxDataset(feed)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds, np.unique(ds.all_keys())


def sorted_pass_keys(files: List[str], feed: DataFeedConfig) -> np.ndarray:
    """The sorted unique feasign keys of a pass over ``files``."""
    return _load(files, feed)[1]


def first_batch_ids(files: List[str], feed: DataFeedConfig,
                    cfg: Flagship = FLAGSHIP) -> np.ndarray:
    """int32 [batch * num_slots * max_len] slab ids of the first batch of
    ``files[0]``, as the pass table of that file gives them: each key's
    rank among the file's sorted unique keys, padding key slots on the
    trash row (capacity - 1)."""
    ds, pass_keys = _load(files[:1], feed)
    b = ds.split_batches(1)[0][0]
    return np.where(b.valid, np.searchsorted(pass_keys, b.keys),
                    cfg.capacity - 1).astype(np.int32)


def first_chunk_ids(files: List[str], feed: DataFeedConfig,
                    cfg: Flagship = FLAGSHIP, chunk: int = 8) -> np.ndarray:
    """int32 [chunk * batch * num_slots * max_len] slab ids of the first
    ``chunk`` batches of ``files`` (unshuffled), one after another as a
    chunk-synchronous chunk flattens them, against the pass table of
    ``files``; padding key slots on the trash row."""
    ds, pass_keys = _load(files, feed)
    group = ds.split_batches(1)[0][:chunk]
    if len(group) < chunk:
        raise ValueError("%d batches, fewer than a chunk of %d"
                         % (len(group), chunk))
    return np.concatenate([
        np.where(b.valid, np.searchsorted(pass_keys, b.keys),
                 cfg.capacity - 1).astype(np.int32) for b in group])


def build_trainer(files: List[str], feed: DataFeedConfig,
                  cfg: Flagship = FLAGSHIP, push_write: str = "scatter",
                  device: DeviceLike = None, seed: int = 0,
                  pass_flags: PassFlags = PassFlags(),
                  plain_host: bool = False,
                  stage_flags: StageFlags = StageFlags(),
                  **trainer_fields) -> Tuple[BoxTrainer, BoxDataset]:
    """(trainer with an 'auc' metric, dataset over ``files``): DeepFM with
    weights from ``seed``, ready for ``trainer.train_pass(dataset)``.

    The host tier is the native one (the columnar dataset, the C++ store,
    the route index); ``plain_host`` puts the dataset on the record path
    and the table on the Python store, the plain versions the native run
    is held bit-equal to. ``trainer_fields`` are TrainerConfig fields
    (scan_chunk, sparse_chunk_sync, check_nan_inf) beside dense_lr: by
    default the pass runs through the chunk driver in chunks of 8."""
    model = DeepFM(ModelSpec(num_slots=cfg.num_slots,
                             slot_dim=3 + cfg.embedx),
                   hidden=cfg.hidden,
                   generator=torch.Generator().manual_seed(seed))
    trainer = BoxTrainer(model, cfg.table(), feed,
                         TrainerConfig(dense_lr=DENSE_LR,
                                       compute_dtype=cfg.compute_dtype,
                                       **trainer_fields),
                         seed=seed, flags=PushFlags(push_write, BLOCK_ROWS),
                         device=device, pass_flags=pass_flags,
                         store=(HostEmbeddingStore(ValueLayout(cfg.embedx),
                                                   cfg.table(), seed)
                                if plain_host else None),
                         stage_flags=stage_flags,
                         dtype_flags=DtypeFlags(cfg.slab_embed_dtype,
                                                cfg.matmul_dtype))
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 20)
    ds = BoxDataset(feed, columnar=not plain_host)
    ds.set_filelist(files)
    return trainer, ds
