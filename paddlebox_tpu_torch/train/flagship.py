"""The flagship configuration of the port, defined once.

bench.py's flagship shape (bench.py:88-91,179-190): DeepFM with hidden
512-256-128 over 32 sparse slots, batch 1024, max_len 4, embedx 8,
in-table adagrad, a 2^20-row f32 pass slab, mf_create_thresholds 0,
mf_initial_range 1e-3, f32 dense Adam at lr 1e-3; trained on synthetic
files (4 files x 4096 lines = 16 batches a pass, 20,000 ids a slot,
seed 0). ``FLAGSHIP_BF16`` is the same with the reference's bf16 slab
diet (``slab_embed_dtype="bfloat16"``: 25 two-byte columns a row, 50 B,
against 17 f32 columns, 68 B); the dense model stays f32 unless
``compute_dtype`` or ``matmul_dtype`` says otherwise. ``FLAGSHIP_ADAM``,
``FLAGSHIP_ADAM_SHARED`` and ``FLAGSHIP_NAIVE`` are the same DeepFM and
data with the reference's other in-table rules (37, 23 and 15 f32 columns
a row); ``FLAGSHIP_EXPAND`` is CtrDnnExpand with hidden (256, 128), as
examples/train_ctr.py:76-78 builds it, over an adagrad table with
``expand_embed_dim=64`` (the default extend_size of the reference user
API _pull_box_extended_sparse, Paddle contrib/layers/nn.py:1678): 82 f32
columns a row, the same files.

The model zoo's dense and multi-task heads (``ZOO_FLAGSHIPS``) keep
FLAGSHIP's table, batch and run settings and read one hybrid file set,
the same generator with ``dense_dim=13`` (the integer-feature count of
Criteo and of the MLPerf-rec DLRM) and ``conversion=True`` (a label_cvr
slot, the "cvr" task's label), each model at the JAX package's default
widths: ``FLAGSHIP_CTR_DNN`` CtrDnn hidden (512, 256, 128) with data_norm
at dn_slot_dim 11 (the pooled slot width; BASELINE.json config 1),
``FLAGSHIP_WIDE_DEEP`` WideDeep hidden (256, 128, 64) and
``FLAGSHIP_DLRM`` DLRM bottom (128, 64) + embedx, top (256, 128) (config
3, the dense+sparse hybrid), ``FLAGSHIP_MMOE`` MMoE with 4 experts of 64
and towers (32,) for tasks (ctr, cvr) and ``FLAGSHIP_ESMM`` ESMM towers
(256, 128, 64) with loss_mode "esmm" (config 4, multi-task ranking).

The join phase's record-path feeds keep FLAGSHIP's table, batch and run
settings and its files' slots: ``FLAGSHIP_JOIN_PV`` is JoinPvDnn at its
defaults (max_rank 3, att_dim 64: rank_param [9 * 352, 64]; MLP
416-512-256-128-1) over the pv rank-offset feed. The reference reads no pv
field from a file (its records carry them), so ``assign_pv`` gives a
loaded pass's records seeded pvs of 1-4 ads in load order, ranks 1..size
and cmatch 222 or 223 for 90% of the ads, channel 100 for the rest: rows
of rank 4 > max_rank and rows of another channel take no part in the join.
``FLAGSHIP_AUX`` is CtrDnnAux 512-256-128 with aux rows 8 wide (an embedx
row, the GpuReplicaCache use) at aux_capacity 4096, over the same files
with instance ids (``item<k>``, k below 4096) through an InputTable
(``input_table``: 3/4 of the vocabulary, so a quarter of the lookups miss
to the zero row), or a ReplicaCache of the whole vocabulary read by
cache_idx (``replica_cache``, ``assign_cache_idx``). ``load_pass`` feeds a
pass of either and gives its records those fields; ``train_pass(ds,
preloaded=True)`` then trains it.

The behavior-sequence model, ``FLAGSHIP_BST``: BstSeqCtr at the JAX
package's defaults (heads 4, d_head 8, d_seq 16, MLP 368-64-32-1) on
FLAGSHIP's table and batch, trained by parallel/seq_trainer.py
SeqCtrTrainer (``build_seq_trainer``) with slot 0 as the history,
``seq_len`` 20 (the behavior sequence length of the BST paper, Chen et
al., "Behavior Sequence Transformer for E-commerce Recommendation in
Alibaba", DLP-KDD 2019, its table of hyperparameters). Its files come from
the same generator and seed with slot 0 carrying 1-20 keys a line
(``slot_max_lens``) and the other 31 slots 1-4, so a batch holds up to
1024 x (20 + 31 x 4) keys, its key capacity 1024 x (16 + 31 x 4) = 143,360
key slots (the reference's key_capacity caps each slot's share at 16), and
20,480 sequence positions. ``FLAGSHIP_SGD`` and ``FLAGSHIP_DENSE_ADAGRAD``
are FLAGSHIP's DeepFM main path with the dense optimizer sgd or adagrad
(TrainerConfig.dense_optimizer), on the main path's files and chunk
driver.

The pipeline's configuration, ``FLAGSHIP_PIPE`` (a ``PipeFlagship``):
parallel/pipeline.py CtrPipelineRunner over FLAGSHIP's table, feed and
batch (32 slots, embedx 8, adagrad, a 2^20-row f32 slab; a micro-batch is
one batch of 1024), 8 micro-batches a step, a tower of width 512 (the
flagship DeepFM's widest layer) with 3 layers a stage, dense Adam at
DENSE_LR, one stage (the card is one GPU): a step pulls 8 x 131,072 =
1,048,576 ids, the first step's the chunk of ``first_chunk_ids``. Its
projection input goes through data_norm at the pooled slot's width, as
FLAGSHIP_CTR_DNN's does, and its weights are drawn at 1/sqrt(512): at
the reference runner's 0.1 (sized for its d_model of 24-32) each relu
layer of width 512 grows the activations' variance about 2.6-fold (512
x 0.01 / 2), and on an H100 the second pass's loss rose far above the
first's instead of falling, with data_norm (0.9555 -> 8.418) and
without it (0.9555 -> 12.54). ``build_pipeline_trainer`` builds it through train/factory.py; a
``base`` of FLAGSHIP_EXPAND gives its expand-64 table.
``build_sharded_pipeline`` builds the same configuration as the pipeline
over the sharded table (ShardedCtrPipelineTrainer, or SectionPSTrainer
over a PS client): at world 1 the one shard is the whole 2^20-row slab,
and a step's bucket cap is 2 x 8 x 131,072 = 2,097,152 ids.

``FLAGSHIP_SSD`` is FLAGSHIP with the SSD tier: a 16 MiB host budget
(``ssd_threshold_mb``; 246,723 rows of 68 B) against the cadence's 557,083
pass keys, so every end_pass spills about 310,000 rows to block files in
the run's ``ssd_dir`` (``dataclasses.replace``); ``FLAGSHIP_ASYNC`` is
FLAGSHIP with the host async dense table (``sync_mode="async"``), which
steps one batch at a time.

chip_smoke.py drives
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
from typing import List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import (DataFeedConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import (DtypeFlags, ObsFlags,
                                              PassFlags, PushFlags,
                                              ShardFlags, StageFlags)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.device import DeviceLike
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.side_tables import (InputTable,
                                                       ReplicaCache)
from paddlebox_tpu_torch.models import MODEL_ZOO
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.parallel.seq_trainer import (SeqCtrTrainer,
                                                      seq_ids_of)
from paddlebox_tpu_torch.train.trainer import (BoxTrainer,
                                               model_accepts_rank_offset)


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
    # the table's in-table rule and expand block; the model, a MODEL_ZOO
    # name ("ctr_dnn_expand", CtrDnnExpand, needs expand_dim > 0)
    optimizer: str = "adagrad"
    expand_dim: int = 0
    model: str = "deepfm"
    # the zoo's feed: dense columns and the conversion label
    dense_dim: int = 0
    conversion: bool = False
    # the join phase's feeds: instance ids from a vocabulary of
    # ins_id_vocab items, the side table's row width (the model keeps
    # CtrDnnAux's default of 4096 aux rows); the pv rank-offset matrix goes
    # with the model (``feed_for``)
    ins_id_vocab: int = 0
    aux_dim: int = 0
    # the dense optimizer (TrainerConfig.dense_optimizer)
    dense_optimizer: str = "adam"
    # the behavior sequence: slot 0's key bound in the files and BST's
    # history length (0: every slot is bounded by max_len)
    seq_len: int = 0
    # the SSD tier: its directory (set by the run, a temporary one) and the
    # host store's budget in MiB (TableConfig.ssd_threshold_mb)
    ssd_dir: Optional[str] = None
    ssd_threshold_mb: float = 0
    # the dense sync (TrainerConfig.sync_mode; "async": the host table)
    sync_mode: str = "step"

    def table(self) -> TableConfig:
        return TableConfig(embedx_dim=self.embedx,
                           expand_embed_dim=self.expand_dim,
                           pass_capacity=self.capacity,
                           optimizer=SparseOptimizerConfig(
                               mf_create_thresholds=0.0,
                               mf_initial_range=1e-3,
                               optimizer=self.optimizer),
                           ssd_dir=self.ssd_dir,
                           ssd_threshold_mb=self.ssd_threshold_mb)

    def layout(self) -> ValueLayout:
        return ValueLayout(self.embedx, self.optimizer, self.expand_dim,
                           self.slab_embed_dtype)


FLAGSHIP = Flagship()
FLAGSHIP_BF16 = dataclasses.replace(FLAGSHIP, slab_embed_dtype="bfloat16")
FLAGSHIP_ADAM = dataclasses.replace(FLAGSHIP, optimizer="adam")
FLAGSHIP_ADAM_SHARED = dataclasses.replace(FLAGSHIP, optimizer="adam_shared")
FLAGSHIP_NAIVE = dataclasses.replace(FLAGSHIP, optimizer="naive")
FLAGSHIP_EXPAND = dataclasses.replace(FLAGSHIP, model="ctr_dnn_expand",
                                      hidden=(256, 128), expand_dim=64)
# the configurations of the other in-table rules and of the expand block,
# by name
RULE_FLAGSHIPS = {"adam": FLAGSHIP_ADAM, "adam_shared": FLAGSHIP_ADAM_SHARED,
                  "naive": FLAGSHIP_NAIVE, "expand": FLAGSHIP_EXPAND}
# their two full-width passes on the card (chip_smoke.py phase 14, seed 0,
# push_write "scatter", chunks of 8): loss and AUC a pass, "%.10f"; the
# values later slices hold
RULE_DIGITS = {
    "adam": {"loss": ("0.6876237988", "1.5722794533"),
             "auc": ("0.4925770353", "0.4029702913")},
    "adam_shared": {"loss": ("0.6877167821", "1.7637530565"),
                    "auc": ("0.4935985159", "0.4417368807")},
    "naive": {"loss": ("0.6866484880", "0.5655780435"),
              "auc": ("0.4971680564", "0.7351465576")},
    "expand": {"loss": ("0.6908681393", "0.3923527598"),
               "auc": ("0.5067039926", "0.8265387528")}}
# the zoo over the hybrid files (dense columns and a conversion label)
ZOO_DATA = dict(dense_dim=13, conversion=True)
FLAGSHIP_CTR_DNN = dataclasses.replace(FLAGSHIP, model="ctr_dnn",
                                       **ZOO_DATA)
FLAGSHIP_WIDE_DEEP = dataclasses.replace(FLAGSHIP, model="wide_deep",
                                         hidden=(256, 128, 64), **ZOO_DATA)
FLAGSHIP_DLRM = dataclasses.replace(FLAGSHIP, model="dlrm",
                                    hidden=(256, 128), **ZOO_DATA)
FLAGSHIP_MMOE = dataclasses.replace(FLAGSHIP, model="mmoe", hidden=(32,),
                                    **ZOO_DATA)
FLAGSHIP_ESMM = dataclasses.replace(FLAGSHIP, model="esmm",
                                    hidden=(256, 128, 64), **ZOO_DATA)
ZOO_FLAGSHIPS = {"ctr_dnn": FLAGSHIP_CTR_DNN,
                 "wide_deep": FLAGSHIP_WIDE_DEEP, "dlrm": FLAGSHIP_DLRM,
                 "mmoe": FLAGSHIP_MMOE, "esmm": FLAGSHIP_ESMM}
# their two full-width passes on the card (chip_smoke.py phase 15, seed 0,
# push_write "scatter", chunks of 8): loss and AUC a pass, "%.10f" (ESMM's
# ctcvr_auc too); the values later slices hold
ZOO_DIGITS = {
    "ctr_dnn": {"loss": ("0.6910443902", "0.2504966259"),
                "auc": ("0.5016594996", "0.8400277333")},
    "wide_deep": {"loss": ("0.6913253069", "0.4287662506"),
                  "auc": ("0.5045334118", "0.7885313656")},
    "dlrm": {"loss": ("0.6853043437", "0.6822754741"),
             "auc": ("0.5021083694", "0.5051073115")},
    "mmoe": {"loss": ("1.2568528652", "0.9889304042"),
             "auc": ("0.4937408910", "0.7726104023")},
    "esmm": {"loss": ("1.2378480434", "0.8536358476"),
             "auc": ("0.5061925378", "0.7749946241"),
             "ctcvr_auc": ("0.4974737686", "0.7128110137")}}
# the dense optimizers on the main path
FLAGSHIP_SGD = dataclasses.replace(FLAGSHIP, dense_optimizer="sgd")
FLAGSHIP_DENSE_ADAGRAD = dataclasses.replace(FLAGSHIP,
                                             dense_optimizer="adagrad")
# the behavior-sequence model (SeqCtrTrainer, history slot SEQ_SLOT)
FLAGSHIP_BST = dataclasses.replace(FLAGSHIP, model="bst_seq_ctr",
                                   hidden=(64, 32), seq_len=20)
SEQ_SLOT = 0
# the join phase's record-path feeds
# the SSD tier: a 16 MiB host budget, 246,723 rows of 68 B against the
# cadence's 557,083 pass keys (the run gives ssd_dir)
FLAGSHIP_SSD = dataclasses.replace(FLAGSHIP, ssd_threshold_mb=16)
FLAGSHIP_ASYNC = dataclasses.replace(FLAGSHIP, sync_mode="async")
FLAGSHIP_JOIN_PV = dataclasses.replace(FLAGSHIP, model="join_pv_dnn")
FLAGSHIP_AUX = dataclasses.replace(FLAGSHIP, model="ctr_dnn_aux",
                                   ins_id_vocab=4096, aux_dim=8)
# their two full-width passes on the card (chip_smoke.py phase 16, seed 0,
# push_write "scatter", chunks of 8; FLAGSHIP_AUX through input_table):
# loss and AUC a pass, "%.10f"; the values later slices hold
JOIN_DIGITS = {"loss": ("0.6929405928", "0.2596362829"),
               "auc": ("0.4983157869", "0.8381600904")}
AUX_DIGITS = {"loss": ("0.6899062395", "0.2910517156"),
              "auc": ("0.4997193346", "0.8436635384")}
# the share of a pass's ads in a join channel (assign_pv)
JOIN_SHARE = 0.9
# the share of the instance-id vocabulary the InputTable holds
INPUT_TABLE_SHARE = 0.75
# the expand configuration's test pass after them (predict_batches over
# the cadence's third window), its AUC, "%.10f"
EXPAND_TEST_PASS_DIGITS = "0.5233778979"
DENSE_LR = 1e-3
# the constructor argument ``Flagship.hidden`` sets, where it is not
# ``hidden``
_HIDDEN_ARG = {"dlrm": "top", "mmoe": "tower", "esmm": "tower"}
BLOCK_ROWS = 1024  # push_block_rows of push_write='blocked'


@dataclasses.dataclass(frozen=True)
class PipeFlagship:
    """A pipeline configuration: the table, feed and batch of ``base``, and
    the CtrPipelineRunner's stages, micro-batches a step, tower width,
    layers a stage, dense learning rate, data_norm (its show-skip block:
    the pooled slot's 3 + embedx columns) and the weights' draws' scale."""

    base: Flagship = FLAGSHIP
    n_stages: int = 1
    n_micro: int = 8
    d_model: int = 512
    layers_per_stage: int = 3
    lr: float = DENSE_LR
    use_data_norm: bool = True
    dn_slot_dim: int = 3 + FLAGSHIP.embedx
    init_scale: float = 512 ** -0.5


FLAGSHIP_PIPE = PipeFlagship()


def write_files(out_dir: str, cfg: Flagship = FLAGSHIP
                ) -> Tuple[List[str], DataFeedConfig]:
    """The configuration's synthetic files and their feed config."""
    files, feed = write_synthetic_ctr_files(
        out_dir, num_files=cfg.num_files, lines_per_file=cfg.lines_per_file,
        num_slots=cfg.num_slots, vocab_per_slot=cfg.vocab_per_slot,
        max_len=cfg.max_len, dense_dim=cfg.dense_dim, seed=cfg.data_seed,
        conversion=cfg.conversion, ins_id_vocab=cfg.ins_id_vocab,
        slot_max_lens=slot_max_lens(cfg))
    return files, feed_for(cfg, feed)


def slot_max_lens(cfg: Flagship) -> List[int]:
    """Each slot's key bound in the configuration's files: slot SEQ_SLOT's
    is ``seq_len`` where the configuration has a sequence, every other
    slot's ``max_len``."""
    lens = [cfg.max_len] * cfg.num_slots
    if cfg.seq_len:
        lens[SEQ_SLOT] = cfg.seq_len
    return lens


def feed_for(cfg: Flagship, feed: DataFeedConfig) -> DataFeedConfig:
    """``feed`` as the configuration reads it: its batch, and the pv
    rank-offset matrix where its model takes one (``use_rank_offset``)."""
    return dataclasses.replace(
        feed, batch_size=cfg.batch,
        rank_offset=model_accepts_rank_offset(MODEL_ZOO[cfg.model]))


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


def first_seq_batch_ids(files: List[str], feed: DataFeedConfig,
                        cfg: Flagship = FLAGSHIP_BST
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(pooled ids [key capacity], sequence ids [batch, seq_len]), int32,
    of the first batch of ``files[0]`` under a sequence configuration, as
    ``first_batch_ids`` gives the pooled ids and SeqCtrTrainer's
    seq_ids_of the history (padding on the trash row)."""
    ds, pass_keys = _load(files[:1], feed)
    b = ds.split_batches(1)[0][0]
    ids = np.where(b.valid, np.searchsorted(pass_keys, b.keys),
                   cfg.capacity - 1).astype(np.int32)
    seq, _ = seq_ids_of(b, ids, SEQ_SLOT, cfg.batch, cfg.num_slots,
                        cfg.seq_len, cfg.capacity - 1)
    return ids, seq


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


def assign_pv(records, seed: int = 0, max_ads: int = 4) -> None:
    """Seeded pv fields on a pass's records, in place: consecutive records
    (load order) form pvs of 1..max_ads ads, search_id the pv's ordinal
    from 1, rank an ad's place in its pv from 1, cmatch 222 or 223 for a
    JOIN_SHARE of the ads and 100 (another channel) for the rest."""
    rng = np.random.RandomState(seed)
    n = len(records)
    sizes = rng.randint(1, max_ads + 1, size=max(n, 1))
    ends = np.cumsum(sizes)
    k = int(np.searchsorted(ends, n)) + 1
    sizes = sizes[:k].copy()
    sizes[-1] -= int(ends[k - 1]) - n
    pv = np.repeat(np.arange(k), sizes)
    starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
    rank = np.arange(n) - starts + 1
    cmatch = np.where(rng.rand(n) < JOIN_SHARE,
                      rng.choice(np.array([222, 223]), size=n), 100)
    for rec, p, r, c in zip(records, pv.tolist(), rank.tolist(),
                            cmatch.tolist()):
        rec.search_id = p + 1
        rec.rank = r
        rec.cmatch = c


def _ins_vocab_rows(cfg: Flagship, seed: int) -> np.ndarray:
    """[ins_id_vocab, aux_dim] float32: the side tables' seeded rows, one
    an item."""
    return np.random.RandomState([seed, 2]).randn(
        cfg.ins_id_vocab, cfg.aux_dim).astype(np.float32)


def input_table(cfg: Flagship = FLAGSHIP_AUX, seed: int = 0) -> InputTable:
    """An InputTable of aux_dim rows keyed ``item<k>``, holding a seeded
    INPUT_TABLE_SHARE of the ins_id vocabulary (in ascending k); the other
    ids miss to its zero row."""
    rows = _ins_vocab_rows(cfg, seed)
    held = np.sort(np.random.RandomState([seed, 3]).choice(
        cfg.ins_id_vocab, int(cfg.ins_id_vocab * INPUT_TABLE_SHARE),
        replace=False))
    table = InputTable(cfg.aux_dim)
    for k in held.tolist():
        table.add_index_data("item%d" % k, rows[k])
    return table


def replica_cache(cfg: Flagship = FLAGSHIP_AUX, seed: int = 0
                  ) -> ReplicaCache:
    """A ReplicaCache with a row for every item of the ins_id vocabulary,
    row k the item ``item<k>``'s (the rows ``input_table`` holds)."""
    cache = ReplicaCache(cfg.aux_dim)
    for row in _ins_vocab_rows(cfg, seed):
        cache.add_items(row)
    return cache


def assign_cache_idx(records) -> None:
    """Each record's cache_idx from its ins_id: ``item<k>`` reads row k of
    ``replica_cache``."""
    for rec in records:
        rec.cache_idx = int(rec.ins_id[len("item"):])


def load_pass(trainer: BoxTrainer, ds: BoxDataset, seed: int = 0) -> None:
    """Feed a pass of ``ds`` into the trainer's table (what train_pass
    does when not preloaded) and give its records the fields its feed
    reads: the pv fields (``assign_pv``) of a rank-offset feed, the cache
    index of a use_cache_idx dataset. Train it with
    ``trainer.train_pass(ds, preloaded=True)``."""
    trainer.table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=trainer.table.add_keys)
    trainer.table.end_feed_pass()
    if ds.feed.rank_offset:
        assign_pv(ds.records, seed)
    if ds.packer.use_cache_idx:
        assign_cache_idx(ds.records)


def build_model(cfg: Flagship = FLAGSHIP, seed: int = 0) -> torch.nn.Module:
    """The configuration's model, MODEL_ZOO[cfg.model], its weights drawn
    on the CPU from ``torch.Generator().manual_seed(seed)``: ``hidden`` is
    the MLP, DLRM's top MLP or the towers, every other width is the
    constructor's default; CtrDnn runs data_norm at the pooled slot
    width."""
    if cfg.model not in MODEL_ZOO:
        raise ValueError("unknown flagship model %r" % (cfg.model,))
    spec = ModelSpec(num_slots=cfg.num_slots, slot_dim=3 + cfg.embedx,
                     dense_dim=cfg.dense_dim)
    kw = {_HIDDEN_ARG.get(cfg.model, "hidden"): cfg.hidden}
    if cfg.model == "ctr_dnn_expand":
        kw["expand_dim"] = cfg.expand_dim
    if cfg.model == "ctr_dnn":
        kw.update(use_data_norm=True, dn_slot_dim=spec.slot_dim)
    if cfg.model == "ctr_dnn_aux":
        kw["aux_dim"] = cfg.aux_dim
    if cfg.model == "bst_seq_ctr":
        kw["seq_len"] = cfg.seq_len
    return MODEL_ZOO[cfg.model](spec, generator=torch.Generator()
                                .manual_seed(seed), **kw)


def build_trainer(files: List[str], feed: DataFeedConfig,
                  cfg: Flagship = FLAGSHIP, push_write: str = "scatter",
                  device: DeviceLike = None, seed: int = 0,
                  pass_flags: Optional[PassFlags] = None,
                  plain_host: bool = False,
                  stage_flags: Optional[StageFlags] = None,
                  obs_flags: Optional[ObsFlags] = None,
                  aux_source=None,
                  push_flags: Optional[PushFlags] = None,
                  **trainer_fields) -> Tuple[BoxTrainer, BoxDataset]:
    """(trainer with an 'auc' metric, dataset over ``files``): the
    configuration's model (``build_model``) with weights from ``seed``,
    ready for ``trainer.train_pass(dataset)``. ESMM's trainer also has a
    'ctcvr_auc' metric on (label_cvr, pred_ctcvr).

    The host tier is the native one (the columnar dataset, the C++ store,
    the route index); ``plain_host`` puts the dataset on the record path
    and the table on the Python store, the plain versions the native run
    is held bit-equal to. ``aux_source`` (``input_table`` or
    ``replica_cache``) is the trainer's aux source and the dataset's
    aux-offset source: an InputTable translates the ins_ids, a ReplicaCache
    is read by cache_idx (``use_cache_idx``). A rank-offset or ins_id feed
    or an aux source puts the dataset on the record path. ``trainer_fields`` are TrainerConfig fields
    (scan_chunk, sparse_chunk_sync, check_nan_inf) beside dense_lr: by
    default the pass runs through the chunk driver in chunks of 8.
    ``obs_flags``: the trainer's host planes, all on by default. The
    flags left None are made here, at the call (their PBTPU_<NAME>
    environment then, config/flags.py); ``push_flags``, when given,
    replaces ``push_write`` and the blocked write's BLOCK_ROWS."""
    model = build_model(cfg, seed)
    trainer = BoxTrainer(model, cfg.table(), feed,
                         TrainerConfig(dense_lr=DENSE_LR,
                                       compute_dtype=cfg.compute_dtype,
                                       dense_optimizer=cfg.dense_optimizer,
                                       sync_mode=cfg.sync_mode,
                                       **trainer_fields),
                         seed=seed,
                         flags=push_flags or PushFlags(push_write,
                                                       BLOCK_ROWS),
                         device=device,
                         pass_flags=pass_flags or PassFlags(),
                         store=(HostEmbeddingStore(
                             ValueLayout(cfg.embedx, cfg.optimizer,
                                         cfg.expand_dim), cfg.table(), seed)
                                if plain_host else None),
                         stage_flags=stage_flags or StageFlags(),
                         dtype_flags=DtypeFlags(cfg.slab_embed_dtype,
                                                cfg.matmul_dtype),
                         obs_flags=obs_flags or ObsFlags(),
                         aux_source=aux_source)
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 20)
    if getattr(model, "loss_mode", "") == "esmm":
        trainer.metrics.init_metric("ctcvr_auc", "label_cvr", "pred_ctcvr",
                                    table_size=1 << 20)
    ds = BoxDataset(feed, columnar=not plain_host,
                    input_table=(aux_source if isinstance(aux_source,
                                                          InputTable)
                                 else None),
                    use_cache_idx=isinstance(aux_source, ReplicaCache))
    ds.set_filelist(files)
    return trainer, ds


def build_seq_trainer(files: List[str], feed: DataFeedConfig,
                      cfg: Flagship = FLAGSHIP_BST,
                      device: DeviceLike = None, seed: int = 0,
                      group=None, attn: str = "ring"
                      ) -> Tuple[SeqCtrTrainer, BoxDataset]:
    """(SeqCtrTrainer with an 'auc' metric, dataset over ``files``) of a
    sequence configuration: ``build_model``'s BstSeqCtr with history slot
    SEQ_SLOT and attention ``attn``, dense Adam at DENSE_LR, on the native
    host tier; ``group``: the trainer's sp process group (None: one
    shard, no group)."""
    if attn not in ("ring", "ulysses"):
        raise ValueError("attn must be ring|ulysses, got %r" % (attn,))
    model = build_model(cfg, seed)
    model.attn = attn
    trainer = SeqCtrTrainer(model, cfg.table(), feed,
                            TrainerConfig(dense_lr=DENSE_LR),
                            seq_slot=SEQ_SLOT, seed=seed, device=device,
                            group=group)
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 20)
    ds = BoxDataset(feed)
    ds.set_filelist(files)
    return trainer, ds


def build_sharded_trainer(files: List[str], feed: DataFeedConfig,
                          cfg: Flagship = FLAGSHIP, fleet=None,
                          device: DeviceLike = None, seed: int = 0,
                          mesh=None, push_flags: Optional[PushFlags] = None,
                          stage_flags: Optional[StageFlags] = None,
                          metric: Optional[dict] = None,
                          shard_flags: Optional[ShardFlags] = None,
                          shuffler=None, ps_client=None, ps_table_id: int = 0,
                          **trainer_fields):
    """(parallel/sharded_trainer.py ShardedBoxTrainer with an 'auc' metric,
    dataset over this rank's files: ``files``' i % world == rank) of a
    configuration: ``build_model``'s weights from ``seed`` (every rank
    the same), its table sharded over the fleet's ranks (its slab
    dtype), its TrainerConfig with ``trainer_fields`` (by default chunks
    of 8). ``fleet``: the rank's initialized Fleet (default the
    module's, from the environment's role); ``mesh``, ``push_flags``,
    ``stage_flags`` and ``shard_flags`` (the sharding policy) go to the
    trainer; ``shuffler`` (Fleet.make_shuffler's) to the dataset;
    ``metric``: the 'auc' metric's init_metric keywords besides its table
    size; ``ps_client``: the trainer is train/factory.py's PSGPUTrainer,
    its shard store on that PS client's sparse table ``ps_table_id``."""
    from paddlebox_tpu_torch.train.factory import create_trainer
    ps = ({} if ps_client is None
          else dict(ps_client=ps_client, ps_table_id=ps_table_id))
    trainer = create_trainer(
        "PSGPUTrainer" if ps else "ShardedBoxTrainer",
        build_model(cfg, seed), cfg.table(), feed,
        TrainerConfig(dense_lr=DENSE_LR, compute_dtype=cfg.compute_dtype,
                      dense_optimizer=cfg.dense_optimizer, **trainer_fields),
        seed=seed, fleet=fleet, device=device, mesh=mesh,
        push_flags=push_flags, stage_flags=stage_flags,
        shard_flags=shard_flags,
        dtype_flags=DtypeFlags(cfg.slab_embed_dtype, cfg.matmul_dtype), **ps)
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 20,
                                **(metric or {}))
    ds = BoxDataset(feed, shuffler=shuffler)
    ds.set_filelist(files)
    ds.set_filelist(ds.my_shard_files(trainer.rank, trainer.P))
    return trainer, ds


def build_sharded_pipeline(fleet, feed: DataFeedConfig,
                           cfg: PipeFlagship = FLAGSHIP_PIPE, seed: int = 0,
                           push_flags=None, ps_client=None,
                           ps_table_id: int = 0):
    """parallel/pipeline.py ShardedCtrPipelineRunner with an 'auc' metric
    of a pipeline configuration on ``fleet`` (an initialized Fleet; its
    mesh is the rank's device; the world is the stage axis), made by
    train/factory.py's "ShardedCtrPipelineTrainer", or with ``ps_client``
    its "SectionPSTrainer" over that client's sparse table
    ``ps_table_id``: ``cfg.base``'s table sharded over the fleet's ranks,
    ``cfg``'s stages, micro-batches, width, layers, learning rate,
    data_norm and init scale; ``push_flags`` goes to the runner. The
    caller feeds each pass a dataset of the rank's row's files."""
    from paddlebox_tpu_torch.train.factory import create_trainer
    ps = ({} if ps_client is None
          else dict(ps_client=ps_client, ps_table_id=ps_table_id))
    runner = create_trainer(
        "SectionPSTrainer" if ps else "ShardedCtrPipelineTrainer",
        cfg.base.table(), feed, n_stages=cfg.n_stages, d_model=cfg.d_model,
        layers_per_stage=cfg.layers_per_stage, lr=cfg.lr,
        n_micro=cfg.n_micro, seed=seed, fleet=fleet,
        use_data_norm=cfg.use_data_norm, dn_slot_dim=cfg.dn_slot_dim,
        init_scale=cfg.init_scale, push_flags=push_flags, **ps)
    runner.metrics.init_metric("auc", "label", "pred", table_size=1 << 20)
    return runner


def build_pipeline_trainer(files: List[str], feed: DataFeedConfig,
                           cfg: PipeFlagship = FLAGSHIP_PIPE,
                           device: DeviceLike = None, seed: int = 0,
                           mesh=None):
    """(parallel/pipeline.py CtrPipelineRunner with an 'auc' metric,
    dataset over ``files``) of a pipeline configuration, made by
    train/factory.py's "CtrPipelineTrainer": ``cfg.base``'s table,
    ``cfg``'s stages, micro-batches, width, layers, learning rate,
    data_norm and init scale; ``mesh`` (a parallel/mesh.py AxisMesh;
    None: the world's stages) goes to the runner."""
    from paddlebox_tpu_torch.train.factory import create_trainer
    runner = create_trainer(
        "CtrPipelineTrainer", cfg.base.table(), feed, n_stages=cfg.n_stages,
        d_model=cfg.d_model, layers_per_stage=cfg.layers_per_stage,
        lr=cfg.lr, n_micro=cfg.n_micro, mesh=mesh, seed=seed,
        device=device, use_data_norm=cfg.use_data_norm,
        dn_slot_dim=cfg.dn_slot_dim, init_scale=cfg.init_scale)
    runner.metrics.init_metric("auc", "label", "pred", table_size=1 << 20)
    ds = BoxDataset(feed)
    ds.set_filelist(files)
    return runner, ds
