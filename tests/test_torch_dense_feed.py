"""The port's feed with dense float slots and per-task labels against the
JAX package's on the CPU: the synthetic generator's files (byte for byte,
with and without dense columns and the conversion label), the record
parser's records, and the packed batches (``dense`` [B, dense_dim] f32 and
``task_labels``) on the record path and on the columnar path (the native
parser, ``psr_parse_file2``), each bit-equal to the JAX package's and to
each other; the packer's dense rules (a slot cut to its dim, zeros where
values are missing and on padding rows, the click label where a record has
no task label) on hand-written lines; ColumnarBlock's select / concat and
an empty block's batch schema; the task_label_slots check on both paths.
Every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from paddlebox_tpu.config.configs import DataFeedConfig as JFeed
from paddlebox_tpu.config.configs import SlotConfig as JSlot
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import \
    write_synthetic_ctr_files as jax_write
from paddlebox_tpu.data.parser import MultiSlotParser as JParser

from paddlebox_tpu_torch.config.configs import DataFeedConfig, SlotConfig
from paddlebox_tpu_torch.data.columnar import ColumnarBlock, pack_columnar
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.data.parser import MultiSlotParser

BATCH = 16
GEN = dict(num_files=2, lines_per_file=40, num_slots=4, vocab_per_slot=50,
           max_len=3, seed=5)
VARIANTS = {"plain": {}, "dense": dict(dense_dim=6),
            "conversion": dict(conversion=True),
            "hybrid": dict(dense_dim=13, conversion=True)}
FIELDS = ("keys", "slots", "segments", "valid", "labels", "ins_valid")


def _jfeed(feed):
    """The JAX package's DataFeedConfig of a port feed."""
    return JFeed(slots=tuple(JSlot(s.name, s.type, s.dim, s.is_used,
                                   s.max_len) for s in feed.slots),
                 batch_size=feed.batch_size,
                 task_label_slots=feed.task_label_slots)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generator_files_match_jax(variant, tmp_path):
    kw = dict(GEN, **VARIANTS[variant])
    jfiles, jfeed = jax_write(str(tmp_path / "jax"), **kw)
    pfiles, pfeed = write_synthetic_ctr_files(str(tmp_path / "port"), **kw)
    for a, b in zip(jfiles, pfiles, strict=True):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert _jfeed(pfeed) == jfeed
    assert [s.name for s in pfeed.used_dense_slots()] == (
        ["dense"] if "dense_dim" in kw else [])


# hand-written lines over click, label_cvr, two sparse slots and two dense
# slots of dims 3 and 2: values past a dim, a slot with no values, a
# record without its conversion value, a malformed line and a blank one
LINES = [
    "1 1 1 0 2 11 12 1 21 3 0.5 1.5 2.5 2 7.25 -1.0",
    "1 0 0 1 13 2 22 23 4 1.0 2.0 3.0 4.0 0",
    "1 1 1 1 1 14 1 24 1 9.0 1 3.0",
    "1 0 1 1 1 15 0 0 2 0.125 -0.5",
    "1 1 1 0 2 16",
    "",
    "1 1 1 0 1 17 1 25 3 1e-3 -2.5e2 3.75 2 0.1 0.2",
]


def _hand_feed(batch=4):
    return DataFeedConfig(
        slots=(SlotConfig("click", "float", is_used=False),
               SlotConfig("label_cvr", "float", is_used=False),
               SlotConfig("s0", max_len=2), SlotConfig("s1", max_len=2),
               SlotConfig("da", "float", dim=3),
               SlotConfig("db", "float", dim=2)),
        batch_size=batch, task_label_slots=(("cvr", "label_cvr"),))


@pytest.fixture
def hand_file(tmp_path):
    path = tmp_path / "hand.txt"
    path.write_text("\n".join(LINES) + "\n")
    return str(path)


def test_records_match_jax_parser():
    feed = _hand_feed()
    mine, theirs = MultiSlotParser(feed), JParser(_jfeed(feed))
    n = 0
    for line in LINES:
        a, b = mine.parse_line(line), theirs.parse_line(line)
        assert (a is None) == (b is None), line
        if a is None:
            continue
        n += 1
        assert a.label == b.label and a.extra_labels == b.extra_labels
        for ours, ref in ((a.uint64_slots, b.uint64_slots),
                          (a.float_slots, b.float_slots)):
            assert sorted(ours) == sorted(ref)
            for k in ours:
                assert ours[k].dtype == ref[k].dtype
                np.testing.assert_array_equal(ours[k], ref[k])
    assert n == 5


def _batches(feed, files, columnar, jax_side=False):
    if jax_side:
        ds = JDataset(_jfeed(feed), read_threads=1, columnar=columnar)
    else:
        ds = BoxDataset(feed, columnar=columnar)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.local_shuffle(3)
    return ds.split_batches(1)[0]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert (a.dense is None) == (b.dense is None)
        if a.dense is not None:
            assert a.dense.dtype == b.dense.dtype == np.float32
            np.testing.assert_array_equal(a.dense.view(np.uint32),
                                          b.dense.view(np.uint32))
        assert (a.task_labels or {}).keys() == (b.task_labels or {}).keys()
        for t, v in (a.task_labels or {}).items():
            assert v.dtype == np.int32
            np.testing.assert_array_equal(v, b.task_labels[t])


@pytest.mark.parametrize("path", ["record", "columnar"])
@pytest.mark.parametrize("variant", ["dense", "hybrid"])
def test_batches_match_jax(variant, path, tmp_path):
    files, feed = write_synthetic_ctr_files(str(tmp_path),
                                            **dict(GEN, **VARIANTS[variant]))
    feed = dataclasses.replace(feed, batch_size=BATCH)
    col = path == "columnar"
    got = _batches(feed, files, col)
    want = _batches(feed, files, col, jax_side=True)
    _assert_batches_equal(got, want)
    assert got[0].dense.shape == (BATCH, VARIANTS[variant]["dense_dim"])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_columnar_path_equals_record_path(variant, tmp_path):
    files, feed = write_synthetic_ctr_files(str(tmp_path),
                                            **dict(GEN, **VARIANTS[variant]))
    feed = dataclasses.replace(feed, batch_size=BATCH)
    _assert_batches_equal(_batches(feed, files, True),
                          _batches(feed, files, False))


def test_hand_lines_on_both_paths_and_against_jax(hand_file):
    """The dense and task-label rules on the hand-written lines: each path
    bit-equal to the other and to the JAX package's."""
    feed = _hand_feed()
    got = _batches(feed, [hand_file], True)
    _assert_batches_equal(got, _batches(feed, [hand_file], False))
    _assert_batches_equal(got, _batches(feed, [hand_file], True, True))
    _assert_batches_equal(got, _batches(feed, [hand_file], False, True))
    # unshuffled: the rules line by line
    ds = BoxDataset(feed)
    ds.set_filelist([hand_file])
    ds.load_into_memory()
    b0, b1 = ds.split_batches(1)[0]
    np.testing.assert_array_equal(b0.dense, np.float32(
        [[0.5, 1.5, 2.5, 7.25, -1.0],      # both slots whole
         [1.0, 2.0, 3.0, 0.0, 0.0],        # cut to 3, an empty slot
         [9.0, 0.0, 0.0, 3.0, 0.0],        # short slots
         [0.0, 0.0, 0.0, 0.125, -0.5]]))
    np.testing.assert_array_equal(b0.labels, [1, 0, 1, 0])
    # the second line has no conversion value: its click label, 0
    np.testing.assert_array_equal(b0.task_labels["cvr"], [0, 0, 1, 1])
    # the malformed line is dropped; the last batch's padding rows are zero
    assert b1.n_ins == 1 and not b1.dense[1:].any()
    np.testing.assert_array_equal(b1.dense[0], np.float32(
        [1e-3, -2.5e2, 3.75, 0.1, 0.2]))
    np.testing.assert_array_equal(b1.task_labels["cvr"], [0, 0, 0, 0])


def test_columnar_block_select_and_concat_carry_dense_and_tasks(hand_file):
    from paddlebox_tpu_torch.data.native_parser import NativeMultiSlotParser
    feed = _hand_feed()
    block = NativeMultiSlotParser(feed).parse_file_columnar(hand_file)
    assert block.n_recs == 5 and block.dense.shape == (5, 5)
    both = ColumnarBlock.concat([block, block.select(np.array([4, 0]))])
    assert both.n_recs == 7
    np.testing.assert_array_equal(both.dense[5:], block.dense[[4, 0]])
    np.testing.assert_array_equal(both.task_labels["cvr"][5:],
                                  block.task_labels["cvr"][[4, 0]])
    tail, picked = both.select(np.array([5, 6])), block.select(
        np.array([4, 0]))
    for f in ("keys", "key_slot", "labels", "rec_offsets", "dense"):
        np.testing.assert_array_equal(getattr(tail, f), getattr(picked, f))


def test_an_empty_block_packs_the_feed_schema():
    """A block of no record packs dense zeros and click-label task columns
    keyed on the feed, as the record path's packer does."""
    feed = _hand_feed()
    empty = ColumnarBlock.concat([])
    b = pack_columnar(empty, np.zeros(0, np.int64), feed, 64, 2,
                      np.array([2, 2]))
    assert b.dense.shape == (4, 5) and not b.dense.any()
    assert list(b.task_labels) == ["cvr"] and not b.task_labels["cvr"].any()


@pytest.mark.parametrize("columnar", [True, False],
                         ids=["columnar", "record"])
def test_task_label_slot_missing_raises(columnar):
    feed = dataclasses.replace(_hand_feed(),
                               task_label_slots=(("pay", "label_pay"),))
    with pytest.raises(ValueError, match="label_pay"):
        BoxDataset(feed, columnar=columnar)
