"""The feed's inputs and outputs against the JAX package: pipe_command and
.gz input, parser plugins, the archive spill and its codec, the file
manager.

The same files go through both packages on the CPU. Records are compared
field by field (exact); archive files byte for byte; a pass trained from
``load_into_disk``'s shards against the reference's pass over the text
files with replayed push seeds: loss rtol 1e-4, AUC 1e-4 absolute (float
reductions in another order, as tests/test_torch_train.py states), and
bit for bit against the port's own text pass.
"""

import functools
import gzip
import os
import shutil
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (DataFeedConfig as JFeed,
                                          SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data import archive as jarchive
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.data.plugin import load_parser_plugin as jload_plugin
from paddlebox_tpu.data.slot_record import SlotRecord as JRecord
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer
from paddlebox_tpu.utils import file_mgr as jfile_mgr

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import HostFlags, PushFlags
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data import archive
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.plugin import load_parser_plugin
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from paddlebox_tpu_torch.utils import file_mgr

D = 8
NUM_SLOTS = 4
BATCH = 32
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
FIELDS = ("label", "rank", "cmatch", "qvalue", "search_id", "ins_id",
          "extra_labels")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("feed_io")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=48, num_slots=NUM_SLOTS,
        vocab_per_slot=40, max_len=3, seed=11)
    gz = []
    for f in files:
        with open(f, "rb") as src, gzip.open(f + ".gz", "wb") as dst:
            dst.write(src.read())
        gz.append(f + ".gz")
    jfeed = JFeed(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, gz, jfeed, pfeed


def rec_tuple(r):
    return (tuple(getattr(r, k) for k in FIELDS),
            {k: v.tolist() for k, v in sorted(r.uint64_slots.items())},
            {k: v.tolist() for k, v in sorted(r.float_slots.items())})


def load(ds, files):
    ds.set_filelist(files)
    ds.load_into_memory()
    return [rec_tuple(r) for r in ds.records]


def with_pipe(feed, cmd):
    return type(feed)(**{**feed.__dict__, "pipe_command": cmd})


@pytest.mark.parametrize("case", ["pipe_cat", "pipe_head", "gz",
                                  "gz_pipe"])
def test_pipe_and_gz_match_the_reference_record_path(data, case):
    """The port's default (columnar) dataset takes the record path for a
    pipe or a .gz file and gives the reference record path's records."""
    files, gz, jfeed, pfeed = data
    cmd = {"pipe_cat": "cat", "pipe_head": "head -n 30", "gz": "",
           "gz_pipe": "head -n 30"}[case]
    inputs = gz if case.startswith("gz") else files
    ours = BoxDataset(with_pipe(pfeed, cmd))
    assert ours.columnar
    got = load(ours, inputs)
    assert not ours._load_columnar and ours.block is None
    want = load(JDataset(with_pipe(jfeed, cmd), read_threads=1,
                         columnar=False), inputs)
    assert got == want
    plain = load(BoxDataset(pfeed, columnar=False), files)
    if "head" in cmd:
        assert len(got) == 60 and got == plain[:30] + plain[48:78]
    else:
        assert got == plain


def test_reference_columnar_load_skips_the_pipe(data):
    """The reference's columnar load reads each file itself, so its
    pipe_command does nothing there (ROADMAP.md C); the port pipes."""
    files, _, jfeed, pfeed = data
    jds = JDataset(with_pipe(jfeed, "head -n 30"), read_threads=1)
    jds.set_filelist(files)
    jds.load_into_memory()
    assert jds.columnar and len(jds) == 96
    ours = BoxDataset(with_pipe(pfeed, "head -n 30"))
    ours.set_filelist(files)
    ours.load_into_memory()
    assert len(ours) == 60


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_failing_pipe_command_raises(data, pkg):
    files, _, jfeed, pfeed = data
    if pkg == "port":
        ds = BoxDataset(with_pipe(pfeed, "exit 3"))
    else:
        ds = JDataset(with_pipe(jfeed, "exit 3"), read_threads=1,
                      columnar=False)
    ds.set_filelist(files[:1])
    with pytest.raises(RuntimeError, match="dataset load failed") as e:
        ds.load_into_memory()
    assert isinstance(e.value.__cause__, IOError)
    assert "exit 3" in str(e.value.__cause__)
    assert files[0] in str(e.value.__cause__)


PLUGIN = '''
import importlib


class EveryOther:
    """Keeps every other record of the package's own parser."""

    def __init__(self, feed):
        pkg = type(feed).__module__.split(".")[0]
        self.inner = importlib.import_module(
            pkg + ".data.parser").MultiSlotParser(feed)

    def parse_file(self, path):
        for i, rec in enumerate(self.inner.parse_file(path)):
            if i % 2 == 0:
                yield rec


def make_parser(feed):
    return EveryOther(feed)
'''


def test_py_plugin_yields_the_same_records(data, tmp_path):
    files, _, jfeed, pfeed = data
    path = tmp_path / "every_other.py"
    path.write_text(PLUGIN)
    ours = BoxDataset(pfeed, parser=load_parser_plugin(str(path), pfeed))
    assert not ours.columnar
    got = load(ours, files)
    want = load(JDataset(jfeed, read_threads=1,
                         parser=jload_plugin(str(path), jfeed)), files)
    assert got == want and len(got) == 48
    bad = tmp_path / "bad.py"
    bad.write_text("x = 1\n")
    for loader, feed in ((load_parser_plugin, pfeed),
                         (jload_plugin, jfeed)):
        with pytest.raises(AttributeError, match="make_parser"):
            loader(str(bad), feed)
        with pytest.raises(ValueError, match=".py module or native .so"):
            loader(str(tmp_path / "x.txt"), feed)


def test_so_plugin_is_the_columnar_parser(data, tmp_path):
    """A shared object with the slot parser's entries (here the port's own
    host library, copied) parses the columnar path's blocks."""
    files, _, _, pfeed = data
    lib = str(tmp_path / "libplugin.so")
    shutil.copy(host_lib.build_host_lib(), lib)
    parser = load_parser_plugin(lib, pfeed)
    ours = BoxDataset(pfeed, parser=parser)
    assert ours.columnar and ours.parser is parser
    base = BoxDataset(pfeed)
    for ds in (ours, base):
        ds.set_filelist(files)
        ds.load_into_memory()
    np.testing.assert_array_equal(ours.block.keys, base.block.keys)
    with pytest.raises(ValueError, match="columnar blocks only"):
        BoxDataset(pfeed, parser=parser, columnar=False)


def odd_records(cls):
    """Records with every codec field set: cmatch past 16 bits, float
    slots, task labels, an ins_id, and a cache_idx the codec drops."""
    rng = np.random.RandomState(3)
    out = []
    for i in range(40):
        out.append(cls(
            label=i % 2, ins_id="ins-%d" % i, rank=i % 5,
            cmatch=(i * 7919) & 0x3FFFF, qvalue=float(np.float32(i / 7)),
            search_id=(1 << 40) + i,
            uint64_slots={s: rng.randint(1, 1 << 62, size=1 + (i + s) % 3,
                                         dtype=np.uint64)
                          for s in range(3) if (i + s) % 4},
            float_slots={0: rng.rand(2).astype(np.float32)} if i % 3 else {},
            extra_labels={"cvr": i % 3} if i % 2 else {},
            **({"cache_idx": i} if cls is SlotRecord else {})))
    return out


def test_codec_bytes_equal_and_cross_read():
    ours, theirs = odd_records(SlotRecord), odd_records(JRecord)
    blob = archive.serialize_records(ours)
    from paddlebox_tpu.data.shuffle import (deserialize_records,
                                            serialize_records)
    assert blob == serialize_records(theirs)
    back = archive.deserialize_records(serialize_records(theirs))
    want = [rec_tuple(r) for r in deserialize_records(blob)]
    assert [rec_tuple(r) for r in back] == want
    for r, src in zip(back, ours):
        assert r.cmatch == src.cmatch & 0xFFFF and r.cache_idx == -1


@pytest.mark.parametrize("max_bytes", [0, 2000], ids=["one", "rotated"])
def test_archive_files_byte_equal_and_cross_read(tmp_path, max_bytes):
    ours, theirs = odd_records(SlotRecord), odd_records(JRecord)
    pw = archive.BinaryArchiveWriter(str(tmp_path / "p" / "part"),
                                     max_bytes)
    jw = jarchive.BinaryArchiveWriter(str(tmp_path / "j" / "part"),
                                      max_bytes or (2 << 30))
    for lo in range(0, 40, 8):
        pw.write_records(ours[lo:lo + 8])
        jw.write_records(theirs[lo:lo + 8])
    pfiles, jfiles = pw.close(), jw.close()
    assert len(pfiles) == len(jfiles)
    assert (len(pfiles) > 1) == bool(max_bytes)
    for a, b in zip(pfiles, jfiles):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        assert archive.is_archive(a) and jarchive.is_archive(a)
        got = [rec_tuple(r) for blk in archive.read_archive(b) for r in blk]
        want = [rec_tuple(r) for blk in jarchive.read_archive(a)
                for r in blk]
        assert got == want
    assert not archive.is_archive(str(tmp_path / "missing"))
    assert HostFlags().dump_file_max_bytes == 2 << 30


def _trainers(jfeed, pfeed, seed=0):
    table = dict(embedx_dim=D, pass_capacity=CAP)
    jt = JTrainer(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                          hidden=HIDDEN),
                  JTable(optimizer=JSparse(**OPT), **table), jfeed,
                  JTrainerCfg(dense_lr=LR, scan_chunk=1), seed=seed)
    pts = []
    for _ in range(2):
        model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                       hidden=HIDDEN)
        model.load_state_dict(params_from_jax(
            {k: np.asarray(v) for k, v in jt.params.items()}))
        pts.append(BoxTrainer(model, TableConfig(
            optimizer=SparseOptimizerConfig(**OPT), **table), pfeed,
            TrainerConfig(dense_lr=LR, scan_chunk=1), seed=seed,
            flags=PushFlags("scatter"), device="cpu"))
    for t in [jt] + pts:
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return jt, pts


@pytest.fixture
def pallas_interpret(monkeypatch):
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))
    yield
    jflags.set_flag("use_pallas_push", False)


def jax_pass_seeds(table, n):
    key, prng = jax.random.split(table._prng)
    seeds = []
    for _ in range(n):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds


def test_archive_spill_trains_as_the_text_files(data, tmp_path,
                                                pallas_interpret):
    """load_into_disk, then a pass from its shards (small max_bytes, so
    they rotate): the reference's text pass within loss rtol 1e-4 and AUC
    1e-4, and the port's text pass bit for bit."""
    files, _, jfeed, pfeed = data
    spill = BoxDataset(pfeed)
    spill.set_filelist(files)
    spill.load_into_disk(str(tmp_path / "spill" / "pass0"), max_bytes=4096)
    assert len(spill.disk_files) > 1 and len(spill) == 0
    assert all(archive.is_archive(f) for f in spill.disk_files)
    jt, (pa, pt) = _trainers(jfeed, pfeed)
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    jds.set_filelist(files)
    ads = BoxDataset(pfeed)
    ads.set_filelist(spill.disk_files)
    tds = BoxDataset(pfeed, columnar=False)
    tds.set_filelist(files)
    seeds = jax_pass_seeds(jt.table, 3)
    out = {}
    for name, t, ds in (("jax", jt, jds), ("archive", pa, ads),
                        ("text", pt, tds)):
        if name != "jax":
            t.seed_fn = iter(seeds).__next__
        res = t.train_pass(ds)
        out[name] = (res["loss"], t.metrics.get_metric_msg("auc")["auc"])
    assert not ads._load_columnar and len(ads) == 96
    assert out["archive"] == out["text"]
    np.testing.assert_allclose(out["archive"][0], out["jax"][0], rtol=1e-4)
    assert abs(out["archive"][1] - out["jax"][1]) <= 1e-4
    np.testing.assert_array_equal(pa.table.store.lookup(pa.table.pass_keys),
                                  pt.table.store.lookup(pt.table.pass_keys))
    for t in (jt, pa, pt):
        t.close()


FAKE_FS = ("#!/bin/sh\n"
           "verb=$1; shift\n"
           "case $verb in\n"
           "  -ls) ls -la $1 | awk -v d=$1 'NR>1 {print $1, d\"/\"$NF}';;\n"
           "  -test) shift; test -e $1;;\n"
           "  -get) cp $1 $2;;\n"
           "  -put) cp $1 $2;;\n"
           "  -mkdir) shift; mkdir -p $1;;\n"
           "  -touchz) touch $1;;\n"
           "  -mv) mv $1 $2;;\n"
           "  -rm) shift; rm -rf $1;;\n"
           "  -du) wc -c < $1;;\n"
           "esac\n")


def _drive(mod, root, shell):
    """The same operations through one package's file manager: the
    observations, with ``root`` stripped from paths."""
    if shell:
        fake = os.path.join(root, "fakefs")
        with open(fake, "w") as f:
            f.write(FAKE_FS)
        os.chmod(fake, os.stat(fake).st_mode | stat.S_IEXEC)
        m = mod.make_file_mgr(fake)
        assert isinstance(m, mod.ShellFileMgr)
    else:
        m = mod.make_file_mgr("")
        assert isinstance(m, mod.LocalFileMgr)
    d = os.path.join(root, "remote")
    m.mkdir(d)
    src = os.path.join(root, "local.txt")
    with open(src, "w") as f:
        f.write("hello")
    m.upload(src, os.path.join(d, "r.txt"))
    m.touch(os.path.join(d, "t.txt"))
    obs = [m.exists(os.path.join(d, "r.txt")),
           m.exists(os.path.join(d, "missing")),
           m.file_size(os.path.join(d, "r.txt")),
           sorted(os.path.basename(p) for p in m.list_dir(d)
                  if p.endswith(".txt"))]
    m.rename(os.path.join(d, "r.txt"), os.path.join(d, "s.txt"))
    m.download(os.path.join(d, "s.txt"), os.path.join(root, "back.txt"))
    with open(os.path.join(root, "back.txt")) as f:
        obs.append(f.read())
    m.remove(d)
    obs.append(m.exists(d))
    return obs


@pytest.mark.parametrize("shell", [False, True], ids=["local", "shell"])
def test_file_mgr_matches_the_reference(tmp_path, shell):
    for side in ("port", "ref"):
        os.makedirs(tmp_path / side)
    got = _drive(file_mgr, str(tmp_path / "port"), shell)
    want = _drive(jfile_mgr, str(tmp_path / "ref"), shell)
    assert got == want
    assert got[:3] == [True, False, 5] and got[-2:] == ["hello", False]
    with pytest.raises(IOError, match="file mgr command failed"):
        file_mgr.ShellFileMgr("false").mkdir(str(tmp_path / "x"))
