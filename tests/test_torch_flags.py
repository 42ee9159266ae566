"""The port's flag surface and configs against the JAX package's.

Every reference flag the port reads is a field of one of the port's flag
dataclasses (config/flags.py FLAG_CLASSES) under the same name, and takes
the same PBTPU_<NAME> override: with every such variable set to a value
off its default, each package runs in a subprocess of its own and the
port's fields equal the reference's registry (exact). The reference flags
the port declines are pinned below; every other reference flag must be a
port field. The config dataclasses have equal field sets, and the rules
the flags feed (key_capacity's order, check_nan_inf's default,
dataset_disable_shuffle, the explicit argument over the environment, no
half-applied environment) hold.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from paddlebox_tpu.config import configs as jconfigs
from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files

from paddlebox_tpu_torch.config import configs
from paddlebox_tpu_torch.config.flags import (FLAG_CLASSES, HostFlags,
                                              ObsFlags, PushFlags,
                                              StageFlags)
from paddlebox_tpu_torch.data.dataset import BoxDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference flags the port does not read, by where they go
LEFT_TO = {
    "declined": ("push_onehot_rows", "push_blocked_pallas",
                 "use_pallas_push", "flatten_dense_opt"),
}

# a valid value off the default for the string flags
STR_VALUES = {"push_write": "blocked", "slab_embed_dtype": "bfloat16",
              "matmul_dtype": "bfloat16", "ckpt_format": "pickle",
              "obs_watchdog_action": "raise",
              "obs_report_path": "/nonexistent/report.jsonl",
              "obs_flight_dir": "/nonexistent/flight",
              "sharding_policy": "table-wise", "hostplane": "store",
              "serving_shard_policy": "2d-grid",
              "serving_hot_keys": "/nonexistent/hot.keys",
              "serving_journal_dir": "/nonexistent/journal"}


def port_fields():
    return {f.name: (cls, f) for cls in FLAG_CLASSES
            for f in dataclasses.fields(cls)}


def off_default(name, default):
    """A PBTPU_ value off ``default`` and its parsed value."""
    if isinstance(default, bool):
        return ("0" if default else "1"), (not default)
    if isinstance(default, int):
        return str(default + 3), default + 3
    if isinstance(default, float):
        return repr(default + 0.5), default + 0.5
    return STR_VALUES[name], STR_VALUES[name]


def test_every_reference_flag_is_a_port_field_or_pinned():
    pinned = [n for names in LEFT_TO.values() for n in names]
    assert len(pinned) == len(set(pinned))
    ref = set(jflags.all_flags())
    assert set(pinned) <= ref, set(pinned) - ref
    fields = port_fields()
    assert set(fields) == ref - set(pinned), (
        set(fields) ^ (ref - set(pinned)))
    # a field and its flag share the default
    for name, (cls, f) in fields.items():
        assert getattr(cls(), name) == jflags._REGISTRY[name].default, name


def _run(code, env):
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_overrides_match_the_reference_in_subprocesses():
    """Every field's PBTPU_<NAME> at once, off its default: the port's
    value equals the reference registry's, each in its own process."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PBTPU_")}
    want = {}
    for name, (cls, f) in port_fields().items():
        raw, value = off_default(name, getattr(cls(), name))
        env["PBTPU_" + name.upper()] = raw
        want[name] = value
    ref = _run("import json\nfrom paddlebox_tpu.config import flags\n"
               "print(json.dumps(flags.all_flags()))", env)
    port = _run(
        "import dataclasses, json\n"
        "from paddlebox_tpu_torch.config.flags import FLAG_CLASSES\n"
        "print(json.dumps({f.name: getattr(c(), f.name) for c in "
        "FLAG_CLASSES for f in dataclasses.fields(c)}))", env)
    for name, value in want.items():
        assert port[name] == ref[name] == value, (name, port[name],
                                                  ref[name])


def test_explicit_arguments_win_and_off_stays_off(monkeypatch):
    monkeypatch.setenv("PBTPU_PUSH_WRITE", "blocked")
    monkeypatch.setenv("PBTPU_OBS_TRACE", "1")
    monkeypatch.setenv("PBTPU_STACK_THREADS", "7")
    assert PushFlags().push_write == "blocked"
    assert PushFlags("scatter").push_write == "scatter"
    assert StageFlags().stack_threads == 7
    assert StageFlags(stack_threads=2).stack_threads == 2
    assert ObsFlags.off().obs_trace is False
    monkeypatch.setenv("PBTPU_PUSH_WRITE", "nope")
    with pytest.raises(ValueError, match="push_write"):
        PushFlags()
    monkeypatch.setenv("PBTPU_STACK_THREADS", "x")
    with pytest.raises(ValueError, match="PBTPU_STACK_THREADS"):
        StageFlags()


def test_an_env_set_after_import_reaches_only_later_objects(monkeypatch):
    """flagship.build_trainer makes its flags at the call, so a variable
    set after the import reaches the next trainer whole."""
    from paddlebox_tpu_torch.train import flagship
    import inspect
    sig = inspect.signature(flagship.build_trainer)
    for name in ("pass_flags", "stage_flags", "obs_flags", "push_flags"):
        assert sig.parameters[name].default is None, name
    before = StageFlags()
    monkeypatch.setenv("PBTPU_H2D_LEAN", "1")
    monkeypatch.setenv("PBTPU_WIRE_DELTA_IDS", "1")
    assert not before.h2d_lean and before.wire == "full"
    assert StageFlags().wire == "delta"


def test_config_field_sets_equal():
    names = [n for n, v in vars(jconfigs).items()
             if isinstance(v, type) and dataclasses.is_dataclass(v)]
    assert sorted(names) == ["CheckpointConfig", "DataFeedConfig",
                             "MeshConfig", "SlotConfig",
                             "SparseOptimizerConfig", "TableConfig",
                             "TrainerConfig"]
    for n in names:
        ours = {f.name: f for f in dataclasses.fields(getattr(configs, n))}
        theirs = {f.name: f for f in dataclasses.fields(getattr(jconfigs,
                                                                  n))}
        assert set(ours) == set(theirs), (n, set(ours) ^ set(theirs))
        if n == "SlotConfig":
            continue   # `name` has no default
        ref_default = getattr(jconfigs, n)()
        for k in ours:
            if k == "optimizer":
                continue
            assert getattr(getattr(configs, n)(), k) == \
                getattr(ref_default, k), (n, k)


@pytest.mark.parametrize("field,value", [
    ("sync_weight_step", 4), ("sync_one_ring", True),
    ("a2a_dtype", "bfloat16")])
def test_a10_trainer_fields_refused(field, value):
    """The config takes the multi-device fields (as the reference's does);
    the single-device trainer refuses them, naming A10 (the sharded
    trainer's refusals: tests/test_torch_sharded.py)."""
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.models.deepfm import DeepFM
    from paddlebox_tpu_torch.train.trainer import BoxTrainer
    assert getattr(configs.TrainerConfig(), field) == getattr(
        jconfigs.TrainerConfig(), field)
    cfg = configs.TrainerConfig(**{field: value})
    jconfigs.TrainerConfig(**{field: value})
    feed = configs.DataFeedConfig(slots=(configs.SlotConfig("s0"),),
                                  batch_size=4)
    with pytest.raises(ValueError, match="A10"):
        BoxTrainer(DeepFM(ModelSpec(1, 3 + 8), hidden=(4,)),
                   configs.TableConfig(embedx_dim=8, pass_capacity=64),
                   feed, cfg, device="cpu")
    for bad in ({"sync_weight_step": 0}, {"a2a_dtype": "float16"}):
        with pytest.raises(ValueError):
            configs.TrainerConfig(**bad)


def test_mesh_sizes_refused():
    """Sizes above 1 are taken (parallel/mesh.py make_mesh lays them
    out); a size that is not a positive int is refused."""
    configs.MeshConfig()
    assert configs.MeshConfig(data=2, pipeline=4).pipeline == 4
    jconfigs.MeshConfig(data=2, pipeline=4)
    for bad in (0, -2, 2.0):
        with pytest.raises(ValueError, match="positive int"):
            configs.MeshConfig(data=bad)


SLOTS = (("s0", 4), ("s1", 2), ("s2", 20))


@pytest.mark.parametrize("field,flag,batch", [
    (0, 0, None), (0, 0, 7), (0, 4096, None), (999, 4096, 7), (999, 0, 7)])
def test_key_capacity_order(monkeypatch, field, flag, batch):
    """The feed's field, then padbox_max_batch_keys, then the heuristic
    with ``batch_size`` (reference configs.py:125-133)."""
    monkeypatch.setattr(jflags._REGISTRY["padbox_max_batch_keys"], "value",
                        flag)
    monkeypatch.setenv("PBTPU_PADBOX_MAX_BATCH_KEYS", str(flag))
    jfeed = jconfigs.DataFeedConfig(
        slots=tuple(jconfigs.SlotConfig(n, max_len=m) for n, m in SLOTS),
        batch_size=64, batch_key_capacity=field)
    pfeed = configs.DataFeedConfig(
        slots=tuple(configs.SlotConfig(n, max_len=m) for n, m in SLOTS),
        batch_size=64, batch_key_capacity=field)
    assert pfeed.key_capacity(batch) == jfeed.key_capacity(batch)


@pytest.mark.parametrize("raw", [None, "1"])
def test_check_nan_inf_default_from_env(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("PBTPU_CHECK_NAN_INF", raising=False)
    else:
        monkeypatch.setenv("PBTPU_CHECK_NAN_INF", raw)
    assert configs.TrainerConfig().check_nan_inf is (raw is not None)
    assert configs.TrainerConfig(check_nan_inf=False).check_nan_inf is False
    assert HostFlags().check_nan_inf is (raw is not None)


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    out = tmp_path_factory.mktemp("flags_files")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=1, lines_per_file=40, num_slots=3,
        vocab_per_slot=30, max_len=2, seed=5)
    pfeed = configs.DataFeedConfig(
        slots=tuple(configs.SlotConfig(s.name, s.type, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=8)
    return files, feed, pfeed


@pytest.mark.parametrize("columnar", [False, True],
                         ids=["record", "columnar"])
def test_dataset_disable_shuffle_keeps_the_load_order(small_files,
                                                      columnar):
    files, jfeed, pfeed = small_files

    def keys(ds):
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.local_shuffle(3)
        return np.concatenate([b.keys[b.valid] for b in
                               ds.split_batches(1)[0]])

    loaded = keys(BoxDataset(pfeed, columnar=columnar,
                             flags=HostFlags(dataset_disable_shuffle=True)))
    shuffled = keys(BoxDataset(pfeed, columnar=columnar))
    jflags.set_flag("dataset_disable_shuffle", True)
    try:
        ref = keys(JDataset(jfeed, read_threads=1, columnar=columnar))
    finally:
        jflags.set_flag("dataset_disable_shuffle", False)
    np.testing.assert_array_equal(loaded, ref)
    assert not np.array_equal(loaded, shuffled)
