"""The small public names this slice ports, each against the reference on
the CPU: utils Channel / ChannelClosed and TimerScope, obs.log set_rank
and error, tracer.configure_from_flags, drift set_active_new and
observe_preds, mesh_comm resolve_hostplane and MeshConnectError,
models.layers num_layers (and the package-level mlp_init / mlp_apply)."""

import threading

import numpy as np
import pytest


def _channel_script(mod):
    """One sequence of channel operations and what each gave."""
    ch = mod.Channel(capacity=3, name="")
    out = []
    ch.put_many([1, 2, 3])
    out.append(len(ch))
    got = []
    t = threading.Thread(target=lambda: got.append(ch.put(4)))
    t.start()                       # blocks on the full channel
    out.append(ch.get())
    t.join(5)
    out.append(ch.get_many(2))
    out.append(ch.drain())
    with pytest.raises(TimeoutError):
        ch.get(timeout=0.01)
    ch.put(5)
    ch.close()
    out.append(ch.closed)
    with pytest.raises(mod.ChannelClosed):
        ch.put(6)
    out.append(list(ch))            # drains what was held, then stops
    with pytest.raises(mod.ChannelClosed):
        ch.get_many(1)
    return out


def test_channel_matches_the_reference():
    from paddlebox_tpu.utils import channel as jchannel
    from paddlebox_tpu_torch.utils import Channel, ChannelClosed, channel
    assert channel.Channel is Channel and channel.ChannelClosed is \
        ChannelClosed
    assert _channel_script(channel) == _channel_script(jchannel) == [
        3, 1, [2, 3], [4], True, [5]]


def test_timer_scope_matches_the_reference():
    from paddlebox_tpu.utils import Timer as JTimer
    from paddlebox_tpu.utils import TimerScope as JScope
    from paddlebox_tpu_torch.utils import Timer, TimerScope
    for timer, scope in ((Timer(), TimerScope), (JTimer(), JScope)):
        for _ in range(3):
            with scope(timer) as t:
                assert t is timer
        timer.resume()
        timer.pause()
        assert timer.count == 4
        assert timer.elapsed_us() == pytest.approx(timer.elapsed_ms() * 1e3,
                                                   rel=1e-9)


def test_log_set_rank_and_error(capsys):
    from paddlebox_tpu.obs import log as jlog
    from paddlebox_tpu_torch.obs import log
    from paddlebox_tpu_torch.utils.stats import stat_peek
    before = stat_peek("log_error_lines")
    try:
        for mod in (log, jlog):
            mod.set_rank(3)
            assert mod.get_rank() == 3
            mod.error("disk full", path="/x", n=2)
    finally:
        for mod in (log, jlog):
            mod._RANK = None
    err = capsys.readouterr().err.splitlines()
    tails = [ln.split("] ", 1)[1] for ln in err if "disk full" in ln]
    assert tails == ["disk full n=2 path=/x"] * 2
    assert all(ln.startswith("[pbtpu r3 ") for ln in err if "disk full" in ln)
    assert stat_peek("log_error_lines") == before + 1


def test_configure_from_flags():
    from paddlebox_tpu_torch.config.flags import ObsFlags
    from paddlebox_tpu_torch.obs import tracer
    t = tracer.get_tracer()
    was = (t.enabled, t.capacity)
    try:
        tracer.configure_from_flags(ObsFlags(obs_trace=False,
                                             obs_trace_capacity=128))
        assert (t.enabled, t.capacity) == (False, 128)
        tracer.configure_from_flags(ObsFlags(obs_trace=True,
                                             obs_trace_capacity=256))
        assert (t.enabled, t.capacity) == (True, 256)
    finally:
        tracer.configure(*was)


def test_drift_set_active_new_and_observe_preds():
    from paddlebox_tpu.metrics import drift as jdrift
    from paddlebox_tpu_torch.metrics import drift
    preds = np.random.RandomState(0).rand(500)
    mask = np.arange(500) % 3 != 0
    hists = []
    for mod in (drift, jdrift):
        prev = mod.active()
        try:
            m = mod.set_active_new()
            assert mod.active() is m and isinstance(m, mod.SlotDriftMonitor)
            mod.observe_preds(preds, mask=mask)
            hists.append(m._cur.pred_hist.copy())
        finally:
            mod.set_active(prev)
    np.testing.assert_array_equal(hists[0], hists[1])
    assert hists[0].sum() == mask.sum()


def test_resolve_hostplane_and_mesh_connect_error():
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.fleet import mesh_comm as jmc
    from paddlebox_tpu_torch.config.flags import ShardFlags
    from paddlebox_tpu_torch.fleet import mesh_comm
    for value in ("p2p", "store", " STORE "):
        old = jflags.get_flag("hostplane")
        jflags.set_flag("hostplane", value)
        try:
            want = jmc.resolve_hostplane()
        finally:
            jflags.set_flag("hostplane", old)
        assert mesh_comm.resolve_hostplane(ShardFlags(hostplane=value)) \
            == want
    assert mesh_comm.resolve_hostplane() == "p2p"
    with pytest.raises(ValueError, match="hostplane"):
        ShardFlags(hostplane="tcp")
    assert issubclass(mesh_comm.MeshConnectError, ConnectionError)
    assert issubclass(jmc.MeshConnectError, ConnectionError)


def test_num_layers_and_the_mlp_exports():
    import jax
    from paddlebox_tpu.models import layers as jlayers
    from paddlebox_tpu.models.base import ModelSpec as JSpec
    from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
    from paddlebox_tpu_torch.convert import params_from_jax
    from paddlebox_tpu_torch.models import DeepFM, mlp_apply, mlp_init
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.models.layers import num_layers
    jparams = JDeepFM(JSpec(4, 11), hidden=(16, 8)).init(
        jax.random.PRNGKey(0))
    model = DeepFM(ModelSpec(4, 11), hidden=(16, 8))
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}))
    for name in ("deep", "dnn", "mlp"):
        want = jlayers.num_layers(jparams, name)
        assert num_layers(model, name) == want
        assert num_layers(model.state_dict(), name) == want
        assert num_layers(jparams, name) == want
    assert num_layers(model, "deep") == 3
    assert callable(mlp_init) and callable(mlp_apply)
