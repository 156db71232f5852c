"""``inference.Config`` of paddle_tpu_torch vs paddle_tpu's, and the
``create_serving_engine(model, config)`` / ``create_serving_frontend(
model, config)`` entry points, on the CPU.

- the same calls give the same ``serving_config()`` and
  ``frontend_config()`` dicts and the same ``summary()``, apart from the
  port's ``device`` (the card ``cuda:<id>`` by default, ``cpu`` after
  ``disable_gpu()``), a key the JAX package's config lacks;
- an engine and a frontend built from a config stream what the same
  knobs passed as keyword arguments stream (and paddle_tpu's engine
  built from its config);
- a config without ``enable_serving`` is refused with the JAX package's
  "serving disabled" error, and so is any other object;
- the ``enable_serving`` cases of the JAX suite: the prefix-cache knob,
  the int8 knobs and ``prefill_replicas`` through the frontend factory.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import create_serving_engine as jax_create_engine
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.inference import Config
from paddle_tpu_torch.serving import (create_serving_engine,
                                      create_serving_frontend)
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 50


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


def _cpu_config(**knobs):
    cfg = Config()
    cfg.disable_gpu()
    cfg.enable_serving(**knobs)
    return cfg


KNOB_SETS = {
    "defaults": {},
    "engine": dict(max_batch_size=2, page_size=4, num_pages=17,
                   max_seq_len=48, eos_id=5, prefill_chunk=8,
                   sync_mode=True, fused_steps=4),
    "quant_prefix_spec": dict(kv_cache_dtype="int8", weight_dtype="int8",
                              prefix_cache=True, spec_decode=3,
                              numeric_guards=False),
    "frontend": dict(replicas=3, queue_cap=None, default_deadline_ms=250,
                     snapshot_interval=None, watchdog=True, brownout=True),
}


@pytest.mark.parametrize("knobs", sorted(KNOB_SETS))
def test_config_dicts_equal_jax(knobs):
    got, want = Config("model/net.pdmodel"), JaxConfig("model/net.pdmodel")
    for cfg in (got, want):
        cfg.enable_serving(**KNOB_SETS[knobs])
    sc = got.serving_config()
    assert sc.pop("device") == "cuda:0"
    assert sc == want.serving_config()
    assert got.frontend_config() == want.frontend_config()
    summ, jsumm = got.summary(), want.summary()
    assert summ.pop("device") == "cuda:0" and jsumm.pop("device") == "tpu"
    assert summ == jsumm
    for name in ("prog_file", "params_file", "model_dir", "ir_optim",
                 "use_gpu", "gpu_device_id", "serving_enabled"):
        assert getattr(got, name)() == getattr(want, name)(), name


def test_config_device_and_parity_knobs():
    cfg = Config()
    cfg.enable_serving(page_size=4)
    assert cfg.use_gpu() and cfg.serving_config()["device"] == "cuda:0"
    cfg.enable_use_gpu(memory_pool_init_size_mb=200, device_id=1)
    assert cfg.gpu_device_id() == 1
    assert cfg.serving_config()["device"] == "cuda:1"
    assert cfg.summary()["device"] == "cuda:1"
    cfg.disable_gpu()
    assert not cfg.use_gpu() and cfg.serving_config()["device"] == "cpu"
    cfg.set_model("other/m.pdmodel", "other/w.bin")
    assert (cfg.prog_file(), cfg.params_file()) == ("other/m.pdmodel",
                                                    "other/w.bin")
    # the parity no-ops take the reference's arguments and change nothing
    cfg.switch_ir_optim(False)
    cfg.enable_memory_optim()
    cfg.set_warmup(False)
    cfg.enable_tensorrt_engine(workspace_size=1 << 20)
    cfg.enable_mkldnn()
    cfg.disable_glog_info()
    assert not cfg.ir_optim() and cfg.summary()["warmup"] is False


def test_serving_disabled_is_refused(port):
    for cfg in (Config(), object()):
        with pytest.raises(InvalidArgumentError, match="serving disabled"):
            create_serving_engine(port, cfg)
        with pytest.raises(InvalidArgumentError, match="serving disabled"):
            create_serving_frontend(port, cfg)
    with pytest.raises(ValueError, match="enable_serving"):
        Config().serving_config()
    with pytest.raises(ValueError, match="enable_serving"):
        Config().frontend_config()


def test_default_config_targets_the_card(port):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = Config()
    cfg.enable_serving(page_size=4)
    with pytest.raises(RuntimeError, match="cuda"):
        create_serving_engine(port, cfg)


def _drive(eng, prompts, budget=6):
    for i, p in enumerate(prompts):
        eng.add_request(p, max_new_tokens=budget, request_id=f"r{i}")
    return eng.drain()


PROMPTS = [np.random.RandomState(40 + i).randint(1, VOCAB, (3 + 5 * i,))
           .astype(np.int32) for i in range(3)]


def test_engine_from_config_equals_kwargs_and_jax(shared_gpt_small, port):
    knobs = dict(max_batch_size=2, page_size=4, eos_id=-1, prefill_chunk=8,
                 prefix_cache=True)
    eng = create_serving_engine(port, _cpu_config(**knobs))
    assert eng.device == torch.device("cpu")
    assert eng.prefix_cache is not None and eng.scheduler.max_batch_size == 2
    got = _drive(eng, PROMPTS)
    want = _drive(create_serving_engine(port, device="cpu", **knobs),
                  PROMPTS)
    jcfg = JaxConfig()
    jcfg.enable_serving(**knobs)
    jax_out = _drive(jax_create_engine(shared_gpt_small, jcfg), PROMPTS)
    assert sorted(got) == sorted(want) == sorted(jax_out)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
        np.testing.assert_array_equal(got[rid], jax_out[rid], err_msg=rid)
    # keyword arguments override the config
    over = create_serving_engine(port, _cpu_config(**knobs),
                                 max_batch_size=3, prefix_cache=False)
    assert over.scheduler.max_batch_size == 3 and over.prefix_cache is None


def test_frontend_from_config_equals_kwargs(port):
    knobs = dict(max_batch_size=4, page_size=4, eos_id=-1, replicas=2,
                 snapshot_interval=None)
    streams = {}
    for how in ("config", "kwargs"):
        if how == "config":
            fe = create_serving_frontend(port, _cpu_config(**knobs))
        else:
            fe = create_serving_frontend(port, device="cpu", **knobs)
        try:
            assert len(fe._replicas) == 2 and fe.device.type == "cpu"
            handles = [fe.submit(p, max_new_tokens=6) for p in PROMPTS]
            assert [h.wait(timeout=120) for h in handles] == \
                ["completed"] * len(PROMPTS)
            streams[how] = [np.asarray(h.tokens) for h in handles]
        finally:
            fe.close()
    for a, b in zip(streams["config"], streams["kwargs"]):
        np.testing.assert_array_equal(a, b)


def test_config_enable_serving_prefix_knob(port):
    eng = create_serving_engine(port, _cpu_config(max_batch_size=2,
                                                  page_size=4,
                                                  prefix_cache=True))
    assert eng.prefix_cache is not None
    assert create_serving_engine(port, _cpu_config(
        max_batch_size=2, page_size=4)).prefix_cache is None


def test_config_int8_passthrough(port):
    eng = create_serving_engine(port, _cpu_config(
        max_batch_size=2, page_size=4, kv_cache_dtype="int8",
        weight_dtype="int8"))
    assert eng.kv_cache_dtype == "int8" and eng.weight_dtype == "int8"


def test_create_serving_frontend_passes_prefill_replicas(port):
    fe = create_serving_frontend(port, _cpu_config(page_size=4,
                                                   max_batch_size=4,
                                                   eos_id=0),
                                 prefill_replicas=1)
    try:
        roles = sorted((rep.id, rep.role) for rep in fe._replicas)
        assert roles == [("prefill-0", "prefill"), ("replica-0", "decode")]
    finally:
        fe.close()
