"""The declarative half on the card: artifacts saved by ``jit.save`` on
the CPU and on the card, run through ``jit.load`` on the card and the
CPU, with the attention's route decided when the program runs; a
``to_static`` BERT's forward and backward on the flash kernels; a static
Program trained through ``Executor`` on the card against the CPU.

Every test here is marked ``cuda`` and skips itself where
``torch.cuda.is_available()`` is False.  The file imports no JAX; run it
on the card's machine without the suite's conftest:

    python -m pytest tests/test_torch_cuda_declarative.py --noconftest -q

Tolerances: outputs of an artifact against the eager model on the same
device 1e-4 of the largest magnitude (the same kernels: f32, TF32 off);
across devices 1e-4 (the flash bodies' 3xTF32 against the CPU's plain
f32 softmax); static losses against the CPU's rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import jit, nn, optimizer, static
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.ops.attention import ROUTE_STATS
from paddle_tpu_torch.ops.flash_attention import FLASH_ROUTE_STATS
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.text.models import BertForSequenceClassification

pytestmark = pytest.mark.cuda

SMALL = dict(num_classes=2, vocab_size=128, hidden_size=64,
             num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=128, max_position_embeddings=256,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             dropout=0.0)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    prev = place._DEFAULT["device"]
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    place._DEFAULT["device"] = prev


def _reset():
    for stats in (ROUTE_STATS, FLASH_ROUTE_STATS):
        for k in stats:
            stats[k] = 0


def _saved_on_cpu(tmp_path, seq):
    pt.set_device("cpu")
    pt.seed(0)
    model = BertForSequenceClassification(**SMALL)
    model.eval()
    path = str(tmp_path / f"bert_s{seq}")
    jit.save(model, path, input_spec=[
        InputSpec([2, seq], "int64", name="input_ids"),
        InputSpec([2, seq], "int64", name="token_type_ids"),
        InputSpec([2, seq], "int64", name="attention_mask")])
    return model, path


def _inputs(seq):
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 128, (2, seq)).astype(np.int64)
    mask = np.ones((2, seq), np.int64)
    mask[1, seq - seq // 4:] = 0
    return ids, np.zeros_like(ids), mask


@pytest.mark.parametrize("seq,flash", [(128, True), (16, False)])
def test_cpu_saved_artifact_routes_on_the_card(tmp_path, seq, flash):
    """S >= 128: the program launches #5 once a layer; S 16: the plain
    route, as the JAX package's routing takes it (no flash launch)."""
    model, path = _saved_on_cpu(tmp_path, seq)
    feeds = _inputs(seq)
    layer = jit.load(path, device="cuda")
    _reset()
    got = layer(*feeds).numpy()
    layers = SMALL["num_hidden_layers"]
    assert FLASH_ROUTE_STATS["fwd"] == (layers if flash else 0)
    assert ROUTE_STATS["xla"] == (0 if flash else layers)
    assert FLASH_ROUTE_STATS["ref"] == 0
    model.to("cuda")
    with torch.no_grad():
        want = model(*(pt.to_tensor(a, place="cuda") for a in feeds)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-4 * max(1.0, np.abs(want).max())


def test_card_saved_artifact_runs_on_the_cpu(tmp_path):
    model, _ = _saved_on_cpu(tmp_path, 128)
    feeds = _inputs(128)
    with torch.no_grad():
        want = model(*(pt.to_tensor(a) for a in feeds)).numpy()
    model.to("cuda")
    path = str(tmp_path / "card")
    jit.save(model, path, input_spec=[InputSpec([2, 128], "int64")] * 3)
    got = jit.load(path, device="cpu")(*feeds).numpy()
    assert np.max(np.abs(got - want)) <= 1e-4 * max(1.0, np.abs(want).max())


def test_to_static_bert_runs_the_flash_kernels():
    pt.set_device("cuda")
    pt.seed(0)
    model = jit.to_static(BertForSequenceClassification(**SMALL))
    ids, types, mask = (pt.to_tensor(a) for a in _inputs(128))
    _reset()
    loss = model(ids, types, mask).sum()
    loss.backward()
    layers = SMALL["num_hidden_layers"]
    assert {k: FLASH_ROUTE_STATS[k] for k in ("fwd", "dkv", "dq", "ref")} \
        == {"fwd": layers, "dkv": layers, "dq": layers, "ref": 0}


def test_static_program_trains_like_the_cpu():
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(16, 8).astype(np.float32),
              "y": rng.randn(16, 1).astype(np.float32)} for _ in range(5)]
    pt.set_device("cpu")
    pt.seed(0)
    state = {k: v.numpy() for k, v in nn.Linear(8, 1).state_dict().items()}
    losses = {}
    for dev in ("cpu", "cuda"):
        pt.set_device(dev)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [16, 8], "float32")
            y = static.data("y", [16, 1], "float32")
            lin = nn.Linear(8, 1)
            lin.set_state_dict(nn.layer.state_from_numpy(state, dev))
            loss = nn.functional.mse_loss(lin(x), y)
            optimizer.Adam(0.05, parameters=lin.parameters()).minimize(loss)
        exe = static.Executor(dev)
        losses[dev] = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                       for f in feeds]
        assert lin.weight._value.device.type == dev
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
