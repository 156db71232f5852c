"""paddle_tpu_torch's ``jit.save`` / ``jit.load``, ``inference.
create_predictor`` and ``onnx.export`` against paddle_tpu's.

The twins of ``tests/test_inference.py`` and the onnx half of
``tests/test_metric_onnx.py``: an MLP and a 2-layer BERT are saved by
both packages (the JAX package's weights carried across by
``state_dict`` name) and served by both predictors on the same numpy
inputs: named IO, bucket padding of a smaller batch, chunking of a larger
one, a fresh process that never imports the model class, pruned outputs.
Besides: the exported program holds the attention as the
``paddle_tpu_torch::attention`` operator (its route decided when it
runs, the plain one on the CPU), a ``to_static`` layer's converted
``if`` exports as ``torch.cond``, and the artifact's three files keep
the reference's layout.  Tolerances: the MLP rtol 1e-5 / atol 1e-6 (f32
on the CPU); BERT rtol 1e-4 / atol 1e-5, the JAX test's.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu import onnx as jonnx
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu.text import models as jmodels

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import onnx as tonnx
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.ops.attention import ROUTE_STATS
from paddle_tpu_torch.static import InputSpec as TSpec
from paddle_tpu_torch.text import models as tmodels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT = dict(num_classes=3, vocab_size=128, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small ops on one thread: the suite's workers share the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _carry(jax_layer, port_layer):
    state = {k: np.asarray(v._value) for k, v in
             jax_layer.state_dict().items()}
    assert port_layer.set_state_dict(state_from_numpy(state, "cpu")) == \
        ([], [])


def _cpu_config(cls, prefix, *rest):
    cfg = cls(prefix, *rest)
    if cls is tinf.Config:
        cfg.disable_gpu()
    return cfg


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    """Both packages' MLP saved at batch 4; (paths, x, eager output)."""
    d = tmp_path_factory.mktemp("mlp")
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    tnet = tnn.Sequential(tnn.Linear(8, 32), tnn.ReLU(), tnn.Linear(32, 4))
    _carry(jnet, tnet)
    jnet.eval()
    tnet.eval()
    paths = {"jax": str(d / "jmlp"), "torch": str(d / "tmlp")}
    jjit.save(jnet, paths["jax"],
              input_spec=[JSpec([4, 8], "float32", name="feats")])
    tjit.save(tnet, paths["torch"],
              input_spec=[TSpec([4, 8], "float32", name="feats")])
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    want = tnet(pt.to_tensor(x)).numpy()
    place._DEFAULT["device"] = prev
    return paths, x, want


def _predictors(paths):
    return {"jax": jinf.create_predictor(_cpu_config(jinf.Config,
                                                     paths["jax"])),
            "torch": tinf.create_predictor(_cpu_config(tinf.Config,
                                                       paths["torch"]))}


class TestPredictor:
    def test_named_io_and_parity(self, mlp):
        paths, x, want = mlp
        got = {}
        for pkg, p in _predictors(paths).items():
            assert p.get_input_names() == ["feats"]
            assert p.get_output_names() == ["out_0"]
            p.get_input_handle("feats").copy_from_cpu(x)
            p.run()
            got[pkg] = p.get_output_handle("out_0").copy_to_cpu()
        np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["torch"], want, rtol=1e-5, atol=1e-6)

    def test_batch_bucket_padding_and_chunking(self, mlp):
        paths, x, want = mlp
        big = np.concatenate([x, x[:3]], axis=0)       # batch 7 > 4
        for pkg, p in _predictors(paths).items():
            small, = p.run([x[:2]])
            assert small.shape == (2, 4), pkg
            np.testing.assert_allclose(small, want[:2], rtol=1e-5,
                                       atol=1e-6)
            out, = p.run([big])
            assert out.shape == (7, 4), pkg
            np.testing.assert_allclose(out[4:], want[:3], rtol=1e-5,
                                       atol=1e-6)

    def test_fresh_process_no_model_class(self, mlp, tmp_path):
        """The serving contract: a NEW process that imports only the
        port's inference package (no model class, no JAX) runs the
        artifact."""
        paths, x, want = mlp
        np.save(str(tmp_path / "x.npy"), x)
        code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from paddle_tpu_torch import inference
cfg = inference.Config({paths["torch"]!r})
cfg.disable_gpu()
p = inference.create_predictor(cfg)
out, = p.run([np.load({str(tmp_path / "x.npy")!r})])
np.save({str(tmp_path / "out.npy")!r}, out)
assert not any(m.split(".")[0] in ("jax", "paddle_tpu") for m in sys.modules)
"""
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        np.testing.assert_allclose(np.load(str(tmp_path / "out.npy")), want,
                                   rtol=1e-5, atol=1e-6)

    def test_artifact_layout(self, mlp):
        paths, _, _ = mlp
        for suffix in (".pdmodel", ".pdiparams", ".pdmeta"):
            assert os.path.exists(paths["torch"] + suffix)
        with open(paths["torch"] + ".pdiparams", "rb") as f:
            state = pickle.load(f)
        with open(paths["jax"] + ".pdiparams", "rb") as f:
            jstate = pickle.load(f)
        assert list(state) == list(jstate)
        for k in state:
            np.testing.assert_array_equal(state[k], jstate[k])
        with open(paths["torch"] + ".pdmeta", "rb") as f:
            meta = pickle.load(f)
        assert meta["input_names"] == ["feats"]
        assert meta["output_names"] == ["out_0"]
        assert isinstance(meta["op_version_map"], dict)

    def test_jit_load_translated_layer(self, mlp):
        paths, x, want = mlp
        layer = tjit.load(paths["torch"], device="cpu")
        assert isinstance(layer, tjit.TranslatedLayer)
        np.testing.assert_allclose(layer(pt.to_tensor(x)).numpy(), want,
                                   rtol=1e-5, atol=1e-6)
        jl = jjit.load(paths["jax"])
        np.testing.assert_allclose(layer(x).numpy(), jl(x).numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_dynamic_dims_refused(self, tmp_path):
        net = tnn.Linear(4, 2)
        with pytest.raises(ValueError, match="static shapes"):
            tjit.save(net, str(tmp_path / "dyn"),
                      input_spec=[TSpec([None, 4], "float32")])
        with pytest.raises(ValueError, match="input_spec"):
            tjit.save(net, str(tmp_path / "dyn"))


def _bert_pair():
    paddle.seed(0)
    jm = jmodels.BertForSequenceClassification(**BERT)
    tm = tmodels.BertForSequenceClassification(**BERT)
    _carry(jm, tm)
    jm.eval()
    tm.eval()
    return jm, tm


class TestBert:
    def test_bert_predictor_matches_jax(self, tmp_path):
        jm, tm = _bert_pair()
        ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(
            np.int32)
        want = jm(paddle.to_tensor(ids)).numpy()
        got = {}
        for pkg, model, jit, spec, inf in (
                ("jax", jm, jjit, JSpec, jinf),
                ("torch", tm, tjit, TSpec, tinf)):
            path = str(tmp_path / f"bert_{pkg}")
            jit.save(model, path,
                     input_spec=[spec([2, 16], "int32", name="input_ids")])
            p = inf.create_predictor(_cpu_config(inf.Config, path))
            p.get_input_handle("input_ids").copy_from_cpu(ids)
            p.run()
            got[pkg] = p.get_output_handle("out_0").copy_to_cpu()
        np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["torch"], want, rtol=1e-4, atol=1e-5)

    def test_exported_graph_holds_the_attention_op(self, tmp_path):
        _, tm = _bert_pair()
        path = str(tmp_path / "bert_op")
        tjit.save(tm, path, input_spec=[
            TSpec([2, 16], "int64", name="input_ids"),
            TSpec([2, 16], "int64", name="token_type_ids"),
            TSpec([2, 16], "int64", name="attention_mask")])
        layer = tjit.load(path, device="cpu")
        graph = layer.program().graph
        targets = [str(n.target) for n in graph.nodes
                   if n.op == "call_function"]
        n_attn = sum("paddle_tpu_torch.attention" in t for t in targets)
        assert n_attn == BERT["num_hidden_layers"], targets
        # the CPU kernel of the op is the plain route, decided at run time
        rng = np.random.RandomState(3)
        ids = rng.randint(0, 128, (2, 16)).astype(np.int64)
        types = np.zeros((2, 16), np.int64)
        mask = np.ones((2, 16), np.int64)
        mask[1, 12:] = 0
        before = ROUTE_STATS["xla"]
        got = layer(ids, types, mask).numpy()
        assert ROUTE_STATS["xla"] == before + BERT["num_hidden_layers"]
        want = tm(pt.to_tensor(ids), pt.to_tensor(types),
                  pt.to_tensor(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_attention_op_routes_at_run_time(self):
        q = torch.randn(2, 8, 2, 4)
        before = dict(ROUTE_STATS)
        out, seed = torch.ops.paddle_tpu_torch.attention(q, q, q, None,
                                                         0.0, False)
        assert seed.tolist() == [0]
        ref = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), q.transpose(1, 2),
            q.transpose(1, 2)).transpose(1, 2)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert ROUTE_STATS["xla"] == before["xla"] + 1
        assert ROUTE_STATS["pallas"] == before["pallas"]


class TestExportedControlFlow:
    def test_to_static_if_exports_as_torch_cond(self, tmp_path):
        class Gate(tnn.Layer):
            def __init__(self):
                tnn.Layer.__init__(self)
                self.fc = tnn.Linear(4, 4)

            def forward(self, x):
                h = self.fc(x)
                if h.mean() > 0.0:
                    out = h * 2.0
                else:
                    out = -h
                return out

        pt.seed(0)
        net = tjit.to_static(Gate())
        net.eval()
        path = str(tmp_path / "gate")
        tjit.save(net, path, input_spec=[TSpec([2, 4], "float32")])
        layer = tjit.load(path, device="cpu")
        targets = [str(n.target) for n in layer.program().graph.nodes]
        assert any("cond" in t for t in targets), targets
        rng = np.random.RandomState(2)
        for _ in range(4):
            x = rng.randn(2, 4).astype(np.float32) * 3
            np.testing.assert_allclose(layer(x).numpy(),
                                       net(pt.to_tensor(x)).numpy(),
                                       rtol=1e-6)


class TestExportedWhileLoop:
    def test_to_static_while_exports_as_while_loop(self, tmp_path):
        class Climb(tnn.Layer):
            def __init__(self):
                tnn.Layer.__init__(self)
                self.fc = tnn.Linear(3, 3)

            def forward(self, x):
                h = self.fc(x)
                while h.sum() < 10.0:
                    h = h + 1.0
                return h

        pt.seed(0)
        net = tjit.to_static(Climb())
        net.eval()
        path = str(tmp_path / "climb")
        tjit.save(net, path, input_spec=[TSpec([2, 3], "float32")])
        layer = tjit.load(path, device="cpu")
        targets = [str(n.target) for n in layer.program().graph.nodes]
        assert any("while_loop" in t for t in targets), targets
        rng = np.random.RandomState(4)
        for scale in (0.1, 5.0, 50.0):
            x = rng.randn(2, 3).astype(np.float32) * scale
            np.testing.assert_allclose(layer(x).numpy(),
                                       net(pt.to_tensor(x)).numpy(),
                                       rtol=1e-6)


class TestOnnxExport:
    def _net(self, pkg):
        nn = jnn if pkg == "jax" else tnn

        class TwoHead(nn.Layer):
            def __init__(self):
                nn.Layer.__init__(self)
                self.fc = nn.Linear(4, 3)

            def forward(self, x):
                logits = self.fc(x)
                return logits, nn.functional.softmax(logits)

        return TwoHead()

    @pytest.mark.parametrize("output_spec", [None, [1]])
    def test_export_roundtrip_and_pruning(self, tmp_path, output_spec):
        paddle.seed(0)
        nets = {pkg: self._net(pkg) for pkg in ("jax", "torch")}
        _carry(nets["jax"], nets["torch"])
        x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
        got = {}
        for pkg, onnx, spec, inf in (("jax", jonnx, JSpec, jinf),
                                     ("torch", tonnx, TSpec, tinf)):
            kw = {} if output_spec is None else {"output_spec": output_spec}
            prefix = onnx.export(nets[pkg], str(tmp_path / f"m_{pkg}.onnx"),
                                 input_spec=[spec([2, 4], "float32", "x")],
                                 **kw)
            assert os.path.exists(prefix + ".pdmodel")
            p = inf.create_predictor(_cpu_config(
                inf.Config, prefix + ".pdmodel", prefix + ".pdiparams"))
            p.get_input_handle(p.get_input_names()[0]).copy_from_cpu(x)
            p.run()
            got[pkg] = [p.get_output_handle(n).copy_to_cpu()
                        for n in p.get_output_names()]
        assert len(got["torch"]) == (2 if output_spec is None else 1)
        for a, b in zip(got["jax"], got["torch"]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
