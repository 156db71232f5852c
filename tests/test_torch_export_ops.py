"""The port's kernel entries as ``torch.library`` operators.

Every routing entry of a hand-written kernel (flash #5-#7, paged #1-#3,
the int8 matmul #4, scale_shift t) and the attention entry are
operators with a fake function, so a tensor with no data never reaches a
kernel or a plain version, and an exported program keeps the operator,
which picks its route where the program runs:

- each fake function gives the real output's shapes and dtypes, on the
  meta device, and counts nothing;
- ``jit.save`` of a layer that calls ``weight_only_matmul``, a
  registered ``scale_shift`` op or ``F.flash_attention`` holds the
  operator node (``F.flash_attention`` becomes the attention operator),
  and the loaded program matches the eager layer (rtol 1e-6, f32 on
  the CPU); a ``torch.export`` of the paged entries keeps theirs;
- the attention operator's backward (recomputed, on the op's own seed)
  matches autograd through the eager plain and flash routes at rtol
  1e-5 / atol 1e-6, with and without dropout;
- a static BERT program with attention saves with ``save_train`` and
  the reloaded step gives the Executor's losses (rtol 1e-5) at dropout
  0, and trains at dropout 0.1;
- ``cond`` refuses a two-element predicate, as the JAX package's does.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import quantized_matmul as tqmm
from paddle_tpu_torch.ops import scale_shift as tss
from paddle_tpu_torch.static import InputSpec as TSpec
from paddle_tpu_torch.text import models as tmodels

STATS = (tatt.ROUTE_STATS, tfa.FLASH_ROUTE_STATS, tpa.PAGED_ROUTE_STATS,
         tqmm.QMM_ROUTE_STATS, tss.SCALE_SHIFT_ROUTE_STATS)


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


def _counts():
    return [dict(s) for s in STATS]


def _paged_inputs(rng, ragged, stats=False):
    N, P, H, D = 3, 4, 2, 4
    kp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    tables = torch.tensor([[1, 2], [2, 0]], dtype=torch.int32)
    if not ragged:
        q = torch.from_numpy(rng.randn(2, H, D).astype(np.float32))
        return (q, kp, vp, tables, torch.tensor([6, 3], dtype=torch.int32),
                None, None, 1)
    q = torch.from_numpy(rng.randn(2, 2, H, D).astype(np.float32))
    lens = torch.tensor([[5, 6], [2, 3]], dtype=torch.int32)
    if stats:
        ok = torch.tensor([[1, 0], [1, 1]], dtype=torch.int32)
        return (q, kp, vp, tables, lens, ok, None, None, 1)
    return (q, kp, vp, tables, lens, None, None, 1)


def _op_cases():
    """(name, operator, CPU inputs) for every kernel entry."""
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    q, k, v, g = t(1, 2, 8, 4), t(1, 2, 8, 4), t(1, 2, 8, 4), t(1, 2, 8, 4)
    mask = torch.ones(1, 8)
    lse, delta = t(2, 8, 1), t(2, 8, 1)
    bq, bk, bv, bg = t(2, 8, 2, 4), t(2, 8, 2, 4), t(2, 8, 2, 4), t(2, 8, 2, 4)
    seed = torch.tensor([7], dtype=torch.int32)
    wq = torch.from_numpy(rng.randint(-127, 128, (8, 5)).astype(np.int8))
    return [
        ("flash_fwd", tfa._flash_fwd_op,
         (q, k, v, mask, None, 3, 0.5, True, 0.25)),
        ("flash_dkv", tfa._flash_dkv_op,
         (q, k, v, g, lse, delta, mask, seed, 0, 0.5, False, 0.25)),
        ("flash_dq", tfa._flash_dq_op,
         (q, k, v, g, lse, delta, mask, None, 0, 0.5, True, 0.0)),
        ("paged_attention", tpa._paged_op, _paged_inputs(rng, False)),
        ("ragged_paged_attention", tpa._ragged_op, _paged_inputs(rng, True)),
        ("ragged_paged_attention_stats", tpa._ragged_stats_op,
         _paged_inputs(rng, True, stats=True)),
        ("quantized_matmul", tqmm._qmm_op, (t(3, 8), wq, t(5).abs())),
        ("scale_shift", tss._scale_shift_op,
         (t(4, 8), torch.tensor([1.5]), torch.tensor([0.25]))),
        ("attention", tatt._attention_op, (bq, bk, bv, None, 0.0, True)),
        ("attention_bwd", tatt._attention_bwd_op,
         (bq, bk, bv, None, 0.1, False, seed, bg)),
    ]


def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_fake_function_matches_the_real_output(case):
    _, op, args = case
    real = op(*args)
    before = _counts()
    fake = op(*[_meta(a) for a in args])
    assert _counts() == before
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert f.device.type == "meta"
        assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype)


class _QLayer(tnn.Layer):
    def __init__(self):
        tnn.Layer.__init__(self)
        self.fc = tnn.Linear(8, 8)
        rng = np.random.RandomState(0)
        self.wq = pt.to_tensor(rng.randint(-127, 128, (8, 6))
                               .astype(np.int8))
        self.ws = pt.to_tensor(rng.rand(6).astype(np.float32) * 0.01)

    def forward(self, x):
        return pt.weight_only_matmul(self.fc(x), self.wq, self.ws)


class _ShiftLayer(tnn.Layer):
    def __init__(self):
        tnn.Layer.__init__(self)
        from paddle_tpu_torch.utils import register_op

        self.fc = tnn.Linear(8, 8)
        self.op = register_op("t_export_shift", tss.scale_shift,
                              vjp=tss.scale_shift_vjp, exist_ok=True)
        self.scale = pt.to_tensor(np.float32([1.5]))
        self.shift = pt.to_tensor(np.float32([0.25]))

    def forward(self, x):
        return self.op(self.fc(x), self.scale, self.shift)


class _FlashLayer(tnn.Layer):
    def __init__(self):
        tnn.Layer.__init__(self)
        self.fc = tnn.Linear(8, 8)

    def forward(self, x):
        h = self.fc(x).reshape([2, 16, 2, 4])
        return TF.flash_attention(h, h, h, causal=True)


@pytest.mark.parametrize("cls,node,force,count", [
    (_QLayer, "quantized_matmul", "0", (3, "ref")),
    (_ShiftLayer, "scale_shift", "0", (4, "ref")),
    (_FlashLayer, "attention", "0", (0, "xla")),
    (_FlashLayer, "attention", "1", (1, "ref")),
], ids=["weight_only_matmul", "scale_shift", "flash", "flash_forced"])
def test_jit_save_keeps_the_kernel_operator(cls, node, force, count,
                                            tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", force)
    pt.seed(0)
    layer = cls()
    layer.eval()
    path = str(tmp_path / "art")
    before = _counts()
    tjit.save(layer, path, input_spec=[TSpec([2, 16, 8], "float32")])
    assert _counts() == before
    loaded = tjit.load(path, device="cpu")
    targets = [str(n.target) for n in loaded.program().graph.nodes
               if n.op == "call_function"]
    assert f"paddle_tpu_torch.{node}.default" in targets, targets
    x = np.random.RandomState(1).randn(2, 16, 8).astype(np.float32)
    got = loaded(x).numpy()
    which, key = count
    assert STATS[which][key] == before[which][key] + 1
    np.testing.assert_allclose(got, layer(pt.to_tensor(x)).numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["paged_attention", "ragged_paged_attention",
                                  "ragged_paged_attention_stats"])
def test_export_keeps_the_paged_operators(name):
    rng = np.random.RandomState(2)
    args = _paged_inputs(rng, name != "paged_attention",
                         stats=name.endswith("stats"))
    entry = getattr(tpa, name)
    n_tensor = sum(isinstance(a, torch.Tensor) for a in args)

    class M(torch.nn.Module):
        def forward(self, *ts):
            return entry(*ts, *args[n_tensor:])

    prog = torch.export.export(M(), args[:n_tensor], strict=False)
    targets = [str(n.target) for n in prog.graph.nodes]
    assert f"paddle_tpu_torch.{name}.default" in targets, targets
    got = prog.module()(*args[:n_tensor])
    want = entry(*args)
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("force", ["0", "1"], ids=["plain", "flash"])
@pytest.mark.parametrize("drop", [0.0, 0.25])
def test_attention_operator_backward_matches_autograd(force, drop,
                                                      monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", force)
    rng = np.random.RandomState(4)
    B, S, H, D = 2, 16, 2, 8
    base = [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]
    w = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
    valid = np.ones((B, S), bool)
    valid[1, 11:] = False
    mask = torch.from_numpy(valid)[:, None, None, :]
    pt.seed(3)
    qkv = [torch.from_numpy(a).requires_grad_() for a in base]
    out, seed = tatt._attention_op(*qkv, mask, drop, True)
    got = torch.autograd.grad((out * w).sum(), qkv)
    ref_in = [torch.from_numpy(a).requires_grad_() for a in base]
    if force == "1":
        want_out = tfa.flash_attention_bshd(
            *ref_in, causal=True, kv_mask=mask[:, 0, 0, :].float(),
            dropout_p=drop, seed=seed)
    else:
        want_out = tatt._plain(*ref_in, mask, drop, True, seed=seed)
    want = torch.autograd.grad((want_out * w).sum(), ref_in)
    np.testing.assert_allclose(out.detach().numpy(),
                               want_out.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert (int(seed[0]) != 0) == (drop > 0.0)


def _bert_program(dropout):
    cfg = dict(num_classes=3, vocab_size=64, hidden_size=16,
               num_hidden_layers=1, num_attention_heads=2,
               intermediate_size=32, max_position_embeddings=32,
               hidden_dropout_prob=dropout,
               attention_probs_dropout_prob=dropout, dropout=dropout)
    pt.seed(0)
    main = tstatic.Program()
    with tstatic.program_guard(main):
        ids = tstatic.data("ids", [2, 8], "int64")
        labels = tstatic.data("labels", [2], "int64")
        net = tmodels.BertForSequenceClassification(**cfg)
        loss = TF.cross_entropy(net(ids), labels)
        topt.Adam(learning_rate=1e-2,
                  parameters=net.parameters()).minimize(loss)
    return main, loss, net


def _bert_feeds(n):
    rng = np.random.RandomState(5)
    return [{"ids": rng.randint(0, 64, (2, 8)).astype(np.int64),
             "labels": rng.randint(0, 3, (2,)).astype(np.int64)}
            for _ in range(n)]


def test_save_train_bert_program_resumes(tmp_path):
    main, loss, _ = _bert_program(0.0)
    feeds = _bert_feeds(4)
    exe = tstatic.Executor()
    exe.run(main, feed=feeds[0], fetch_list=[loss])
    main.save_train(str(tmp_path / "bert"), fetch_list=[loss])
    prog = torch.export.load(str(tmp_path / "bert") + ".trainprogram")
    targets = [str(n.target) for n in prog.graph.nodes]
    assert "paddle_tpu_torch.attention.default" in targets
    assert "paddle_tpu_torch.attention_bwd.default" in targets
    loaded = tstatic.load_train_program(str(tmp_path / "bert"))
    for fd in feeds[1:]:
        want = exe.run(main, feed=fd, fetch_list=[loss])[0]
        np.testing.assert_allclose(loaded.run(fd)[0], want, rtol=1e-5)


def test_save_train_bert_program_with_dropout_trains(tmp_path):
    main, loss, net = _bert_program(0.1)
    feeds = _bert_feeds(1) * 6
    tstatic.Executor().run(main, feed=feeds[0], fetch_list=[loss])
    main.save_train(str(tmp_path / "bert_drop"), fetch_list=[loss])
    loaded = tstatic.load_train_program(str(tmp_path / "bert_drop"))
    w0 = {k: v.copy() for k, v in loaded.state_dict().items()}
    losses = [float(loaded.run(fd)[0]) for fd in feeds]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    moved = [k for k, v in loaded.state_dict().items()
             if not np.array_equal(v, w0[k])]
    assert len(moved) == len(w0)


def test_cond_refuses_a_two_element_predicate():
    with pytest.raises(Exception):
        paddle.ops.logic.cond(paddle.to_tensor([True, False]), lambda: 1,
                              lambda: 2)
    with pytest.raises(ValueError, match="one element"):
        pt.ops.logic.cond(pt.to_tensor([True, False]), lambda: 1,
                          lambda: 2)
    assert pt.ops.logic.cond(pt.to_tensor([False]), lambda: 1,
                             lambda: 2) == 2
