"""The common functionals and layers of the port against the JAX
package's (``paddle_tpu/nn/functional/common.py:90-496``,
``paddle_tpu/nn/common_layers.py:89-238``) on the same seeded inputs and
weights: each case is the forward and the gradient of one weighted sum
of the outputs with respect to every float input (and, for a layer, its
parameters).

Where torch's own mode would differ, the case pins the JAX rule:
nearest resizing (half-pixel, torch's "nearest-exact"), downsampling
linear / bilinear / trilinear resizes (antialiased), bicubic (Keys'
a = -0.5), ``align_corners=True`` (the reference's linear gather, also
for bicubic), "area" (linear), ``one_hot`` (float32, zero rows out of
range), ``cosine_similarity`` (the product of the norms clamped), the
full-rank constant ``pad`` form and the ``grid_sample`` tap rules.  The
dropouts are compared at p = 0 and in eval mode, and by their statistics
(their bits come from another generator).

Tolerances: exact (forward and gradient) for the index work — the
shuffles, ``pad`` (the gradient of a reflected, replicated or wrapped
border sums two or three terms in another order: 1e-6), ``one_hot``,
nearest resizing, ``fold`` and the forward of ``unfold``; 1e-6 relative
and 1e-6 absolute for f32 arithmetic (inputs of unit scale; the absolute
term covers the entries that cancel to near zero, and ``unfold``'s
gradient, whose overlaps sum in another order); 1e-5 for the products of
``bilinear`` and ``affine_grid`` (a few dozen terms summed in another
order) and for ``align_corners=True`` resizes (the reference's sample
points come from XLA's ``linspace``, an ulp off ``i·(in-1)/(out-1)`` at
some points, times pixel steps of a few units)."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from torch_layer_parity import as_np, build, compare, one_torch_thread_on_the_cpu
from torch_layer_parity import rand as _x

EXACT = dict(rtol=0, atol=0)
F32 = dict(rtol=1e-6, atol=1e-6)
SUMS = dict(rtol=1e-5, atol=1e-5)
ALIGN = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


def _ids(high, *shape, low=0, seed=0):
    return np.random.RandomState(seed).randint(low, high, shape).astype(
        np.int64)


def _both(fn, arrays, tol, grad_tol=None):
    """``fn(F, *tensors)`` in both packages: the outputs within ``tol``
    and the gradients of the same weighted sum of the first output within
    ``grad_tol`` (``tol`` by default); an input the output does not
    depend on (a grid sampled by nearest) has no gradient in the port and
    zeros in the reference."""
    grad_tol = tol if grad_tol is None else grad_tol
    def wrap(pkg, a):
        fl = np.issubdtype(a.dtype, np.floating)
        return pkg.to_tensor(a, stop_gradient=not fl)

    jx = [wrap(jp, a) for a in arrays]
    tx = [wrap(pt, a) for a in arrays]
    jo, to = fn(JF, *jx), fn(TF, *tx)
    jo = list(jo) if isinstance(jo, (tuple, list)) else [jo]
    to = list(to) if isinstance(to, (tuple, list)) else [to]
    for j, t in zip(jo, to):
        assert list(j.shape) == list(t.shape)
        assert np.dtype(as_np(t).dtype) == np.dtype(as_np(j).dtype)
        np.testing.assert_allclose(as_np(t), as_np(j), **tol)
    if not np.issubdtype(as_np(jo[0]).dtype, np.floating) or not any(
            not t.stop_gradient for t in tx):
        return
    w = np.asarray(_x(*jo[0].shape, seed=99) if jo[0].shape else 0.7,
                   np.float32)
    (jo[0] * jp.to_tensor(w)).sum().backward()
    (to[0] * pt.to_tensor(w)).sum().backward()
    for j, t in zip(jx, tx):
        if t.stop_gradient:
            continue
        if t.grad is None:
            assert j.grad is None or not as_np(j.grad).any()
            continue
        np.testing.assert_allclose(as_np(t.grad), as_np(j.grad), **grad_tol)


X4 = _x(2, 3, 8, 8)
X4_CL = _x(2, 8, 8, 3, seed=1)
X3 = _x(2, 3, 8)
X5 = _x(1, 2, 4, 6, 6, seed=2)
FUNCTIONALS = {
    # --- dropouts at p = 0 and in eval mode
    "dropout2d_p0": (lambda F, x: F.dropout2d(x, p=0.0), [X4], EXACT),
    "dropout2d_eval": (lambda F, x: F.dropout2d(x, training=False), [X4],
                       EXACT),
    "dropout3d_eval": (lambda F, x: F.dropout3d(x, training=False), [X5],
                       EXACT),
    "alpha_dropout_eval": (lambda F, x: F.alpha_dropout(x, training=False),
                           [X4], EXACT),
    # --- pads
    "pad_full_rank_constant": (
        lambda F, x: F.pad(x, [0, 1, 1, 0, 2, 1, 0, 3], value=1.5), [X4],
        EXACT),
    "pad_constant_nchw": (lambda F, x: F.pad(x, [1, 2, 0, 3], value=-1.0),
                          [X4], EXACT),
    "pad_reflect_nchw": (lambda F, x: F.pad(x, [1, 2, 3, 1], "reflect"),
                         [X4], EXACT, F32),
    "pad_replicate_nchw": (lambda F, x: F.pad(x, [2, 1, 1, 3], "replicate"),
                           [X4], EXACT, F32),
    "pad_circular_nchw": (lambda F, x: F.pad(x, [1, 1, 2, 2], "circular"),
                          [X4], EXACT, F32),
    "pad_reflect_nhwc": (lambda F, x: F.pad(x, [1, 2, 3, 1], "reflect",
                                            data_format="NHWC"),
                         [X4_CL], EXACT, F32),
    "pad_replicate_ncl": (lambda F, x: F.pad(x, [2, 3], "replicate",
                                             data_format="NCL"), [X3],
                          EXACT, F32),
    "pad_circular_ncdhw": (lambda F, x: F.pad(x, [1, 1, 0, 2, 1, 0],
                                              "circular",
                                              data_format="NCDHW"),
                           [X5], EXACT, F32),
    "pad_partial_spatial": (lambda F, x: F.pad(x, [1, 2], "reflect"), [X4],
                            EXACT, F32),
    "zeropad2d": (lambda F, x: F.zeropad2d(x, [1, 0, 2, 1]), [X4], EXACT),
    # --- one_hot, label_smooth, cosine_similarity, bilinear
    "one_hot": (lambda F, x: F.one_hot(x, 6), [_ids(6, 3, 5)], EXACT),
    "one_hot_out_of_range": (lambda F, x: F.one_hot(x, 4),
                             [_ids(7, 4, 3, low=-2)], EXACT),
    "label_smooth": (lambda F, x: F.label_smooth(x, epsilon=0.2),
                     [np.eye(5, dtype=np.float32)[[0, 3, 1]]], F32),
    "label_smooth_prior": (
        lambda F, x, p: F.label_smooth(x, prior_dist=p, epsilon=0.1),
        [np.eye(4, dtype=np.float32)[[2, 0]],
         np.full((1, 4), 0.25, np.float32)], F32),
    "cosine_similarity": (lambda F, a, b: F.cosine_similarity(a, b),
                          [_x(4, 6, 3), _x(4, 6, 3, seed=1)], F32),
    "cosine_similarity_zero_row": (
        lambda F, a, b: F.cosine_similarity(a, b, axis=-1, eps=1e-4),
        [np.vstack([_x(3, 5), np.zeros((1, 5), np.float32)]),
         _x(4, 5, seed=3)], F32),
    "bilinear": (lambda F, a, b, w, c: F.bilinear(a, b, w, c),
                 [_x(4, 5), _x(4, 3, seed=1), _x(2, 5, 3, seed=2),
                  _x(1, 2, seed=3)], SUMS),
    "bilinear_no_bias": (lambda F, a, b, w: F.bilinear(a, b, w),
                         [_x(4, 5), _x(4, 3, seed=1), _x(2, 5, 3, seed=2)],
                         SUMS),
    # --- interpolate
    "nearest_up_8_to_12": (lambda F, x: F.interpolate(x, size=[12, 12]),
                           [X4], EXACT),
    "nearest_down_8_to_5": (lambda F, x: F.interpolate(x, size=[5, 3]),
                            [X4], EXACT),
    "nearest_align_corners_ignored": (
        lambda F, x: F.interpolate(x, size=[12, 6], align_corners=True),
        [X4], EXACT),
    "nearest_1d_scale": (lambda F, x: F.interpolate(
        x, scale_factor=1.5, data_format="NCW"), [X3], EXACT),
    "nearest_3d": (lambda F, x: F.interpolate(
        x, size=[6, 9, 4], data_format="NCDHW"), [X5], EXACT),
    "bilinear_up_x2": (lambda F, x: F.interpolate(
        x, scale_factor=2, mode="bilinear"), [X4], F32),
    "bilinear_up_x2_align": (lambda F, x: F.interpolate(
        x, scale_factor=2, mode="bilinear", align_corners=True), [X4], ALIGN),
    "bilinear_down_half_antialiased": (lambda F, x: F.interpolate(
        x, size=[4, 4], mode="bilinear"), [X4], F32),
    "bilinear_down_uneven": (lambda F, x: F.interpolate(
        x, size=[5, 3], mode="bilinear"), [X4], F32),
    "bilinear_down_align": (lambda F, x: F.interpolate(
        x, size=[5, 3], mode="bilinear", align_corners=True), [X4], ALIGN),
    "bilinear_nhwc": (lambda F, x: F.interpolate(
        x, size=[11, 5], mode="bilinear", data_format="NHWC"), [X4_CL],
                      F32),
    "linear_1d_down": (lambda F, x: F.interpolate(
        x, size=[3], mode="linear", data_format="NCW"), [X3], F32),
    "trilinear_down": (lambda F, x: F.interpolate(
        x, size=[3, 4, 3], mode="trilinear", data_format="NCDHW"), [X5],
                       F32),
    "bicubic_up_x2": (lambda F, x: F.interpolate(
        x, scale_factor=2, mode="bicubic"), [X4], F32),
    "bicubic_down": (lambda F, x: F.interpolate(
        x, size=[5, 3], mode="bicubic"), [X4], F32),
    "bicubic_align_corners": (lambda F, x: F.interpolate(
        x, size=[12, 5], mode="bicubic", align_corners=True), [X4], ALIGN),
    "area_is_linear": (lambda F, x: F.interpolate(
        x, size=[4, 6], mode="area"), [X4], F32),
    "upsample": (lambda F, x: F.upsample(
        x, size=[10, 12], mode="bilinear", align_mode=1), [X4], F32),
    # --- shuffles
    "pixel_shuffle": (lambda F, x: F.pixel_shuffle(x, 2),
                      [_x(2, 8, 3, 5)], EXACT),
    "pixel_shuffle_nhwc": (lambda F, x: F.pixel_shuffle(x, 2, "NHWC"),
                           [_x(2, 3, 5, 8)], EXACT),
    "pixel_unshuffle": (lambda F, x: F.pixel_unshuffle(x, 2),
                        [_x(2, 3, 4, 6)], EXACT),
    "pixel_unshuffle_nhwc": (lambda F, x: F.pixel_unshuffle(x, 2, "NHWC"),
                             [_x(2, 4, 6, 3)], EXACT),
    "channel_shuffle": (lambda F, x: F.channel_shuffle(x, 3),
                        [_x(2, 6, 3, 4)], EXACT),
    "channel_shuffle_nhwc": (lambda F, x: F.channel_shuffle(x, 2, "NHWC"),
                             [_x(2, 3, 4, 6)], EXACT),
    # --- unfold / fold
    "unfold_3x3_pad1": (lambda F, x: F.unfold(x, 3, paddings=1), [X4], F32),
    "unfold_stride_dilation": (lambda F, x: F.unfold(
        x, [2, 3], strides=2, paddings=[1, 0], dilations=[1, 2]), [X4], F32),
    "unfold_asymmetric_pad": (lambda F, x: F.unfold(
        x, 2, paddings=[1, 0, 0, 2]), [X4], F32),
    "fold_3x3_pad1": (lambda F, x: F.fold(x, [6, 5], 3, paddings=1),
                      [_x(2, 18, 30)], EXACT),
    "fold_stride2": (lambda F, x: F.fold(x, [7, 7], 3, strides=2),
                     [_x(1, 9, 9)], EXACT),
    # --- sampling grids
    "affine_grid": (lambda F, t: F.affine_grid(t, [2, 3, 5, 4]),
                    [_x(2, 2, 3)], SUMS),
    "affine_grid_no_align": (
        lambda F, t: F.affine_grid(t, [2, 3, 5, 4], align_corners=False),
        [_x(2, 2, 3)], SUMS),
    "grid_sample_bilinear_zeros": (
        lambda F, x, g: F.grid_sample(x, g), [X4, 1.3 * _x(2, 5, 7, 2, seed=4)],
        F32),
    "grid_sample_bilinear_border": (
        lambda F, x, g: F.grid_sample(x, g, padding_mode="border",
                                      align_corners=False),
        [X4, 1.3 * _x(2, 5, 7, 2, seed=5)], F32),
    "grid_sample_nearest": (
        lambda F, x, g: F.grid_sample(x, g, mode="nearest"),
        [X4, _x(2, 4, 4, 2, seed=6)], EXACT),
    "temporal_shift": (lambda F, x: F.temporal_shift(x, 3),
                       [_x(6, 8, 2, 3)], EXACT),
    "npair_loss": (lambda F, a, p, y: F.npair_loss(a, p, y),
                   [_x(4, 6), _x(4, 6, seed=1),
                    np.array([0, 1, 0, 2], np.int64)], F32),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONALS))
def test_functional(name):
    fn, arrays, *tol = FUNCTIONALS[name]
    _both(fn, [np.asarray(a) for a in arrays], *tol)


def test_grid_sample_nearest_rounds_half_to_even():
    """Taps exactly between two pixels: 0.5 and 2.5 round to 0 and 2."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    # align_corners: pixel = (c + 1) * 1.5; c = -2/3 -> 0.5, 2/3 -> 2.5
    g = np.array([[[[-2 / 3, -2 / 3], [2 / 3, 2 / 3]]]], np.float32)
    _both(lambda F, a, b: F.grid_sample(a, b, mode="nearest"), [x, g], EXACT)


def test_refused_and_ignored_knobs():
    x = pt.to_tensor(X4)
    g = pt.to_tensor(_x(2, 3, 3, 2))
    with pytest.raises(InvalidArgumentError, match="reflection"):
        TF.grid_sample(x, g, padding_mode="reflection")
    a = TF.interpolate(x, size=[5, 5], mode="bilinear", align_mode=0)
    b = TF.interpolate(x, size=[5, 5], mode="bilinear", align_mode=1)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("fn", ["dropout2d", "dropout3d"])
def test_channel_dropout_statistics(fn):
    """Whole maps dropped at rate p, the kept ones scaled by 1/(1-p)."""
    shape = (64, 32, 3, 3) if fn == "dropout2d" else (64, 32, 2, 2, 2)
    x = pt.ones(list(shape))
    out = getattr(TF, fn)(x, p=0.25).numpy().reshape(64, 32, -1)
    per_map = out.max(axis=-1)
    assert np.all(out == per_map[..., None])
    assert set(np.unique(per_map)) <= {0.0, np.float32(1 / 0.75)}
    assert abs((per_map == 0).mean() - 0.25) < 0.03


def test_alpha_dropout_statistics():
    """Dropped entries take -alpha*scale before the affine; the output of
    a unit normal keeps mean 0 and variance 1."""
    x = pt.to_tensor(_x(400, 500))
    out = TF.alpha_dropout(x, p=0.2).numpy()
    assert abs(out.mean()) < 0.02 and abs(out.var() - 1.0) < 0.03
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1.0 / ((1 - 0.2) * (1 + 0.2 * alpha_p ** 2))) ** 0.5
    dropped = np.isclose(out, a * alpha_p - a * alpha_p * 0.2)
    assert abs(dropped.mean() - 0.2) < 0.01


# --- the layers -----------------------------------------------------------
LAYERS = {
    "Dropout2D_eval": (lambda nn: nn.Dropout2D(0.5), [X4]),
    "Dropout3D_eval": (lambda nn: nn.Dropout3D(0.5), [X5]),
    "AlphaDropout_eval": (lambda nn: nn.AlphaDropout(0.3), [X4]),
    "Upsample": (lambda nn: nn.Upsample(scale_factor=2, mode="bicubic"),
                 [X4]),
    "UpsamplingNearest2D": (lambda nn: nn.UpsamplingNearest2D(size=[12, 5]),
                            [X4]),
    "UpsamplingBilinear2D": (
        lambda nn: nn.UpsamplingBilinear2D(scale_factor=1.5), [X4]),
    "Pad1D": (lambda nn: nn.Pad1D([1, 2], mode="reflect"), [X3]),
    "Pad2D": (lambda nn: nn.Pad2D([1, 0, 2, 1], mode="replicate"), [X4]),
    "Pad3D": (lambda nn: nn.Pad3D([1, 1, 0, 1, 2, 0], value=0.5), [X5]),
    "ZeroPad2D": (lambda nn: nn.ZeroPad2D([0, 2, 1, 1]), [X4]),
    "PixelShuffle": (lambda nn: nn.PixelShuffle(2), [_x(2, 8, 3, 3)]),
    "PixelUnshuffle": (lambda nn: nn.PixelUnshuffle(2), [X4]),
    "ChannelShuffle": (lambda nn: nn.ChannelShuffle(3), [_x(2, 6, 2, 2)]),
    "Bilinear": (lambda nn: nn.Bilinear(5, 3, 4),
                 [_x(6, 5), _x(6, 3, seed=1)]),
    "CosineSimilarity": (lambda nn: nn.CosineSimilarity(axis=-1),
                         [_x(4, 7), _x(4, 7, seed=1)]),
    "Unfold": (lambda nn: nn.Unfold(3, strides=1, paddings=1), [X4]),
    "Fold": (lambda nn: nn.Fold([5, 6], 2, strides=1), [_x(2, 12, 20)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    """Forward within 1e-5 and gradients within 1e-4
    (``tests/torch_layer_parity.py``), eval mode for the dropouts."""
    factory, inputs = LAYERS[name]
    jl, tl = build(factory)
    jl.eval()
    tl.eval()
    compare(jl, tl, inputs)
