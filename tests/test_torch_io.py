"""paddle_tpu_torch.io against the JAX package's: datasets, samplers and the
DataLoader.

Inputs are numpy arrays from a seed.  Items, index orders and batches
must be equal (exact: the same numpy arithmetic, and both packages'
random samplers draw from numpy's global stream, seeded alike before
each run).  The DataLoader gives the same batches in the same order on
every feed path: the array path (a TensorDataset), no workers, 2 thread
workers and 2 process workers (shared memory).  ``prefetch_to_device``
to the CPU hands out the same batches.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch as pt
import paddle_tpu_torch.io as tio

N = 37


class Squares:
    """A map-style dataset (module level, so process workers can take
    it): a float image and an int label per item."""

    def __init__(self, n=N):
        rng = np.random.RandomState(4)
        self.x = rng.randn(n, 3, 2).astype(np.float32)
        self.y = rng.randint(0, 10, (n, 1)).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i] * 2.0, self.y[i]

    def __len__(self):
        return len(self.x)


def _make(io, cls):
    """``Squares`` registered as a ``Dataset`` of ``io``."""
    return type("Squares", (Squares, cls), {})()


class _Stream:
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full((2,), i, np.float32), np.int64(i)


def _np(batch):
    out = []
    for b in batch:
        out.append(b.numpy() if hasattr(b, "numpy") else np.asarray(b))
    return out


def _batches(loader, seed=11):
    np.random.seed(seed)
    return [_np(b) for b in loader]


def _same(got, want):
    """Equal batches; an int64 column may come back from the JAX package
    as int32 (JAX runs without 64-bit types)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype or (a.dtype == np.int64
                                          and b.dtype == np.int32)
            assert a.shape == b.shape and np.array_equal(a, b)


def test_tensor_compose_concat_subset_datasets():
    rng = np.random.RandomState(0)
    a = rng.randn(6, 2).astype(np.float32)
    b = rng.randint(0, 5, (6,)).astype(np.int64)
    for io in (jio, tio):
        td = io.TensorDataset([a, b])
        assert len(td) == 6
        np.testing.assert_array_equal(td[3][0], a[3])
        cd = io.ComposeDataset([td, io.TensorDataset([b])])
        assert len(cd[2]) == 3 and cd[2][2] == b[2]
        cat = io.ConcatDataset([td, td])
        assert len(cat) == 12
        np.testing.assert_array_equal(cat[8][0], a[2])
        np.testing.assert_array_equal(cat[-1][0], a[5])
        sub = io.Subset(td, [4, 1])
        assert len(sub) == 2 and sub[0][1] == b[4]
    tt = tio.TensorDataset([pt.to_tensor(a, place="cpu"), b])
    np.testing.assert_array_equal(tt[1][0].numpy(), a[1])


def test_chain_and_iterable_datasets():
    for io in (jio, tio):
        s = type("S", (_Stream, io.IterableDataset), {})
        chain = io.ChainDataset([s(2), s(3)])
        assert [int(y) for _, y in chain] == [0, 1, 0, 1, 2]
        with pytest.raises(RuntimeError):
            s(2)[0]


@pytest.mark.parametrize("lengths", [[0.5, 0.5], [10, 20, 7]])
def test_random_split_matches_jax(lengths):
    out = {}
    for name, io in (("jax", jio), ("torch", tio)):
        np.random.seed(3)
        out[name] = [s.indices for s in io.random_split(Squares(), lengths)]
    assert out["jax"] == out["torch"]
    assert sorted(sum(out["torch"], [])) == list(range(N))


SAMPLERS = {
    "sequence": lambda io, ds: io.SequenceSampler(ds),
    "random": lambda io, ds: io.RandomSampler(ds),
    "random_replacement": lambda io, ds: io.RandomSampler(
        ds, replacement=True, num_samples=50),
    "random_num_samples": lambda io, ds: io.RandomSampler(ds,
                                                          num_samples=9),
    "subset_random": lambda io, ds: io.SubsetRandomSampler([5, 1, 9, 30]),
    "weighted": lambda io, ds: io.WeightedRandomSampler(
        [1, 2, 3, 4, 0.5], 20),
    "weighted_no_replacement": lambda io, ds: io.WeightedRandomSampler(
        [1, 2, 3, 4, 0.5], 4, replacement=False),
    "batch": lambda io, ds: io.BatchSampler(ds, batch_size=5),
    "batch_shuffle_drop_last": lambda io, ds: io.BatchSampler(
        ds, shuffle=True, batch_size=5, drop_last=True),
    "batch_of_sampler": lambda io, ds: io.BatchSampler(
        sampler=io.RandomSampler(ds), batch_size=4),
    "distributed_rank0": lambda io, ds: io.DistributedBatchSampler(
        ds, 4, num_replicas=2, rank=0, shuffle=True),
    "distributed_rank1_drop_last": lambda io, ds: io.DistributedBatchSampler(
        ds, 4, num_replicas=3, rank=1, drop_last=True),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_order_matches_jax(name):
    ds = Squares()
    out = {}
    for key, io in (("jax", jio), ("torch", tio)):
        s = SAMPLERS[name](io, ds)
        np.random.seed(21)
        out[key] = (list(iter(s)), list(iter(s)), len(s))
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == len(out["torch"][0])


def test_distributed_sampler_needs_its_rank():
    s = tio.DistributedBatchSampler(Squares(), 4, num_replicas=2, rank=1,
                                    shuffle=True)
    s.set_epoch(3)
    j = jio.DistributedBatchSampler(Squares(), 4, num_replicas=2, rank=1,
                                    shuffle=True)
    j.set_epoch(3)
    assert list(s) == list(j)
    # without num_replicas / rank: the environment's, as in the JAX
    # package (one process: every sample on rank 0)
    s1, j1 = (io.DistributedBatchSampler(Squares(), 4) for io in (tio, jio))
    assert (s1.nranks, s1.local_rank) == (j1.nranks, j1.local_rank) == (1, 0)
    assert list(s1) == list(j1)


LOADERS = {
    "workers0": dict(num_workers=0),
    "threads2": dict(num_workers=2, use_shared_memory=False),
    "processes2": dict(num_workers=2),
    "processes2_persistent": dict(num_workers=2, persistent_workers=True),
}


@pytest.mark.parametrize("shuffle,drop_last", [(False, False),
                                               (True, True)])
@pytest.mark.parametrize("path", list(LOADERS))
def test_dataloader_batches_match_jax(path, shuffle, drop_last):
    """Every feed path gives the JAX package's batches (its default
    path) in the same order; a persistent pool serves two epochs."""
    want = _batches(jio.DataLoader(_make(jio, jio.Dataset), batch_size=8,
                                   shuffle=shuffle, drop_last=drop_last))
    loader = tio.DataLoader(_make(tio, tio.Dataset), batch_size=8,
                            shuffle=shuffle, drop_last=drop_last,
                            **LOADERS[path])
    assert len(loader) == len(want)
    got = _batches(loader)
    _same(got, want)
    assert isinstance(next(iter(loader))[0], pt.Tensor)
    if loader.persistent_workers:
        _same(_batches(loader), want)
        loader._pool.shutdown()


def test_array_path_matches_jax_native_path():
    """A TensorDataset goes through the gather path in both packages
    (uint8 columns scaled by 1/255 to f32)."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (N, 4, 4)).astype(np.uint8)
    lab = rng.randint(0, 10, (N, 1)).astype(np.int64)
    want = _batches(jio.DataLoader(jio.TensorDataset([img, lab]),
                                   batch_size=6, shuffle=True))
    got = _batches(tio.DataLoader(tio.TensorDataset([img, lab]),
                                  batch_size=6, shuffle=True))
    _same(got, want)
    assert got[0][0].dtype == np.float32


def test_iterable_dataset_and_custom_collate():
    def collate(batch):
        return np.stack([b[0] for b in batch]).sum(axis=1)

    out = {}
    for key, io in (("jax", jio), ("torch", tio)):
        s = type("S", (_Stream, io.IterableDataset), {})(7)
        loader = io.DataLoader(s, batch_size=3, drop_last=False)
        first = [_np(b) for b in loader]
        coll = io.DataLoader(_make(io, io.Dataset), batch_size=5,
                             collate_fn=lambda b: [collate(b)])
        out[key] = (first, [_np(b) for b in coll])
    _same(out["torch"][0], out["jax"][0])
    _same(out["torch"][1], out["jax"][1])
    with pytest.raises(TypeError):
        len(tio.DataLoader(type("S", (_Stream, tio.IterableDataset), {})(3)))


def test_worker_errors_surface():
    class Bad(tio.Dataset):
        def __getitem__(self, i):
            raise KeyError(i)

        def __len__(self):
            return 4

    with pytest.raises(KeyError):
        list(tio.DataLoader(Bad(), batch_size=2, num_workers=2,
                            use_shared_memory=False))


def test_prefetch_to_device_on_the_cpu():
    loader = tio.DataLoader(_make(tio, tio.Dataset), batch_size=8,
                            shuffle=True)
    want = _batches(loader)
    np.random.seed(11)
    staged = list(tio.prefetch_to_device(iter(loader), depth=2,
                                         device="cpu"))
    _same([_np(b) for b in staged], want)
    assert all(isinstance(t, pt.Tensor) and t.place.type == "cpu"
               for b in staged for t in b)
    raw = [torch.zeros(2), {"k": torch.ones(1)}]
    out = next(tio.prefetch_to_device(iter([raw]), device="cpu"))
    assert torch.equal(out[0], raw[0]) and torch.equal(out[1]["k"],
                                                       raw[1]["k"])
