"""The port's data loaders against the JAX package's, batch for batch and
bit for bit: `RandomBatchLoader` (uniform, Gaussian ids, variable pooling),
`LearnableSyntheticLoader`, `TraceSyntheticLoader` and `CriteoBinDataset`
on a file the JAX package's preprocessing wrote; `random_batches_on_device`
(shapes, ranges, dtypes, determinism); `concat_batches`; `prefetch`."""

import threading

import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu import train_step as jts
from deep_quantized_recommendation_model_dqrm_tpu.data import binary as jbin
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.data.criteo import preprocess_criteo
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as tts
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import binary as tbin
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic as tsyn
from deep_quantized_recommendation_model_dqrm_tpu_torch.data.prefetch import prefetch
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
from tests.test_data import write_raw

torch.set_num_threads(1)

SIZES = (30000, 500, 20, 7)


def configs(**kw):
    return tuple(m.DLRMConfig(table_sizes=SIZES, embedding_dim=8, mlp_bot=(13, 32, 8),
                              mlp_top=(18, 16, 1), **kw) for m in (jcfg, tcfg))


def assert_batches_equal(jbatches, tbatches):
    jbatches, tbatches = list(jbatches), list(tbatches)
    assert len(jbatches) == len(tbatches) > 0
    for jb, tb in zip(jbatches, tbatches):
        for name, j, t in zip(Batch._fields, jb, tb):
            assert (j is None) == (t is None), name
            if t is None:
                continue
            assert t.device.type == "cpu", name
            j = np.asarray(j)
            assert t.numpy().dtype == j.dtype and t.shape == j.shape, name
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


@pytest.mark.parametrize("gen", [
    {},
    dict(rand_data_dist="gaussian", rand_data_min=0.0, rand_data_max=400.0, rand_data_sigma=50.0),
    dict(variable_pooling=True),
    dict(round_targets=False),
])
def test_random_batch_loader_matches_jax(gen):
    jc, tc = configs(pooling_size=3 if gen.get("variable_pooling") else 1)
    args = (32, 4)
    assert_batches_equal(jsyn.RandomBatchLoader(jc, *args, seed=7, **gen),
                         tsyn.RandomBatchLoader(tc, *args, seed=7, **gen))
    assert len(tsyn.RandomBatchLoader(tc, *args)) == 4


def test_random_batch_loader_variable_pooling_masks():
    _, tc = configs(pooling_size=4)
    b = next(iter(tsyn.RandomBatchLoader(tc, 64, 1, variable_pooling=True)))
    assert b.mask is not None and b.mask.shape == (4, 64, 4)
    assert bool((b.mask[:, :, 0] == 1).all()) and bool((b.mask == 0).any())


def test_learnable_loader_matches_jax():
    jc, tc = configs()
    assert_batches_equal(jsyn.LearnableSyntheticLoader(jc, 64, 3, seed=11),
                         tsyn.LearnableSyntheticLoader(tc, 64, 3, seed=11))


def test_trace_loader_matches_jax():
    jc, tc = configs(pooling_size=2)
    assert_batches_equal(jsyn.TraceSyntheticLoader(jc, 16, 3, seed=5),
                         tsyn.TraceSyntheticLoader(tc, 16, 3, seed=5))
    rng = (np.random.RandomState(2), np.random.RandomState(2))
    np.testing.assert_array_equal(jsyn.trace_generate_indices(50, 200, rng[0]),
                                  tsyn.trace_generate_indices(50, 200, rng[1]))


def test_criteo_bin_dataset_matches_jax(tmp_path):
    raw = write_raw(str(tmp_path / "raw.txt"), 300, seed=4)
    paths = preprocess_criteo(raw, str(tmp_path / "proc"), num_days=2, use_native=False)
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    assert jbin.numpy_to_binary(paths, jpath) == tbin.numpy_to_binary(paths, tpath) == 300
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    for kw in (dict(), dict(max_ind_range=50, shuffle=True, seed=3),
               dict(start_record=120, num_records=100), dict(rank=1, world_size=2)):
        assert_batches_equal(jbin.CriteoBinDataset(jpath, 40, **kw),
                             tbin.CriteoBinDataset(tpath, 40, **kw))


def test_random_batches_on_device_shapes_ranges_determinism():
    _, tc = configs(pooling_size=2)
    make = lambda seed: tsyn.random_batches_on_device(  # noqa: E731
        tc, 512, torch.Generator().manual_seed(seed))
    b = make(3)
    assert b.dense.shape == (512, 13) and b.dense.dtype == torch.float32
    assert bool((b.dense >= 0).all()) and bool((b.dense < 1).all())
    assert b.indices.shape == (4, 512, 2) and b.indices.dtype == torch.int32
    for k, rows in enumerate(SIZES):
        assert int(b.indices[k].min()) >= 0 and int(b.indices[k].max()) < rows
    assert int(b.indices[2].max()) == 19  # 1024 draws cover a 20-row table
    assert b.labels.shape == (512,) and b.labels.dtype == torch.float32
    assert set(b.labels.unique().tolist()) == {0.0, 1.0} and b.mask is None
    again, other = make(3), make(4)
    for x, y in zip(b[:3], again[:3]):
        assert torch.equal(x, y)
    assert not torch.equal(b.indices, other.indices)


@pytest.mark.parametrize("pooling", [1, 3])
def test_concat_batches_matches_jax(pooling):
    jc, tc = configs(pooling_size=pooling)
    jb = list(jsyn.RandomBatchLoader(jc, 8, 3, seed=2, variable_pooling=pooling > 1))
    tb = list(tsyn.RandomBatchLoader(tc, 8, 3, seed=2, variable_pooling=pooling > 1))
    assert_batches_equal([jts.concat_batches(jb)], [tts.concat_batches(tb)])


def test_prefetch_keeps_order_and_raises():
    items = list(range(50))
    assert list(prefetch(items, depth=3)) == items

    def broken():
        yield 1
        raise ValueError("bad batch")

    it = prefetch(broken(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


def test_prefetch_yields_host_batches_from_a_thread():
    _, tc = configs()
    seen = []

    class Loader:
        def __iter__(self):
            seen.append(threading.current_thread() is threading.main_thread())
            yield from tsyn.RandomBatchLoader(tc, 4, 3, seed=1)

    got = list(prefetch(Loader()))
    assert seen == [False] and len(got) == 3
    assert all(t.device.type == "cpu" for b in got for t in b if t is not None)
    assert_batches_equal(got, tsyn.RandomBatchLoader(tc, 4, 3, seed=1))
