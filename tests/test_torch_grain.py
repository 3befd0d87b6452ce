"""The port's ``workers_mode="grain"`` loader against the JAX package's grain loader and the port's
thread mode, on the CPU (mirrors tests/test_data.py:536-575).

The port runs the mode on PyTorch's worker pool (spawned processes, one
collated batch a task, one persistent pool); the batches are the contract:
equal, array for array and string for string, to the JAX grain loader's
(where the ``grain`` package is installed: the JAX side only) and to the
thread mode's, over two epochs, after ``set_epoch(5)`` and from
``iter_batches(1)``. The dataset's tokenizer is a trained BPE, so the
spawned workers receive it pickled, without its native handle.
"""

import numpy as np
import pytest

from pgica_tpu.data import loader as jloader
from pgica_tpu.data import preprocessing as jpre
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu_torch.data import loader, preprocessing
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.utils import config, factories

from conftest import make_config_dict

CORPUS = ["a red bird sitting on a branch", "two dogs playing in the park", "a bowl of fresh fruit on a table",
          "a city skyline at night", "children flying a kite on the beach"] * 4


def _datasets(root):
    port_tok = CaptionTokenizer.train_bpe(CORPUS, vocab_size=300)
    jax_tok = JaxTokenizer.train_bpe(CORPUS, vocab_size=300)
    port = loader.ConceptualCaptionsDataset(root, preprocessing.ImageProcessor(image_size=32),
                                            preprocessing.TextProcessor(port_tok, max_length=16))
    ref = jloader.ConceptualCaptionsDataset(root, jpre.ImageProcessor(image_size=32),
                                            jpre.TextProcessor(jax_tok, max_length=16))
    return port, ref


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], np.ndarray):
                assert isinstance(g[k], np.ndarray), k  # numpy batches, not tensors
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert g[k].dtype == w[k].dtype, k
            else:
                assert g[k] == w[k], k


def test_grain_batches_equal_thread_batches_and_the_pool_persists(temp_dataset_dir):
    ds, _ = _datasets(temp_dataset_dir)
    thread = loader.DataLoader(ds, batch_size=3, shuffle=True, seed=4)
    grain = loader.DataLoader(ds, batch_size=3, shuffle=True, seed=4, num_workers=2, workers_mode="grain")
    try:
        for epoch in range(2):  # the same shuffled batches, epoch after epoch, from one pool
            _assert_batches_equal(grain, thread)
            if epoch == 0:
                pool = grain._grain_dl
            assert grain._grain_dl is pool, "grain pool respawned per epoch"
        assert grain._grain_pos == 2 * len(grain)

        thread.set_epoch(5)
        grain.set_epoch(5)
        _assert_batches_equal(grain.iter_batches(1), thread.iter_batches(1))  # a resume: a positioned pool
        assert grain._grain_dl is not pool
        resumed = grain._grain_dl
        _assert_batches_equal(grain, thread)  # epoch 6 continues it
        assert grain._grain_dl is resumed
    finally:
        grain.close()
    assert grain._grain_it is None and grain._grain_dl is None
    workers = pool._iterator._workers if pool._iterator is not None else []
    assert not any(w.is_alive() for w in workers)


def test_a_second_iteration_gets_its_own_pool(temp_dataset_dir):
    ds, _ = _datasets(temp_dataset_dir)
    thread = loader.DataLoader(ds, batch_size=4, seed=1)
    grain = loader.DataLoader(ds, batch_size=4, seed=1, num_workers=2, workers_mode="grain")
    try:
        outer = grain.iter_batches(0)
        first = next(outer)
        pool, pos = grain._grain_dl, grain._grain_pos
        grain.set_epoch(0)
        _assert_batches_equal(grain, thread)  # while the first runs: a one-shot pool
        assert grain._grain_dl is pool and grain._grain_pos == pos
        _assert_batches_equal([first, *outer], thread)
    finally:
        grain.close()


def test_grain_batches_equal_jax_grain_batches(temp_dataset_dir):
    pytest.importorskip("grain")  # the JAX side's pipeline; the port never imports grain
    port_ds, jax_ds = _datasets(temp_dataset_dir)
    port = loader.DataLoader(port_ds, batch_size=3, shuffle=True, seed=7, num_workers=2, workers_mode="grain")
    ref = jloader.DataLoader(jax_ds, batch_size=3, shuffle=True, seed=7, num_workers=2, workers_mode="grain")
    try:
        for _ in range(2):
            _assert_batches_equal(port, ref)
        port.set_epoch(3)
        ref.set_epoch(3)
        _assert_batches_equal(port.iter_batches(1), ref.iter_batches(1))
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("drop_last, base", [(True, 0), (True, 7), (False, 5)])
def test_multi_epoch_source_maps_records_to_the_pinned_order_of_each_epoch(drop_last, base):
    items = list(range(10))
    src = loader._MultiEpochBatchSource(items, 3, True, drop_last, 2, list, base=base)
    ref = jloader._MultiEpochBatchSource(items, 3, True, drop_last, 2, list, base=base)
    assert len(src) == len(ref) and src.batches_per_epoch == ref.batches_per_epoch
    for i in range(3 * src.batches_per_epoch):
        epoch, b = divmod(i + base, src.batches_per_epoch)
        assert src[i] == ref[i] == loader._pinned_batch_order(10, 3, True, drop_last, 2, epoch)[b]


def test_create_dataloaders_and_the_factory_run_grain_mode(temp_dataset_dir):
    cfg = config.Config(config_dict=make_config_dict(**{
        "data.conceptual_captions_path": str(temp_dataset_dir), "data.workers_mode": "grain",
        "data.num_workers": 2, "training.stage1.batch_size": 2}))
    processors = factories.create_processors(cfg)
    train, val, test = factories.create_loaders_with_fallback(cfg, *processors)
    try:
        assert {dl.workers_mode for dl in (train, val, test)} == {"grain"}
        thread = loader.DataLoader(train.dataset, 2, shuffle=True, drop_last=True, seed=42)
        _assert_batches_equal(train, thread)
    finally:
        for dl in (train, val, test):
            dl.close()
    with pytest.raises(ValueError, match="workers_mode"):
        loader.DataLoader([], 2, workers_mode="fork")
