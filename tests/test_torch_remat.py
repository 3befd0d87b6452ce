"""Activation checkpointing (``remat``) of the port: gradients do not depend on the flag.

The tiny model with dropout 0.1 and a trainable ViT (so that every tower
runs under ``torch.utils.checkpoint``) takes the stage-1 and the stage-2
losses' gradients from one dropout generator seed with ``remat`` off and on.
They must be bit-equal (tolerance none): the recompute replays the
generator's state, as the JAX package's ``nn.remat`` replays its key. A
checkpoint that did not replay it would draw new dropout masks in the
backward; the last test shows that such gradients differ, so the replay is
what holds the first tests.
"""

import numpy as np
import pytest
import torch

from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models import layers
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
from pgica_tpu_torch.training.train_step import stage1_loss_fn, stage2_loss_fn

SEQ, B = 10, 3
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16, max_caption_length=SEQ,
            image_size=32, dropout=0.1, freeze_vision_backbone=False)


def _model(remat):
    return PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", remat=remat, seed=4, **TINY)


def _batch():
    rng = np.random.default_rng(0)
    lengths = rng.integers(3, SEQ + 1, size=(2, B))
    masks = [(np.arange(SEQ)[None, :] < n[:, None]).astype(np.int32) for n in lengths]
    ids = [torch.from_numpy(rng.integers(0, 261, size=(B, SEQ))) for _ in range(2)]
    return {"image": torch.from_numpy(rng.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)),
            "caption_ids": ids[0], "caption_mask": torch.from_numpy(masks[0]),
            "preferred_ids": ids[0], "preferred_mask": torch.from_numpy(masks[0]),
            "rejected_ids": ids[1], "rejected_mask": torch.from_numpy(masks[1])}


def _grads(model, stage):
    batch = _batch()
    gen = torch.Generator().manual_seed(11)
    if stage == 1:
        loss, _ = stage1_loss_fn(model.module, batch, gen, 0.5)
    else:
        ref = frozen_copy(model.module, torch.float32)
        loss, _ = stage2_loss_fn(model.module, ref, batch, gen, 0.1, False, False, 0.0)
    params = [p for p in model.module.parameters()]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss, {n: g for (n, _), g in zip(model.module.named_parameters(), grads) if g is not None}


def _count_block_calls(model):
    calls = []
    for block in list(model.module.modules()):
        if isinstance(block, layers.TransformerBlock):
            block.register_forward_pre_hook(lambda *a: calls.append(1))
    return calls


@pytest.mark.parametrize("stage", [1, 2])
def test_remat_gradients_are_bit_equal_to_plain(stage):
    plain, remat = _model(False), _model(True)
    calls = _count_block_calls(remat)
    loss0, g0 = _grads(plain, stage)
    loss1, g1 = _grads(remat, stage)
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys() and len(g0) > 10
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    vit = 2 * sum(1 for _ in remat.module.vision_encoder.backbone.blocks)
    assert len(calls) > vit, "the backward recomputed no block"  # each checkpointed block runs twice


def test_remat_is_off_without_gradients():
    model = _model(True)
    calls = _count_block_calls(model)
    with torch.no_grad():
        stage1_loss_fn(model.module, _batch(), None, 0.5)
    n_blocks = sum(1 for m in model.module.modules() if isinstance(m, layers.TransformerBlock))
    assert len(calls) == n_blocks - len(model.module.caption_decoder.lm.blocks)  # stage 1 skips the decoder


def test_a_checkpoint_without_the_replay_draws_other_masks(monkeypatch):
    plain = _model(False)
    _, g0 = _grads(plain, 1)

    class NoReplay(layers._ReplayDropout):
        def __call__(self, block, x, *args):
            return block(x, *args, self.generator)

    monkeypatch.setattr(layers, "_ReplayDropout", NoReplay)
    _, g1 = _grads(_model(True), 1)
    assert any(not torch.equal(g0[n], g1[n]) for n in g0)
