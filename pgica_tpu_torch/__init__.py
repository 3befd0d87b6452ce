"""pgica_tpu_torch — the PyTorch/CUDA port of pgica_tpu for one NVIDIA H100.

The JAX package ``pgica_tpu`` is the reference and stays unchanged; this
package sits beside it and mirrors its layout (``core/``, ``data/``,
``ops/``, ``models/``, ``generation/``, ``training/``, ``evaluation/``,
``utils/``, ``scripts/``) so each module's counterpart is easy to find. It
imports ``torch`` and numpy only — never ``jax``, ``flax`` or anything of
``pgica_tpu``.

Ported so far: caption serving, greedy, sampled and beam search
(``models.model.PreferenceGuidedCaptioningModel.generate_captions``); the
stage 0/1/2 train steps with device augmentation and activation
checkpointing (``training.train_step``); the trainer, checkpoints, config,
datasets and loaders, and the ``python -m pgica_tpu_torch.scripts.train``
CLI; the continuous-batching engine and the ``serve`` CLI; the evaluation
suite (``evaluation.CaptioningMetrics``, ``evaluation.EvaluationRunner``)
and the ``predict``, ``evaluate`` and ``run_evaluation`` CLIs; over the
GPT-2 flagship (CLIP ViT-B/32, GPT-2 Medium) and the SigLIP + Llama-3-8B
architecture. Every LayerNorm, RMSNorm, self-attention and fused linear
cross-entropy on the card runs through hand-written CUDA kernels, forward
and backward (``csrc/``, built by ``nvcc`` at first use; see
``ops/_kernels.py``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version.
"""

__version__ = "0.1.0"
