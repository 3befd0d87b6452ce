"""pgica_tpu_torch — the PyTorch/CUDA port of pgica_tpu for one NVIDIA H100.

The JAX package ``pgica_tpu`` is the reference and stays unchanged; this
package sits beside it and mirrors its layout (``core/``, ``data/``, ``ops/``,
``models/``, ``generation/``) so each module's counterpart is easy to find.
It imports ``torch`` and numpy only — never ``jax``, ``flax`` or anything of
``pgica_tpu``.

The slice ported so far is greedy caption serving:
``models.model.PreferenceGuidedCaptioningModel.generate_captions`` over the
CLIP ViT-B/32 tower and the GPT-2 Medium decoder, with every LayerNorm and
every self-attention on the card running through hand-written CUDA kernels
(``csrc/``, built by ``nvcc`` at first use; see ``ops/_kernels.py``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version.
"""

__version__ = "0.1.0"
