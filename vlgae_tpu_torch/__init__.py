"""vlgae_tpu_torch: the PyTorch/CUDA port of vlgae_tpu.

The JAX package ``vlgae_tpu`` is the reference; this package keeps its
module names and its layouts at public functions, so a reader finds each
counterpart under the same path. It imports ``torch`` and numpy only.

What runs here: training (``python -m vlgae_tpu_torch.train``) and
prediction (``python -m vlgae_tpu_torch.predict``) of the recipes
``exp=vlgae`` (region features), ``exp=vlgae_vit`` (the patch grid of a
ViT over raw pixels) and ``exp=lang_only`` (the text-only parser), with
the CoNLL+ALIGN prediction writer that ``eval.py`` scores, on one card or
under ``torchrun`` over a ``(data, model)`` grid of processes
(:mod:`vlgae_tpu_torch.parallel`), and the serving export of the forward
(:mod:`vlgae_tpu_torch.training.export`). The TPU kernels of those paths
are hand-written CUDA C++ kernels for ``sm_90a`` under ``csrc/``, called
through ``torch.library`` custom ops and built at first use by
:mod:`vlgae_tpu_torch.ops._build`, which also builds the native
det-feature packer (``csrc/vlgae_io.cpp``, :mod:`vlgae_tpu_torch.data.native_io`).
"""

__version__ = "0.1.0"
