"""vlgae_tpu_torch: the PyTorch/CUDA port of vlgae_tpu.

The JAX package ``vlgae_tpu`` is the reference; this package keeps its
module names and its layouts at public functions, so a reader finds each
counterpart under the same path. It imports ``torch`` and numpy only.

What runs here is the ``exp=vlgae`` predict path: the deterministic joint
forward, the Viterbi tree read from the reused DP indicators, the
grounding decode with the exact top-5, and the CoNLL+ALIGN prediction
writer (``python -m vlgae_tpu_torch.predict``). The two TPU kernels on
that path are hand-written CUDA C++ kernels for ``sm_90a`` under
``csrc/``, built at first use by :mod:`vlgae_tpu_torch.ops._build`.
"""

__version__ = "0.1.0"
