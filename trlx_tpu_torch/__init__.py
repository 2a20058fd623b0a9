"""trlx_tpu_torch — the PyTorch/CUDA port of :mod:`trlx_tpu` for one NVIDIA
H100.

The port mirrors the JAX package's module paths, imports ``torch`` and never
JAX nor any module of ``trlx_tpu``, and replaces each Pallas kernel with one
written by hand for Hopper (``csrc/``). It serves GPT-2 through the
continuous-batching engine (:mod:`trlx_tpu_torch.inference`) and trains it
with online PPO (:func:`train`). Entry points take ``device=None``, which
means CUDA, and raise when CUDA is missing; pass ``device="cpu"`` to run
the plain versions (the tests do).

Importing the package imports no model code.
"""

__version__ = "0.1.0"


def train(*args, **kwargs):
    """:func:`trlx_tpu_torch.api.train` (imported on first call)."""
    from trlx_tpu_torch.api import train as _train

    return _train(*args, **kwargs)
