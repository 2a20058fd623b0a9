"""trlx_tpu_torch — the PyTorch/CUDA port of :mod:`trlx_tpu` for one NVIDIA
H100.

The port mirrors the JAX package's module paths, imports ``torch`` and never
JAX nor any module of ``trlx_tpu``, and replaces each Pallas kernel with one
written by hand for Hopper (``csrc/``). This slice serves GPT-2 through the
continuous-batching engine (:mod:`trlx_tpu_torch.inference`). Entry points
take ``device=None``, which means CUDA, and raise when CUDA is missing;
pass ``device="cpu"`` to run the plain versions (the tests do).

Importing the package imports no model code.
"""

__version__ = "0.1.0"
