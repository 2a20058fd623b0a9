"""The port's copies of the repository's examples that import the JAX
package (``examples/``): each a ``make_task`` and a ``main(overrides)``
that the sweep CLI (:mod:`trlx_tpu_torch.sweep`) can drive."""
