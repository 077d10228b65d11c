"""The port's LM: dense GQA decoder layers, the ``Model`` with prefill and
decode entry points and the kNN-LM retrieval hook, and ``params_from_jax``
to carry the JAX package's weights across."""
