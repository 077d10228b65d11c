"""The port's LM for every family of the model zoo (dense GQA and MQA, MoE,
MLA, Mamba, RWKV-6, whisper's encoder-decoder, the vision stub): the
``Model`` with forward, prefill and decode entry points and the kNN-LM
retrieval hook, and ``params_from_jax`` to carry the JAX package's weights
across."""
