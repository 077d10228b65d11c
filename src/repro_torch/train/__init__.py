"""The port's training loop: the train step and the fault-tolerant trainer
(the JAX package's ``repro/train``)."""
