"""Plain PyTorch references of the benchmark's configurations.

Written from the models' equations, in float32 with TF32 off, on any
device. They import nothing of ``audiosourcesep_tpu_torch`` (and neither
JAX nor the JAX package): the benchmark makes the weights and inputs and
hands the same tensors to the program and to these functions.

Parameters are a flat ``{name: tensor}`` dict named as the port's (and the
JAX package's) checkpoints are, so that one dict loads into both.
"""
