"""TransMVSNet in PyTorch, with hand-written CUDA kernels for Hopper.

The JAX package ``transmvsnet_tpu`` is the reference this package is held
against; nothing here imports it. Activations are NCHW inside the model;
the top-level ``TransMVSNet.forward`` keeps the JAX package's channel-last
input contract. CUDA tensors go through the kernels under ``csrc/``; CPU
tensors take each kernel's plain PyTorch version.
"""
