"""PyTorch port of the Cronus serving system, for NVIDIA Hopper GPUs.

The sub-packages mirror those of the JAX package ``repro`` so that each
module's counterpart is easy to find. This package imports ``torch``,
numpy and the standard library only: the pure-Python control plane
(engine, schedulers, Balancer, allocator, cluster runtime) is kept as its
own copy here, and the tensor side (models, kernels, executors) is ported.
"""
