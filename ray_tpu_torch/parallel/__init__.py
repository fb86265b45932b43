"""Parallel layer of the port. So far the one-card Mixture-of-Experts
layer (``parallel/moe.py``); the mesh, sharding, pipelining, the expert
mesh axis and ring/Ulysses attention are still to be ported."""
from ray_tpu_torch.parallel.moe import MoEConfig, init_moe_params, moe_layer

__all__ = ["MoEConfig", "init_moe_params", "moe_layer"]
