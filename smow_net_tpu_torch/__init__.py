"""smow_net_tpu_torch — the PyTorch/CUDA port of smow_net_tpu.

The JAX package `smow_net_tpu` is the reference; this package mirrors its
module paths and class names and speaks the reference checkpoint naming
(`state_dict()` keys are the ones `smow_net_tpu.train.convert` reads).

Layouts follow PyTorch habit: images are NCHW and the temporal stacks NCDHW
with D == T. The two hand-written CUDA kernels (csrc/) run when a tensor
lies on a CUDA device; on a CPU tensor each op takes its plain PyTorch
version. This package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
