"""PyTorch/CUDA port of the blockmaze_tpu Groth16 proving stack.

Same layout as blockmaze_tpu (fields/ curves/ ntt/ msm/ groth16/), with the
JAX package's Pallas kernels as hand-written CUDA kernels in csrc/, built at
first use by utils/kernels.py. Imports torch and never jax.
"""
