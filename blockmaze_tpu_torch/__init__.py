"""PyTorch/CUDA port of the blockmaze_tpu Groth16 proving stack.

Same layout as blockmaze_tpu (fields/ curves/ ntt/ msm/ groth16/), with the
JAX package's Pallas kernels as hand-written CUDA kernels in csrc/, built at
first use by utils/kernels.py. Imports torch, never jax, and nothing of
blockmaze_tpu: the host modules it needs (constants and host field
arithmetic, the host curve and pairing, the evaluation domains, libsnark
serialisation, the protoboard, the SHA-256 gadgets, the mint circuit and
the verifier) are its own copies, under the same sub-layout.
"""
