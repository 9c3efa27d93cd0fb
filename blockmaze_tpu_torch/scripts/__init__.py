"""The port's operator drivers, one module for each script of the JAX
package's scripts/ under the same name, each run as

    python -m blockmaze_tpu_torch.scripts.<name> [--device cuda|cpu] ...

msmbench (one MSM, its phase split), warmstart (a fresh process's first
proofs), e2e (prove and verify named circuits), batch (prove_batch),
depth20 (deposit at Merkle depth 20), lifecycle (the node path with real
proofs), scaling (sharded_msm over cards or processes) and prewarm (build
the kernels and keys, one proof a circuit). _common holds what they
share.
"""
