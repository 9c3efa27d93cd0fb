"""The benchmark of blockmaze_tpu_torch, the PyTorch and CUDA port, on the
H100 cards a cell asks for: `python3 -m portbench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` from the checkout's root runs one
cell of BENCHMARK.json.

Nothing here imports the JAX package or JAX; portbench/reference and the
configurations' *_ref.py, the judge's side, import nothing of the port
either.
"""
